"""Mamba-1 selective scan (the full-sequence SSM of every Mamba layer).

Counterpart of ``repro/kernels/ssm_scan/ops.py``.  ``ssm_scan`` is the
hand-written Hopper kernel of ``csrc/ssm_scan.cu`` for a CUDA tensor (or
the call raises) and the plain version in ``ref.py`` for a CPU tensor;
``ssm_scan.launches`` counts kernel launches.  The kernel takes any S and
di (ragged edges are masked inside it, nothing is padded here) and a
state of up to ``MAX_STATE`` per channel.

On the card the call raises where autograd would need a gradient
(``_build.refuse_grad``): the kernel has no backward, as the Pallas
kernel has none.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssm_scan_ref

F32, BF16 = torch.float32, torch.bfloat16
MAX_STATE = 16           # h and A of one channel live in registers
MAX_BATCH = 65_535       # the grid's y axis walks batch rows
_DTYPE_CODE = {F32: 0, BF16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssm_scan_fwd": (_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _P)}


def ssm_scan(x, dt, Bm, Cm, A_log, D):
    """x, dt: (B, S, di); Bm, Cm: (B, S, N), all in x's dtype (f32 or
    bf16); A_log: (di, N) f32; D: (di,) f32 -> y (B, S, di) in x's dtype.
    Zero initial state, f32 inside (see ``ref.ssm_scan_ref``)."""
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, Bm, Cm, A_log, D)
    _build.refuse_grad("ssm_scan", x, dt, Bm, Cm, A_log, D)
    dtypes = (F32, BF16)
    _build.require_cuda("ssm_scan x", x, dtypes, 3)
    _build.require_cuda("ssm_scan dt", dt, (x.dtype,), 3)
    _build.require_cuda("ssm_scan Bm", Bm, (x.dtype,), 3)
    _build.require_cuda("ssm_scan Cm", Cm, (x.dtype,), 3)
    _build.require_cuda("ssm_scan A_log", A_log, (F32,), 2)
    _build.require_cuda("ssm_scan D", D, (F32,), 1)
    B, S, di = x.shape
    N = Bm.shape[-1]
    if (dt.shape != x.shape or Bm.shape != (B, S, N)
            or Cm.shape != (B, S, N) or A_log.shape != (di, N)
            or D.shape != (di,) or not 0 < N <= MAX_STATE
            or B > MAX_BATCH
            or any(t.device != x.device for t in (dt, Bm, Cm, A_log, D))):
        raise ValueError(
            f"ssm_scan: unsupported shapes x{tuple(x.shape)} "
            f"dt{tuple(dt.shape)} Bm{tuple(Bm.shape)} Cm{tuple(Cm.shape)} "
            f"A_log{tuple(A_log.shape)} D{tuple(D.shape)} "
            f"(0 < N <= {MAX_STATE}, B <= {MAX_BATCH}, one device)")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.load(_SIGNATURES)
    _build.launch(
        lib, "ssm_scan_fwd", "ssm_scan", x.device,
        _build.stream_ptr(x.device), x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A_log.data_ptr(), D.data_ptr(), y.data_ptr(), B, S, di, N,
        _DTYPE_CODE[x.dtype])
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
