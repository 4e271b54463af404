"""RG-LRU recurrence (the full-sequence scan of every Griffin ``rec`` layer).

Counterpart of ``repro/kernels/rg_lru/ops.py``.  ``rg_lru`` is the
hand-written Hopper kernel of ``csrc/rg_lru.cu`` for a CUDA tensor (or
the call raises) and the plain version in ``ref.py`` for a CPU tensor;
``rg_lru.launches`` counts kernel launches.  The kernel takes any S and
di (ragged edges are masked inside it, nothing is padded here).

On the card the call raises where autograd would need a gradient
(``_build.refuse_grad``): the kernel has no backward, as the Pallas
kernel has none.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rg_lru_ref

F32, BF16 = torch.float32, torch.bfloat16
MAX_BATCH = 65_535       # the grid's y axis walks batch rows
_DTYPE_CODE = {F32: 0, BF16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rg_lru_fwd": (_P, _P, _P, _I, _I, _I, _I, _P)}


def rg_lru(a, b):
    """a, b: (B, S, di) of one dtype (f32 or bf16) -> h (B, S, di) in a's
    dtype, ``h_t = a_t * h_{t-1} + b_t`` from a zero state, f32 inside."""
    if a.device.type == "cpu":
        return rg_lru_ref(a, b)
    _build.refuse_grad("rg_lru", a, b)
    _build.require_cuda("rg_lru a", a, (F32, BF16), 3)
    _build.require_cuda("rg_lru b", b, (a.dtype,), 3)
    B, S, di = a.shape
    if b.shape != a.shape or B > MAX_BATCH or b.device != a.device:
        raise ValueError(f"rg_lru: unsupported shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} (equal shapes, B <= "
                         f"{MAX_BATCH}, one device)")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _build.load(_SIGNATURES)
    rc = lib.rg_lru_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, di,
                        _DTYPE_CODE[a.dtype], _build.stream_ptr(a.device))
    _build.check_launch(lib, rc, "rg_lru")
    rg_lru.launches += 1
    return h


rg_lru.launches = 0
