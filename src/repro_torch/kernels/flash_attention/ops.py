"""Flash-attention forward: wrapper of ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention/ops.py``, in the same
(B, S, H, hd) layout.  A CUDA tensor goes through the hand-written Hopper
kernel (or the call raises); a CPU tensor goes through the plain version
in ``ref.py``.  ``flash_attention.launches`` counts kernel launches.

On the card the call raises where autograd would need a gradient
(``_build.refuse_grad``): the kernel has no backward, as the Pallas
kernel has none.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _F, _I, _P),
               "flash_attention_info": (_I, _I, ctypes.POINTER(_I))}
INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd) -> (B, Sq, H, hd) in q's
    dtype.  ``window`` > 0 adds the sliding-window mask
    q_pos - k_pos < window."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    _build.refuse_grad("flash_attention", q, k, v)
    _build.require_cuda("flash_attention q", q, tuple(_DTYPES), 4)
    for name, t in (("k", k), ("v", v)):
        _build.require_cuda(f"flash_attention {name}", t, (q.dtype,), 4)
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or H % KH or hd not in HEAD_DIMS or k.device != q.device
            or v.device != q.device):
        raise ValueError(f"flash_attention: unsupported shapes q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} v{tuple(v.shape)} (head dim in "
                         f"{HEAD_DIMS}, H divisible by KH, one device)")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    scale = scale if scale is not None else hd ** -0.5
    lib = _build.load(_SIGNATURES)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
        H, KH, hd, int(causal), int(window), float(scale), _DTYPES[q.dtype],
        _build.stream_ptr(q.device))
    _build.check_launch(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def instance_info(hd: int, dtype=torch.bfloat16) -> dict:
    """What the kernel instance for head dim ``hd`` and ``dtype`` takes on
    the current card, from the CUDA runtime: registers and local bytes
    (spills and stack) a thread, dynamic shared bytes, and resident blocks
    per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if hd not in HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"flash_attention: no instance for hd {hd}, {dtype}")
    lib = _build.load(_SIGNATURES)
    out = (_I * len(INFO_KEYS))()
    rc = lib.flash_attention_info(hd, _DTYPES[dtype], out)
    _build.check_launch(lib, rc, "flash_attention_info")
    return dict(zip(INFO_KEYS, out))
