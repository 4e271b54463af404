"""Flash-decoding attention: wrapper of ``csrc/decode_attention.cu``.

Counterpart of ``repro/kernels/decode_attention/ops.py``, in the model's
layout: q (B, 1, H, hd), caches (B, S, KH, hd), per-row positions.  A
CUDA tensor goes through the hand-written Hopper kernel (or the call
raises); a CPU tensor goes through the plain version in ``ref.py``.
``decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
MAX_GROUP_BLOCK = 8      # query heads one block scores (csrc)
WARPS = 4                # partial (m, l, acc) triples per split (csrc)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"decode_attention_fwd": (_P,) * 8 + (_I,) * 6 + (_F, _I, _I,
                                                                _I, _P)}


def _n_splits(device: torch.device, rows: int, S: int,
              group_block: int) -> int:
    """Chunks each row's valid positions are cut into: about four blocks
    per SM over all rows, and at least 16 positions per chunk for each
    query head a block scores (so a split's partials stay a quarter of
    the K/V bytes it reads)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // rows), -(-S // (16 * group_block))))


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: float | None = None):
    """q: (B, 1, H, hd); caches: (B, S, KH, hd); pos: int or (B,) int —
    the current token's position (its K/V already written).
    Returns (B, 1, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos,
                                    window=window, scale=scale)
    _build.require_cuda("decode_attention q", q, tuple(_DTYPES), 4)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.require_cuda(f"decode_attention {name}", t, (q.dtype,), 4)
    B, one, H, hd = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    if (one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or H % KH or hd not in HEAD_DIMS
            or H // KH not in GROUPS or S == 0 or k_cache.device != q.device
            or v_cache.device != q.device):
        raise ValueError(
            f"decode_attention: unsupported shapes q{tuple(q.shape)} "
            f"cache{tuple(k_cache.shape)} (head dim in {HEAD_DIMS}, "
            f"H/KH in {GROUPS}, one device)")
    pos_b = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int32, device=q.device),
        (B,)).contiguous()
    o = torch.empty_like(q)
    if B == 0:
        return o
    gb = min(H // KH, MAX_GROUP_BLOCK)
    rows = B * H // gb
    split = _n_splits(q.device, rows, S, gb)
    m_part = torch.empty((rows, split * WARPS, gb), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((rows, split * WARPS, gb, hd),
                           dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else hd ** -0.5
    lib = _build.load(_SIGNATURES)
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_b.data_ptr(), o.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), B, S, H, KH, hd,
        int(window), float(scale), split, gb, _DTYPES[q.dtype],
        _build.stream_ptr(q.device))
    _build.check_launch(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
