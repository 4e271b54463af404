"""Flash-decoding attention: wrapper of ``csrc/decode_attention.cu``.

Counterpart of ``repro/kernels/decode_attention/ops.py``, in the model's
layout: q (B, 1, H, hd), caches (B, S, KH, hd), per-row positions.  A
CUDA tensor goes through the hand-written Hopper kernel (or the call
raises); a CPU tensor goes through the plain version in ``ref.py``.
``decode_attention`` takes each row's position and the window, as the
Pallas kernel does: the kernel takes each row's valid range as ``[max(0,
pos - window + 1), pos]``, forming the lower end itself (in the wrapper it
would cost two elementwise launches a call); ``decode_attention_range``
takes the ranges themselves (a sequence shard's, in its own positions,
possibly empty) and also returns each head's log-sum-exp, by which the
mesh's decode merges its shards (``models/sharding.py``).
``decode_attention.launches`` counts calls of either that launched the
kernel (one launch in bf16; the f32 kernel adds a merge launch).

On the card the call raises where autograd would need a gradient
(``_build.refuse_grad``): the kernel has no backward, as the Pallas
kernel has none.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from .ref import decode_attention_range_ref, valid_range

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
TILE_KEYS = 64           # keys per K/V tile of the bf16 kernel (csrc)
GRID_WAVES = 2           # bf16 grid bound: waves of resident blocks
F32_GROUP_BLOCK = 8      # query heads one block of the f32 kernel scores
F32_WARPS = 4            # partial (m, l, acc) triples per f32 split
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "decode_attention_mma": (_P,) * 11 + (_I,) * 7 + (_F, _I, _P),
    "decode_attention_f32": (_P,) * 10 + (_I,) * 6 + (_F, _I, _I, _P),
    "decode_attention_info": (_I, _I, ctypes.POINTER(_I))}
INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")
# per (device, stream): the bf16 kernel's per-row counters, zero between
# calls (the last block of a row sets its counter back to 0); calls on one
# stream run in order, so each stream needs one set of its own.  No lock of
# its own: the plan layer's worker threads reach this only through
# LocalTorchProvider's ``_engine_lock``, which serialises every engine call,
# and a worker thread's current stream is the device's default stream, so
# they share one set in order
_COUNTERS: dict = {}


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _grid_blocks(device: torch.device, hd: int) -> int:
    """The bf16 grid bound at head dim ``hd``: GRID_WAVES waves of the
    blocks the card holds resident at once."""
    with torch.cuda.device(device):
        per_sm = instance_info(hd)["blocks_per_sm"]
    return GRID_WAVES * per_sm * _sms(device)


def _row_counters(device: torch.device, stream: int,
                  rows: int) -> torch.Tensor:
    counters = _COUNTERS.get((device, stream))
    if counters is None or counters.numel() < rows:
        counters = torch.zeros(max(rows, 256), dtype=torch.int32,
                               device=device)
        _COUNTERS[device, stream] = counters
    return counters


def chunk_keys(grid_blocks: int, rows: int, n_max: int, G: int) -> int:
    """Keys per block of the bf16 kernel, a multiple of the tile.  A row of
    n valid keys takes ceil(n / chunk) blocks and its last block merges
    their partials of G x hd floats each, so a long chunk costs parallel
    reads and a short one a longer merge: about sqrt(n_max * G) keys
    balances the two.  The grid is sized for the longest row
    (rows x ceil(n_max / chunk) blocks), and every block adds its own
    fixed cost (launch, counter, partial), so the chunk doubles until that
    grid stays within ``grid_blocks`` (GRID_WAVES waves of resident
    blocks), or one chunk holds the longest row.
    ``tools/decode_sweep.py`` times the alternatives on the card."""
    tiles = max(1, round(math.sqrt(n_max * G) / TILE_KEYS))
    while (tiles * TILE_KEYS < n_max and rows * -(-n_max // (
            tiles * TILE_KEYS)) > grid_blocks):
        tiles *= 2
    return tiles * TILE_KEYS


def _f32_splits(device: torch.device, rows: int, S: int,
                group_block: int) -> int:
    """Chunks of the f32 kernel: about four blocks per SM over all rows, and
    at least 16 positions per chunk for each query head a block scores."""
    return max(1, min(-(-4 * _sms(device) // rows),
                      -(-S // (16 * group_block))))


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: float | None = None):
    """q: (B, 1, H, hd); caches: (B, S, KH, hd); pos: int or (B,) int —
    the current token's position (its K/V already written).
    Returns (B, 1, H, hd) in q's dtype."""
    hi = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                            device=q.device), (q.shape[0],))
    return _decode(q, k_cache, v_cache, None, hi.contiguous(), window,
                   window, scale, False)[0]


def decode_attention_range(q, k_cache, v_cache, lo, hi, *, window: int = 0,
                           scale: float | None = None):
    """q: (B, 1, H, hd); caches: (B, S, KH, hd); lo, hi: (B,) int32, row
    b's valid keys [lo[b], hi[b]] (clipped to the cache; empty when hi <
    lo), and with ``window`` > 0 no more than the range's last ``window``
    keys: lo is raised to ``hi - window + 1`` here, so that every range
    fits the grid, which is sized for min(S, window) keys a row (S
    without a window).  Returns (o (B, 1, H, hd) in q's dtype, lse (B, H)
    f32: each head's log-sum-exp of its scaled scores, -inf with o = 0
    where the range is empty)."""
    if window > 0:
        lo = torch.maximum(lo, hi - (window - 1))
    return _decode(q, k_cache, v_cache, lo, hi, window, 0, scale, True)


def _decode(q, k_cache, v_cache, lo, hi, max_len, window, scale, with_lse):
    """The call: rows' ranges [lo, hi], or with lo None [max(0, hi - window
    + 1), hi].  ``max_len`` (0: S) sizes the bf16 grid and bounds every
    range: both forms pass their window, which bounds their ranges."""
    if q.device.type == "cpu":
        if lo is None:
            lo, hi = valid_range(hi, q.shape[0], window, q.device)
        return decode_attention_range_ref(q, k_cache, v_cache, lo, hi,
                                          scale=scale)
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
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
    for name, t in (("lo", lo), ("hi", hi)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (B,) or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"int32 ({B},) tensor on {q.device}")
    o = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0:
        return o, lse
    lse_ptr = lse.data_ptr() if with_lse else None
    lo_ptr = None if lo is None else lo.data_ptr()
    scale = scale if scale is not None else hd ** -0.5
    lib = _build.load(_SIGNATURES)
    stream = _build.stream_ptr(q.device)
    G = H // KH
    if q.dtype == torch.bfloat16:
        rows = B * KH
        n_max = min(S, max_len) if max_len > 0 else S
        chunk = chunk_keys(_grid_blocks(q.device, hd), rows, n_max, G)
        parts = rows * -(-n_max // chunk) * G     # (row, split, head)
        scratch = torch.empty(parts * (hd + 2), dtype=torch.float32,
                              device=q.device)
        acc_part, m_part, l_part = scratch.split((parts * hd, parts, parts))
        _build.launch(
            lib, "decode_attention_mma", "decode_attention", q.device,
            stream, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lo_ptr, hi.data_ptr(), o.data_ptr(), lse_ptr,
            acc_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            _row_counters(q.device, stream, rows).data_ptr(), B, S, H, KH,
            hd, int(max_len), int(window), float(scale), chunk)
    else:
        gb = min(G, F32_GROUP_BLOCK)
        rows = B * H // gb
        split = _f32_splits(q.device, rows, S, gb)
        m_part = torch.empty((rows, split * F32_WARPS, gb),
                             dtype=torch.float32, device=q.device)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((rows, split * F32_WARPS, gb, hd),
                               dtype=torch.float32, device=q.device)
        _build.launch(
            lib, "decode_attention_f32", "decode_attention", q.device,
            stream, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lo_ptr, hi.data_ptr(), o.data_ptr(), lse_ptr,
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(), B, S,
            H, KH, hd, int(window), float(scale), split, gb)
    decode_attention.launches += 1
    return o, lse


decode_attention.launches = 0


def instance_info(hd: int, dtype=torch.bfloat16) -> dict:
    """What the kernel instance for head dim ``hd`` and ``dtype`` takes on
    the current card, from the CUDA runtime: registers and local bytes
    (spills and stack) a thread, dynamic shared bytes, and resident blocks
    per SM.  The bf16 instance serves every G in ``GROUPS`` and is given
    here with its largest ring; the f32 one at 8 heads a block."""
    if hd not in HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"decode_attention: no instance for hd {hd}, "
                         f"{dtype}")
    lib = _build.load(_SIGNATURES)
    out = (_I * len(INFO_KEYS))()
    rc = lib.decode_attention_info(hd, _DTYPES[dtype], out)
    _build.check_launch(lib, rc, "decode_attention_info")
    return dict(zip(INFO_KEYS, out))
