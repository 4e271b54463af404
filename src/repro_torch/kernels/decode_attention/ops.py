"""Flash-decoding attention: wrapper of ``csrc/decode_attention.cu``.

Counterpart of ``repro/kernels/decode_attention/ops.py``, in the model's
layout: q (B, 1, H, hd), caches (B, S, KH, hd), per-row positions.  A
CUDA tensor goes through the hand-written Hopper kernel (or the call
raises); a CPU tensor goes through the plain version in ``ref.py``.
``decode_attention.launches`` counts calls that launched the kernel (one
launch in bf16; the f32 kernel adds a merge launch).

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
from .ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
TILE_KEYS = 64           # keys per K/V tile of the bf16 kernel (csrc)
GRID_WAVES = 2           # bf16 grid bound: waves of resident blocks
F32_GROUP_BLOCK = 8      # query heads one block of the f32 kernel scores
F32_WARPS = 4            # partial (m, l, acc) triples per f32 split
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "decode_attention_mma": (_P,) * 9 + (_I,) * 6 + (_F, _I, _P),
    "decode_attention_f32": (_P,) * 8 + (_I,) * 6 + (_F, _I, _I, _P),
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
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos,
                                    window=window, scale=scale)
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
    pos_b = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int32, device=q.device),
        (B,)).contiguous()
    o = torch.empty_like(q)
    if B == 0:
        return o
    scale = scale if scale is not None else hd ** -0.5
    lib = _build.load(_SIGNATURES)
    stream = _build.stream_ptr(q.device)
    G = H // KH
    if q.dtype == torch.bfloat16:
        rows = B * KH
        n_max = min(S, window) if window > 0 else S
        chunk = chunk_keys(_grid_blocks(q.device, hd), rows, n_max, G)
        parts = rows * -(-n_max // chunk) * G     # (row, split, head)
        scratch = torch.empty(parts * (hd + 2), dtype=torch.float32,
                              device=q.device)
        acc_part, m_part, l_part = scratch.split((parts * hd, parts, parts))
        rc = lib.decode_attention_mma(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos_b.data_ptr(), o.data_ptr(), acc_part.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(),
            _row_counters(q.device, stream, rows).data_ptr(), B, S, H, KH,
            hd, int(window), float(scale), chunk, stream)
    else:
        gb = min(G, F32_GROUP_BLOCK)
        rows = B * H // gb
        split = _f32_splits(q.device, rows, S, gb)
        m_part = torch.empty((rows, split * F32_WARPS, gb),
                             dtype=torch.float32, device=q.device)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((rows, split * F32_WARPS, gb, hd),
                               dtype=torch.float32, device=q.device)
        rc = lib.decode_attention_f32(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos_b.data_ptr(), o.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), acc_part.data_ptr(), B, S, H, KH, hd,
            int(window), float(scale), split, gb, stream)
    _build.check_launch(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return o


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
