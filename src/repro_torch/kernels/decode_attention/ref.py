"""Plain PyTorch flash-decode (one token over a masked cache): the version
the CUDA kernel is held against, and what ``ops.decode_attention`` runs
for a tensor on the CPU.  Port of ``repro/kernels/decode_attention/ref.py``,
with the per-row valid range and log-sum-exp of a sequence shard
(``decode_attention_range_ref``)."""

from __future__ import annotations

import torch

F32 = torch.float32


def valid_range(pos, B: int, window: int, device):
    """The (lo, hi) int32 (B,) valid key range of rows at ``pos`` (int or
    (B,)): [max(0, pos - window + 1), pos] windowed, [0, pos] without."""
    hi = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int32, device=device), (B,))
    hi = hi.contiguous()
    lo = (hi - (window - 1)).clamp_min_(0) if window else torch.zeros_like(hi)
    return lo, hi


def decode_attention_range_ref(q, k_cache, v_cache, lo, hi, *,
                               scale: float | None = None):
    """q: (B, 1, H, hd); caches: (B, S, KH, hd); lo, hi: (B,) int, the
    valid keys of row b are [lo[b], hi[b]] (clipped to the cache; empty
    when hi < lo).  Returns (o (B, 1, H, hd) in q's dtype, lse (B, H)
    f32): lse is the log-sum-exp of the row's scaled scores, -inf where
    the range is empty, and o is 0 there."""
    B, _, H, hd = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    qg = (q.to(F32) * scale).reshape(B, KH, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(F32))
    k_pos = torch.arange(S, device=q.device)
    mask = (k_pos[None, :] >= lo[:, None]) & (k_pos[None, :] <= hi[:, None])
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(torch.isfinite(s), p, torch.zeros((), dtype=F32,
                                                      device=q.device))
    total = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", p / total.clamp_min(1e-37),
                     v_cache.to(F32))
    lse = torch.where(total > 0, m + torch.log(total),
                      torch.full((), float("-inf"), device=q.device))
    return o.reshape(B, 1, H, hd).to(q.dtype), lse.reshape(B, H)


def decode_attention_ref(q, k_cache, v_cache, pos, *, window: int = 0,
                         scale: float | None = None):
    """q: (B, 1, H, hd); caches: (B, S, KH, hd); pos: int or (B,)."""
    lo, hi = valid_range(pos, q.shape[0], window, q.device)
    return decode_attention_range_ref(q, k_cache, v_cache, lo, hi,
                                      scale=scale)[0]
