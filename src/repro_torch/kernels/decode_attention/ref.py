"""Plain PyTorch flash-decode (one token over a masked cache): the version
the CUDA kernel is held against, and what ``ops.decode_attention`` runs
for a tensor on the CPU.  Port of ``repro/kernels/decode_attention/ref.py``."""

from __future__ import annotations

import torch

F32 = torch.float32


def decode_attention_ref(q, k_cache, v_cache, pos, *, window: int = 0,
                         scale: float | None = None):
    """q: (B, 1, H, hd); caches: (B, S, KH, hd); pos: int or (B,)."""
    B, _, H, hd = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    qg = (q.to(F32) * scale).reshape(B, KH, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(F32))
    pos_b = torch.broadcast_to(torch.as_tensor(pos, device=q.device), (B,))
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos[None, :] <= pos_b[:, None]
    if window:
        mask = mask & (pos_b[:, None] - k_pos[None, :] < window)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, torch.zeros((), dtype=F32,
                                                      device=q.device))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    o = torch.einsum("bkgs,bskh->bkgh", p / l, v_cache.to(F32))
    return o.reshape(B, 1, H, hd).to(q.dtype)
