"""Plain PyTorch flash-attention (full masked softmax): the version the
CUDA kernel is held against, and what ``ops.flash_attention`` runs for a
tensor on the CPU.  Port of ``repro/kernels/flash_attention/ref.py``."""

from __future__ import annotations

import torch

F32 = torch.float32


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, kv_len: int | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd).  Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    kv_len = Sk if kv_len is None else kv_len
    qg = q.reshape(B, Sq, KH, G, hd).to(F32) * scale
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k.to(F32))
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = k_pos[None, :] < kv_len
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    else:
        mask = mask.expand(Sq, Sk)
    if window:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, torch.zeros((), dtype=F32,
                                                      device=q.device))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    o = torch.einsum("bkgqt,btkh->bkgqh", p / l, v.to(F32))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
