"""Plain PyTorch version of the RG-LRU recurrence: the function of
``csrc/rg_lru.cu``, which ``ops.rg_lru`` runs for a tensor on the CPU and
``chip_smoke.py`` holds the kernel against on the card.

Counterpart of ``repro/kernels/rg_lru/ref.py``: a loop over time on a
(B, di) f32 state.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def rg_lru_ref(a, b):
    """a, b: (B, S, di) -> h (B, S, di) in a's dtype, with
    ``h_t = a_t * h_{t-1} + b_t`` from h = 0, f32 inside."""
    af, bf = a.to(F32), b.to(F32)
    h = torch.zeros_like(af[:, 0])
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
