"""Plain PyTorch version of the Mamba-1 selective scan: the function of
``csrc/ssm_scan.cu``, which ``ops.ssm_scan`` runs for a tensor on the CPU
and ``chip_smoke.py`` holds the kernel against on the card.

Counterpart of ``repro/kernels/ssm_scan/ref.py``.  Like that oracle it
loops over time; unlike it, it holds only the (B, di, N) state and never
builds the (B, S, di, N) discretised tensors, which at falcon-mamba-7b's
embed shape would take gigabytes per layer.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def ssm_scan_ref(x, dt, Bm, Cm, A_log, D):
    """x, dt: (B, S, di); Bm, Cm: (B, S, N); A_log: (di, N); D: (di,).

    ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t`` with
    ``A = -exp(A_log)`` and a zero initial state, ``y_t = h_t . C_t +
    D * x_t``; f32 inside.  Returns y (B, S, di) in x's dtype."""
    A = -torch.exp(A_log.to(F32))                          # (di, N)
    xf, dtf = x.to(F32), dt.to(F32)
    dtx = dtf * xf
    Bf, Cf = Bm.to(F32), Cm.to(F32)
    B, S, di = x.shape
    h = torch.zeros((B, di, A.shape[-1]), dtype=F32, device=x.device)
    y = torch.empty((B, S, di), dtype=F32, device=x.device)
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * A)              # (B, di, N)
        h = a * h + dtx[:, t, :, None] * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(dim=-1)
    return (y + D.to(F32) * xf).to(x.dtype)
