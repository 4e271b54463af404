"""Plain PyTorch versions of the exact cosine top-k scan.  Port of
``repro/kernels/topk_sim/ref.py``, plus ``block_max_scores_ref``: the
plain version of the block-max kernel, which ``ops.block_max_scores``
runs for a tensor on the CPU."""

from __future__ import annotations

import torch

F32 = torch.float32


def _normalise(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-9)


def topk_sim_ref(corpus, queries, k: int):
    """corpus: (N, D); queries: (Q, D) -> (scores (Q,k), idx (Q,k)) in
    (score desc, id asc) order."""
    s = torch.einsum("qd,nd->qn", _normalise(queries).to(F32),
                     _normalise(corpus).to(F32))
    top_s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return top_s[:, :k], idx[:, :k]


def block_max_scores_ref(corpus, queries, *, block_n: int = 64):
    """corpus: (N, D); queries: (Q, D) -> (Q, ceil(N / block_n)): the max
    of q . c over each block of ``block_n`` rows (rows past N never
    count)."""
    N = corpus.shape[0]
    Q = queries.shape[0]
    n_blocks = -(-N // block_n)
    s = queries.to(F32) @ corpus.to(F32).T                  # (Q, N)
    pad = n_blocks * block_n - N
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    return s.reshape(Q, n_blocks, block_n).amax(dim=2)
