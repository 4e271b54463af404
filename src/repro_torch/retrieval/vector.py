"""Exact vector similarity search (paper Query 3 step 2 — the VSS scan);
port of ``repro/retrieval/vector.py``.

``cosine_topk`` is the plain PyTorch scan: a blocked product with a
running top-k, the oracle of the block-max kernel.  ``VectorIndex`` is
the materialised index behind vector retrieval: its normalised corpus is
moved to the device once, when the index is built, and ``topk`` runs the
exact block-max scan of ``kernels.topk_sim`` there (the CUDA kernel on
the GPU, its plain version on the CPU).  The IVF route (``topk_ann``),
segment appends and the multi-GPU sharded scan are later slices
(ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.topk_sim.ops import topk_sim

F32 = torch.float32


def cosine_topk(corpus, queries, k: int, block: int = 4096):
    """corpus: (N, D) unit-normalised; queries: (Q, D).  Returns
    (scores (Q,k), indices (Q,k) int32) by cosine similarity in (score
    desc, id asc) order, blocked over N so the full (N, Q) score matrix is
    never materialised.  ``k`` is capped at N; an empty corpus returns
    empty (Q, 0) results."""
    N, D = corpus.shape
    Q = queries.shape[0]
    k = min(k, N)
    dev = corpus.device
    if N == 0 or k == 0:
        return (torch.zeros((Q, 0), dtype=F32, device=dev),
                torch.zeros((Q, 0), dtype=torch.int32, device=dev))
    qn = queries / torch.linalg.vector_norm(
        queries, dim=-1, keepdim=True).clamp_min(1e-9)
    block = min(block, N)
    best_s = torch.full((Q, k), float("-inf"), dtype=F32, device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    for start in range(0, N, block):
        cb = corpus[start:start + block]
        s = (qn.to(F32) @ cb.to(F32).T)
        idx = torch.arange(start, start + cb.shape[0], dtype=torch.int32,
                           device=dev)
        # best holds lower ids than this block, in (score desc, id asc)
        # order: a stable sort keeps that order among ties
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, idx.expand(Q, -1)], dim=1)
        cat_s, at = torch.sort(cat_s, dim=1, descending=True, stable=True)
        best_s, best_i = cat_s[:, :k], torch.gather(cat_i, 1, at[:, :k])
    return best_s, best_i


class VectorIndex:
    """Materialised embedding index over a column of texts.  ``device``
    None keeps the corpus on the GPU (and raises without one)."""

    def __init__(self, vectors: np.ndarray, device=None):
        v = np.asarray(vectors, np.float32)
        if v.ndim == 1:
            v = v.reshape(0, 0) if v.size == 0 else v.reshape(1, -1)
        norms = np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        self.device = resolve_device(device)
        self.vectors = torch.from_numpy(v / norms).to(self.device)

    def __len__(self) -> int:
        return self.vectors.shape[0]

    def topk(self, query_vecs: np.ndarray, k: int = 100):
        """Exact cosine top-k: (scores (Q, k) f32, ids (Q, k) int32) as
        numpy arrays, ``k`` capped at the corpus size."""
        q = np.atleast_2d(np.asarray(query_vecs, np.float32))
        use_k = min(k, len(self))
        if use_k <= 0 or q.shape[-1] == 0:
            return (np.zeros((len(q), 0), np.float32),
                    np.zeros((len(q), 0), np.int32))
        s, i = topk_sim(self.vectors, torch.from_numpy(q).to(self.device),
                        use_k)
        return s.cpu().numpy(), i.cpu().numpy()
