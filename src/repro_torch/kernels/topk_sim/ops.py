"""Exact cosine top-k by block-max pruning.

Counterpart of ``repro/kernels/topk_sim/ops.py``.  Phase 1,
``block_max_scores``, is the hand-written Hopper kernel of
``csrc/topk_sim.cu`` for a CUDA tensor (or the call raises) and the plain
version in ``ref.py`` for a CPU tensor; ``block_max_scores.launches``
counts kernel launches.  Phase 2 (top-k blocks, gather, exact rescore,
duplicate mask, top-k) is plain PyTorch, as the JAX package leaves it to
XLA.  Results come in the canonical (score desc, id asc) order of the
reference's retrieval operators (``repro/engine/retrieval_ops.py``).
``topk_sim`` normalises its inputs and calls ``topk_normalised``, which
runs both phases on unit-norm rows: the mesh-sharded scan
(``retrieval/distributed.py``) calls it on each shard as it lies on its
card, without a normalised copy.

On the card the call raises where autograd would need a gradient
(``_build.refuse_grad``): the kernel has no backward, as the Pallas
kernel has none.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import block_max_scores_ref

F32 = torch.float32
MAX_DIM = 6144           # the 8-query tile must fit in shared memory
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"block_max_scores_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P)}


def block_max_scores(corpus, queries, *, block_n: int = 64):
    """corpus: (N, D) f32; queries: (Q, D) f32 -> (Q, ceil(N / block_n))
    per-block maxima of q . c."""
    if corpus.device.type == "cpu":
        return block_max_scores_ref(corpus, queries, block_n=block_n)
    _build.refuse_grad("block_max_scores", corpus, queries)
    _build.require_cuda("block_max_scores corpus", corpus, (F32,), 2)
    _build.require_cuda("block_max_scores queries", queries, (F32,), 2)
    N, D = corpus.shape
    Q = queries.shape[0]
    if (queries.shape[1] != D or not 0 < D <= MAX_DIM or block_n <= 0
            or queries.device != corpus.device):
        raise ValueError(
            f"block_max_scores: unsupported shapes corpus{tuple(corpus.shape)}"
            f" queries{tuple(queries.shape)} (0 < D <= {MAX_DIM}, one device)")
    n_blocks = -(-N // block_n)
    out = torch.empty((Q, n_blocks), dtype=F32, device=corpus.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(corpus.device).multi_processor_count
    per_cta = max(1, n_blocks // (3 * sms))
    lib = _build.load(_SIGNATURES)
    _build.launch(
        lib, "block_max_scores_fwd", "block_max_scores", corpus.device,
        _build.stream_ptr(corpus.device), corpus.data_ptr(), queries.data_ptr(), out.data_ptr(), N, D, Q,
        block_n, per_cta)
    block_max_scores.launches += 1
    return out


block_max_scores.launches = 0


def topk_sim(corpus, queries, k: int, *, block_n: int = 64):
    """Exact cosine top-k via block-max pruning.

    corpus: (N, D) (normalised inside); queries: (Q, D).
    Returns (scores (Q, k) f32, indices (Q, k) int32).  ``k`` is capped at
    N; an empty corpus or query set returns empty results."""
    cn = corpus / torch.linalg.vector_norm(
        corpus, dim=-1, keepdim=True).clamp_min(1e-9)
    qn = queries / torch.linalg.vector_norm(
        queries, dim=-1, keepdim=True).clamp_min(1e-9)
    return topk_normalised(cn, qn.to(cn.dtype), k, block_n=block_n)


def topk_normalised(cn, qn, k: int, *, block_n: int = 64):
    """``topk_sim`` on rows that are already unit-norm: cn (N, D), qn
    (Q, D) of cn's dtype, on one device.  Phase 1 is the block-max kernel
    (its plain version on the CPU), phase 2 the exact rescore of the top
    blocks.  No host sync: a caller may queue it on several cards at once
    (``retrieval.distributed``)."""
    N, D = cn.shape
    Q = qn.shape[0]
    k = min(k, N)
    if N == 0 or k == 0 or Q == 0:
        return (torch.zeros((Q, k), dtype=F32, device=cn.device),
                torch.zeros((Q, k), dtype=torch.int32, device=cn.device))
    block_n = min(block_n, max(N, 8))

    bmax = block_max_scores(cn, qn, block_n=block_n)      # (Q, n_blocks)
    kb = min(k, bmax.shape[1])
    # the kb best blocks, ties to the lower block: a canonical top-k doc
    # outside them would trail a better-or-equal doc of each of kb >= k
    # chosen blocks in (score desc, id asc) order
    top_blocks = torch.sort(bmax, dim=1, descending=True,
                            stable=True).indices[:, :kb]     # (Q, kb)

    # candidate rows of the top blocks: (Q, kb * block_n), clipped to N-1
    row_idx = (top_blocks[:, :, None] * block_n
               + torch.arange(block_n, device=cn.device)
               ).reshape(Q, kb * block_n).clamp_max(N - 1)
    # candidates in id order; a clipped row gathered twice is kept once
    rows, _ = torch.sort(row_idx, dim=1, stable=True)
    first = torch.cat(
        [torch.ones((Q, 1), dtype=torch.bool, device=cn.device),
         rows[:, 1:] != rows[:, :-1]], dim=1)
    cand = cn[rows]                                         # (Q, kb*bn, D)
    # a product and a sum over D, not a batched matrix-vector product: a
    # document's score must not depend on how many candidates there are
    # (the optimizer's corpus pruning relies on it, and a batched product
    # on the CPU sums in an order that follows the candidate count)
    s = (cand.to(F32) * qn.to(F32)[:, None, :]).sum(dim=-1)
    s = s.masked_fill(~first, float("-inf"))
    # (score desc, id asc): a stable sort keeps tied candidates in id order
    top_s, at = torch.sort(s, dim=1, descending=True, stable=True)
    top_i = torch.gather(rows, 1, at[:, :k])
    return top_s[:, :k], top_i.to(torch.int32)
