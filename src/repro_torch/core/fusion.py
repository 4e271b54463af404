"""Score-fusion functions for hybrid search (paper Table 1: FUSION).

Implements rrf / combsum / combmnz / combmed / combanz over N retriever
score columns, vectorised with numpy.  Missing scores (a document absent
from one retriever's top-k) are NaN.

These are the fusion methods the ``hybrid_topk`` plan operator
(``engine.retrieval_ops``) dispatches on — the paper's Query 3 step 4
composes them relationally over the per-retriever score columns of a
FULL OUTER JOIN.  Edge-case contract (hardened):

  * a retriever column that is ALL NaN contributes nothing (it behaves
    as an absent retriever, never poisons the fused scores with NaN);
  * a single retriever column is valid input (fusion degenerates to a
    monotone transform of that retriever's ranking);
  * ``rrf`` assigns competition ("1224") ranks, so tied scores share
    the rank of their tie group's first element — fused scores are
    independent of the retrievers' internal tie-break order;
  * ``combmnz`` of a row with zero non-NaN entries is exactly 0.0 (no
    0 * nansum-of-empty-slice degeneracy), and fused outputs never
    contain NaN.

A copy of ``repro/core/fusion.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

import numpy as np

FUSION_METHODS = ("rrf", "combsum", "combmnz", "combmed", "combanz")


def _scores_matrix(score_lists) -> np.ndarray:
    """Stack score columns -> (n_docs, n_retrievers) float with NaN holes."""
    if not score_lists:
        raise ValueError("fusion needs at least one score column")
    cols = [np.asarray(s, dtype=np.float64) for s in score_lists]
    n = {len(c) for c in cols}
    if len(n) != 1:
        raise ValueError("fusion inputs must share length")
    return np.stack(cols, axis=1)


def rrf(*score_lists, k: int = 60) -> np.ndarray:
    """Reciprocal rank fusion: sum_i 1/(k + rank_i).  NaN -> no contribution.

    Ranks are competition ranks ("1224"): documents with equal scores in
    one retriever share that tie group's first rank, so the fused score
    does not depend on the arbitrary order a retriever reports ties in."""
    m = _scores_matrix(score_lists)
    n = m.shape[0]
    out = np.zeros(n)
    if n == 0:
        return out
    for j in range(m.shape[1]):
        col = m[:, j]
        valid = ~np.isnan(col)
        if not valid.any():
            continue                    # all-NaN retriever: absent
        vals = np.where(valid, col, -np.inf)
        order = np.argsort(-vals, kind="stable")
        sv = vals[order]
        # index of each sorted element's tie-group head
        tied = np.zeros(n, dtype=bool)
        tied[1:] = sv[1:] == sv[:-1]
        head = np.maximum.accumulate(
            np.where(tied, 0, np.arange(n)))
        ranks = np.empty(n, dtype=np.int64)
        ranks[order] = head + 1
        out += np.where(valid, 1.0 / (k + ranks), 0.0)
    return out


def combsum(*score_lists) -> np.ndarray:
    m = _scores_matrix(score_lists)
    with np.errstate(all="ignore"):
        return np.nansum(m, axis=1)


def combmnz(*score_lists) -> np.ndarray:
    m = _scores_matrix(score_lists)
    with np.errstate(all="ignore"):
        nz = np.sum(~np.isnan(m) & (m != 0), axis=1)
        total = np.nansum(m, axis=1)
    # a row with zero non-NaN entries has no evidence at all: exactly 0,
    # never 0 * <empty-slice nansum> style degenerate arithmetic
    return np.where(nz > 0, total * nz, 0.0)


def combmed(*score_lists) -> np.ndarray:
    m = _scores_matrix(score_lists)
    med = np.zeros(m.shape[0])
    # nanmedian WARNS on all-NaN rows (errstate does not cover it);
    # compute it only where at least one retriever scored the doc
    some = ~np.all(np.isnan(m), axis=1)
    if some.any():
        med[some] = np.nanmedian(m[some], axis=1)
    return med


def combanz(*score_lists) -> np.ndarray:
    m = _scores_matrix(score_lists)
    with np.errstate(all="ignore"):
        nz = np.maximum(np.sum(~np.isnan(m), axis=1), 1)
        return np.nansum(m, axis=1) / nz


def fusion(method: str, *score_lists, **kw) -> np.ndarray:
    fns = {"rrf": rrf, "combsum": combsum, "combmnz": combmnz,
           "combmed": combmed, "combanz": combanz}
    if method not in fns:
        raise ValueError(f"unknown fusion method {method!r}; "
                         f"choices: {FUSION_METHODS}")
    return fns[method](*score_lists, **kw)


def max_normalize(scores) -> np.ndarray:
    """Per-retriever max normalisation (paper Query 3 step 4)."""
    s = np.asarray(scores, dtype=np.float64)
    with np.errstate(all="ignore"):
        mx = np.nanmax(np.abs(s)) if len(s) else np.nan
    return s / mx if mx and not np.isnan(mx) else s
