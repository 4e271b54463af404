"""IVF-ANN coarse-quantized vector index (million-document retrieval).

The exact scan in ``vector.py`` prices at ``2*N*D`` FLOPs per query; at
millions of documents that is the plan's dominant non-provider cost.
``IVFIndex`` is the classic inverted-file ANN: a k-means coarse quantizer
partitions the corpus into ``nlist`` cluster lists, and a query scans only
its ``nprobe`` nearest lists — ``~2*(nlist + N*nprobe/nlist)*D`` FLOPs per
query, the estimate the plan optimizer prices against ``scan_flops``.

Contracts the test suite pins:

  * ``nprobe >= nlist`` probes every list and degenerates to the exact
    scan — ``search`` routes through the same ``exact_scan`` scorer, so
    the results are bit-identical by construction.
  * The candidate cut is the canonical retrieval tie-break
    ``(score desc, doc id asc)``, matching ``engine.retrieval_ops``.
  * A query whose probed lists hold fewer than ``k`` docs falls back to
    the exact scan for that query — ``search`` never returns short rows.

Recall is *calibrated per index*: ``build`` samples corpus vectors as
held-out queries, ranks each sample's true top-k neighbours by the
cluster rank the quantizer assigns them, and stores the cumulative
recall-vs-nprobe curve.  ``nprobe_for(recall_target)`` reads the curve;
the optimizer renders ``estimated_recall`` in ``explain()``.  Before an
index exists the optimizer falls back to the planning prior
``planned_recall`` below.

Appends are lazy: ``extended`` assigns new vectors to their nearest
*existing* centroid (no re-training) and defers the inverted-list merge
and recall re-calibration to the next ``search`` — the incremental
``IndexStore`` path adds segments without touching the quantizer.

A copy of ``repro/retrieval/ivf.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# Planning prior for recall(nprobe) before a calibrated curve exists:
# ``1 - (1 - nprobe/nlist) ** SHARPNESS``.  Sharpness 32 encodes the
# empirical IVF behaviour on clustered embedding corpora (recall ~0.95
# near nprobe/nlist ~ 0.09); the per-index calibrated curve replaces it
# as soon as the index is built.
IVF_PLANNING_SHARPNESS = 32
IVF_DEFAULT_TRAIN_ITERS = 8
IVF_CALIB_QUERIES = 32
IVF_CALIB_K = 10

# below this corpus size the optimizer never auto-selects IVF: training
# the quantizer costs more than the exact scan it would save
IVF_MIN_DOCS = 256


def default_nlist(n_docs: int) -> int:
    """sqrt(N) coarse-quantizer size, the standard IVF default."""
    return max(1, min(int(n_docs), int(round(math.sqrt(max(n_docs, 1))))))


def planned_recall(nprobe: int, nlist: int) -> float:
    """Planning-prior recall estimate (no built index yet)."""
    if nlist <= 0:
        return 1.0
    p = min(max(int(nprobe), 1), nlist) / nlist
    if p >= 1.0:
        return 1.0
    return 1.0 - (1.0 - p) ** IVF_PLANNING_SHARPNESS


def planned_nprobe(nlist: int, recall_target: float) -> int:
    """Smallest nprobe whose planning-prior recall meets the target."""
    if recall_target >= 1.0:
        return nlist
    rho = 1.0 - (1.0 - recall_target) ** (1.0 / IVF_PLANNING_SHARPNESS)
    return max(1, min(nlist, int(math.ceil(rho * nlist))))


def ivf_scan_flops(nq: float, n_docs: float, dim: float, nlist: int,
                   nprobe: int) -> float:
    """Priced probe cost: centroid scan + the probed fraction of lists."""
    nlist = max(int(nlist), 1)
    probe = min(max(int(nprobe), 1), nlist)
    return 2.0 * nq * dim * (nlist + n_docs * probe / nlist)


def kmeans(vectors: np.ndarray, nlist: int, *, iters: int = 8,
           seed: int = 0) -> np.ndarray:
    """Deterministic Lloyd's k-means over unit-normalised rows.

    Returns unit-normalised centroids (nlist, D).  Trains on a bounded
    sample (k-means cost must not dwarf the scan it amortises); empty
    clusters keep their previous centroid."""
    x = np.asarray(vectors, np.float32)
    n = len(x)
    nlist = max(1, min(nlist, n))
    rng = np.random.default_rng(seed)
    train_n = min(n, max(10 * nlist, 4096))
    train = x[rng.choice(n, size=train_n, replace=False)] if train_n < n \
        else x
    cent = train[rng.choice(len(train), size=nlist, replace=False)].copy()
    for _ in range(max(int(iters), 1)):
        cn = cent / np.maximum(
            np.linalg.norm(cent, axis=1, keepdims=True), 1e-9)
        assign = np.argmax(train @ cn.T, axis=1)
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, train)
        counts = np.bincount(assign, minlength=nlist).astype(np.float32)
        nonempty = counts > 0
        cent[nonempty] = sums[nonempty] / counts[nonempty, None]
    return cent / np.maximum(np.linalg.norm(cent, axis=1, keepdims=True),
                             1e-9)


def _topk_rows(scores: np.ndarray, ids: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k of one score row by (score desc, id asc)."""
    if k >= len(ids):
        sel = np.lexsort((ids, -scores))
    else:
        part = np.argpartition(-scores, k - 1)[:k]
        sel = part[np.lexsort((ids[part], -scores[part]))]
    sel = sel[:k]
    return scores[sel], ids[sel]


class IVFIndex:
    """Inverted-file ANN over a unit-normalised embedding matrix."""

    def __init__(self, centroids: np.ndarray, vectors: np.ndarray,
                 assign: np.ndarray, *, seed: int = 0):
        self.centroids = np.asarray(centroids, np.float32)
        self.nlist = len(self.centroids)
        self._vectors = np.asarray(vectors, np.float32)
        self._assign = np.asarray(assign, np.int32)
        self._seed = seed
        self._order: Optional[np.ndarray] = None     # doc ids by cluster
        self._offsets: Optional[np.ndarray] = None   # CSR list bounds
        self.recall_curve: Optional[np.ndarray] = None

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, vectors: np.ndarray, nlist: Optional[int] = None, *,
              seed: int = 0,
              train_iters: int = IVF_DEFAULT_TRAIN_ITERS) -> "IVFIndex":
        v = np.asarray(vectors, np.float32)
        nlist = default_nlist(len(v)) if nlist is None else \
            max(1, min(int(nlist), len(v)))
        cent = kmeans(v, nlist, iters=train_iters, seed=seed)
        assign = np.argmax(v @ cent.T, axis=1).astype(np.int32)
        return cls(cent, v, assign, seed=seed)

    def extended(self, vectors_full: np.ndarray, n_new: int) -> "IVFIndex":
        """A new index over ``vectors_full`` (= this index's corpus plus
        ``n_new`` appended rows) sharing this quantizer: new rows join
        their nearest existing list, the CSR merge and recall
        re-calibration stay lazy (next ``search``)."""
        v = np.asarray(vectors_full, np.float32)
        if n_new <= 0:
            return IVFIndex(self.centroids, v, self._assign,
                            seed=self._seed)
        new_assign = np.argmax(v[-n_new:] @ self.centroids.T,
                               axis=1).astype(np.int32)
        return IVFIndex(self.centroids, v,
                        np.concatenate([self._assign, new_assign]),
                        seed=self._seed)

    def _merge(self):
        """Materialise the inverted lists (CSR over cluster-sorted doc
        ids) and the calibrated recall curve; no-op when current."""
        if self._order is not None and len(self._order) == len(
                self._vectors):
            return
        order = np.argsort(self._assign, kind="stable")
        counts = np.bincount(self._assign, minlength=self.nlist)
        self._order = order.astype(np.int64)
        self._offsets = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64)
        self._by_list = self._vectors[order]
        self._calibrate()

    def _calibrate(self):
        """Recall-vs-nprobe curve from held-out sampled corpus vectors:
        for each sample's true top-k neighbour, record the rank the
        quantizer gives the neighbour's cluster; the cumulative
        distribution IS recall(nprobe)."""
        n = len(self._vectors)
        if n == 0 or self.nlist <= 1:
            self.recall_curve = np.ones(max(self.nlist, 1))
            return
        rng = np.random.default_rng(self._seed + 1)
        qids = rng.choice(n, size=min(IVF_CALIB_QUERIES, n), replace=False)
        q = self._vectors[qids]
        k = min(IVF_CALIB_K, n)
        s = q @ self._vectors.T                       # (S, N)
        part = np.argpartition(-s, k - 1, axis=1)[:, :k]
        cq = q @ self.centroids.T                     # (S, nlist)
        cluster_order = np.argsort(-cq, axis=1, kind="stable")
        rank_of = np.empty_like(cluster_order)
        rows = np.arange(len(qids))[:, None]
        rank_of[rows, cluster_order] = np.arange(self.nlist)[None, :]
        neigh_cluster = self._assign[part]            # (S, k)
        neigh_rank = rank_of[rows, neigh_cluster].ravel()
        hits = np.bincount(neigh_rank, minlength=self.nlist)
        self.recall_curve = np.cumsum(hits) / max(len(neigh_rank), 1)

    # ---- recall knobs ----------------------------------------------------
    def nprobe_for(self, recall_target: float) -> int:
        """Smallest nprobe whose calibrated recall meets the target."""
        self._merge()
        meets = np.nonzero(self.recall_curve >= recall_target)[0]
        return int(meets[0]) + 1 if len(meets) else self.nlist

    def estimated_recall(self, nprobe: int) -> float:
        self._merge()
        if not len(self.recall_curve):
            return 1.0
        return float(
            self.recall_curve[min(max(int(nprobe), 1), self.nlist) - 1])

    # ---- search ----------------------------------------------------------
    def exact_scan(self, queries: np.ndarray, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan over all docs in id order — the ``nprobe == nlist``
        degenerate case shares this scorer, making the equality
        bit-identical by construction."""
        qn = np.atleast_2d(np.asarray(queries, np.float32))
        n = len(self._vectors)
        k = min(int(k), n)
        out_s = np.zeros((len(qn), k), np.float32)
        out_i = np.zeros((len(qn), k), np.int64)
        if k == 0:
            return out_s, out_i
        ids = np.arange(n, dtype=np.int64)
        scores = qn @ self._vectors.T                 # (Q, N)
        for r in range(len(qn)):
            out_s[r], out_i[r] = _topk_rows(scores[r], ids, k)
        return out_s, out_i

    def search(self, queries: np.ndarray, k: int, nprobe: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the ``nprobe`` nearest inverted lists per query.
        queries: (Q, D) unit-normalised.  Returns (scores (Q, k),
        doc ids (Q, k))."""
        self._merge()
        qn = np.atleast_2d(np.asarray(queries, np.float32))
        n = len(self._vectors)
        k = min(int(k), n)
        if k == 0:
            return (np.zeros((len(qn), 0), np.float32),
                    np.zeros((len(qn), 0), np.int64))
        nprobe = min(max(int(nprobe), 1), self.nlist)
        if nprobe >= self.nlist:
            return self.exact_scan(qn, k)

        cq = qn @ self.centroids.T                    # (Q, nlist)
        if nprobe < self.nlist:
            part = np.argpartition(-cq, nprobe - 1, axis=1)[:, :nprobe]
        else:
            part = np.tile(np.arange(self.nlist), (len(qn), 1))
        # cluster-major probe: each probed list is scored ONCE for every
        # query probing it (one contiguous matmul per list — the lists
        # are CSR-contiguous, so no gather), instead of per-query loops
        q_of = np.repeat(np.arange(len(qn)), part.shape[1])
        c_of = part.ravel()
        grp = np.argsort(c_of, kind="stable")
        q_of, c_of = q_of[grp], c_of[grp]
        bounds = np.searchsorted(c_of, np.arange(self.nlist + 1))
        per_q_ids: list = [[] for _ in range(len(qn))]
        per_q_s: list = [[] for _ in range(len(qn))]
        for c in range(self.nlist):
            glo, ghi = bounds[c], bounds[c + 1]
            if glo == ghi:
                continue
            lo, hi = self._offsets[c], self._offsets[c + 1]
            if lo == hi:
                continue
            qs = q_of[glo:ghi]
            s = qn[qs] @ self._by_list[lo:hi].T       # (nq_c, list_len)
            ids = self._order[lo:hi]
            for row, qi in enumerate(qs):
                per_q_ids[qi].append(ids)
                per_q_s[qi].append(s[row])
        out_s = np.zeros((len(qn), k), np.float32)
        out_i = np.zeros((len(qn), k), np.int64)
        for qi in range(len(qn)):
            if per_q_ids[qi]:
                ids = np.concatenate(per_q_ids[qi])
                sc = np.concatenate(per_q_s[qi])
            else:
                ids = np.zeros(0, np.int64)
                sc = np.zeros(0, np.float32)
            if len(ids) < k:
                # probed lists too small for k: exact fallback for this
                # query keeps rows rectangular and results exact-capped
                out_s[qi:qi + 1], out_i[qi:qi + 1] = self.exact_scan(
                    qn[qi:qi + 1], k)
                continue
            out_s[qi], out_i[qi] = _topk_rows(sc, ids, k)
        return out_s, out_i
