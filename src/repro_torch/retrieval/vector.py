"""Exact vector similarity search (paper Query 3 step 2 — the VSS scan);
port of ``repro/retrieval/vector.py``.

``cosine_topk`` is the plain PyTorch scan: a blocked product with a
running top-k, the oracle of the block-max kernel.

``VectorIndex`` is the materialised index behind the ``vector_topk`` /
``hybrid_topk`` plan operators (``engine.retrieval_ops``).  Scan routing,
as the reference's:

  * a mesh of more than one device (``mesh=``, or an enclosing ``with
    mesh:``, ``active_mesh()``) — the sharded scan of
    ``retrieval.distributed``: corpus rows shard over the mesh's
    devices, queries replicate, only (Q, shards * k) candidates move to
    the mesh's first device;
  * otherwise — the exact block-max scan of ``kernels.topk_sim`` on the
    index's device (the CUDA kernel on the GPU, its plain version on the
    CPU).

Without ``mesh=`` the normalised corpus is moved to the index's device
once, when the index is built; with ``mesh=`` its shards are placed on
the mesh's devices once instead, and no device holds the whole corpus.
Under an enclosing mesh an index built without one places its shards
from the host copy on first use, once a mesh.  The index keeps the
normalised corpus on the host, as a numpy array, for the numpy IVF
quantizer and the shards, and ``raw``, the vectors before normalisation.

``topk_ann`` routes through a lazily built ``retrieval.ivf.IVFIndex``
(the ``vector_topk(ann=...)`` plan option); ``nprobe >= nlist`` probes
everything and reproduces the exact scan.

Built indexes are memoised per session and in the persistent
``IndexStore`` sidecar via ``ensure_index``, keyed by (embedding model
ref, corpus fingerprint).  A corpus that *extends* a memoised one is an
incremental append: only the delta is embedded (through the same
``plan_batches``/co-pack path as any embed) and stored as a new segment
next to the base instead of re-embedding the whole corpus.

Differences from the reference: an index lives on a ``device`` (None
means the GPU, and raises without one) or, with ``mesh=``, on the mesh's
devices (``device`` is then not read): ``VectorIndex.build`` and
``ensure_index`` place it on the context's ``SemanticContext.device``,
and ``extended`` where the base index lives.  Without a mesh ``topk``
runs the exact block-max route, never the plain scan; on either route
ties come in (score desc, id asc) order.  ``len(index)`` counts its rows
(``index.vectors`` is None under ``mesh=``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.topk_sim.ops import topk_sim
from repro_torch.launch.mesh import current_mesh

from .distributed import make_sharded_topk, shard_corpus
from .ivf import IVFIndex

F32 = torch.float32
DEFAULT_RECALL_TARGET = 0.95


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


def active_mesh():
    """The mesh of the innermost enclosing ``with mesh:`` of this thread,
    or None.

    A single-device mesh is reported as None — sharding the corpus over
    one device only adds dispatch overhead."""
    mesh = current_mesh()
    if mesh is None or mesh.empty or mesh.size <= 1:
        return None
    return mesh


class VectorIndex:
    """Materialised embedding index over a column of texts.

    ``topk`` is the exact scan (mesh-sharded, or the block-max scan on
    ``device``, None meaning the GPU and raising without one; see the
    module docstring); ``topk_ann`` the IVF approximate scan on the host.
    ``raw`` keeps the pre-normalisation vectors so segment appends
    (``extended``) rebuild bit-identically to a from-scratch index over
    the full corpus."""

    def __init__(self, vectors: np.ndarray, device=None, mesh=None):
        v = np.asarray(vectors, np.float32)
        if v.ndim == 1:
            v = v.reshape(0, 0) if v.size == 0 else v.reshape(1, -1)
        self.raw = v
        norms = np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        self.host_vectors = v / norms
        self.mesh = mesh
        self._shards = {}            # id(mesh) -> (mesh, placed shards)
        if mesh is None:
            self.device = resolve_device(device)
            self.vectors = torch.from_numpy(self.host_vectors).to(
                self.device)
        else:
            self.device = mesh.devices.flat[0]
            self.vectors = None
            self._placed(mesh)
        self._ivf: Optional[IVFIndex] = None

    def __len__(self) -> int:
        return self.host_vectors.shape[0]

    @classmethod
    def build(cls, ctx, model_spec, texts: Sequence[str],
              mesh=None) -> "VectorIndex":
        from repro_torch.core.functions import llm_embedding
        return cls(llm_embedding(ctx, model_spec, list(texts)),
                   device=ctx.device, mesh=mesh)

    def _placed(self, mesh) -> list:
        """The corpus shards on ``mesh``'s devices, placed from the host
        copy on first use."""
        hit = self._shards.get(id(mesh))
        if hit is None or hit[0] is not mesh:
            hit = self._shards[id(mesh)] = (
                mesh, shard_corpus(mesh, self.host_vectors))
        return hit[1]

    def topk(self, query_vecs: np.ndarray, k: int = 100):
        """Exact cosine top-k: (scores (Q, k) f32, ids (Q, k) int32) as
        numpy arrays, ``k`` capped at the corpus size."""
        q = np.atleast_2d(np.asarray(query_vecs, np.float32))
        use_k = min(k, len(self))
        if use_k <= 0 or q.shape[-1] == 0:
            return (np.zeros((len(q), 0), np.float32),
                    np.zeros((len(q), 0), np.int32))
        mesh = self.mesh if self.mesh is not None else active_mesh()
        if mesh is not None:
            s, i = make_sharded_topk(mesh, use_k)(self._placed(mesh),
                                                  torch.from_numpy(q))
        else:
            s, i = topk_sim(self.vectors,
                            torch.from_numpy(q).to(self.device), use_k)
        return s.cpu().numpy(), i.cpu().numpy()

    # ---- ANN -------------------------------------------------------------
    def ivf(self, nlist: Optional[int] = None) -> IVFIndex:
        """The lazily built (and memoised) IVF index over this corpus.
        An explicit ``nlist`` differing from the memoised quantizer
        rebuilds it."""
        if self._ivf is None or (
                nlist is not None and self._ivf.nlist != min(
                    max(int(nlist), 1), len(self))):
            self._ivf = IVFIndex.build(self.host_vectors, nlist)
        return self._ivf

    def topk_ann(self, query_vecs: np.ndarray, k: int = 100, *,
                 nprobe: Optional[int] = None,
                 nlist: Optional[int] = None,
                 recall_target: Optional[float] = None):
        """IVF approximate top-k.  ``nprobe`` wins over ``recall_target``
        (which picks the smallest calibrated nprobe meeting the target);
        ``nprobe >= nlist`` reproduces the exact scan."""
        q = np.atleast_2d(np.asarray(query_vecs, np.float32))
        use_k = min(k, len(self))
        if use_k <= 0 or q.shape[-1] == 0:
            return (np.zeros((len(q), 0), np.float32),
                    np.zeros((len(q), 0), np.int64))
        qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
        ivf = self.ivf(nlist)
        if nprobe is None:
            nprobe = ivf.nprobe_for(recall_target
                                    if recall_target is not None
                                    else DEFAULT_RECALL_TARGET)
        return ivf.search(qn, use_k, nprobe)

    # ---- incremental appends ---------------------------------------------
    def extended(self, delta_vectors: np.ndarray) -> "VectorIndex":
        """A NEW index over this corpus plus ``delta_vectors`` (raw,
        un-normalised — same as ``llm_embedding`` output), where this
        index lives (its device, or its mesh).  The base index is untouched (it stays registered
        under its own fingerprint); a built IVF quantizer carries over
        with the new rows assigned to existing lists (merged lazily)."""
        delta = np.asarray(delta_vectors, np.float32)
        if delta.ndim == 1 and delta.size:
            delta = delta.reshape(1, -1)
        if not delta.size:
            return self
        idx = VectorIndex(np.concatenate([self.raw, delta]),
                          device=self.device, mesh=self.mesh)
        if self._ivf is not None:
            idx._ivf = self._ivf.extended(idx.host_vectors, len(delta))
        return idx


def _find_prefix_base(ctx, store, model_ref: str, texts):
    """An existing index over a strict prefix of ``texts``: returns
    ``(n_base, base_fp, base_index_or_None, base_vectors_or_None)`` for
    the LONGEST matching prefix, or None.  Candidates come from the
    session registry and the ``IndexStore``; a candidate of length n
    matches iff ``corpus_fingerprint(texts[:n])`` equals its key."""
    from repro_torch.core.cache import corpus_fingerprint

    lengths = {}                       # n -> [fp, ...] candidates
    for fp, n in getattr(ctx, "index_entries", lambda _ref: [])(model_ref):
        if 0 < n < len(texts):
            lengths.setdefault(n, []).append(fp)
    if store is not None:
        for fp, n in store.entries(model_ref):
            if 0 < n < len(texts):
                lengths.setdefault(n, []).append(fp)
    for n in sorted(lengths, reverse=True):
        fp_n = corpus_fingerprint(texts[:n])
        if fp_n not in lengths[n]:
            continue
        index = ctx.lookup_index((model_ref, fp_n))
        if index is not None and len(index) == n:
            return n, fp_n, index, None
        if store is not None:
            vectors = store.get(model_ref, fp_n)
            if vectors is not None and len(vectors) == n:
                return n, fp_n, None, vectors
    return None


def ensure_index(ctx, model_spec, texts: Sequence[str],
                 fingerprint: Optional[str] = None):
    """Build-or-fetch the vector index for (embedding model, corpus).

    Lookup order: the context's session registry, then the persistent
    ``IndexStore`` sidecar, then — new in the segment era — a memoised
    index over a strict PREFIX of this corpus, in which case only the
    delta texts are embedded (the same ``plan_batches``/co-pack path as
    a full build) and persisted as an appended segment.  Returns
    ``(index, source)`` with source one of ``"session"`` / ``"store"`` /
    ``"appended"`` / ``"built"``.  A new index lives on ``ctx.device``."""
    from repro_torch.core.cache import corpus_fingerprint
    from repro_torch.core.functions import llm_embedding

    texts = list(texts)
    model = ctx.resolve_model(model_spec)
    if fingerprint is None:
        fingerprint = corpus_fingerprint(texts)
    key = (model.ref, fingerprint)
    index = ctx.lookup_index(key)
    if index is not None:
        return index, "session"
    store = getattr(ctx, "index_store", None)
    if store is not None:
        vectors = store.get(model.ref, fingerprint)
        if vectors is not None and len(vectors) == len(texts):
            index = VectorIndex(vectors, device=ctx.device)
            ctx.store_index(key, index)
            return index, "store"

    base = _find_prefix_base(ctx, store, model.ref, texts)
    if base is not None:
        n_base, base_fp, base_index, base_vectors = base
        delta = llm_embedding(ctx, model_spec, texts[n_base:])
        if base_index is None:
            base_index = VectorIndex(base_vectors, device=ctx.device)
        index = base_index.extended(delta)
        ctx.store_index(key, index)
        if store is not None:
            if store.has(model.ref, base_fp):
                store.append_segment(model.ref, base_fp, fingerprint,
                                     delta)
            else:
                store.put(model.ref, fingerprint, index.raw)
        return index, "appended"

    vectors = llm_embedding(ctx, model_spec, texts)
    index = VectorIndex(vectors, device=ctx.device)
    ctx.store_index(key, index)
    if store is not None:
        store.put(model.ref, fingerprint, vectors)
    return index, "built"
