"""First-class retrieval plan operators (paper Query 3, Table 1 FUSION).

FlockMTL's pitch is that RAG composes *relationally*: retrieval, score
fusion and LLM reasoning are operators in one plan, so the optimizer can
batch, cache and reorder them.  This module is the executor layer behind
the ``Pipeline`` retrieval nodes:

  * ``vector_topk``  — paper Query 3 step 2: embed the query column,
    scan the corpus embedding index, expand each query row into its
    top-k candidate rows (a LATERAL join).
  * ``bm25_topk``    — Query 3 step 3: the FTS retriever over the same
    corpus; no LLM calls at all.
  * ``hybrid_topk``  — Query 3 steps 2-4: both retrievers at a
    per-retriever candidate depth, fused with ``core.fusion`` (Table 1:
    ``fusion_rrf``/``combsum``/...), final top-k by fused score.

Canonical candidate semantics (what the equivalence suite pins): each
retriever scores the corpus, candidates are the top-``depth`` docs by
``(score desc, doc id asc)``; fusion sees full-length per-retriever
score arrays with NaN at non-candidate positions (exactly the
FULL-OUTER-JOIN idiom of ``examples/hybrid_search.py``), and the final
cut is top-k of the fused array with the same deterministic tie-break.

Corpus predicates (``corpus_filter=``) are part of the operator's
contract — "top-k among corpus docs satisfying the predicate".  The
unoptimized plan embeds the FULL corpus and masks non-matching docs out
of the ranking; the optimizer's ``prune_corpus`` rewrite moves the
predicate below the index build so only matching docs are embedded.
Both produce identical rows: per-doc scores are independent of the rest
of the corpus on the vector side, and BM25 statistics (idf, avgdl) are
ALWAYS computed over the full corpus so its scores cannot depend on the
rewrite.

Corpus embeddings are memoised through ``retrieval.ensure_index`` —
session registry first, then the persistent ``IndexStore`` sidecar —
keyed by (embedding model ref, corpus fingerprint), so plan nodes
sharing a corpus dedupe the embed work and repeated queries skip it
entirely.  When the context allows cross-job co-packing, the corpus and
query embed dispatches run concurrently and their part-filled tail
batches merge into one provider request (``embedding_pack_key``).

A copy of ``repro/engine/retrieval_ops.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.cache import corpus_fingerprint
from repro_torch.core.functions import (SemanticContext, embedding_pack_key,
                                  llm_embedding, llm_rerank)
from repro_torch.core.fusion import fusion
from repro_torch.core.scheduler import SpecTask, SpeculativeJoin
from repro_torch.retrieval import BM25Index, ensure_index

from .table import Table

RETRIEVAL_OPS = ("vector_topk", "bm25_topk", "hybrid_topk")

# k-pushdown defaults: when ``hybrid_topk(candidate_k=None)`` leaves the
# per-retriever depth to the engine, the unoptimized plan fuses FULL
# candidate lists and the optimizer pushes the final k down to
# ``max(CANDIDATE_MIN, CANDIDATE_FACTOR * k)`` per retriever
CANDIDATE_FACTOR = 4
CANDIDATE_MIN = 32


def retrieval_outputs(info: dict) -> List[str]:
    """Columns a retrieval node may produce: the score and rank columns
    plus every corpus column (under both its own name and the ``_doc``
    collision suffix) — the conservative ban set for pushdown."""
    corpus_cols = list(info["corpus"].column_names)
    return ([info["out"], info["out"] + "_rank"]
            + corpus_cols + [c + "_doc" for c in corpus_cols])


def pushed_candidate_k(k: int) -> int:
    """The per-retriever candidate depth the optimizer's k-pushdown rule
    derives from a final fused top-``k``."""
    return max(CANDIDATE_MIN, CANDIDATE_FACTOR * k)


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------
def _corpus_selection(info: dict) -> List[int]:
    """Doc ids satisfying the node's corpus predicate (all ids without
    one) — identical whether or not the optimizer pruned, so the rewrite
    can only change WHERE the predicate is applied, never the result."""
    corpus = info["corpus"]
    pred = info.get("corpus_filter")
    if pred is None:
        return list(range(len(corpus)))
    return [i for i, r in enumerate(corpus.rows()) if pred(r)]


def _ranked(scores: np.ndarray, eligible: Sequence[int],
            depth: int) -> Tuple[List[int], List[float]]:
    """Top-``depth`` of ``eligible`` doc ids by ``(score desc, id asc)``
    — ``eligible`` arrives ascending, so the stable sort IS the
    canonical tie-break."""
    s = np.asarray(scores, np.float64)[list(eligible)]
    order = np.argsort(-s, kind="stable")[:depth]
    return ([int(eligible[j]) for j in order],
            [float(s[j]) for j in order])


def _embed_corpus_and_queries(ctx: SemanticContext, model_spec,
                              corpus_texts: List[str],
                              queries: List[str], fingerprint):
    """Corpus index (via ``ensure_index``) + query vectors.  When the
    corpus is not memoised and the context allows co-packing, the two
    embed dispatches run on concurrent threads under an activated
    embedding pack identity, so the corpus tail batch and the (small)
    query batch merge into one provider request."""
    model = ctx.resolve_model(model_spec)
    if fingerprint is None:
        fingerprint = corpus_fingerprint(corpus_texts)
    cached = ctx.index_cached(model.ref, fingerprint)
    if (cached or not queries or not ctx.copack
            or ctx.scheduler is None or not ctx.enable_batching):
        index, _ = ensure_index(ctx, model_spec, corpus_texts,
                                fingerprint=fingerprint)
        qv = llm_embedding(ctx, model_spec, queries)
        return index, qv

    ident = embedding_pack_key(ctx, model)
    slots: List = [None, None]
    errors: List[BaseException] = []

    def worker(slot: int, thunk):
        try:
            slots[slot] = thunk()
        # re-raised on the caller  # flocklint: ignore[FLKL105]
        except BaseException as exc:
            errors.append(exc)

    # two expected submitters under one embedding identity (corpus +
    # queries): the scheduler flushes the merged pack the moment the
    # second tail arrives instead of waiting out the linger deadline
    ctx.copack_begin({ident: 2})
    try:
        threads = [
            # exactly two bounded submitters under one activated pack
            # identity, joined below  # flocklint: ignore[FLKL106]
            threading.Thread(
                target=worker,
                args=(0, lambda: ensure_index(ctx, model_spec,
                                              corpus_texts,
                                              fingerprint=fingerprint)),
                name="flockjax-embed-corpus"),
            # flocklint: ignore[FLKL106]
            threading.Thread(
                target=worker,
                args=(1, lambda: llm_embedding(ctx, model_spec, queries)),
                name="flockjax-embed-query"),
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        ctx.copack_end({ident: 2})
    if errors:
        raise errors[0]
    return slots[0][0], slots[1]


def _vector_candidates(ctx: SemanticContext, info: dict,
                       queries: List[str], sel: List[int],
                       depth: int) -> List[Tuple[List[int], List[float]]]:
    """Per-query vector candidates at ``depth``: (doc ids, cosine
    scores).  Three modes — no predicate (scan all), pruned (embed and
    scan only matching docs), unpruned predicate (scan all, mask the
    ranking) — produce identical candidates; only the embed volume
    differs."""
    corpus_texts = [str(x) for x in
                    info["corpus"].column(info["doc_col"])]
    n = len(corpus_texts)
    full = len(sel) == n
    pruned = bool(info.get("prune_corpus")) and not full
    texts = ([corpus_texts[i] for i in sel] if pruned else corpus_texts)
    if not texts:
        return [([], []) for _ in queries]
    fp = None if pruned else info.get("corpus_fp")
    index, qv = _embed_corpus_and_queries(ctx, info["model"], texts,
                                          queries, fp)
    # ANN routing: the optimizer's ann_select resolution wins; a forced
    # ann="ivf" is honoured even on an unoptimized plan; "auto" without
    # a resolution stays exact (result-preserving default).  The masked
    # unpruned-predicate branch always scans exactly — its full ranking
    # feeds the mask.
    ann = info.get("ann_resolved") or (
        "ivf" if info.get("ann") == "ivf" else "exact")
    out: List[Tuple[List[int], List[float]]] = []
    if full or pruned:
        if ann == "ivf":
            s, li = index.topk_ann(
                qv, min(depth, len(texts)),
                nprobe=info.get("ann_nprobe", info.get("nprobe")),
                nlist=info.get("ann_nlist", info.get("nlist")),
                recall_target=info.get("recall_target"))
        else:
            s, li = index.topk(qv, min(depth, len(texts)))
        for r in range(len(queries)):
            ids = ([sel[int(j)] for j in li[r]] if pruned
                   else [int(j) for j in li[r]])
            out.append((ids, [float(x) for x in s[r]]))
    else:
        s, li = index.topk(qv, n)          # full ranking, then mask
        selset = set(sel)
        for r in range(len(queries)):
            pairs = [(int(i), float(sc))
                     for i, sc in zip(li[r], s[r]) if int(i) in selset]
            pairs = pairs[:depth]
            out.append(([p[0] for p in pairs], [p[1] for p in pairs]))
    return out


def _bm25_candidates(info: dict, queries: List[str], sel: List[int],
                     depth: int) -> List[Tuple[List[int], List[float]]]:
    """Per-query BM25 candidates at ``depth``.  The index is ALWAYS
    built over the full corpus (idf/avgdl are corpus statistics; a
    pruned build would change scores), memoised on the node info."""
    bm = info.get("_bm25")
    if bm is None:
        bm = info["_bm25"] = BM25Index.build(
            [str(x) for x in info["corpus"].column(info["doc_col"])])
    # all pending queries score in ONE vectorized pass over the
    # postings (bit-identical rows to per-query score(), see bm25.py)
    scores = bm.score_many([str(q) for q in queries])
    return [_ranked(scores[i], sel, depth) for i in range(len(queries))]


def _candidates(ctx: SemanticContext, op: str, info: dict,
                queries: List[str]) -> List[Tuple[List[int], List[float]]]:
    sel = _corpus_selection(info)
    k_eff = min(info["k"], len(sel))
    if op == "bm25_topk":
        return _bm25_candidates(info, queries, sel, k_eff)
    if op == "vector_topk":
        return _vector_candidates(ctx, info, queries, sel, k_eff)

    # hybrid: per-retriever candidate lists at the (possibly pushed-
    # down) depth, fused over full-length NaN-holed score arrays
    n = len(info["corpus"])
    depth = info.get("candidate_k") or len(sel)
    depth = min(depth, len(sel))
    vec = _vector_candidates(ctx, info, queries, sel, depth)
    bm = _bm25_candidates(info, queries, sel, depth)
    out = []
    for (v_ids, v_s), (b_ids, b_s) in zip(vec, bm):
        col_b = np.full(n, np.nan)
        col_b[b_ids] = b_s
        col_v = np.full(n, np.nan)
        col_v[v_ids] = v_s
        fused = fusion(info["fusion"], col_b, col_v)
        out.append(_ranked(fused, sel, k_eff))
    return out


# ---------------------------------------------------------------------------
# node executor
# ---------------------------------------------------------------------------
def make_retrieval_fn(ctx: SemanticContext, op: str, info: dict):
    """Executor closure for one retrieval plan node.  Bound to the
    passed ``info`` dict, so the optimizer can rebuild a node with
    modified info (``prune_corpus``, ``candidate_k``) without mutating
    the shared logical plan."""
    if op not in RETRIEVAL_OPS:
        raise ValueError(f"unknown retrieval op {op!r}")

    def fn(t: Table) -> Table:
        corpus = info["corpus"]
        out_col, rank_col = info["out"], info["out"] + "_rank"
        names: Dict[str, str] = {
            c: (c + "_doc" if c in t.column_names else c)
            for c in corpus.column_names}
        if not len(t):
            cols = {nm: [] for nm in t.column_names}
            for c in corpus.column_names:
                cols[names[c]] = []
            cols[out_col] = []
            cols[rank_col] = []
            return Table(cols)
        queries = [str(v) for v in t.column(info["query_col"])]
        cand = _candidates(ctx, op, info, queries)

        def child(i, row):
            ids, scores = cand[i]
            cols = {names[c]: [corpus.columns[c][d] for d in ids]
                    for c in corpus.column_names}
            cols[out_col] = list(scores)
            cols[rank_col] = list(range(1, len(ids) + 1))
            return Table(cols)

        return t.lateral(child)

    return fn


# ---------------------------------------------------------------------------
# speculative retrieval->rerank executor
# ---------------------------------------------------------------------------
def make_spec_rerank_fn(ctx: SemanticContext, node):
    """Executor for one ``spec_rerank`` plan node: ``hybrid_topk``
    followed by a grouped ``llm_rerank``, with the rerank's window
    cache warmed over BM25-predicted candidates WHILE the dense
    retriever and fusion finish.

    The BM25 side of a hybrid node is provider-free (postings scan), so
    the final per-query top-k can be *predicted* before any embed
    request returns.  Warmup tasks rerank the predicted candidate
    tuples — their permutations are discarded, but every rerank window
    lands in the prediction cache keyed by its serialized tuple
    content.  The mandatory task runs the full retrieval; when it
    resolves, warmups for queries whose predicted list does not match
    the fused top-k (content and order both) are cancelled if not yet
    started, or counted as wasted rows if already dispatched.  The
    authoritative rerank then runs over the REAL expanded table —
    matched groups hit the cache window-for-window, mispredicted ones
    pay the provider exactly as the serial plan would — so the output
    is bit-identical to ``hybrid_topk`` -> ``llm_rerank`` by
    construction."""
    info = node.info
    retr_info = info["_retr"]
    rr = info["_rerank"]
    retr_fn = make_retrieval_fn(ctx, info["retr_op"], retr_info)

    def rerank_table(expanded: Table) -> Table:
        """The serial plan's grouped rerank, verbatim."""
        tuples = [{c: r[c] for c in rr["cols"]} for r in expanded.rows()]
        if rr.get("by") is None:
            perm = llm_rerank(ctx, rr["model"], rr["prompt"], tuples)
            return expanded.take(perm)
        groups: dict = {}
        for i, v in enumerate(expanded.column(rr["by"])):
            groups.setdefault(v, []).append(i)
        order: List[int] = []
        for idxs in groups.values():
            perm = llm_rerank(ctx, rr["model"], rr["prompt"],
                              [tuples[i] for i in idxs])
            order.extend(idxs[p] for p in perm)
        return expanded.take(order)

    def fn(t: Table) -> Table:
        if not len(t):
            return retr_fn(t)
        corpus = retr_info["corpus"]
        names = {c: (c + "_doc" if c in t.column_names else c)
                 for c in corpus.column_names}
        inv = {v: c for c, v in names.items()}
        parents = list(t.rows())
        queries = [str(v) for v in t.column(retr_info["query_col"])]
        sel = _corpus_selection(retr_info)
        k_eff = min(retr_info["k"], len(sel))
        pred = _bm25_candidates(retr_info, queries, sel, k_eff)
        rr_cols = list(rr["cols"])
        by = rr.get("by")

        def value(pi: int, d: int, c: str):
            if c in inv:
                return corpus.columns[inv[c]][d]
            return parents[pi][c]

        # predicted expanded rows (parent order x rank order), grouped
        # exactly as the serial rerank groups the real expansion
        pgroups: dict = {}
        for pi in range(len(parents)):
            for d in pred[pi][0]:
                key = value(pi, d, by) if by is not None else None
                pgroups.setdefault(key, []).append((pi, d))
        pkeys = list(pgroups)
        ptuples = {key: [{c: value(pi, d, c) for c in rr_cols}
                         for pi, d in pgroups[key]] for key in pkeys}

        join = SpeculativeJoin(ctx.scheduler)
        state: dict = {"mismatched": set()}

        def authoritative() -> Table:
            expanded = retr_fn(t)
            tuples = [{c: r[c] for c in rr_cols}
                      for r in expanded.rows()]
            if by is None:
                agroups = {None: list(range(len(tuples)))}
            else:
                agroups = {}
                for i, v in enumerate(expanded.column(by)):
                    agroups.setdefault(v, []).append(i)
            mismatched = set()
            for j, key in enumerate(pkeys):
                actual = ([tuples[i] for i in agroups[key]]
                          if key in agroups else None)
                if actual != ptuples[key]:
                    mismatched.add(key)
                    join.cancel(1 + j)      # warmup windows can't hit
            state["mismatched"] = mismatched
            return expanded

        def make_warmup(key):
            def thunk():
                llm_rerank(ctx, rr["model"], rr["prompt"], ptuples[key])
                return key
            return thunk

        tasks = ([SpecTask(authoritative, rows=len(t), label="retrieve",
                           mandatory=True)]
                 + [SpecTask(make_warmup(key), rows=len(ptuples[key]),
                             label=f"warmup-{j}")
                    for j, key in enumerate(pkeys)])
        results = join.run(tasks)
        expanded = results[0]
        cancelled = set(join.cancelled)
        wasted = sum(len(ptuples[key]) for j, key in enumerate(pkeys)
                     if key in state["mismatched"]
                     and (1 + j) not in cancelled)
        if wasted:
            join.note_wasted(wasted)
        return rerank_table(expanded)

    return fn
