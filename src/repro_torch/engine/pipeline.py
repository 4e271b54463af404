"""Lazy CTE-style pipeline over Tables with semantic operators + explain().

Mirrors how FlockMTL queries chain CTEs (paper Query 2/3): each chained
call appends a plan node; ``collect()`` executes; ``explain()`` shows the
plan with the optimizer's execution reports (batch sizes, cache hits,
dedup factor, meta-prompt prefix) — the paper's plan-inspection interface
(Fig. 2b) as a library call.

**Plan optimization** (``optimizer.py``): by default ``collect()`` first
rewrites the chained node list with three cost-based rules —

  * *pushdown*: cheap relational ops (``filter``/``limit``/``select``/
    key-independent ``order_by``) bubble below semantic ops they commute
    with, so LLM calls see fewer tuples (a ``limit(10)`` chained after an
    ``llm_complete`` over 10k rows runs first, making the LLM pass 1000x
    cheaper);
  * *semantic fusion*: adjacent ``llm_filter``/``llm_complete``/
    ``llm_complete_json`` nodes sharing one model + input-column set merge
    into a single multi-output metaprompt pass (one request stream instead
    of N);
  * *cost-ordered filter chains*: consecutive ``llm_filter`` nodes run
    cheapest-and-most-selective first, ranked by estimated token cost x
    the pass rates recorded in ``SemanticContext.selectivity_stats``.

``collect(optimize=False)`` is the escape hatch that executes nodes
exactly as chained; ``explain()`` prints the logical and rewritten plans
side by side with estimated request/token counts, the critical-path
``waves`` latency estimate, and the fired rewrites.

**Concurrent dispatch** (``core/scheduler.py``): when the context holds
a ``RequestScheduler``, ``collect()`` additionally dispatches runs of
independent row-preserving map nodes concurrently (and every node's
batches overlap on the scheduler's worker pool), so wall-clock tracks
the model's ``max_concurrency`` instead of the batch count.  Dispatch
never changes which tuples a node sees — results and request/token
counts are identical to the serial path.

**Cross-node batch co-packing** (``SemanticContext(copack=...)``,
default on): map nodes of one concurrent dispatch group that share a
metaprompt-prefix identity (model + function kind + serialization +
prompt text — ``copack_identity``) register with the scheduler's
packing queue, and their part-filled TAIL batches merge into shared
provider requests before admission.  Per-row results are independent of
batch composition, so collected tables are bit-identical; only request
density changes (fewer, fuller batches — the TPU step stays dense when
concurrency is highest).  ``copack=False`` is the escape hatch.

**Speculative pipelining** (``collect(speculate=...)`` or the
context's ``speculate`` knob): serial plans stall wherever a node
waits on an upstream LLM round-trip.  The optimizer speculates across
three such edges.  *Filter chains*: a chain of k ``llm_filter`` nodes
normally costs k sequential round-trips; speculation fans a chosen
*prefix* of members out over the chain's input concurrently and ANDs
the masks, keeping the expensive tail serial on survivors (the split
minimizing estimated wall time under the waste cap).  *Map past
filter*: a map (``llm_complete``/``llm_complete_json``) downstream of
a filter dispatches completions for the filter's *input* rows while
the mask is still in flight — chunks whose rows all die are cancelled,
and results for masked-out rows are discarded (their cache entries
survive).  *Retrieval-aware rerank*: ``llm_rerank`` downstream of
``hybrid_topk`` starts reranking the first retriever's candidate set
while fusion finishes, warming the prediction cache; the final top-k
is reconciled against the authoritative retrieval.  Every decision is
driven by the calibrated cost model (observed latency percentiles,
retry rates and batch sizes from the ``CalibrationStore`` sidecar);
the expected waste — predicted from recorded selectivity — is capped
by ``ctx.speculate_waste_cap`` (widened 1.25x under
``objective="latency"``, narrowed 0.8x under ``"cost"``) and reported
per edge in ``explain()``'s "Speculation:" section.  Surviving streams
are bit-identical to the serial plan in all three shapes.

**First-class retrieval operators** (``retrieval_ops.py``): paper
Query 3 is a plan, not a script — ``vector_topk`` / ``bm25_topk`` /
``hybrid_topk`` expand each query row into its top-k candidate rows (a
LATERAL join over the corpus), ``hybrid_topk`` fuses both retrievers
with the paper's FUSION table methods (rrf/combsum/...), and
``llm_rerank(by=...)`` reranks each query's candidate list through the
existing map path.  Because retrieval is IN the plan, the optimizer
prunes filtered corpora before embedding, pushes query-side filters
below the expansion, pushes k into per-retriever candidate depth,
dedupes shared corpus embeddings (session registry + the persistent
``IndexStore`` sidecar), and ``explain()`` prices the embed requests,
their co-packed estimate, and the index-scan cost.

Relational ``filter`` predicates are opaque closures; pass
``filter(pred, cols=[...])`` to declare the columns the predicate reads
and unlock pushdown past column-producing semantic ops.

``ask()`` is the ASK functionality: NL -> pipeline.  Faithful NL->SQL needs
an instruction-tuned checkpoint; with research (random-weight) models it is
a deterministic template planner — DEMO-ONLY, as recorded in DESIGN.md §8.

A copy of ``repro/engine/pipeline.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import functions as F
from repro_torch.core.functions import SemanticContext
from repro_torch.core.metaprompt import build_multi_task

from .table import Table

# row-preserving semantic map ops: safe to dispatch concurrently when no
# def-use dependency links them (each sees the group's input table either
# way, so results AND request/token counts match the serial execution)
_PARALLEL_MAP_OPS = ("llm_complete", "llm_complete_json", "llm_embedding")

# plan ops whose dispatches can co-pack: their metaprompt prefix is fully
# determined by (model, function kind, serialization, prompt text), so
# two nodes agreeing on that tuple produce byte-identical static prefixes
# and their rows can share one provider request.  Embedding dispatches
# have no prompt at all, so they co-pack on the model alone; fused
# multi-output nodes co-pack on the full rendered multi-task prompt
# (sub-task kinds AND texts, in order), so only structurally identical
# fusions merge and the positional demux stays exact per sub-output.
_COPACK_KINDS = {"llm_complete": "complete",
                 "llm_complete_json": "complete_json",
                 "llm_embedding": "embedding",
                 "llm_fused": "multi"}


def copack_identity(ctx: SemanticContext, node: "PlanNode"):
    """Metaprompt-prefix identity of a map node, or ``None`` when the
    node cannot co-pack.  Must mirror the ``pack_key`` computed by
    ``functions._map_core`` (``functions.llm_multi`` renders the same
    multi-task prompt for fused nodes, and
    ``functions.embedding_pack_key`` covers embedding dispatches) — the
    scheduler's packing queue merges tail batches exactly when these
    tuples compare equal."""
    kind = _COPACK_KINDS.get(node.op)
    if kind is None:
        return None
    try:
        model = ctx.resolve_model(node.info["model"])
        if kind == "embedding":
            return F.embedding_pack_key(ctx, model)
        if kind == "multi":
            text = build_multi_task(
                node.info["kinds"],
                [ctx.resolve_prompt(p)[0] for p in node.info["prompts"]])
        else:
            text, _ = ctx.resolve_prompt(node.info["prompt"])
    except KeyError:
        return None
    # the FULL resolved resource, not just name@version: inline specs
    # all land on version 0, and a merged request executes under one
    # job's model object — jobs whose caps (max_output_tokens,
    # context_window) differ must never merge
    return (id(ctx.provider), model, kind, ctx.serialization, text)


@dataclass
class PlanNode:
    op: str
    info: dict = field(default_factory=dict)
    fn: Optional[Callable] = None
    report_slot: Optional[int] = None


class Pipeline:
    def __init__(self, ctx: SemanticContext, source: Table,
                 name: str = "scan"):
        self.ctx = ctx
        self.source = source
        self.nodes: List[PlanNode] = [PlanNode("scan", {"rows": len(source),
                                                        "name": name})]

    def _add(self, op: str, fn, **info) -> "Pipeline":
        p = Pipeline.__new__(Pipeline)
        p.ctx, p.source = self.ctx, self.source
        p.nodes = self.nodes + [PlanNode(op, info, fn)]
        return p

    # ---- relational --------------------------------------------------------
    def select(self, *names):
        return self._add("select", lambda t: t.select(*names), cols=names)

    def filter(self, pred, cols: Optional[Sequence[str]] = None):
        """``cols`` declares which columns ``pred`` reads — optional, but
        required for the optimizer to push the filter past
        column-producing semantic ops."""
        info = {} if cols is None else {"cols": list(cols)}
        return self._add("filter", lambda t: t.filter(pred), **info)

    def order_by(self, key, desc=False):
        return self._add("order_by", lambda t: t.order_by(key, desc),
                         key=str(key), desc=desc,
                         key_is_callable=callable(key))

    def limit(self, n):
        return self._add("limit", lambda t: t.limit(n), n=n)

    def with_column(self, name, fn):
        return self._add(
            "project", lambda t: t.with_column(name, [fn(r)
                                                      for r in t.rows()]),
            out=name)

    # ---- semantic scalar ops -------------------------------------------------
    def llm_filter(self, model, prompt, cols: Sequence[str]):
        def fn(t: Table) -> Table:
            tuples = [{c: r[c] for c in cols} for r in t.rows()]
            mask = F.llm_filter(self.ctx, model, prompt, tuples)
            return t.filter_mask(mask)
        return self._add("llm_filter", fn, model=model, prompt=prompt,
                         cols=cols)

    def llm_complete(self, out: str, model, prompt, cols: Sequence[str]):
        def fn(t: Table) -> Table:
            tuples = [{c: r[c] for c in cols} for r in t.rows()]
            vals = F.llm_complete(self.ctx, model, prompt, tuples)
            return t.with_column(out, vals)
        return self._add("llm_complete", fn, model=model, prompt=prompt,
                         cols=cols, out=out)

    def llm_complete_json(self, out: str, model, prompt,
                          cols: Sequence[str]):
        def fn(t: Table) -> Table:
            tuples = [{c: r[c] for c in cols} for r in t.rows()]
            vals = F.llm_complete_json(self.ctx, model, prompt, tuples)
            return t.with_column(out, vals)
        return self._add("llm_complete_json", fn, model=model,
                         prompt=prompt, cols=cols, out=out)

    def llm_embedding(self, out: str, model, cols: Sequence[str]):
        def fn(t: Table) -> Table:
            tuples = [{c: r[c] for c in cols} for r in t.rows()]
            vecs = F.llm_embedding(self.ctx, model, tuples)
            return t.with_column(out, list(vecs))
        return self._add("llm_embedding", fn, model=model, cols=cols,
                         out=out)

    # ---- retrieval operators -------------------------------------------------
    def _add_retrieval(self, op: str, info: dict) -> "Pipeline":
        from .retrieval_ops import make_retrieval_fn, retrieval_outputs
        from repro_torch.core.cache import corpus_fingerprint
        info["corpus_rows"] = len(info["corpus"])
        info["corpus_fp"] = corpus_fingerprint(
            [str(x) for x in info["corpus"].column(info["doc_col"])])
        info["outs"] = retrieval_outputs(info)
        return self._add(op, make_retrieval_fn(self.ctx, op, info), **info)

    @staticmethod
    def _ann_info(ann, recall_target, nprobe, nlist) -> dict:
        """Validated ``ann=`` plan options; {} when ANN is off (keys are
        only present when requested, so plans without the option render
        and estimate exactly as before)."""
        if ann is None:
            if any(v is not None for v in (recall_target, nprobe, nlist)):
                raise ValueError(
                    "recall_target/nprobe/nlist require ann= "
                    "('auto', 'ivf' or 'exact')")
            return {}
        if ann not in ("auto", "ivf", "exact"):
            raise ValueError(f"ann={ann!r}: expected 'auto', 'ivf', "
                             f"'exact' or None")
        out: dict = {"ann": ann}
        if recall_target is not None:
            if not 0.0 < float(recall_target) <= 1.0:
                raise ValueError("recall_target must be in (0, 1]")
            out["recall_target"] = float(recall_target)
        for name, v in (("nprobe", nprobe), ("nlist", nlist)):
            if v is not None:
                if int(v) < 1:
                    raise ValueError(f"{name} must be >= 1")
                out[name] = int(v)
        return out

    def vector_topk(self, out: str, model, query_col: str, corpus: Table,
                    k: int, doc_col: str = "text", corpus_filter=None,
                    corpus_filter_cols: Optional[Sequence[str]] = None,
                    ann: Optional[str] = None,
                    recall_target: Optional[float] = None,
                    nprobe: Optional[int] = None,
                    nlist: Optional[int] = None):
        """Paper Query 3 step 2 as a plan node: embed ``query_col``,
        scan the corpus embedding index, expand each query row into its
        top-``k`` candidate rows (corpus columns + cosine score ``out``
        + ``out_rank``).  ``corpus_filter`` restricts retrieval to
        matching corpus docs; the optimizer's ``prune_corpus`` rewrite
        then embeds only those (identical rows, fewer embed requests).

        ``ann`` opts the scan into IVF approximate search: ``"ivf"``
        forces it, ``"auto"`` lets the optimizer price the probed-list
        FLOPs against the exact scan and pick per node (choice and
        estimated recall render in ``explain()``), ``"exact"`` pins the
        exact scan while still rendering both frontiers.
        ``recall_target`` (default 0.95) sizes ``nprobe`` when it is not
        given explicitly; ``nlist`` overrides the ~sqrt(N) quantizer."""
        return self._add_retrieval("vector_topk", dict(
            out=out, model=model, query_col=query_col, corpus=corpus,
            k=k, doc_col=doc_col, corpus_filter=corpus_filter,
            corpus_filter_cols=(None if corpus_filter_cols is None
                                else list(corpus_filter_cols)),
            cols=[query_col],
            **self._ann_info(ann, recall_target, nprobe, nlist)))

    def bm25_topk(self, out: str, query_col: str, corpus: Table, k: int,
                  doc_col: str = "text", corpus_filter=None,
                  corpus_filter_cols: Optional[Sequence[str]] = None):
        """Paper Query 3 step 3 as a plan node: the BM25 FTS retriever —
        no LLM calls.  Index statistics always come from the full
        corpus, so results are independent of optimizer rewrites."""
        return self._add_retrieval("bm25_topk", dict(
            out=out, query_col=query_col, corpus=corpus, k=k,
            doc_col=doc_col, corpus_filter=corpus_filter,
            corpus_filter_cols=(None if corpus_filter_cols is None
                                else list(corpus_filter_cols)),
            cols=[query_col]))

    def hybrid_topk(self, out: str, model, query_col: str, corpus: Table,
                    k: int, fusion: str = "rrf", doc_col: str = "text",
                    candidate_k: Optional[int] = None, corpus_filter=None,
                    corpus_filter_cols: Optional[Sequence[str]] = None,
                    ann: Optional[str] = None,
                    recall_target: Optional[float] = None,
                    nprobe: Optional[int] = None,
                    nlist: Optional[int] = None):
        """Paper Query 3 steps 2-4 as one plan node: vector + BM25
        retrievers at per-retriever depth ``candidate_k``, fused with
        ``core.fusion`` (Table 1: rrf/combsum/...), final top-``k`` by
        fused score.  ``candidate_k=None`` lets the engine choose the
        depth: full candidate lists unoptimized, ``k`` pushed down to
        ``max(32, 4k)`` per retriever by the optimizer.  The ``ann``
        options (see ``vector_topk``) apply to the vector retriever;
        BM25 always scans its postings exactly."""
        return self._add_retrieval("hybrid_topk", dict(
            out=out, model=model, query_col=query_col, corpus=corpus,
            k=k, fusion=fusion, doc_col=doc_col, candidate_k=candidate_k,
            corpus_filter=corpus_filter,
            corpus_filter_cols=(None if corpus_filter_cols is None
                                else list(corpus_filter_cols)),
            cols=[query_col],
            **self._ann_info(ann, recall_target, nprobe, nlist)))

    # ---- semantic aggregates ---------------------------------------------------
    def llm_rerank(self, model, prompt, cols: Sequence[str],
                   by: Optional[str] = None):
        """Listwise LLM rerank.  Without ``by`` the whole table is one
        candidate list; with ``by`` rows rerank WITHIN each group of
        equal ``by`` values (paper Query 3 step 5 over a retrieval
        operator's expansion: one candidate list per query row), groups
        keeping their first-seen order."""
        def fn(t: Table) -> Table:
            tuples = [{c: r[c] for c in cols} for r in t.rows()]
            if by is None:
                perm = F.llm_rerank(self.ctx, model, prompt, tuples)
                return t.take(perm)
            groups: dict = {}
            for i, v in enumerate(t.column(by)):
                groups.setdefault(v, []).append(i)
            order: List[int] = []
            for idxs in groups.values():
                perm = F.llm_rerank(self.ctx, model, prompt,
                                    [tuples[i] for i in idxs])
                order.extend(idxs[p] for p in perm)
            return t.take(order)
        info = {"model": model, "prompt": prompt, "cols": cols}
        if by is not None:
            info["by"] = by
        return self._add("llm_rerank", fn, **info)

    # ---- static analysis ---------------------------------------------------
    def check(self, strict: bool = True):
        """Pre-flight static analysis of the plan *as written* — schema
        inference, catalog resolution of MODEL/PROMPT refs, prompt
        placeholder binding, and parameter validation — with **zero
        provider requests** (paper §2.1: resources are schema objects,
        so references are statically resolvable).

        Returns the list of ``analysis.Diagnostic`` findings.  With
        ``strict=True`` (default) any error-severity diagnostic raises
        ``analysis.PlanValidationError`` instead, carrying the full
        list on ``.diagnostics``."""
        from .analysis import analyze_plan
        res = analyze_plan(self.ctx, self.source, self.nodes)
        self._last_diagnostics = res.diagnostics
        if strict:
            res.raise_on_error()
        return res.diagnostics

    def _verify_preflight(self, verify: str):
        from .analysis import PlanValidationError, analyze_plan
        res = analyze_plan(self.ctx, self.source, self.nodes)
        self._last_diagnostics = list(res.diagnostics)
        if res.errors and verify == "strict":
            raise PlanValidationError(res.diagnostics)
        if verify == "warn":
            import warnings
            for d in res.diagnostics:
                warnings.warn(str(d), stacklevel=3)

    def _verify_rewrites(self, verify: str, opt):
        from .analysis import PlanValidationError, verify_rewrites
        diags = verify_rewrites(self.ctx, self.source, self.nodes, opt)
        self._last_diagnostics = (
            getattr(self, "_last_diagnostics", []) + diags)
        if diags and verify == "strict":
            raise PlanValidationError(diags)
        if verify == "warn":
            import warnings
            for d in diags:
                warnings.warn(str(d), stacklevel=3)

    # ---- execution -----------------------------------------------------------
    def _plan(self, speculate=None, objective=None):
        """Run (and memoise, per ``(speculate, objective)`` mode) the
        cost-based rewrite for the current nodes."""
        from .optimizer import optimize_plan
        if speculate is None:
            speculate = self.ctx.speculate
        if objective is None:
            objective = self.ctx.objective
        # True and "auto" produce identical plans — share one memo slot
        key = ("always" if speculate == "always"
               else "auto" if speculate else False, objective)
        plans = getattr(self, "_opt", None)
        if plans is None:
            plans = self._opt = {}
        if key not in plans:
            plans[key] = optimize_plan(self.ctx, self.source, self.nodes,
                                       speculate=speculate,
                                       objective=objective)
        return plans[key]

    # ---- concurrent node dispatch -----------------------------------------
    @staticmethod
    def _node_outs(node: PlanNode) -> List[str]:
        if node.info.get("out"):
            return [node.info["out"]]
        return list(node.info.get("outs", ()))

    @staticmethod
    def _dispatch_groups(nodes: List[PlanNode]) -> List[List[PlanNode]]:
        """Partition the plan into maximal runs of independent,
        row-preserving semantic map nodes (fused siblings included when
        they carry no filter sub-task).  Each multi-node group executes
        concurrently; everything else stays node-at-a-time."""
        def parallel_ok(node: PlanNode) -> bool:
            if node.op in _PARALLEL_MAP_OPS:
                return True
            return (node.op == "llm_fused"
                    and "filter" not in node.info.get("kinds", ()))

        groups: List[List[PlanNode]] = []
        i = 0
        while i < len(nodes):
            node = nodes[i]
            if not parallel_ok(node):
                groups.append([node])
                i += 1
                continue
            group = [node]
            produced = set(Pipeline._node_outs(node))
            j = i + 1
            while j < len(nodes):
                nxt = nodes[j]
                if not parallel_ok(nxt):
                    break
                if set(nxt.info.get("cols", ())) & produced:
                    break          # def-use dependency: must stay serial
                group.append(nxt)
                produced |= set(Pipeline._node_outs(nxt))
                j += 1
            groups.append(group)
            i = j
        return groups

    def _copack_group_ids(self, group: List[PlanNode]) -> Dict:
        """Prefix identities shared by >= 2 nodes of one dispatch
        group, mapped to how many member nodes will dispatch under each
        — the co-packable set AND rider-expectation counts this group
        activates on the context while it runs (a lone node never pays
        the packing-queue linger, and a pack whose last expected rider
        has arrived flushes immediately)."""
        counts: Dict = {}
        for node in group:
            ident = copack_identity(self.ctx, node)
            if ident is not None:
                counts[ident] = counts.get(ident, 0) + 1
        return {i: n for i, n in counts.items() if n >= 2}

    def _run_group(self, t_in: Table, group: List[PlanNode]) -> Table:
        """Execute a group of independent map nodes concurrently over one
        input table, then merge their output columns in plan order.
        Nodes sharing a metaprompt-prefix identity are registered as
        co-packable for the duration, so their part-filled tail batches
        can merge into shared provider requests."""
        results: List = [None] * len(group)
        errors: List[BaseException] = []

        def worker(k: int, node: PlanNode):
            try:
                tbl = node.fn(t_in)
                results[k] = (tbl, self.ctx.last_report_slot())
            # re-raised on the caller  # flocklint: ignore[FLKL105]
            except BaseException as exc:
                errors.append(exc)

        shared = (self._copack_group_ids(group)
                  if self.ctx.copack and self.ctx.scheduler is not None
                  else [])
        if shared:
            self.ctx.copack_begin(shared)
        try:
            # node-group fan-out, joined below; batches themselves ride
            # the scheduler pool  # flocklint: ignore[FLKL106]
            threads = [threading.Thread(target=worker, args=(k, n),
                                        name=f"flockjax-node-{n.op}")
                       for k, n in enumerate(group)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        finally:
            if shared:
                self.ctx.copack_end(shared)
        if errors:
            raise errors[0]

        acc = t_in
        for node, (tbl, slot) in zip(group, results):
            for out in self._node_outs(node):
                acc = acc.with_column(out, tbl.column(out))
            if slot is not None:
                node.report_slot = slot
            node.info["rows_out"] = len(acc)
        return acc

    def collect(self, optimize: bool = True,
                parallel: Optional[bool] = None,
                speculate=None, objective: Optional[str] = None,
                verify: str = "off") -> Table:
        """Execute the plan.  ``optimize=False`` is the escape hatch that
        runs the nodes exactly as chained (no pushdown/fusion/reorder —
        and no speculation, which is an optimizer rewrite).

        ``parallel`` controls concurrent dispatch of independent plan
        nodes (fused siblings, adjacent map ops with no def-use edge):
        default on when the context has a ``RequestScheduler``, off
        otherwise.  Dispatch never changes which tuples a node sees, so
        results and request/token counts are identical either way.

        ``speculate`` opts ``llm_filter`` chains into concurrent
        mask-join dispatch (``False`` off, ``True``/``"auto"``
        cost-gated per chain, ``"always"`` forced); defaults to the
        context's ``speculate`` knob.  Speculation preserves the
        surviving tuple stream bit-for-bit but may issue extra requests
        over tuples a serial chain would have eliminated — the expected
        waste, predicted from recorded selectivity, is reported by
        ``explain()`` and bounded by ``ctx.speculate_waste_cap``.

        ``objective`` overrides the context's scheduling objective for
        this execution: ``"latency"`` bounds the co-pack linger by the
        calibrated expected-arrival window and ranks plan rewrites by
        estimated wall-clock, ``"cost"`` keeps the full configured
        linger (density dial) and ranks by token/request spend.

        ``verify`` runs the static analyzer (``engine/analysis.py``)
        around execution: ``"strict"`` rejects the plan with
        ``PlanValidationError`` BEFORE any provider request when
        pre-flight finds errors, and discharges every optimizer
        rewrite's soundness obligation on the optimized plan;
        ``"warn"`` emits the same findings as ``warnings`` and
        proceeds; ``"off"`` (default) skips analysis entirely."""
        if parallel is None:
            parallel = self.ctx.scheduler is not None
        if speculate is None:
            speculate = self.ctx.speculate
        if objective is not None and objective not in ("latency", "cost"):
            raise ValueError("objective must be 'latency' or 'cost', "
                             f"got {objective!r}")
        if verify not in ("off", "warn", "strict"):
            raise ValueError("verify must be 'off', 'warn' or "
                             f"'strict', got {verify!r}")
        if verify != "off":
            # pre-flight BEFORE planning/execution: an invalid plan is
            # rejected with zero provider requests
            self._verify_preflight(verify)
        if optimize:
            # remembered for explain(); an optimize=False run bypasses
            # the optimizer entirely, so recording its speculate mode
            # would make explain() describe a plan that never ran
            self._last_speculate = speculate
        # the override must reach runtime decisions (ctx.copack_linger)
        # taken on worker threads mid-execution, so it is installed on
        # the context for the duration and restored afterwards
        prev_objective = self.ctx.objective
        if objective is not None:
            self.ctx.objective = objective
        try:
            if optimize:
                opt = self._plan(speculate)
                if verify != "off":
                    # discharge the optimizer's soundness obligations
                    # on the rewritten plan before it executes
                    self._verify_rewrites(verify, opt)
                nodes = opt.nodes
            else:
                nodes = self.nodes
            self._executed_nodes = nodes
            self._executed_optimized = optimize
            t = self.source
            base = len(self.ctx.reports)
            groups = (self._dispatch_groups(nodes) if parallel
                      else [[n] for n in nodes])
            try:
                for group in groups:
                    if len(group) > 1:
                        t = self._run_group(t, group)
                        continue
                    node = group[0]
                    if node.fn is not None:
                        before = len(self.ctx.reports)
                        t = node.fn(t)
                        # spec-chain members append reports from their
                        # own threads and record the slots themselves;
                        # the main thread's thread-local slot would be
                        # stale here
                        if (len(self.ctx.reports) > before
                                and "member_report_slots"
                                not in node.info):
                            slot = self.ctx.last_report_slot()
                            node.report_slot = (before if slot is None
                                                else slot)
                        node.info["rows_out"] = len(t)
            finally:
                # bookkeeping + debounced sidecars survive node errors:
                # earlier filters' observations would otherwise be lost
                self._last_reports = self.ctx.reports[base:]
                self.ctx.flush_stats()
        finally:
            self.ctx.objective = prev_objective
        return t

    def reduce(self, model, prompt, cols: Sequence[str],
               optimize: bool = True):
        t = self.collect(optimize=optimize)
        tuples = [{c: r[c] for c in cols} for r in t.rows()]
        return F.llm_reduce(self.ctx, model, prompt, tuples)

    # ---- plan inspection -----------------------------------------------------
    def _render_report(self, lines, slot, indent="        "):
        r = self.ctx.reports[slot]
        sel = ("" if r.selectivity is None
               else f" selectivity={r.selectivity:.2f}")
        coal = ("" if not r.coalesced
                else f" coalesced={r.coalesced}")
        packed = ("" if not r.packed
                  else f" packed={r.packed}")
        lines.append(
            f"{indent}tuples={r.n_tuples} unique={r.n_unique} "
            f"cache_hits={r.cache_hits} requests={r.requests} "
            f"retries={r.retries} nulls={r.nulls} "
            f"batch_sizes={r.batch_sizes[:8]} "
            f"serialization={r.serialization}{sel}{coal}{packed}")

    def _render_nodes(self, lines, nodes, node_costs):
        for i, node in enumerate(nodes):
            info = {k: v for k, v in node.info.items()
                    if k not in ("model", "prompt", "prompts",
                                 "prompt_ids", "member_specs",
                                 "member_masks", "member_report_slots",
                                 "corpus", "corpus_filter", "outs")
                    and not k.startswith("_")}
            est = node_costs[i] if i < len(node_costs) else None
            est_s = ""
            if est and (est["requests"] or est.get("scan_flops")):
                est_s = (f"  est[rows->{est['rows']} "
                         f"req={est['requests']} tok={est['tokens']}")
                if est.get("scan_flops"):
                    est_s += f" scan_flops={est['scan_flops']:.2e}"
                est_s += "]"
            ann = est.get("ann") if est else None
            if ann:
                est_s += (f" ann[{ann['choice']} nlist={ann['nlist']} "
                          f"nprobe={ann['nprobe']} "
                          f"est_recall={ann['recall_est']:.2f} "
                          f"ivf_flops={ann['ivf_flops']:.2e} "
                          f"exact_flops={ann['exact_flops']:.2e}]")
            lines.append(f"  [{i}] {node.op:18s} {info}{est_s}")
            if node.report_slot is not None:
                self._render_report(lines, node.report_slot)
            for k, slot in enumerate(
                    node.info.get("member_report_slots", ())):
                if slot is not None:
                    lines.append(f"        member[{k}]:")
                    self._render_report(lines, slot, indent="          ")

    def explain(self, speculate=None) -> str:
        """Render the logical plan, the optimizer's rewritten plan, the
        fired rewrite rules, and both plans' estimated request/token
        totals (paper Fig. 2b, now with the optimizer's decisions).

        With speculation on (``speculate`` argument, the last
        ``collect()``'s mode, or the context knob — first set wins),
        a "Speculation:" section reports each ``llm_filter`` chain's
        serial-waves vs speculative-waves estimates, the calibrated
        wall-clock predictions when execution statistics exist, and the
        expected wasted-request budget."""
        if speculate is None:
            speculate = getattr(self, "_last_speculate", None)
        opt = self._plan(speculate)
        lines = ["Pipeline plan (as written):"]
        self._render_nodes(lines, self.nodes, opt.naive_node_costs)
        lines.append(f"  estimated: {opt.naive_cost}")
        lines.append("Optimized plan:")
        self._render_nodes(lines, opt.nodes, opt.optimized_node_costs)
        lines.append(f"  estimated: {opt.optimized_cost}")
        from .analysis import infer_schema
        lines.append("Inferred schema (optimized plan):")
        for i, (node, sch) in enumerate(
                zip(opt.nodes, infer_schema(self.source, opt.nodes))):
            lines.append(f"  [{i}] {node.op:18s} -> {sch.render()}")
        if opt.frontiers:
            # both scheduling frontiers of the optimized plan: the
            # co-packed request count is free under "latency" (last-
            # tail-out), while "cost" may spend up to the configured
            # linger per packed group waiting for denser merges
            lines.append("Objectives:")
            for name in ("latency", "cost"):
                fr = opt.frontiers.get(name)
                if fr is None:
                    continue
                wall = ("est_wall=uncalibrated"
                        if fr["est_wall"] is None
                        else f"est_wall={fr['est_wall']:.3f}s")
                star = "  <- active" if name == opt.objective else ""
                lines.append(f"  {name}: packed_req={fr['packed_req']} "
                             f"{wall}{star}")
        if opt.rewrites:
            lines.append("Rewrites applied:")
            for rw in opt.rewrites:
                lines.append(f"  - {rw}")
        else:
            lines.append("Rewrites applied: none")
        if opt.spec_decisions:
            lines.append("Speculation:")
            for d in opt.spec_decisions:
                lines.append(f"  - {d}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# ASK: natural language -> pipeline (deterministic template planner)
# ---------------------------------------------------------------------------
_SEVERITY = re.compile(r"\b(severity|score|rate|rating)\b", re.I)
_FILTER = re.compile(r"\b(mention\w*|about|related to|regarding)\s+(.+?)"
                     r"(?:\s+and\b|[.,]|$)", re.I)
_SUMMARIZE = re.compile(r"\b(summari[sz]e|overview)\b", re.I)


def ask(ctx: SemanticContext, table: Table, question: str,
        model={"model": "ask-default", "context_window": 8192},
        text_cols: Optional[Sequence[str]] = None):
    """NL question -> (generated pseudo-SQL, Pipeline).  DEMO-ONLY planner."""
    cols = list(text_cols or table.column_names)
    pipe = Pipeline(ctx, table, name="ask")
    sql = [f"SELECT * FROM t"]
    m = _FILTER.search(question)
    if m:
        topic = m.group(2).strip()
        pipe = pipe.llm_filter(model, {"prompt": f"is about {topic}"}, cols)
        sql.append(f"WHERE llm_filter(..., 'is about {topic}', "
                   f"{{{', '.join(cols)}}})")
    if _SEVERITY.search(question):
        pipe = pipe.llm_complete_json(
            "assessment", model,
            {"prompt": 'extract {"issue": <short>, "severity": <1-5>}'},
            cols)
        sql.append("SELECT *, llm_complete_json(..., 'severity json', ...)")
    if _SUMMARIZE.search(question):
        pipe = pipe.llm_complete("summary", model,
                                 {"prompt": "summarize in one sentence"},
                                 cols)
        sql.append("SELECT *, llm_complete(..., 'summarize', ...)")
    return "\n".join(sql), pipe
