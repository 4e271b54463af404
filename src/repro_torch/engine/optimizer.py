"""Cost-based semantic plan optimizer (paper §2.3, "seamless" tier).

FlockMTL's pitch is that LLM-backed relational plans get optimized below
the query surface: the user chains operators in whatever order reads
naturally, and the engine re-orders and fuses them so the model sees as
few tuples — and as few requests — as possible.  This module implements
that rewrite layer for ``Pipeline`` plans.  Three rules run in sequence:

1. **Pushdown** — cheap relational ops (``filter``, ``limit``, ``select``,
   key-independent ``order_by``) bubble *toward the scan*, past semantic
   ops they commute with, so LLM calls see fewer tuples:

   * ``limit`` commutes with per-row map ops (``llm_complete``,
     ``llm_complete_json``, ``llm_embedding``, ``project``) — they preserve
     row count and order.  It never crosses ``llm_filter`` / ``order_by`` /
     ``llm_rerank``.
   * relational ``filter`` commutes with ``llm_filter`` (conjunctive
     predicates) and — when its column dependencies are declared via
     ``Pipeline.filter(pred, cols=...)`` — with map ops whose output
     column it does not read.
   * ``select`` crosses ``llm_filter``/``llm_rerank`` when it retains
     their input columns.
   * ``order_by`` with a string key crosses map ops that don't produce
     that key, and ``llm_filter`` (stable sort of a subset == subset of
     the stable-sorted whole).

2. **Semantic fusion** — adjacent ``llm_filter``/``llm_complete``/
   ``llm_complete_json`` nodes sharing one model and one input-column set
   (and with no def-use dependency between them) merge into a single
   ``llm_fused`` node that answers all sub-tasks in one metaprompt pass
   (``core.functions.llm_multi``, kind ``multi``).

3. **Cost-ordered filter chains** — runs of consecutive ``llm_filter``
   nodes are re-ordered by estimated per-tuple token cost x expected
   selectivity (cheap, selective filters first), using
   ``provider.estimate_tokens`` and the per-prompt pass rates recorded in
   ``SemanticContext.selectivity_stats``.

4. **Speculative pipelining** (opt-in via the context/``collect()``
   ``speculate`` knob) — dependent plan edges overlap instead of
   queueing, in three shapes:

   * **filter chains** — a cost-ordered ``llm_filter`` chain normally
     pays one provider round-trip PER member, because member k+1 waits
     for member k's survivors.  The optimizer may replace the chain
     with one ``llm_spec_chain`` node that fans a chosen *prefix* of
     members out over the chain's input stream concurrently
     (``core.scheduler.SpeculativeJoin``) and ANDs the masks, keeping
     the expensive tail serial over the prefix's survivors — the split
     point is the one minimizing the wall estimate under the waste
     cap (``split == len(chain)`` reproduces the all-or-nothing
     fan-out).
   * **map past filter** — an ``llm_complete``/``llm_complete_json``
     node downstream of an ``llm_filter`` (or spec chain) dispatches
     completions for the filter's INPUT rows concurrently with the
     mask (``llm_spec_map``).  Chunks whose rows the resolved mask
     proves dead are cancelled before dispatch; completed values for
     masked-out rows are discarded from the output but still land in
     the prediction cache.
   * **retrieval-aware rerank** — ``llm_rerank`` downstream of
     ``hybrid_topk`` starts reranking the BM25-predicted per-query
     candidate lists while the dense retriever and fusion finish
     (``spec_rerank``), warming the rerank window cache; the
     authoritative pass over the final top-k reconciles via cache
     hits, so outputs are bit-identical by construction.

   Every decision is per edge: expected wasted requests are predicted
   from recorded selectivity and must stay within
   ``speculate_waste_cap`` x the serial request count (widened 1.25x
   under the ``latency`` objective, narrowed 0.8x under ``cost``), and
   the speculative plan must win on the **calibrated** wall-clock
   estimate (observed per-request latency percentiles and retry rates
   from the ``CalibrationStore``; plain ``waves`` comparison when
   uncalibrated).  ``speculate="always"`` forces eligible edges
   regardless (equivalence tests, benchmarks).

The cost model is *calibrated* when execution statistics exist:
per-request latency percentiles turn ``waves`` into an ``est_wall``
seconds estimate, observed overflow-retry rates inflate request counts,
and observed mean batch sizes replace the flat default width for
columns produced mid-plan that cannot be sampled from the source.

``optimize_plan`` is pure planning: it returns new ``PlanNode`` lists
(fused/speculative nodes carry fresh closures) plus a cost estimate of
both plans — nothing executes until ``Pipeline.collect()`` runs the
rewritten plan.

A copy of ``repro/engine/optimizer.py``; its only differences are this
paragraph and two docstrings that call the whole-chain fan-out "all or
nothing" where the reference names the change that introduced it.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.core import functions as F
from repro_torch.core.batching import plan_batches
from repro_torch.core.functions import SemanticContext
from repro_torch.core.metaprompt import build_multi_task, build_prefix, \
    serialize_tuple
from repro_torch.core.provider import estimate_tokens

from repro_torch.retrieval.ivf import (IVF_MIN_DOCS, default_nlist,
                                 ivf_scan_flops, planned_nprobe,
                                 planned_recall)
from repro_torch.retrieval.vector import DEFAULT_RECALL_TARGET

from .analysis import Obligation, semantic_key
from .retrieval_ops import RETRIEVAL_OPS, pushed_candidate_k
from .table import Table

# node taxonomy --------------------------------------------------------------
SEMANTIC_MAP_OPS = ("llm_complete", "llm_complete_json", "llm_embedding")
SEMANTIC_OPS = SEMANTIC_MAP_OPS + ("llm_filter", "llm_rerank", "llm_fused")
RELATIONAL_OPS = ("filter", "limit", "select", "order_by")
FUSABLE = {"llm_filter": "filter", "llm_complete": "complete",
           "llm_complete_json": "complete_json"}

# default pass rate assumed for predicates with no recorded statistics
DEFAULT_SELECTIVITY = 0.5
# token estimate for a column whose width we cannot sample (produced
# mid-plan by an earlier semantic op)
DEFAULT_COL_TOKENS = 16
_SAMPLE_ROWS = 32


@dataclass
class PlanCost:
    """Estimated provider-side cost of one plan.

    ``waves`` is the critical-path latency estimate for the concurrent
    scheduler: per node, ``ceil(requests / model.max_concurrency)``
    request round-trips must run back-to-back (the scheduler overlaps
    everything else), summed over the sequential node chain.  With the
    serial executor (``scheduler=None``) the critical path is simply
    ``requests``.

    ``wall_s`` is the calibrated wall-clock estimate: waves multiplied
    by each model's observed per-request latency percentile (p50 from
    the ``CalibrationStore``).  It is 0.0 when any contributing model
    has no recorded statistics — uncalibrated, not "instant".

    ``wasted_requests`` is the expected speculative-dispatch waste: the
    requests a chosen ``llm_spec_chain`` issues over tuples a serial
    chain would have eliminated, predicted from recorded selectivity
    (0 for plans without chosen speculation).

    ``packed_requests`` is the request estimate WITH cross-node batch
    co-packing: same-prefix map nodes of one dispatch group merge their
    part-filled tail batches, so the packed estimate plans their tuples
    as one stream (0 when no dispatch group co-packs — the plain
    ``requests`` estimate stands).

    ``tokens`` counts estimated PROMPT tokens (tuple payloads + one
    prefix per request); expected output tokens shape the batch plans
    but are not part of the token totals.

    ``scan_flops`` is the retrieval operators' index-scan cost estimate
    (vector scan ~ 2*N*D per query, BM25 postings scan ~ N per query,
    fusion ~ N per query) — provider-free work, reported separately so
    ``explain()`` shows a RAG plan's full retrieval cost next to its
    embed requests.

    ``pack_wait_s`` is the worst-case co-pack linger spend: one full
    configured linger window per dispatch group with packed savings.
    Under the latency objective the scheduler's last-tail-out flush
    makes this ~0 on the critical path (riders arrive together); under
    the cost objective the plan may actually pay it — the two
    ``est_wall`` frontiers ``explain()`` reports differ by exactly this
    term."""
    requests: int = 0
    tokens: int = 0
    rows_into_llm: int = 0      # tuples fed to semantic ops, post-dedup-free
    waves: int = 0              # critical-path request waves (concurrent)
    wall_s: float = 0.0         # calibrated latency estimate (0 = no data)
    wasted_requests: int = 0    # expected speculative-request overshoot
    packed_requests: int = 0    # request estimate with tail co-packing
    scan_flops: float = 0.0     # retrieval index-scan cost (non-provider)
    pack_wait_s: float = 0.0    # worst-case co-pack linger (cost frontier)
    # exact-vs-ANN pricing of a retrieval scan: both frontiers plus the
    # choice, set only on nodes with an ``ann=`` plan option (explain()
    # renders it; totals aggregate only the chosen frontier's flops)
    ann: Optional[dict] = None

    def __str__(self):
        s = (f"requests={self.requests} tokens={self.tokens} "
             f"llm_rows={self.rows_into_llm} waves={self.waves}")
        if self.wall_s:
            s += f" est_wall={self.wall_s:.3f}s"
        if self.wasted_requests:
            s += f" wasted_requests={self.wasted_requests}"
        if self.packed_requests and self.packed_requests != self.requests:
            s += f" packed_req={self.packed_requests}"
        if self.scan_flops:
            s += f" scan_flops={self.scan_flops:.2e}"
        return s


@dataclass
class SpeculationDecision:
    """Record of one per-edge speculative-dispatch decision: the serial
    vs speculative waves/wall estimates, the expected wasted-request
    budget, and whether the planner chose speculation.  ``kind`` names
    the speculation shape (``chain`` / ``map`` / ``rerank``); for
    chains ``split`` is the number of prefix members speculated (0 or
    ``len(members)`` = the whole chain)."""
    members: List[str]                  # member prompt identities
    rows_in: int = 0
    serial_requests: int = 0
    spec_requests: int = 0
    serial_waves: int = 0
    spec_waves: int = 0
    wasted_requests: int = 0            # expected extra requests (budget)
    serial_wall_s: float = 0.0          # calibrated; 0.0 = uncalibrated
    spec_wall_s: float = 0.0
    chosen: bool = False
    reason: str = ""
    kind: str = "chain"                 # chain | map | rerank
    split: int = 0                      # chain: speculated prefix length

    def __str__(self):
        if self.kind == "map":
            head = f"map past filter over {self.rows_in} rows"
        elif self.kind == "rerank":
            head = (f"rerank over retrieval "
                    f"({self.rows_in} candidate rows)")
        else:
            head = f"chain of {len(self.members)} over {self.rows_in} rows"
            if 0 < self.split < len(self.members):
                head += f" (spec prefix {self.split})"
        walls = ""
        if self.serial_wall_s or self.spec_wall_s:
            walls = (f" serial_wall={self.serial_wall_s:.3f}s "
                     f"spec_wall={self.spec_wall_s:.3f}s")
        return (f"{head}: "
                f"serial_waves={self.serial_waves} "
                f"spec_waves={self.spec_waves}{walls} "
                f"wasted<={self.wasted_requests} "
                f"-> {'SPECULATE' if self.chosen else 'serial'} "
                f"({self.reason})")


@dataclass
class OptimizedPlan:
    nodes: List[Any]                    # rewritten PlanNode list
    rewrites: List[str] = field(default_factory=list)
    naive_cost: PlanCost = field(default_factory=PlanCost)
    optimized_cost: PlanCost = field(default_factory=PlanCost)
    # per-node {rows, requests, tokens} estimates, aligned with the
    # original and rewritten node lists (PlanNodes are shared between the
    # two plans, so estimates live here, not on node.info)
    naive_node_costs: List[dict] = field(default_factory=list)
    optimized_node_costs: List[dict] = field(default_factory=list)
    # one entry per llm_filter chain considered for speculation
    spec_decisions: List[SpeculationDecision] = field(default_factory=list)
    # the objective the rewrite gates ranked under, and both scheduling
    # frontiers of the optimized plan: {"latency"|"cost": {"packed_req",
    # "est_wall"}} with est_wall None when uncalibrated
    objective: str = "latency"
    frontiers: dict = field(default_factory=dict)
    # machine-checkable soundness claims, one or more per applied
    # rewrite, discharged by ``analysis.verify_rewrites`` on the
    # optimized plan (``collect(verify="strict")`` runs it)
    obligations: List[Obligation] = field(default_factory=list)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------
def _avg_tuple_tokens(source: Table, cols: Sequence[str],
                      serialization: str) -> int:
    """Mean serialized-tuple token cost, sampled from the source table.

    Columns produced mid-plan (not present at the scan) are charged a
    flat default width."""
    known = [c for c in cols if c in source.columns]
    missing = len(cols) - len(known)
    if not known:
        return max(1, missing * DEFAULT_COL_TOKENS)
    n = min(len(source), _SAMPLE_ROWS)
    if n == 0:
        return max(1, missing * DEFAULT_COL_TOKENS)
    total = 0
    for i in range(n):
        tup = {c: source.columns[c][i] for c in known}
        total += estimate_tokens(serialize_tuple(tup, serialization))
    return max(1, total // n + missing * DEFAULT_COL_TOKENS)


def _node_prompt_text(ctx: SemanticContext, node) -> Tuple[str, str]:
    """(prompt_text, prompt_id) for a semantic node, '' for non-LLM ops."""
    spec = node.info.get("prompt")
    if spec is None:
        return "", ""
    return ctx.resolve_prompt(spec)


def _fused_prompt_text(ctx: SemanticContext, node) -> str:
    kinds = node.info["kinds"]
    texts = [ctx.resolve_prompt(p)[0] for p in node.info["prompts"]]
    return build_multi_task(kinds, texts)


def _calibrated_requests(ctx: SemanticContext, model, n_rows: int,
                         plan_requests: int, sampled: bool) -> int:
    """Correct a batch-plan request estimate with recorded execution
    statistics: when the tuple width could not be sampled from the
    source (columns produced mid-plan), fall back to the model's
    observed mean batch size; always inflate by the observed
    overflow-retry rate (a model that routinely overflows pays more
    requests than the plan alone predicts)."""
    req = plan_requests
    rec = ctx.calibration_stats.get(model.ref)
    if not sampled and rec and rec["requests"]:
        mean_bs = max(1.0, rec["tuples"] / rec["requests"])
        req = max(req, math.ceil(n_rows / mean_bs))
    retry_rate = ctx.calibrated_retry_rate(model.ref)
    if retry_rate:
        req = math.ceil(req * (1.0 + retry_rate))
    return req


def _per_model_waves(entries) -> Tuple[int, Optional[float]]:
    """Reduce per-model ``(requests, limit, latency|None)`` entries to
    the concurrent critical path: models fan out on independent gates,
    so waves = max over models of ``ceil(requests / limit)``, and the
    calibrated wall is the slowest model's ``waves x latency`` — or
    ``None`` when any contributing model has no recorded latency."""
    waves = 0
    wall: Optional[float] = 0.0
    for req, limit, lat in entries:
        if not req:
            continue
        w = -(-req // limit)
        waves = max(waves, w)
        if lat is None:
            wall = None
        elif wall is not None:
            wall = max(wall, w * lat)
    return waves, wall


def _filter_estimate(ctx: SemanticContext, member: dict, n: int,
                     source: Table, kind: str = "filter") -> Tuple[int, int]:
    """(requests, tokens) estimate for one per-row semantic evaluation —
    ``member`` carries ``model``/``prompt``/``cols`` specs, ``kind`` the
    metaprompt flavour (``filter``/``complete``/``complete_json``) —
    over ``n`` tuples, with the calibrated request correction applied."""
    if n <= 0:
        return 0, 0
    model = ctx.resolve_model(member["model"])
    per_tuple = _avg_tuple_tokens(source, member.get("cols", ()),
                                  ctx.serialization)
    prompt_text, _ = ctx.resolve_prompt(member["prompt"])
    prefix_tokens = estimate_tokens(
        build_prefix(kind, prompt_text, ctx.serialization))
    plan = plan_batches([per_tuple] * n, prefix_tokens,
                        model.context_window, model.max_output_tokens,
                        ctx.max_batch if ctx.enable_batching else 1,
                        headroom=ctx.batch_headroom(model.ref))
    sampled = any(c in source.columns for c in member.get("cols", ()))
    requests = _calibrated_requests(ctx, model, n, len(plan.batches),
                                    sampled)
    tokens = sum(plan.est_tokens) + len(plan.batches) * prefix_tokens
    if len(plan.batches):
        tokens = int(tokens * requests / len(plan.batches))
    return requests, tokens


def _avg_text_tokens(values) -> int:
    """Mean token estimate of raw text values (corpus docs, query
    strings), sampled like ``_avg_tuple_tokens``."""
    vals = list(values)[:_SAMPLE_ROWS]
    if not vals:
        return 1
    return max(1, sum(estimate_tokens(str(v)) for v in vals) // len(vals))


# ANN auto-select: IVF must undercut the exact scan by at least this
# factor before the optimizer switches a node off the exact path — the
# quantizer build and the recall risk are not worth a marginal win
ANN_FLOPS_ADVANTAGE = 0.5


def _ann_decision(ctx: SemanticContext, info: dict, model_ref: str,
                  docs: int) -> dict:
    """Resolve a node's ``ann=`` plan option over a ``docs``-row scan:
    {choice, nlist, nprobe, recall_target, recall_est, calibrated}.

    ``nlist``/``nprobe`` honour explicit plan options, defaulting to
    ~sqrt(N) lists and the smallest probe count whose recall estimate
    meets the target.  The estimate uses a session-built index's
    calibrated recall curve when one exists, else the planning prior.
    ``ann="ivf"`` forces IVF and ``"exact"`` the exact scan; ``"auto"``
    picks IVF iff the corpus is big enough, the recall estimate meets
    the target, and the probed FLOPs undercut the exact scan by
    ``ANN_FLOPS_ADVANTAGE`` — a per-query ratio, so the choice is
    independent of how many queries flow in."""
    mode = info.get("ann")
    target = float(info.get("recall_target") or DEFAULT_RECALL_TARGET)
    nlist = int(info.get("nlist") or default_nlist(docs))
    nlist = max(1, min(nlist, max(docs, 1)))
    ivf = None
    if not info.get("prune_corpus") and info.get("corpus_fp"):
        idx = ctx.lookup_index((model_ref, info["corpus_fp"]))
        built = getattr(idx, "_ivf", None)
        if built is not None and (info.get("nlist") is None
                                  or built.nlist == nlist):
            ivf, nlist = built, built.nlist
    nprobe = info.get("nprobe")
    if nprobe is None:
        nprobe = (ivf.nprobe_for(target) if ivf is not None
                  else planned_nprobe(nlist, target))
    nprobe = max(1, min(int(nprobe), nlist))
    recall = (ivf.estimated_recall(nprobe) if ivf is not None
              else planned_recall(nprobe, nlist))
    if mode == "ivf":
        choice = "ivf"
    elif mode == "exact":
        choice = "exact"
    else:                                   # auto
        ratio = (nlist + docs * nprobe / nlist) / max(docs, 1) / 2.0
        choice = ("ivf" if docs >= IVF_MIN_DOCS and recall >= target
                  and ratio <= ANN_FLOPS_ADVANTAGE else "exact")
    return {"choice": choice, "nlist": nlist, "nprobe": nprobe,
            "recall_target": target, "recall_est": float(recall),
            "calibrated": ivf is not None}


def _ann_frontiers(ctx: SemanticContext, info: dict, model_ref: str,
                   nq: int, docs: int, dim: int) -> Optional[dict]:
    """Both priced scan frontiers for a node with an ``ann=`` option
    (None otherwise): the resolved choice plus exact and IVF FLOPs."""
    if not info.get("ann"):
        return None
    if info.get("ann_resolved"):
        dec = {"choice": info["ann_resolved"],
               "nlist": info["ann_nlist"], "nprobe": info["ann_nprobe"],
               "recall_target": float(info.get("recall_target")
                                      or DEFAULT_RECALL_TARGET),
               "recall_est": info["ann_recall_est"],
               "calibrated": bool(info.get("ann_calibrated"))}
    else:
        dec = _ann_decision(ctx, info, model_ref, docs)
        if info["ann"] == "auto":
            # an unresolved auto executes the exact scan — the naive
            # plan prices that, so explain() shows the optimized plan
            # dropping the scan FLOPs when ann_select picks IVF
            dec["choice"] = "exact"
    dec = dict(dec)
    dec["exact_flops"] = 2.0 * nq * docs * dim
    dec["ivf_flops"] = ivf_scan_flops(nq, docs, dim, dec["nlist"],
                                      dec["nprobe"])
    return dec


def _retrieval_estimate(ctx: SemanticContext, node, rows_in: float,
                        source: Table,
                        seen_corpus: set) -> Tuple[float, PlanCost]:
    """(rows_out, cost) for a retrieval operator.

    Embed requests come from ``plan_batches`` over the corpus + query
    text streams (no output tokens, calibrated per-model headroom);
    a corpus whose index is memoised — by an earlier node of this plan
    (``seen_corpus``), the session registry, or the ``IndexStore``
    sidecar — charges the query embeds only.  ``scan_flops`` covers the
    provider-free index-scan work, and ``packed_requests`` the embed
    estimate with corpus/query tail co-packing."""
    op, info = node.op, node.info
    cost = PlanCost()
    nq = max(int(round(rows_in)), 0)
    corpus_rows = info.get("corpus_rows", len(info["corpus"]))
    sel_rows = corpus_rows
    if info.get("corpus_filter") is not None:
        sel_rows = max(1, int(round(corpus_rows * DEFAULT_SELECTIVITY)))
    rows_out = float(nq * min(info["k"], sel_rows))
    if nq == 0 or corpus_rows == 0:
        return rows_out, cost

    if op != "vector_topk":         # bm25 or hybrid: postings scan
        cost.scan_flops += float(nq * corpus_rows)
    if op == "hybrid_topk":         # fusion over full-length arrays
        cost.scan_flops += float(nq * corpus_rows)
    if op == "bm25_topk":
        return rows_out, cost

    model = ctx.resolve_model(info["model"])
    dim = model.embedding_dim or 64
    scan_docs = sel_rows if info.get("prune_corpus") else corpus_rows
    exact_flops = 2.0 * nq * scan_docs * dim
    ann = _ann_frontiers(ctx, info, model.ref, nq, scan_docs, dim)
    if ann is not None:
        cost.ann = ann
        cost.scan_flops += (ann["ivf_flops"] if ann["choice"] == "ivf"
                            else ann["exact_flops"])
    else:
        cost.scan_flops += exact_flops

    per_doc = _avg_text_tokens(info["corpus"].column(info["doc_col"]))
    qcol = info.get("query_col")
    per_q = (_avg_text_tokens(source.columns[qcol])
             if qcol in source.columns else DEFAULT_COL_TOKENS)
    key = (model.ref, info.get("corpus_fp"), bool(info.get(
        "prune_corpus")) and info.get("corpus_filter") is not None)
    cached = key in seen_corpus
    if not cached and not key[2] and info.get("corpus_fp"):
        cached = ctx.index_cached(model.ref, info["corpus_fp"])
    embed_docs = 0 if cached else (
        sel_rows if info.get("prune_corpus") else corpus_rows)
    seen_corpus.add(key)

    mb = ctx.max_batch if ctx.enable_batching else 1
    headroom = ctx.batch_headroom(model.ref)
    window = model.context_window
    corpus_costs = [per_doc] * embed_docs
    query_costs = [per_q] * nq
    requests, tokens = 0, 0
    for costs in (corpus_costs, query_costs):
        if not costs:
            continue
        plan = plan_batches(costs, 0, window, 0, mb, headroom=headroom)
        requests += len(plan.batches)
        tokens += sum(plan.est_tokens)
    cost.requests = requests
    cost.tokens = tokens
    cost.rows_into_llm = embed_docs + nq
    limit = max(1, getattr(model, "max_concurrency", 1) or 1)
    cost.waves = -(-requests // limit) if requests else 0
    copack_on = (getattr(ctx, "copack", False)
                 and ctx.scheduler is not None and ctx.enable_batching)
    if copack_on and corpus_costs and query_costs:
        joint = plan_batches(corpus_costs + query_costs, 0, window, 0,
                             mb, headroom=headroom)
        if len(joint.batches) < requests:
            cost.packed_requests = len(joint.batches)
    return rows_out, cost


def estimate_node_cost(ctx: SemanticContext, node, rows_in: float,
                       source: Table,
                       seen_corpus: Optional[set] = None
                       ) -> Tuple[float, PlanCost]:
    """(rows_out, provider cost) for one node under the cost model.

    Cardinalities flow through: relational filters halve, llm_filters use
    recorded selectivity, limit truncates, maps preserve, retrieval
    operators expand to k rows per query.  ``seen_corpus`` threads the
    shared-corpus embed dedupe across the nodes of one plan."""
    op, info = node.op, node.info
    cost = PlanCost()
    rows = rows_in

    if op == "filter":
        return rows * DEFAULT_SELECTIVITY, cost
    if op == "limit":
        return min(rows, info.get("n", rows)), cost
    if op in ("select", "order_by", "project", "scan"):
        return rows, cost

    if op in RETRIEVAL_OPS:
        return _retrieval_estimate(ctx, node, rows, source,
                                   set() if seen_corpus is None
                                   else seen_corpus)

    if op == "llm_spec_chain":
        # speculative mask-join: the speculated prefix runs over the
        # full chain input with per-model waves (members of different
        # models fan out on independent gates, same-model members share
        # one); serial tail members queue behind it over the prefix's
        # survivors
        n = int(round(rows))
        if n <= 0:
            return 0.0, cost
        members = info["member_specs"]
        split = info.get("split") or len(members)
        per_model: dict = {}        # ref -> [requests, limit, latency]
        tail_waves, tail_wall = 0, 0.0
        tail_calibrated = True
        for k, member in enumerate(members):
            model = ctx.resolve_model(member["model"])
            limit = max(1, getattr(model, "max_concurrency", 1) or 1)
            lat = ctx.calibrated_latency(model.ref)
            if k < split:
                req, tok = _filter_estimate(ctx, member, n, source)
                cost.rows_into_llm += n
                entry = per_model.setdefault(model.ref, [0, limit, lat])
                entry[0] += req
                entry[1] = min(entry[1], limit)
            else:
                m = int(round(rows))
                req, tok = _filter_estimate(ctx, member, m, source)
                cost.rows_into_llm += m
                w = -(-req // limit) if req else 0
                tail_waves += w
                if lat is None:
                    tail_calibrated = False
                else:
                    tail_wall += w * lat
            cost.requests += req
            cost.tokens += tok
            _, pid = ctx.resolve_prompt(member["prompt"])
            rows = rows * ctx.expected_selectivity(pid,
                                                   DEFAULT_SELECTIVITY)
        waves, wall = _per_model_waves(per_model.values())
        cost.waves = waves + tail_waves
        cost.wall_s = (wall + tail_wall
                       if wall is not None and tail_calibrated else 0.0)
        return rows, cost

    if op == "llm_spec_map":
        # map-past-filter: filter members and the downstream map all
        # run over the node's full input concurrently; the critical
        # path is the slowest model's wave count
        n = int(round(rows))
        if n <= 0:
            return 0.0, cost
        per_model = {}
        for member in info["member_specs"]:
            model = ctx.resolve_model(member["model"])
            limit = max(1, getattr(model, "max_concurrency", 1) or 1)
            req, tok = _filter_estimate(ctx, member, n, source)
            cost.requests += req
            cost.tokens += tok
            cost.rows_into_llm += n
            entry = per_model.setdefault(
                model.ref, [0, limit, ctx.calibrated_latency(model.ref)])
            entry[0] += req
            entry[1] = min(entry[1], limit)
            _, pid = ctx.resolve_prompt(member["prompt"])
            rows = rows * ctx.expected_selectivity(pid,
                                                   DEFAULT_SELECTIVITY)
        map_spec = {"model": info["model"], "prompt": info["prompt"],
                    "cols": info.get("cols", ())}
        mkind = ("complete_json" if info.get("map_op") ==
                 "llm_complete_json" else "complete")
        req, tok = _filter_estimate(ctx, map_spec, n, source, kind=mkind)
        model = ctx.resolve_model(info["model"])
        limit = max(1, getattr(model, "max_concurrency", 1) or 1)
        cost.requests += req
        cost.tokens += tok
        cost.rows_into_llm += n
        entry = per_model.setdefault(
            model.ref, [0, limit, ctx.calibrated_latency(model.ref)])
        entry[0] += req
        entry[1] = min(entry[1], limit)
        cost.waves, wall = _per_model_waves(per_model.values())
        cost.wall_s = wall or 0.0
        return rows, cost

    if op == "spec_rerank":
        # retrieval + rerank warmup overlap: the retrieval's embeds and
        # the BM25-predicted rerank windows run concurrently; the
        # authoritative pass reconciles through the window cache
        shim = node.__class__(info["retr_op"], info["_retr"])
        rows_out, cost = _retrieval_estimate(
            ctx, shim, rows, source,
            set() if seen_corpus is None else seen_corpus)
        n = int(round(rows_out))
        if n > 0:
            window, stride = 10, 5
            windows = 1 if n <= window else 1 + -(-(n - window) // stride)
            rr = info["_rerank"]
            per_tuple = _avg_tuple_tokens(source, rr.get("cols", ()),
                                          ctx.serialization)
            prompt_text, _ = ctx.resolve_prompt(rr["prompt"])
            prefix_tokens = estimate_tokens(
                build_prefix("rerank", prompt_text, ctx.serialization))
            cost.requests += windows
            cost.tokens += windows * (prefix_tokens + window * per_tuple)
            cost.rows_into_llm += n
            cost.waves = max(cost.waves, windows)
        return rows_out, cost

    if op not in SEMANTIC_OPS:
        return rows, cost

    model = ctx.resolve_model(info["model"])
    n = int(round(rows))
    if n <= 0:
        return 0.0, cost
    per_tuple = _avg_tuple_tokens(source, info.get("cols", ()),
                                  ctx.serialization)

    def waves(requests: int) -> int:
        limit = max(1, getattr(model, "max_concurrency", 1) or 1)
        return -(-requests // limit)

    if op == "llm_embedding":
        cost.requests = 1
        cost.tokens = n * per_tuple
        cost.rows_into_llm = n
        cost.waves = waves(cost.requests)
        return rows, cost

    if op == "llm_rerank":
        window, stride = 10, 5
        windows = 1 if n <= window else 1 + -(-(n - window) // stride)
        prompt_text, _ = _node_prompt_text(ctx, node)
        prefix_tokens = estimate_tokens(
            build_prefix("rerank", prompt_text, ctx.serialization))
        cost.requests = windows
        cost.tokens = windows * (prefix_tokens + window * per_tuple)
        cost.rows_into_llm = n
        # rerank windows chain (each consumes the last window's output):
        # no overlap available, every request is its own wave
        cost.waves = cost.requests
        return rows, cost

    if op == "llm_fused":
        kind = "multi"
        prompt_text = _fused_prompt_text(ctx, node)
    else:
        kind = {"llm_filter": "filter", "llm_complete": "complete",
                "llm_complete_json": "complete_json"}[op]
        prompt_text, _ = _node_prompt_text(ctx, node)
    prefix_tokens = estimate_tokens(
        build_prefix(kind, prompt_text, ctx.serialization))
    plan = plan_batches([per_tuple] * n, prefix_tokens,
                        model.context_window, model.max_output_tokens,
                        ctx.max_batch if ctx.enable_batching else 1,
                        headroom=ctx.batch_headroom(model.ref))
    sampled = any(c in source.columns for c in info.get("cols", ()))
    cost.requests = _calibrated_requests(ctx, model, n, len(plan.batches),
                                         sampled)
    cost.tokens = sum(plan.est_tokens) + len(plan.batches) * prefix_tokens
    if len(plan.batches):
        cost.tokens = int(cost.tokens * cost.requests / len(plan.batches))
    cost.rows_into_llm = n
    cost.waves = waves(cost.requests)

    if op == "llm_filter":
        _, pid = _node_prompt_text(ctx, node)
        rows = rows * ctx.expected_selectivity(pid, DEFAULT_SELECTIVITY)
    elif op == "llm_fused":
        for k, pid in zip(node.info["kinds"], node.info["prompt_ids"]):
            if k == "filter":
                rows = rows * ctx.expected_selectivity(
                    pid, DEFAULT_SELECTIVITY)
    return rows, cost


def _packed_savings(ctx: SemanticContext, source: Table, group,
                    n: int) -> int:
    """Requests saved by co-packing one dispatch group: members sharing
    a metaprompt-prefix identity plan their tuples as ONE stream, so the
    part-filled tails that would ship per node merge (mirrors the
    scheduler's packing queue)."""
    from .pipeline import copack_identity   # local import: avoid cycle

    if n <= 0:
        return 0
    by_ident: dict = {}
    for node in group:
        ident = copack_identity(ctx, node)
        if ident is not None:
            by_ident.setdefault(ident, []).append(node)
    saved = 0
    mb = ctx.max_batch if ctx.enable_batching else 1
    for ident, members in by_ident.items():
        if len(members) < 2:
            continue
        model = ctx.resolve_model(members[0].info["model"])
        kind = ident[2]         # (provider, model, kind, ser, text)
        if members[0].op == "llm_fused":
            # fused nodes carry sub-task prompt specs, not a single
            # prompt: the shared prefix is the rendered multi-task text
            prompt_text = _fused_prompt_text(ctx, members[0])
        else:
            prompt_text, _ = _node_prompt_text(ctx, members[0])
        prefix_tokens = estimate_tokens(
            build_prefix(kind, prompt_text, ctx.serialization))
        headroom = ctx.batch_headroom(model.ref)
        costs: List[int] = []
        solo = 0
        for node in members:
            per_tuple = _avg_tuple_tokens(source, node.info.get("cols",
                                                                ()),
                                          ctx.serialization)
            member_costs = [per_tuple] * n
            solo += len(plan_batches(
                member_costs, prefix_tokens, model.context_window,
                model.max_output_tokens, mb, headroom=headroom).batches)
            costs.extend(member_costs)
        joint = len(plan_batches(
            costs, prefix_tokens, model.context_window,
            model.max_output_tokens, mb, headroom=headroom).batches)
        saved += max(0, solo - joint)
    return saved


def estimate_plan_cost(ctx: SemanticContext, source: Table,
                       nodes: Sequence) -> Tuple[PlanCost, List[dict]]:
    from .pipeline import Pipeline      # local import: avoid cycle

    total = PlanCost()
    per_node: List[dict] = []
    node_info: dict = {}      # id(node) -> (model_ref, limit, requests,
    #                            standalone waves, standalone wall)
    entry_rows: dict = {}     # id(node) -> rows flowing INTO the node
    rows = float(len(source))
    seen_corpus: set = set()      # shared-corpus embed dedupe across nodes
    node_packed_saved = 0
    # worst-case linger a co-packing site may spend waiting for denser
    # merges (the cost objective's density dial; ~0 under latency-first
    # last-tail-out scheduling): one window per site with packed savings
    linger_s = (ctx.scheduler.pack_linger_s
                if getattr(ctx, "scheduler", None) is not None else 0.0)
    for node in nodes:
        entry_rows[id(node)] = rows
        rows, c = estimate_node_cost(ctx, node, rows, source, seen_corpus)
        nd = {"rows": int(round(rows)),
              "requests": c.requests, "tokens": c.tokens}
        if c.scan_flops:
            nd["scan_flops"] = c.scan_flops
        if c.ann is not None:
            nd["ann"] = c.ann
        per_node.append(nd)
        total.requests += c.requests
        total.tokens += c.tokens
        total.rows_into_llm += c.rows_into_llm
        total.scan_flops += c.scan_flops
        if c.packed_requests and c.packed_requests < c.requests:
            node_packed_saved += c.requests - c.packed_requests
            total.pack_wait_s += linger_s
        ref, limit = "", 1
        if (c.requests and "model" in node.info
                and (node.op in SEMANTIC_OPS or node.op in RETRIEVAL_OPS)):
            m = ctx.resolve_model(node.info["model"])
            ref = m.ref
            limit = max(1, getattr(m, "max_concurrency", 1) or 1)
        node_info[id(node)] = (ref, limit, c.requests, c.waves, c.wall_s)
    # critical path: nodes in one dispatch group overlap, but same-model
    # members contend for one gate — their requests share the model's
    # concurrency budget, so per group it is the slowest MODEL (summed
    # requests / limit), and groups run back-to-back.  The calibrated
    # wall estimate multiplies each wave count by the model's observed
    # p50 request latency; a plan touching any uncalibrated model
    # reports wall_s = 0.0 (unknown) rather than an undercount.
    uncalibrated = False
    copack_on = (getattr(ctx, "copack", False)
                 and ctx.scheduler is not None and ctx.enable_batching)
    packed_saved = 0
    for group in Pipeline._dispatch_groups(list(nodes)):
        if copack_on and len(group) > 1:
            saved = _packed_savings(
                ctx, source, group,
                int(round(entry_rows.get(id(group[0]), 0.0))))
            if saved:
                packed_saved += saved
                total.pack_wait_s += linger_s
        if len(group) == 1:
            ref, limit, reqs, w, nwall = node_info.get(
                id(group[0]), ("", 1, 0, 0, 0.0))
            total.waves += w
            if not reqs:
                continue
            if nwall:               # node computed its own (spec chain)
                total.wall_s += nwall
                continue
            lat = ctx.calibrated_latency(ref) if ref else None
            if lat is None:
                uncalibrated = True
            else:
                total.wall_s += w * lat
            continue
        per_model: dict = {}
        for n in group:
            ref, limit, reqs, _, _ = node_info[id(n)]
            if not reqs:
                continue
            r0, l0 = per_model.get(ref, (0, limit))
            per_model[ref] = (r0 + reqs, min(l0, limit))
        group_waves, group_wall = _per_model_waves(
            (r, l, ctx.calibrated_latency(ref) if ref else None)
            for ref, (r, l) in per_model.items())
        total.waves += group_waves
        if group_wall is None:
            uncalibrated = True
        else:
            total.wall_s += group_wall
    if uncalibrated:
        total.wall_s = 0.0
    packed_saved += node_packed_saved
    if packed_saved:
        total.packed_requests = max(0, total.requests - packed_saved)
    return total, per_node


# ---------------------------------------------------------------------------
# rule 1: relational pushdown
# ---------------------------------------------------------------------------
def _commutes_before(rel, sem) -> bool:
    """May relational node ``rel`` move to run before node ``sem``?"""
    r, s = rel.op, sem.op
    produced = sem.info.get("out")
    fused_outs = sem.info.get("outs", ())

    if r == "limit":
        return s in ("llm_complete", "llm_complete_json", "llm_embedding",
                     "project")
    if r == "filter":
        if s == "llm_filter":
            return True
        if s in RETRIEVAL_OPS:
            # a filter over query-side columns commutes with the LATERAL
            # expansion (candidate rows replicate the query columns);
            # one reading the node's outputs (scores, ranks, corpus
            # columns) must stay above it
            deps = rel.info.get("cols")
            if deps is None:
                return False               # opaque predicate: stay put
            return not (set(deps) & set(sem.info.get("outs", ())))
        if s in ("llm_complete", "llm_complete_json", "llm_embedding",
                 "project"):
            deps = rel.info.get("cols")
            if deps is None:
                return False               # opaque predicate: stay put
            banned = set(fused_outs) | ({produced} if produced else set())
            return not (set(deps) & banned)
        return False
    if r == "select":
        if s in ("llm_filter", "llm_rerank"):
            needed = set(sem.info.get("cols", ()))
            if sem.info.get("by") is not None:
                needed.add(sem.info["by"])     # grouped rerank key
            return needed <= set(rel.info.get("cols", ()))
        return False
    if r == "order_by":
        key = rel.info.get("key")
        if rel.info.get("key_is_callable"):
            return False
        if s == "llm_filter":
            return True
        if s in ("llm_complete", "llm_complete_json", "llm_embedding",
                 "project"):
            banned = set(fused_outs) | ({produced} if produced else set())
            return key not in banned
        return False
    return False


def _pushdown(nodes: List, rewrites: List[str],
              obligations: List[Obligation]) -> List:
    nodes = list(nodes)
    changed = True
    while changed:
        changed = False
        for i in range(len(nodes) - 1):
            a, b = nodes[i], nodes[i + 1]
            if (a.op in SEMANTIC_OPS + RETRIEVAL_OPS + ("project",)
                    and b.op in RELATIONAL_OPS
                    and _commutes_before(b, a)):
                nodes[i], nodes[i + 1] = b, a
                rule = f"pushdown({b.op} before {a.op})"
                rewrites.append(rule)
                # claim: b may legally run before a, and b's read-set
                # is satisfied at its new position (the verifier
                # re-checks both with its own legality table)
                obligations.append(Obligation(
                    rule=rule, kind="commute",
                    payload={"rel_id": id(b), "rel_op": b.op,
                             "sem_key": semantic_key(a),
                             "sem_node": a}))
                changed = True
    return nodes


# ---------------------------------------------------------------------------
# rule 1b: retrieval rewrites (corpus pruning, k-pushdown, embed dedupe)
# ---------------------------------------------------------------------------
def _retrieval_rewrites(ctx: SemanticContext, nodes: List,
                        rewrites: List[str],
                        obligations: List[Obligation]) -> List:
    """Monotone retrieval-operator rewrites (never cost-gated — each one
    only ever removes work):

    * ``prune_corpus`` — a node carrying a ``corpus_filter`` embeds only
      the matching docs instead of embedding everything and masking the
      ranking.  Result-preserving by construction: per-doc vector scores
      are independent of the rest of the corpus, the selection and the
      tie-break are identical either way, and BM25 statistics always
      come from the full corpus.
    * ``k_pushdown`` — ``hybrid_topk(candidate_k=None)`` fuses FULL
      per-retriever candidate lists unoptimized; the rewrite pushes the
      final k into a per-retriever depth of ``max(32, 4k)`` (the
      engine-chosen physical depth, like a batch size).
    * ``dedupe_corpus_embed`` — notes nodes sharing (model, corpus
      fingerprint) with an earlier node; at runtime the session index
      registry / ``IndexStore`` serves them without re-embedding, and
      the cost model charges the corpus embed once.

    Rewritten nodes are REBUILT (fresh info dict + executor closure) so
    the shared logical plan is never mutated."""
    from .pipeline import PlanNode              # local import: avoid cycle
    from .retrieval_ops import make_retrieval_fn

    out: List = []
    seen: set = set()
    for node in nodes:
        if node.op not in RETRIEVAL_OPS:
            out.append(node)
            continue
        info = node.info
        changes: dict = {}
        if (info.get("corpus_filter") is not None
                and not info.get("prune_corpus")
                and node.op != "bm25_topk"):
            changes["prune_corpus"] = True
            rule = (f"prune_corpus({node.op}: corpus filter "
                    f"below the index build)")
            rewrites.append(rule)
            obligations.append(Obligation(
                rule=rule, kind="selection_invariance",
                payload={"key": semantic_key(node)}))
        if node.op == "hybrid_topk" and not info.get("candidate_k"):
            c = pushed_candidate_k(info["k"])
            if c < info.get("corpus_rows", 0):
                changes["candidate_k"] = c
                rule = (f"k_pushdown(hybrid_topk: k={info['k']} -> "
                        f"per-retriever candidate_k={c})")
                rewrites.append(rule)
                obligations.append(Obligation(
                    rule=rule, kind="recall_contract",
                    payload={"key": semantic_key(node),
                             "k": info["k"], "candidate_k": c}))
        if (node.op != "bm25_topk" and info.get("ann")
                and not info.get("ann_resolved")):
            # ann_select: resolve auto/forced ANN into a concrete scan
            # choice the executor follows and the cost model prices
            try:
                ref = ctx.resolve_model(info["model"]).ref
            except KeyError:
                ref = None
            if ref is not None:
                docs = info.get("corpus_rows", len(info["corpus"]))
                if (info.get("corpus_filter") is not None
                        and changes.get("prune_corpus")):
                    docs = max(1, int(round(docs * DEFAULT_SELECTIVITY)))
                probe = dict(info)
                probe.update(changes)
                dec = _ann_decision(ctx, probe, ref, docs)
                changes.update(
                    ann_resolved=dec["choice"], ann_nlist=dec["nlist"],
                    ann_nprobe=dec["nprobe"],
                    ann_recall_est=dec["recall_est"],
                    ann_calibrated=dec["calibrated"])
                rule = (
                    f"ann_select({node.op}: ann={info['ann']} -> "
                    f"{dec['choice']} nlist={dec['nlist']} "
                    f"nprobe={dec['nprobe']} "
                    f"est_recall={dec['recall_est']:.2f}"
                    f"{' calibrated' if dec['calibrated'] else ''})")
                rewrites.append(rule)
                obligations.append(Obligation(
                    rule=rule, kind="recall_contract",
                    payload={"key": semantic_key(node),
                             "mode": info["ann"],
                             "choice": dec["choice"],
                             "nlist": dec["nlist"],
                             "nprobe": dec["nprobe"],
                             "recall_est": dec["recall_est"],
                             "recall_target": dec["recall_target"]}))
        if "model" in info and info.get("corpus_fp"):
            try:
                ref = ctx.resolve_model(info["model"]).ref
            except KeyError:
                ref = None
            if ref is not None:
                key = (ref, info["corpus_fp"])
                if key in seen:
                    rule = (f"dedupe_corpus_embed({node.op}: corpus "
                            f"index shared with an earlier node)")
                    rewrites.append(rule)
                    obligations.append(Obligation(
                        rule=rule, kind="index_shared",
                        payload={"ref": ref, "fp": info["corpus_fp"]}))
                seen.add(key)
        if changes:
            new_info = dict(info)
            new_info.pop("_bm25", None)
            new_info.update(changes)
            out.append(PlanNode(node.op, new_info,
                                make_retrieval_fn(ctx, node.op,
                                                  new_info)))
        else:
            out.append(node)
    return out


# ---------------------------------------------------------------------------
# rule 2: semantic fusion
# ---------------------------------------------------------------------------
def _model_identity(ctx: SemanticContext, spec):
    # the full resolved resource, not just name@version: inline specs all
    # land on version 0, and fusing ops whose context_window /
    # max_output_tokens differ would run one sub-task under the other's
    # limits
    try:
        return ctx.resolve_model(spec)
    except KeyError:
        return repr(sorted(spec.items()))


def _can_join_group(ctx, group: List, node) -> bool:
    if node.op not in FUSABLE:
        return False
    head = group[0]
    if tuple(node.info["cols"]) != tuple(head.info["cols"]):
        return False
    if _model_identity(ctx, node.info["model"]) != _model_identity(
            ctx, head.info["model"]):
        return False
    # def-use: a later op reading an earlier op's output cannot fuse —
    # guaranteed here because cols are identical and outputs are new
    # columns, but guard against out-name collisions with input cols
    produced = {g.info.get("out") for g in group if g.info.get("out")}
    return not (set(node.info["cols"]) & produced)


def _make_fused_node(ctx: SemanticContext, group: List):
    from .pipeline import PlanNode      # local import: avoid cycle

    cols = list(group[0].info["cols"])
    model_spec = group[0].info["model"]
    subtasks = [{"kind": FUSABLE[g.op], "prompt": g.info["prompt"],
                 "out": g.info.get("out")} for g in group]
    prompt_ids = [ctx.resolve_prompt(g.info["prompt"])[1] for g in group]

    def fn(t: Table) -> Table:
        tuples = [{c: r[c] for c in cols} for r in t.rows()]
        per_task = F.llm_multi(ctx, model_spec,
                               [{"kind": s["kind"], "prompt": s["prompt"]}
                                for s in subtasks], tuples)
        mask = [True] * len(tuples)
        res = t
        for sub, vals in zip(subtasks, per_task):
            if sub["kind"] == "filter":
                mask = [m and bool(v) for m, v in zip(mask, vals)]
            else:
                res = res.with_column(sub["out"], vals)
        return res.filter_mask(mask)

    return PlanNode("llm_fused", {
        "model": model_spec, "cols": cols,
        "kinds": [s["kind"] for s in subtasks],
        "outs": [s["out"] for s in subtasks if s["out"]],
        "prompts": [g.info["prompt"] for g in group],
        "prompt_ids": prompt_ids,
        "fused": [g.op for g in group]}, fn)


def _fuse(ctx: SemanticContext, nodes: List, rewrites: List[str],
          obligations: List[Obligation]) -> List:
    out: List = []
    i = 0
    while i < len(nodes):
        node = nodes[i]
        if node.op in FUSABLE:
            group = [node]
            j = i + 1
            while j < len(nodes) and _can_join_group(ctx, group, nodes[j]):
                group.append(nodes[j])
                j += 1
            if len(group) > 1:
                fused = _make_fused_node(ctx, group)
                out.append(fused)
                rule = "fusion(" + "+".join(g.op for g in group) + ")"
                rewrites.append(rule)
                # claim: one llm_fused node carries exactly the merged
                # sub-tasks (kinds, outs, cols, prompts) under one model
                obligations.append(Obligation(
                    rule=rule, kind="fusion_exact",
                    payload={"kinds": list(fused.info["kinds"]),
                             "cols": list(fused.info["cols"]),
                             "outs": list(fused.info["outs"]),
                             "prompts": list(fused.info["prompts"]),
                             "models": [g.info["model"]
                                        for g in group]}))
                if "filter" in fused.info["kinds"]:
                    obligations.append(Obligation(
                        rule=rule, kind="mask_equivalence",
                        payload={}))
                i = j
                continue
        out.append(node)
        i += 1
    return out


# ---------------------------------------------------------------------------
# rule 3: cost-ordered filter chains
# ---------------------------------------------------------------------------
def _filter_rank(ctx: SemanticContext, node, source: Table) -> float:
    """Predicate-ordering rank: token cost per unit of elimination,
    cost / (1 - selectivity), ascending — cheap, selective predicates run
    first.  (Plain cost x selectivity mis-orders chains where an
    expensive filter is also very selective; the final plan is
    cost-gated either way.)"""
    prompt_text, pid = _node_prompt_text(ctx, node)
    per_tuple = _avg_tuple_tokens(source, node.info.get("cols", ()),
                                  ctx.serialization)
    prefix = estimate_tokens(
        build_prefix("filter", prompt_text, ctx.serialization))
    sel = ctx.expected_selectivity(pid, DEFAULT_SELECTIVITY)
    return (prefix + per_tuple) / max(1.0 - sel, 1e-6)


def _reorder_filters(ctx: SemanticContext, nodes: List, source: Table,
                     rewrites: List[str],
                     obligations: List[Obligation]) -> List:
    out: List = []
    i = 0
    while i < len(nodes):
        if nodes[i].op != "llm_filter":
            out.append(nodes[i])
            i += 1
            continue
        j = i
        while j < len(nodes) and nodes[j].op == "llm_filter":
            j += 1
        chain = nodes[i:j]
        ranked = sorted(chain, key=lambda n: _filter_rank(ctx, n, source))
        if ranked != chain:
            rule = (f"reorder_filters(chain of {len(chain)} by cost "
                    f"per eliminated tuple)")
            rewrites.append(rule)
            # claim: conjunctions commute — the plan's filter-predicate
            # multiset is unchanged by the reorder
            obligations.append(Obligation(
                rule=rule, kind="mask_equivalence", payload={}))
        out.extend(ranked)
        i = j
    return out


# ---------------------------------------------------------------------------
# rule 4: speculative pipelining (opt-in)
# ---------------------------------------------------------------------------
# objective-aware widening of the waste budget: a latency-first session
# tolerates extra speculative requests (they buy wall-clock), a
# cost-first one narrows the budget below the configured cap
SPEC_CAP_OBJECTIVE_MULT = {"latency": 1.25, "cost": 0.8}

# prior probability that a BM25-predicted per-query candidate list does
# NOT match the final fused top-k (no per-corpus calibration yet): the
# expected fraction of rerank warmup requests charged as waste
SPEC_RERANK_MISMATCH_PRIOR = 0.5


def _waste_cap(ctx: SemanticContext, serial_requests: int,
               objective: str) -> float:
    """Wasted-request budget for one speculation decision."""
    mult = SPEC_CAP_OBJECTIVE_MULT.get(objective, 1.0)
    return ctx.speculate_waste_cap * mult * max(serial_requests, 1)


def _make_spec_chain_node(ctx: SemanticContext, chain: List,
                          split: Optional[int] = None):
    """Build one ``llm_spec_chain`` node executing the first ``split``
    chain members as a concurrent mask-join over the chain's input
    tuple stream, then the remaining members serially over the prefix's
    survivors (``split`` omitted or == ``len(chain)``: the whole chain
    fans out, all or nothing).

    Each speculated member runs the full ``llm_filter`` staged path
    (dedup, cache, batch-plan, scheduler dispatch) on one of the join's
    bounded runner threads, so identical cache keys across members
    coalesce through the scheduler's single-flight registry and every
    member honours its model's concurrency gate.  Masks are ANDed; a
    tuple NULLed by overflow decodes to False — exactly the serial
    path's disposition — so the surviving stream is bit-identical to
    serial chain execution.  Tail members' masks are expanded back to
    the chain-input frame (False at already-dead positions) so
    ``member_masks`` stays one full-length mask per member.

    Note on statistics: speculative members observe *marginal* pass
    rates (over the chain input) where serial execution records
    *conditional* ones (over the predecessors' survivors); both are
    valid estimators for the cost model, and the waste budget is
    computed from the same recorded values either way."""
    from .pipeline import PlanNode      # local import: avoid cycle

    members = [{"model": g.info["model"], "prompt": g.info["prompt"],
                "cols": list(g.info["cols"])} for g in chain]
    prompt_ids = [ctx.resolve_prompt(g.info["prompt"])[1] for g in chain]
    k = len(members)
    if split is None or split <= 0 or split > k:
        split = k
    all_cols: List[str] = []
    for m in members:
        for c in m["cols"]:
            if c not in all_cols:
                all_cols.append(c)

    node = PlanNode("llm_spec_chain", {
        "member_specs": members, "cols": all_cols,
        "members": prompt_ids, "chain": k, "split": split})

    def fn(t: Table) -> Table:
        from repro_torch.core.scheduler import SpecTask, SpeculativeJoin

        slots: List[Any] = [None] * k
        masks_out: List[Any] = [None] * k

        def make_thunk(kk: int, member: dict):
            def thunk() -> List[bool]:
                tuples = [{c: row[c] for c in member["cols"]}
                          for row in t.rows()]
                mask = F.llm_filter(ctx, member["model"],
                                    member["prompt"], tuples)
                slots[kk] = ctx.last_report_slot()
                return mask
            return thunk

        join = SpeculativeJoin(ctx.scheduler)
        masks = join.run(
            [SpecTask(make_thunk(kk, m), rows=len(t), label=f"member-{kk}")
             for kk, m in enumerate(members[:split])])
        lengths = {len(m) for m in masks}
        if len(lengths) > 1:
            raise ValueError(
                f"speculative members returned masks of differing "
                f"lengths {sorted(lengths)}")
        combined = [all(col) for col in zip(*masks)]
        for kk in range(split):
            masks_out[kk] = list(masks[kk])
        cur = t.filter_mask(combined)
        alive = [i for i, keep in enumerate(combined) if keep]
        for kk in range(split, k):
            member = members[kk]
            tuples = [{c: row[c] for c in member["cols"]}
                      for row in cur.rows()]
            mask = F.llm_filter(ctx, member["model"], member["prompt"],
                                tuples)
            slots[kk] = ctx.last_report_slot()
            full = [False] * len(t)
            for pos, keep in zip(alive, mask):
                full[pos] = bool(keep)
            masks_out[kk] = full
            cur = cur.filter_mask(mask)
            alive = [pos for pos, keep in zip(alive, mask) if keep]
        node.info["member_masks"] = masks_out
        node.info["member_report_slots"] = slots
        return cur

    node.fn = fn
    return node


def _decide_speculation(ctx: SemanticContext, source: Table, chain: List,
                        rows_in: float, mode: str,
                        objective: str = "latency"
                        ) -> Tuple[SpeculationDecision, float]:
    """Estimate serial vs speculative execution of one filter chain,
    over every candidate prefix split.

    Serial: member k sees the survivors of members < k (cardinalities
    from recorded selectivity) and its waves queue behind k-1 finished
    round-trips.  Speculative with split s: the first s members all see
    the full chain input; same-model members share one concurrency
    gate, different models fan out independently, so the prefix's
    critical path is the slowest model's wave count — ~1 round-trip
    when the fan-out fits the concurrency limits — and the remaining
    members queue serially over the prefix's survivors (their
    cardinalities are the serial ones: the ANDed prefix admits exactly
    the rows serial prefix execution would).  Expected waste is the
    prefix's request count over the full input minus its serial one;
    the chosen split minimizes the wall estimate (waves when
    uncalibrated) among splits within the waste cap."""
    n = int(round(rows_in))
    k = len(chain)
    decision = SpeculationDecision(
        members=[ctx.resolve_prompt(g.info["prompt"])[1] for g in chain],
        rows_in=n)
    per_member: List[dict] = []
    calibrated = True
    rows = rows_in
    for g in chain:
        member = {"model": g.info["model"], "prompt": g.info["prompt"],
                  "cols": g.info.get("cols", ())}
        model = ctx.resolve_model(member["model"])
        limit = max(1, getattr(model, "max_concurrency", 1) or 1)
        lat = ctx.calibrated_latency(model.ref)
        if lat is None:
            calibrated = False
        m = int(round(rows))
        req_serial, _ = _filter_estimate(ctx, member, m, source)
        if m == n:                      # first member: same estimate
            req_spec = req_serial
        else:
            req_spec, _ = _filter_estimate(ctx, member, n, source)
        w = -(-req_serial // limit) if req_serial else 0
        per_member.append({"ref": model.ref, "limit": limit, "lat": lat,
                           "req_serial": req_serial, "req_spec": req_spec,
                           "w_serial": w})
        decision.serial_requests += req_serial
        decision.serial_waves += w
        if lat is not None:
            decision.serial_wall_s += w * lat
        _, pid = ctx.resolve_prompt(member["prompt"])
        rows = rows * ctx.expected_selectivity(pid, DEFAULT_SELECTIVITY)

    def candidate(s: int) -> dict:
        per_model: dict = {}    # ref -> [spec requests, limit, latency]
        for pm in per_member[:s]:
            entry = per_model.setdefault(pm["ref"],
                                         [0, pm["limit"], pm["lat"]])
            entry[0] += pm["req_spec"]
            entry[1] = min(entry[1], pm["limit"])
        waves, wall = _per_model_waves(per_model.values())
        for pm in per_member[s:]:
            waves += pm["w_serial"]
            if wall is not None:
                if pm["lat"] is None and pm["req_serial"]:
                    wall = None
                elif pm["lat"] is not None:
                    wall += pm["w_serial"] * pm["lat"]
        wasted = max(0, sum(pm["req_spec"] - pm["req_serial"]
                            for pm in per_member[:s]))
        requests = (sum(pm["req_spec"] for pm in per_member[:s])
                    + sum(pm["req_serial"] for pm in per_member[s:]))
        return {"split": s, "waves": waves, "wall": wall,
                "wasted": wasted, "requests": requests}

    def adopt(c: dict):
        decision.split = c["split"]
        decision.spec_requests = c["requests"]
        decision.spec_waves = c["waves"]
        decision.wasted_requests = c["wasted"]
        if c["wall"] is not None:
            decision.spec_wall_s = c["wall"]
        else:
            decision.serial_wall_s = 0.0

    cands = [candidate(s) for s in range(2, k + 1)]
    if mode == "always":
        adopt(cands[-1])                # force the whole chain
        decision.chosen = True
        decision.reason = "forced by speculate='always'"
        return decision, rows
    cap = _waste_cap(ctx, decision.serial_requests, objective)
    feasible = [c for c in cands if c["wasted"] <= cap]
    if not feasible:
        adopt(min(cands, key=lambda c: c["wasted"]))
        decision.reason = (f"expected waste {decision.wasted_requests} "
                           f"requests exceeds cap {cap:.0f}")
    elif calibrated and decision.serial_wall_s:
        adopt(min(feasible,
                  key=lambda c: (c["wall"] if c["wall"] is not None
                                 else float("inf"), c["wasted"])))
        decision.chosen = bool(
            decision.spec_wall_s
            and decision.spec_wall_s < decision.serial_wall_s)
        decision.reason = (
            f"calibrated wall {decision.spec_wall_s:.3f}s "
            f"{'<' if decision.chosen else '>='} "
            f"{decision.serial_wall_s:.3f}s")
    else:
        adopt(min(feasible, key=lambda c: (c["waves"], c["wasted"])))
        decision.chosen = decision.spec_waves < decision.serial_waves
        decision.reason = (
            f"uncalibrated waves {decision.spec_waves} "
            f"{'<' if decision.chosen else '>='} {decision.serial_waves}")
    return decision, rows


def _speculate_chains(ctx: SemanticContext, source: Table, nodes: List,
                      rewrites: List[str],
                      obligations: List[Obligation], mode: str,
                      objective: str = "latency"
                      ) -> Tuple[List, List[SpeculationDecision]]:
    """Replace each eligible ``llm_filter`` chain (length >= 2) with a
    speculative mask-join node when the decision model says it pays."""
    out: List = []
    decisions: List[SpeculationDecision] = []
    rows = float(len(source))
    i = 0
    while i < len(nodes):
        node = nodes[i]
        if node.op != "llm_filter":
            rows, _ = estimate_node_cost(ctx, node, rows, source)
            out.append(node)
            i += 1
            continue
        j = i
        while j < len(nodes) and nodes[j].op == "llm_filter":
            j += 1
        chain = nodes[i:j]
        if len(chain) < 2:
            rows, _ = estimate_node_cost(ctx, node, rows, source)
            out.append(node)
            i = j
            continue
        decision, rows = _decide_speculation(ctx, source, chain, rows,
                                             mode, objective)
        decisions.append(decision)
        if decision.chosen:
            out.append(_make_spec_chain_node(ctx, chain, decision.split))
            prefix = ""
            if 0 < decision.split < len(chain):
                prefix = f", prefix={decision.split}"
            rule = (f"speculate(chain of {len(chain)}: "
                    f"spec_waves={decision.spec_waves} vs "
                    f"serial_waves={decision.serial_waves}, "
                    f"wasted<={decision.wasted_requests}{prefix})")
            rewrites.append(rule)
            # claim: the mask-join ANDs exactly the chain's predicates
            # (surviving stream bit-identical to serial execution)
            obligations.append(Obligation(
                rule=rule, kind="mask_equivalence",
                payload={"spec_chain": True,
                         "prompts": [g.info["prompt"] for g in chain]}))
        else:
            out.extend(chain)
            rewrites.append(
                f"rejected(speculate chain of {len(chain)}: "
                f"{decision.reason})")
        i = j
    return out, decisions


# ---------------------------------------------------------------------------
# rule 4b: map-past-filter speculation
# ---------------------------------------------------------------------------
def _filter_members(node) -> List[dict]:
    """Member specs of an upstream mask producer: one spec for a plain
    ``llm_filter``, the member list for an ``llm_spec_chain``."""
    if node.op == "llm_spec_chain":
        return [dict(m) for m in node.info["member_specs"]]
    return [{"model": node.info["model"], "prompt": node.info["prompt"],
             "cols": list(node.info["cols"])}]


def _decide_spec_map(ctx: SemanticContext, source: Table, filt, mp,
                     rows_in: float, mode: str, objective: str
                     ) -> Tuple[SpeculationDecision, float]:
    """Estimate serial vs speculative execution of one filter->map edge.

    Serial: the map queues behind the mask and sees only the survivors.
    Speculative: the map dispatches over the filter's full input
    concurrently with the mask — the edge's critical path is
    ``max(filter waves, map waves over the full input)`` — and the
    expected waste is the map requests over rows the mask kills."""
    n = int(round(rows_in))
    rows_out, fcost = estimate_node_cost(ctx, filt, rows_in, source)
    members = _filter_members(filt)
    decision = SpeculationDecision(
        kind="map",
        members=([ctx.resolve_prompt(m["prompt"])[1] for m in members]
                 + [ctx.resolve_prompt(mp.info["prompt"])[1]]),
        rows_in=n)
    if n <= 0:
        decision.reason = "no input rows"
        return decision, rows_out
    survivors = int(round(rows_out))
    map_spec = {"model": mp.info["model"], "prompt": mp.info["prompt"],
                "cols": mp.info.get("cols", ())}
    mkind = ("complete_json" if mp.op == "llm_complete_json"
             else "complete")
    req_surv, _ = _filter_estimate(ctx, map_spec, survivors, source,
                                   kind=mkind)
    req_full, _ = _filter_estimate(ctx, map_spec, n, source, kind=mkind)
    model = ctx.resolve_model(mp.info["model"])
    limit = max(1, getattr(model, "max_concurrency", 1) or 1)
    lat = ctx.calibrated_latency(model.ref)
    w_surv = -(-req_surv // limit) if req_surv else 0
    w_full = -(-req_full // limit) if req_full else 0
    decision.serial_requests = fcost.requests + req_surv
    decision.spec_requests = fcost.requests + req_full
    decision.serial_waves = fcost.waves + w_surv
    decision.spec_waves = max(fcost.waves, w_full)
    decision.wasted_requests = max(0, req_full - req_surv)

    # the filter side's calibrated wall: spec chains self-wall, plain
    # filters wall via their model's recorded latency
    if filt.op == "llm_spec_chain":
        wall_f = fcost.wall_s if fcost.wall_s else None
    else:
        lat_f = ctx.calibrated_latency(
            ctx.resolve_model(filt.info["model"]).ref)
        wall_f = fcost.waves * lat_f if lat_f is not None else None
    if wall_f is not None and lat is not None:
        decision.serial_wall_s = wall_f + w_surv * lat
        decision.spec_wall_s = max(wall_f, w_full * lat)

    if mode == "always":
        decision.chosen = True
        decision.reason = "forced by speculate='always'"
        return decision, rows_out
    cap = _waste_cap(ctx, decision.serial_requests, objective)
    if decision.wasted_requests > cap:
        decision.reason = (f"expected waste {decision.wasted_requests} "
                           f"requests exceeds cap {cap:.0f}")
    elif decision.spec_wall_s and decision.serial_wall_s:
        decision.chosen = decision.spec_wall_s < decision.serial_wall_s
        decision.reason = (
            f"calibrated wall {decision.spec_wall_s:.3f}s "
            f"{'<' if decision.chosen else '>='} "
            f"{decision.serial_wall_s:.3f}s")
    else:
        decision.chosen = decision.spec_waves < decision.serial_waves
        decision.reason = (
            f"uncalibrated waves {decision.spec_waves} "
            f"{'<' if decision.chosen else '>='} {decision.serial_waves}")
    return decision, rows_out


def _make_spec_map_node(ctx: SemanticContext, filt, mp):
    """Build one ``llm_spec_map`` node running the upstream mask members
    and the downstream map concurrently over the edge's input rows.

    The mask members are mandatory tasks (the serial plan needs them);
    the map dispatches in row chunks so the resolved mask can cancel
    not-yet-started chunks whose rows are all dead.  Values computed
    for rows the mask kills are dropped from the output (and counted
    via ``SchedulerStats.spec_wasted_rows``) but remain in the
    prediction cache — a later plan over the same rows gets them free.
    Surviving rows keep their serial values: per-tuple completions are
    independent of batch composition, so the output is bit-identical
    to filter-then-map."""
    from .pipeline import PlanNode      # local import: avoid cycle

    members = _filter_members(filt)
    prompt_ids = [ctx.resolve_prompt(m["prompt"])[1] for m in members]
    nm = len(members)
    node = PlanNode("llm_spec_map", {
        "member_specs": members, "members": prompt_ids,
        "model": mp.info["model"], "prompt": mp.info["prompt"],
        "cols": list(mp.info["cols"]), "out": mp.info["out"],
        "map_op": mp.op, "chain": nm})

    def fn(t: Table) -> Table:
        from repro_torch.core.scheduler import SpecTask, SpeculativeJoin

        n = len(t)
        out_col = node.info["out"]
        if n == 0:
            return t.filter_mask([]).with_column(out_col, [])
        rows_all = list(t.rows())
        chunk = (ctx.max_batch
                 if ctx.enable_batching and ctx.max_batch else 32)
        spans = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]
        join = SpeculativeJoin(ctx.scheduler)
        slots: List[Any] = [None] * (nm + 1)
        masks: List[Any] = [None] * nm
        lock = threading.Lock()
        state = {"left": nm}

        def make_member(k: int, member: dict):
            def thunk() -> List[bool]:
                tuples = [{c: row[c] for c in member["cols"]}
                          for row in rows_all]
                mask = F.llm_filter(ctx, member["model"],
                                    member["prompt"], tuples)
                slots[k] = ctx.last_report_slot()
                masks[k] = mask
                with lock:
                    state["left"] -= 1
                    done = state["left"] == 0
                if done:
                    combined = [all(col) for col in zip(*masks)]
                    state["combined"] = combined
                    # the mask resolved: speculative chunks whose rows
                    # are all dead never need to run
                    for j, (s, e) in enumerate(spans):
                        if not any(combined[s:e]):
                            join.cancel(nm + j)
                return mask
            return thunk

        map_cols = node.info["cols"]
        map_fn = (F.llm_complete_json
                  if node.info["map_op"] == "llm_complete_json"
                  else F.llm_complete)

        def make_chunk(j: int, s: int, e: int):
            def thunk() -> list:
                tuples = [{c: rows_all[i][c] for c in map_cols}
                          for i in range(s, e)]
                vals = map_fn(ctx, node.info["model"],
                              node.info["prompt"], tuples)
                slots[nm] = ctx.last_report_slot()
                return vals
            return thunk

        tasks = ([SpecTask(make_member(k, m), rows=n,
                           label=f"member-{k}", mandatory=True)
                  for k, m in enumerate(members)]
                 + [SpecTask(make_chunk(j, s, e), rows=e - s,
                             label=f"map-{j}")
                    for j, (s, e) in enumerate(spans)])
        results = join.run(tasks)
        combined = state["combined"]
        cancelled = set(join.cancelled)
        out_vals: List[Any] = [None] * n
        wasted = 0
        for j, (s, e) in enumerate(spans):
            vals = results[nm + j]
            if nm + j in cancelled or vals is None:
                continue
            for i in range(s, e):
                if combined[i]:
                    out_vals[i] = vals[i - s]
                else:
                    wasted += 1
        if wasted:
            join.note_wasted(wasted)
        node.info["member_masks"] = [list(m) for m in masks]
        node.info["member_report_slots"] = slots
        surv = [v for v, keep in zip(out_vals, combined) if keep]
        return t.filter_mask(combined).with_column(out_col, surv)

    node.fn = fn
    return node


def _speculate_maps(ctx: SemanticContext, source: Table, nodes: List,
                    rewrites: List[str],
                    obligations: List[Obligation], mode: str,
                    objective: str
                    ) -> Tuple[List, List[SpeculationDecision]]:
    """Fuse each eligible filter->map edge (an ``llm_filter`` or chosen
    ``llm_spec_chain`` directly feeding an ``llm_complete`` /
    ``llm_complete_json``) into one ``llm_spec_map`` node when the
    decision model says the overlap pays."""
    out: List = []
    decisions: List[SpeculationDecision] = []
    rows = float(len(source))
    i = 0
    while i < len(nodes):
        node = nodes[i]
        nxt = nodes[i + 1] if i + 1 < len(nodes) else None
        if (node.op in ("llm_filter", "llm_spec_chain")
                and nxt is not None
                and nxt.op in ("llm_complete", "llm_complete_json")):
            decision, rows_out = _decide_spec_map(ctx, source, node, nxt,
                                                  rows, mode, objective)
            decisions.append(decision)
            if decision.chosen:
                out.append(_make_spec_map_node(ctx, node, nxt))
                rule = (f"speculate(map past filter: "
                        f"spec_waves={decision.spec_waves} vs "
                        f"serial_waves={decision.serial_waves}, "
                        f"wasted<={decision.wasted_requests})")
                rewrites.append(rule)
                # claim: the node ANDs exactly the upstream predicates
                # and maps exactly the downstream prompt over survivors
                obligations.append(Obligation(
                    rule=rule, kind="mask_equivalence",
                    payload={"spec_map": True,
                             "prompts": [m["prompt"] for m in
                                         _filter_members(node)]}))
                rows = rows_out
                i += 2
                continue
            rewrites.append(
                f"rejected(speculate map past filter: {decision.reason})")
        rows, _ = estimate_node_cost(ctx, node, rows, source)
        out.append(node)
        i += 1
    return out, decisions


# ---------------------------------------------------------------------------
# rule 4c: retrieval-aware rerank speculation
# ---------------------------------------------------------------------------
def _decide_spec_rerank(ctx: SemanticContext, source: Table, retr, rr,
                        rows_in: float, mode: str, objective: str
                        ) -> Tuple[SpeculationDecision, float]:
    """Estimate serial vs speculative execution of one retrieval->rerank
    edge.  Serial: the rerank's chained windows queue behind the
    retrieval's embed waves.  Speculative: warmup windows over the
    BM25-predicted candidates overlap the dense embeds and fusion; the
    authoritative pass reconciles through the window cache, so only
    mispredicted queries pay again (``SPEC_RERANK_MISMATCH_PRIOR``)."""
    rows_out, rcost = _retrieval_estimate(ctx, retr, rows_in, source,
                                          set())
    n = int(round(rows_out))
    decision = SpeculationDecision(
        kind="rerank",
        members=[ctx.resolve_prompt(rr.info["prompt"])[1]],
        rows_in=n)
    if n <= 0:
        decision.reason = "no candidate rows"
        return decision, rows_out
    window, stride = 10, 5
    windows = 1 if n <= window else 1 + -(-(n - window) // stride)
    decision.serial_requests = rcost.requests + windows
    decision.wasted_requests = int(
        math.ceil(windows * SPEC_RERANK_MISMATCH_PRIOR))
    decision.spec_requests = (decision.serial_requests
                              + decision.wasted_requests)
    decision.serial_waves = rcost.waves + windows
    decision.spec_waves = max(rcost.waves, windows)

    if mode == "always":
        decision.chosen = True
        decision.reason = "forced by speculate='always'"
        return decision, rows_out
    cap = _waste_cap(ctx, decision.serial_requests, objective)
    if decision.wasted_requests > cap:
        decision.reason = (f"expected waste {decision.wasted_requests} "
                           f"requests exceeds cap {cap:.0f}")
    else:
        decision.chosen = decision.spec_waves < decision.serial_waves
        decision.reason = (
            f"uncalibrated waves {decision.spec_waves} "
            f"{'<' if decision.chosen else '>='} {decision.serial_waves}")
    return decision, rows_out


def _speculate_rerank(ctx: SemanticContext, source: Table, nodes: List,
                      rewrites: List[str],
                      obligations: List[Obligation], mode: str,
                      objective: str
                      ) -> Tuple[List, List[SpeculationDecision]]:
    """Fuse each eligible ``hybrid_topk`` -> ``llm_rerank`` edge into a
    ``spec_rerank`` node that warms the rerank window cache over the
    BM25-predicted candidates while the dense side finishes.

    Structural guards: the prediction cache must be enabled (it IS the
    reconciliation mechanism — without it warmup results cannot carry
    over to the authoritative pass), and the rerank must not read the
    retrieval's *computed* columns — the fused score and its rank are
    unknowable before fusion, so predicted tuples would never
    byte-match.  Joined corpus columns are fine: the BM25 side predicts
    which documents expand, and their content is known up front."""
    from .retrieval_ops import make_spec_rerank_fn
    from .pipeline import PlanNode      # local import: avoid cycle

    out: List = []
    decisions: List[SpeculationDecision] = []
    rows = float(len(source))
    i = 0
    while i < len(nodes):
        node = nodes[i]
        nxt = nodes[i + 1] if i + 1 < len(nodes) else None
        if (node.op == "hybrid_topk" and nxt is not None
                and nxt.op == "llm_rerank"):
            if not ctx.enable_cache:
                rewrites.append("rejected(speculate rerank: prediction "
                                "cache disabled)")
            elif (set(nxt.info.get("cols", ()))
                  | {nxt.info.get("by")}) & {
                      node.info.get("out"),
                      str(node.info.get("out")) + "_rank"}:
                rewrites.append("rejected(speculate rerank: rerank reads "
                                "the fused score/rank columns)")
            else:
                decision, rows_out = _decide_spec_rerank(
                    ctx, source, node, nxt, rows, mode, objective)
                decisions.append(decision)
                if decision.chosen:
                    info = {"k": node.info["k"],
                            "by": nxt.info.get("by"),
                            "outs": list(node.info.get("outs", ())),
                            "retr_op": node.op,
                            "members": list(decision.members),
                            "_retr": node.info,
                            "_rerank": {
                                "model": nxt.info["model"],
                                "prompt": nxt.info["prompt"],
                                "cols": list(nxt.info["cols"]),
                                "by": nxt.info.get("by")}}
                    spec = PlanNode("spec_rerank", info)
                    spec.fn = make_spec_rerank_fn(ctx, spec)
                    out.append(spec)
                    rule = (f"speculate(rerank over retrieval: "
                            f"spec_waves={decision.spec_waves} vs "
                            f"serial_waves={decision.serial_waves}, "
                            f"wasted<={decision.wasted_requests})")
                    rewrites.append(rule)
                    # claim: the authoritative rerank runs over the
                    # full fused top-k — warmup only pre-fills the
                    # window cache, never changes the candidate set
                    obligations.append(Obligation(
                        rule=rule, kind="recall_contract",
                        payload={"spec_rerank": True,
                                 "key": semantic_key(node),
                                 "k": node.info["k"]}))
                    rows = rows_out
                    i += 2
                    continue
                rewrites.append(
                    f"rejected(speculate rerank: {decision.reason})")
        rows, _ = estimate_node_cost(ctx, node, rows, source)
        out.append(node)
        i += 1
    return out, decisions


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
# latency-equivalent token cost charged per provider request when ranking
# plans: a chat-API round trip costs ~30 ms of overhead, the price of a
# few hundred tokens of service time (benchmarks/run.py batching bench)
REQUEST_OVERHEAD_TOKENS = 200

# nominal per-request round-trip seconds for ranking plans on waves when
# no calibrated latency exists (the same ~30 ms ballpark that motivates
# REQUEST_OVERHEAD_TOKENS)
NOMINAL_REQUEST_S = 0.03


def _cost_rank(c: PlanCost, objective: str = "cost") -> tuple:
    """Comparable plan rank under a scheduling objective.  ``cost``
    ranks by token spend plus a flat per-request overhead (the provider
    bill).  ``latency`` ranks by the calibrated wall estimate — waves x
    a nominal round-trip when uncalibrated — with the token rank as the
    tie-break, so among equally fast plans the cheaper one wins."""
    base = float(c.tokens + REQUEST_OVERHEAD_TOKENS * c.requests)
    if objective == "latency":
        wall = c.wall_s if c.wall_s else c.waves * NOMINAL_REQUEST_S
        return (wall, base)
    return (base, 0.0)


def _objective_frontiers(cost: PlanCost) -> dict:
    """Both scheduling frontiers of one plan estimate.  The co-packed
    request count is identical (last-tail-out makes packing free under
    the latency objective, so neither frontier gives it up); the wall
    estimates differ by the linger the cost objective may spend waiting
    for denser merges.  ``est_wall`` is None when uncalibrated."""
    packed = cost.packed_requests or cost.requests
    wall = cost.wall_s if cost.wall_s else None
    return {
        "latency": {"packed_req": packed, "est_wall": wall},
        "cost": {"packed_req": packed,
                 "est_wall": (None if wall is None
                              else wall + cost.pack_wait_s)},
    }


def optimize_plan(ctx: SemanticContext, source: Table, nodes: Sequence,
                  speculate=None, objective: Optional[str] = None
                  ) -> OptimizedPlan:
    """Rewrite a Pipeline node list; returns both plans' cost estimates.

    Pushdown always applies (it only ever shrinks the tuple stream LLM
    ops see); the filter re-ordering and semantic-fusion rewrites are
    cost-gated — each is kept only if the cost model says the plan got
    cheaper (e.g. fusing a highly selective filter with a completion
    would run the completion over the whole input, so it is rejected).

    ``speculate`` (``None``/``False`` off, ``True``/``"auto"``
    cost-gated, ``"always"`` forced) runs the speculative-pipelining
    rules last, over the cost-ordered plan: ``llm_filter`` chains of
    length >= 2 may become concurrent mask-join nodes (whole chain or
    a prefix), filter->map edges may become ``llm_spec_map`` nodes,
    and ``hybrid_topk``->``llm_rerank`` edges may become
    ``spec_rerank`` nodes — each per the calibrated decision recorded
    in ``OptimizedPlan.spec_decisions`` (the waste cap widens 1.25x
    under the latency objective and narrows 0.8x under cost).

    ``objective`` (``"latency"``/``"cost"``, default the context's) sets
    the rank the cost gates compare under: ``latency`` accepts a rewrite
    that lowers the wall estimate even when it spends more tokens (e.g.
    fusion collapsing two waves into one), ``cost`` keeps the token-first
    gate.  Pure planning: no provider calls, no table materialisation."""
    if objective is None:
        objective = getattr(ctx, "objective", "latency")
    if objective not in ("latency", "cost"):
        raise ValueError(
            f"objective must be 'latency' or 'cost', got {objective!r}")
    naive = [n for n in nodes]
    rewrites: List[str] = []
    obligations: List[Obligation] = []
    new = _pushdown(list(nodes), rewrites, obligations)
    new = _retrieval_rewrites(ctx, new, rewrites, obligations)

    cost, _ = estimate_plan_cost(ctx, source, new)
    for rule in (_reorder_filters, _fuse):
        trial_rw: List[str] = []
        trial_ob: List[Obligation] = []
        if rule is _reorder_filters:
            trial = rule(ctx, new, source, trial_rw, trial_ob)
        else:
            trial = rule(ctx, new, trial_rw, trial_ob)
        if not trial_rw:
            continue
        trial_cost, _ = estimate_plan_cost(ctx, source, trial)
        if _cost_rank(trial_cost, objective) <= _cost_rank(cost, objective):
            new, cost = trial, trial_cost
            rewrites.extend(trial_rw)
            obligations.extend(trial_ob)
        else:
            rewrites.extend(f"rejected({rw}: estimated cost higher)"
                            for rw in trial_rw)

    spec_decisions: List[SpeculationDecision] = []
    if speculate:
        mode = "always" if speculate == "always" else "auto"
        new, spec_decisions = _speculate_chains(ctx, source, new,
                                                rewrites, obligations,
                                                mode, objective)
        for rule_fn in (_speculate_maps, _speculate_rerank):
            new, more = rule_fn(ctx, source, new, rewrites, obligations,
                                mode, objective)
            spec_decisions.extend(more)

    if rewrites:
        # the one claim every rewrite shares: the plan's final output
        # schema (names + dtypes) is unchanged
        obligations.append(Obligation(
            rule="plan", kind="schema_preserved", payload={}))
    plan = OptimizedPlan(nodes=new, rewrites=rewrites,
                         spec_decisions=spec_decisions,
                         objective=objective, obligations=obligations)
    plan.naive_cost, plan.naive_node_costs = estimate_plan_cost(
        ctx, source, list(naive))
    plan.optimized_cost, plan.optimized_node_costs = estimate_plan_cost(
        ctx, source, new)
    plan.optimized_cost.wasted_requests = sum(
        d.wasted_requests for d in spec_decisions if d.chosen)
    plan.frontiers = _objective_frontiers(plan.optimized_cost)
    return plan
