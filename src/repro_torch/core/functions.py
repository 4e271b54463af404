"""Semantic scalar & aggregate functions (paper Table 1) + the staged
execution path that backs them: dedup -> cache -> batch-plan -> dispatch.

Scalar (map) functions — one output per input tuple:
    llm_complete, llm_complete_json, llm_filter, llm_embedding
Aggregate (reduce) functions — one output per tuple group:
    llm_reduce, llm_reduce_json, llm_rerank, llm_first, llm_last
plus ``fusion`` (see fusion.py) for hybrid-search score combination.

Every function takes ``{'model_name': ...}``-style model/prompt argument
dicts like FlockMTL: either a registered resource name (+optional @version)
or an inline spec, so SQL pipelines stay fixed while admins swap resources.

The dispatch stage has two modes: with ``SemanticContext(scheduler=...)``
batch requests go to the concurrent ``RequestScheduler`` (overlapped
in-flight requests, single-flight key dedup); with ``scheduler=None``
they run through the serial adaptive loop — same batches, same results.

Every dispatch additionally folds its ``BatchStats`` (request/retry
counts, batch sizes, per-request latencies) into the context's
``calibration_stats`` — persisted by the ``CalibrationStore`` sidecar —
so the plan optimizer's cost model is calibrated from observed execution
statistics rather than static heuristics.  The ``speculate`` knob
(``False`` | ``True``/``"auto"`` | ``"always"``) opts a session into
speculative ``llm_filter``-chain dispatch: the optimizer fans a chain's
members out over the chain *input* concurrently and ANDs the masks,
trading wasted requests — expected waste is predicted from recorded
selectivity and capped at ``speculate_waste_cap`` x the serial chain's
request count — for k-1 saved round-trips.

A copy of ``repro/core/functions.py``.  Its differences, besides this
paragraph: ``SemanticContext`` takes ``device`` (None: the GPU), the
device on which the vector indexes a plan builds live
(``retrieval.vector.ensure_index``); a retrieval plan without a GPU
raises unless the context was given ``device="cpu"``.  ``index_entries``
counts an index's rows with ``len(index)`` (a mesh-sharded index has no
whole-corpus tensor).
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .cache import (CALIBRATION_COUNT_WINDOW, CALIBRATION_WINDOW,
                    CalibrationStore, IndexStore, PredictionCache,
                    SelectivityStore, bound_observations, cache_key,
                    headroom_factor)
from .batching import plan_batches
from .metaprompt import (build_metaprompt, build_multi_task, build_prefix,
                         serialize_tuple)
from .provider import BaseProvider, MockProvider, estimate_tokens
from .resources import Catalog, ModelResource
from .scheduler import (PACK_LINGER_LATENCY_FRACTION, PACK_LINGER_MIN_S,
                        RequestScheduler, execute_serial)


@dataclass
class ExecutionReport:
    """Per-call optimizer trace (feeds the plan-inspection UI)."""
    function: str = ""
    n_tuples: int = 0
    n_unique: int = 0
    cache_hits: int = 0
    requests: int = 0
    retries: int = 0
    nulls: int = 0
    batch_sizes: List[int] = field(default_factory=list)
    serialization: str = "xml"
    meta_prompt_prefix: str = ""
    chosen_batch_size: str = "auto"
    selectivity: Optional[float] = None   # filter calls: pass rate
    coalesced: int = 0    # keys served by another job's in-flight request
    packed: int = 0       # tail batches that rode another job's request
    # wall seconds per successful provider request (completion order);
    # aggregated into the CalibrationStore for the calibrated cost model
    latencies: List[float] = field(default_factory=list)


class SemanticContext:
    """Catalog + provider + cache + knobs — one per database session."""

    def __init__(self, catalog: Optional[Catalog] = None,
                 provider: Optional[BaseProvider] = None,
                 cache: Optional[PredictionCache] = None,
                 serialization: str = "xml",
                 enable_cache: bool = True, enable_dedup: bool = True,
                 enable_batching: bool = True, max_batch: int = 0,
                 scheduler: Optional[RequestScheduler] = None,
                 selectivity_path: Optional[str] = None,
                 speculate=False, speculate_waste_cap: float = 1.0,
                 calibration_path: Optional[str] = None,
                 copack: bool = True,
                 index_path: Optional[str] = None,
                 objective: str = "latency", device=None):
        self.catalog = catalog or Catalog()
        self.provider = provider or MockProvider()
        self.cache = cache or PredictionCache()
        self.serialization = serialization
        self.enable_cache = enable_cache
        self.enable_dedup = enable_dedup
        self.enable_batching = enable_batching
        self.max_batch = max_batch
        # concurrent dispatch engine; None = serial (bit-identical) path
        self.scheduler = scheduler
        # speculative filter-chain dispatch: False = off, True/"auto" =
        # the optimizer speculates a chain only when the calibrated cost
        # model says it is cheaper, "always" = force every eligible
        # chain (tests/benchmarks).  ``speculate_waste_cap`` bounds the
        # expected wasted requests (those over tuples an earlier filter
        # would have eliminated, predicted from recorded selectivity)
        # to at most cap x the serial chain's request count.
        self.speculate = speculate
        self.speculate_waste_cap = speculate_waste_cap
        # cross-node batch co-packing: part-filled tail batches from
        # concurrently-dispatched map nodes that share a (model,
        # metaprompt-prefix) identity merge into one provider request.
        # copack=False is the escape hatch (results are bit-identical
        # either way; only request density changes).
        self.copack = copack
        # scheduling objective: "latency" flushes a parked co-pack the
        # moment no rider is plausibly in flight and bounds the linger
        # by the calibrated expected-arrival window; "cost" keeps the
        # full configured linger window (the density dial) and ranks
        # plans by token/request spend alone.  The optimizer prices
        # both frontiers either way (explain() shows them).
        if objective not in ("latency", "cost"):
            raise ValueError("objective must be 'latency' or 'cost', "
                             f"got {objective!r}")
        self.objective = objective
        # prefix identities currently eligible for co-packing: managed
        # by Pipeline._run_group (only node groups that actually contain
        # >= 2 same-prefix nodes pay the packing-queue linger)
        self._copack_active: Dict[Any, int] = {}
        self.reports: List[ExecutionReport] = []
        self._lock = threading.Lock()
        # selectivity gets its own lock: its save() does file I/O, which
        # must not stall add_report on concurrently dispatched map nodes
        self._sel_lock = threading.Lock()
        self._tl = threading.local()     # per-thread last report
        # per-prompt filter pass-rate observations: prompt_id -> [passed,
        # total].  Feeds the plan optimizer's cost-ordered filter chains.
        self.selectivity_stats: Dict[str, List[int]] = {}
        # persistence sidecar: survives sessions next to the prediction
        # cache, so recurring prompts are cost-ordered from real stats
        if selectivity_path is None and self.cache.persist_path is not None:
            selectivity_path = str(self.cache.persist_path) \
                + ".selectivity.json"
        self.selectivity_store = (SelectivityStore(selectivity_path)
                                  if selectivity_path else None)
        # debounce sidecar writes: at most one full-file rewrite per
        # interval on the hot path; flush_selectivity() forces the rest
        # (Pipeline.collect() calls it once per plan execution)
        self._sel_save_interval = 0.5
        self._sel_last_save = float("-inf")
        self._sel_dirty = False
        if self.selectivity_store is not None:
            loaded = SelectivityStore.prune_stale(
                self.selectivity_store.load(), self.catalog)
            self.selectivity_stats.update(loaded)
        # execution-statistics sidecar (calibrated cost model): per-model
        # request/retry/tuple counts + a bounded latency window, fed by
        # every dispatch and persisted next to the prediction cache
        self.calibration_stats: Dict[str, dict] = {}
        self._cal_lock = threading.Lock()
        self._cal_last_save = float("-inf")
        self._cal_dirty = False
        if calibration_path is None and self.cache.persist_path is not None:
            calibration_path = str(self.cache.persist_path) \
                + ".calibration.json"
        self.calibration_store = (CalibrationStore(calibration_path)
                                  if calibration_path else None)
        if self.calibration_store is not None:
            self.calibration_stats.update(CalibrationStore.prune_stale(
                self.calibration_store.load(), self.catalog))
        # vector-index memoisation (retrieval plan operators): a
        # session-local registry of built VectorIndex objects keyed by
        # (model ref, corpus fingerprint), plus the persistent
        # ``IndexStore`` sidecar so a repeated RAG query over an
        # unchanged corpus skips re-embedding entirely
        self._index_registry: Dict[Any, Any] = {}
        self._index_lock = threading.Lock()
        # where a built index lives (None: the GPU)
        self.device = device
        if index_path is None and self.cache.persist_path is not None:
            index_path = str(self.cache.persist_path) + ".index.json"
        self.index_store = IndexStore(index_path) if index_path else None
        if self.index_store is not None:
            self.index_store.prune(self.catalog)
        # calibration-aware batch sizing: per-model planning headroom is
        # SNAPSHOT from the loaded statistics (a model that routinely
        # overflowed last session plans smaller batches up front this
        # session) and stays fixed within the session — recomputing it
        # mid-flight would make concurrently-dispatched nodes' batch
        # plans depend on scheduling order, breaking determinism
        self._headroom: Dict[str, float] = {
            ref: headroom_factor(rec["requests"], rec["retries"])
            for ref, rec in self.calibration_stats.items()}

    # ---- report bookkeeping (thread-safe: nodes may run concurrently) ------
    def add_report(self, rep: ExecutionReport):
        with self._lock:
            self.reports.append(rep)
            slot = len(self.reports) - 1
        self._tl.last_report = rep
        self._tl.last_report_slot = slot

    def last_report(self) -> Optional[ExecutionReport]:
        """The report appended by the current thread's most recent
        semantic call (``reports[-1]`` is racy under the scheduler's
        concurrent node dispatch)."""
        return getattr(self._tl, "last_report", None)

    def last_report_slot(self) -> Optional[int]:
        """Index of ``last_report()`` in ``reports`` — recorded at
        append time so plan bookkeeping stays O(1) on long-lived
        contexts."""
        return getattr(self._tl, "last_report_slot", None)

    # ---- co-packing eligibility (managed by Pipeline._run_group) -----------
    @staticmethod
    def _copack_counts(identities) -> Dict[Any, int]:
        """Normalise a co-pack group spec — a ``{identity: expected
        submitter count}`` mapping or a plain iterable (one submitter
        per occurrence) — into a count dict."""
        if isinstance(identities, dict):
            return {i: int(n) for i, n in identities.items() if n > 0}
        counts: Dict[Any, int] = {}
        for ident in identities:
            counts[ident] = counts.get(ident, 0) + 1
        return counts

    @staticmethod
    def _pack_queue_key(identity):
        # the scheduler keys its packing queue (and rider-expectation
        # registry) by (model.ref, identity); identity[1] is the fully-
        # resolved ModelResource in every pack identity we mint
        return (identity[1].ref, identity)

    def copack_begin(self, identities):
        """Mark prefix identities as co-packable for the duration of a
        concurrent node-group dispatch (re-entrant: counted).

        ``identities`` maps each identity to the number of submitters
        the group expects to dispatch under it (an iterable counts one
        per occurrence).  The counts are registered with the scheduler
        as outstanding rider expectations, so a parked pack flushes the
        moment its LAST expected tail arrives instead of waiting out
        the linger deadline."""
        counts = self._copack_counts(identities)
        with self._lock:
            for ident in counts:
                self._copack_active[ident] = \
                    self._copack_active.get(ident, 0) + 1
        if self.scheduler is not None:
            for ident, n in counts.items():
                self.scheduler.pack_expect(self._pack_queue_key(ident), n)

    def copack_end(self, identities):
        """Close a co-pack group: drop eligibility and retire whatever
        rider expectations the group never delivered (members that
        resolved entirely from cache, raised, ...).  Retiring flushes
        packs still parked under a newly-riderless identity — a lone
        surviving tail must not wait out a window no partner can ever
        fill."""
        counts = self._copack_counts(identities)
        with self._lock:
            for ident in counts:
                n = self._copack_active.get(ident, 0) - 1
                if n <= 0:
                    self._copack_active.pop(ident, None)
                else:
                    self._copack_active[ident] = n
        if self.scheduler is not None:
            for ident, n in counts.items():
                self.scheduler.pack_retire(self._pack_queue_key(ident), n)

    def copack_skip(self, identity):
        """Signal that one expected co-pack submitter resolved WITHOUT
        dispatching (all rows deduped/cached): riders parked on the
        identity must not keep waiting for a tail that never comes."""
        if self.scheduler is not None and self.copack_eligible(identity):
            self.scheduler.pack_arrived(self._pack_queue_key(identity))

    def copack_eligible(self, identity) -> bool:
        if not (self.copack and self.scheduler is not None
                and self.enable_batching):
            return False
        with self._lock:
            return identity in self._copack_active

    def copack_linger(self, model_ref: str) -> Optional[float]:
        """Calibrated expected-arrival window for a parked tail batch:
        under the latency objective, a fraction of the model's observed
        p50 request latency (floored at ``PACK_LINGER_MIN_S``, capped by
        the scheduler's configured ``pack_linger_s``).  None — meaning
        the scheduler's fixed window governs — when uncalibrated or
        when the session optimizes for cost (the density dial)."""
        if self.scheduler is None or self.objective != "latency":
            return None
        lat = self.calibrated_latency(model_ref, 50.0)
        if lat is None:
            return None
        return min(self.scheduler.pack_linger_s,
                   max(PACK_LINGER_MIN_S,
                       PACK_LINGER_LATENCY_FRACTION * lat))

    # ---- vector-index registry (retrieval plan operators) ------------------
    def lookup_index(self, key):
        """Session-local built-index lookup: ``key`` is ``(model ref,
        corpus fingerprint)``; None when no node built it yet."""
        with self._index_lock:
            return self._index_registry.get(key)

    def store_index(self, key, index):
        with self._index_lock:
            self._index_registry[key] = index

    def index_entries(self, model_ref: str) -> list:
        """(fingerprint, n_rows) for every session-built index of this
        model — the prefix-append candidates ``ensure_index`` matches a
        grown corpus against."""
        with self._index_lock:
            return [(fp, len(idx))
                    for (ref, fp), idx in self._index_registry.items()
                    if ref == model_ref]

    def index_cached(self, model_ref: str, fingerprint: str) -> bool:
        """Would a retrieval node over this (model, corpus) skip the
        corpus embed?  Feeds the optimizer's cost model (an index found
        in the session registry or the persistent sidecar makes the
        node's embed estimate queries-only)."""
        with self._index_lock:
            if (model_ref, fingerprint) in self._index_registry:
                return True
        return (self.index_store is not None
                and self.index_store.has(model_ref, fingerprint))

    # ---- selectivity bookkeeping (filter reordering) -----------------------
    def record_selectivity(self, prompt_id: str, passed: int, total: int):
        if total <= 0:
            return
        # snapshot + save stay under one lock: concurrent filter nodes
        # saving stale snapshots out of order would lose observations
        with self._sel_lock:
            s = self.selectivity_stats.setdefault(prompt_id, [0, 0])
            s[0] += passed
            s[1] += total
            # bounded observation window (drift detection): rescale so
            # old observations decay and a shifted distribution
            # re-learns within ~one window
            s[0], s[1] = bound_observations(s[0], s[1])
            self._sel_dirty = True
            self._save_selectivity_locked()

    def flush_selectivity(self):
        """Persist any selectivity observations the debounce deferred."""
        with self._sel_lock:
            self._save_selectivity_locked(force=True)

    def _save_selectivity_locked(self, force: bool = False):
        if self.selectivity_store is None or not self._sel_dirty:
            return
        now = time.monotonic()
        if not force and now - self._sel_last_save < \
                self._sel_save_interval:
            return
        self.selectivity_store.save(
            {k: list(v) for k, v in self.selectivity_stats.items()})
        self._sel_last_save = now
        self._sel_dirty = False

    def expected_selectivity(self, prompt_id: str,
                             default: float = 0.5) -> float:
        s = self.selectivity_stats.get(prompt_id)
        if not s or s[1] == 0:
            return default
        return s[0] / s[1]

    # ---- calibration bookkeeping (calibrated cost model) -------------------
    def record_calibration(self, model_ref: str, requests: int,
                           retries: int, tuples: int,
                           latencies: Sequence[float]):
        """Fold one dispatch's ``BatchStats`` into the per-model
        execution statistics (debounced sidecar write, like
        selectivity)."""
        if requests <= 0 and retries <= 0:
            return
        with self._cal_lock:
            rec = self.calibration_stats.setdefault(
                model_ref, {"requests": 0, "retries": 0, "tuples": 0,
                            "latency_s": []})
            rec["requests"] += requests
            rec["retries"] += retries
            rec["tuples"] += tuples
            # bounded counters: beyond the window old admissions decay,
            # so retry rate and mean batch size track the model's
            # CURRENT behaviour (headroom re-learns after a fix)
            total = rec["requests"] + rec["retries"]
            if total > CALIBRATION_COUNT_WINDOW:
                scale = CALIBRATION_COUNT_WINDOW / total
                for k in ("requests", "retries", "tuples"):
                    rec[k] = int(round(rec[k] * scale))
            rec["latency_s"].extend(float(x) for x in latencies)
            del rec["latency_s"][:-CALIBRATION_WINDOW]
            self._cal_dirty = True
            self._save_calibration_locked()

    def flush_calibration(self):
        """Persist any calibration observations the debounce deferred."""
        with self._cal_lock:
            self._save_calibration_locked(force=True)

    def _save_calibration_locked(self, force: bool = False):
        if self.calibration_store is None or not self._cal_dirty:
            return
        now = time.monotonic()
        if not force and now - self._cal_last_save < \
                self._sel_save_interval:
            return
        self.calibration_store.save(
            {ref: {"requests": r["requests"], "retries": r["retries"],
                   "tuples": r["tuples"],
                   "latency_s": list(r["latency_s"])}
             for ref, r in self.calibration_stats.items()})
        self._cal_last_save = now
        self._cal_dirty = False

    def flush_stats(self):
        """Force both debounced sidecars (selectivity + calibration) to
        disk.  ``Pipeline.collect()`` calls this once per plan
        execution; using the context as a ``with`` block flushes on
        exit."""
        self.flush_selectivity()
        self.flush_calibration()

    def calibrated_latency(self, model_ref: str,
                           pct: float = 50.0) -> Optional[float]:
        """Observed per-request latency percentile for a model, from the
        recorded execution statistics; None when uncalibrated."""
        rec = self.calibration_stats.get(model_ref)
        lat = rec["latency_s"] if rec else None
        if not lat:
            return None
        return float(np.percentile(np.asarray(lat, dtype=float), pct))

    def calibrated_retry_rate(self, model_ref: str) -> float:
        """Observed overflow-retry fraction: retries / (requests +
        retries), 0.0 when uncalibrated.  Inflates calibrated request
        estimates — a model that routinely overflows pays more waves
        than the batch plan alone predicts."""
        rec = self.calibration_stats.get(model_ref)
        if not rec:
            return 0.0
        total = rec["requests"] + rec["retries"]
        return rec["retries"] / total if total else 0.0

    def batch_headroom(self, model_ref: str) -> float:
        """Planning headroom for ``plan_batches`` — the calibration
        feedback path.  Snapshot at session start from the persisted
        execution statistics (see ``__init__``); 1.0 (full budget) for
        models with no recorded overflow history."""
        return self._headroom.get(model_ref, 1.0)

    def refresh_headroom(self):
        """Recompute the per-model headroom snapshot from the current
        in-session calibration statistics.  Call between plan executions
        (never mid-dispatch) — e.g. after a warmup pass in a benchmark —
        to apply observed retry rates without a session restart."""
        with self._cal_lock:
            self._headroom = {
                ref: headroom_factor(rec["requests"], rec["retries"])
                for ref, rec in self.calibration_stats.items()}

    # ---- lifecycle ---------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush_stats()
        return False

    # ---- resource resolution (name ref or inline spec) --------------------
    def resolve_model(self, spec: Dict[str, Any]) -> ModelResource:
        if "model_name" in spec:
            m = self.catalog.get_model(spec["model_name"])
            if m is None:
                raise KeyError(f"MODEL {spec['model_name']!r} not found")
            return m
        return ModelResource(
            name=spec.get("model", "inline"), version=0,
            arch=spec.get("arch", "mock"),
            context_window=int(spec.get("context_window", 4096)),
            max_output_tokens=int(spec.get("max_output_tokens", 32)),
            embedding_dim=int(spec.get("embedding_dim", 0)),
            max_concurrency=int(spec.get("max_concurrency", 4)))

    def resolve_prompt(self, spec: Dict[str, Any]) -> tuple[str, str]:
        """Returns (prompt_text, cache_identity)."""
        if "prompt_name" in spec:
            p = self.catalog.get_prompt(spec["prompt_name"])
            if p is None:
                raise KeyError(f"PROMPT {spec['prompt_name']!r} not found")
            return p.text, p.ref
        text = spec.get("prompt", "")
        return text, f"inline:{text}"


# ---------------------------------------------------------------------------
# map-function core, staged: dedup -> cache -> batch-plan -> dispatch
# ---------------------------------------------------------------------------
_LINE_RE = re.compile(r"^\s*(\d+)\s*:\s*(.*)$")


def _parse_rows(lines: Sequence[str], n: int) -> List[Optional[str]]:
    out: List[Optional[str]] = [None] * n
    for ln in lines:
        m = _LINE_RE.match(str(ln))
        if m and int(m.group(1)) < n:
            out[int(m.group(1))] = m.group(2).strip()
    return out


def _map_function(ctx: SemanticContext, kind: str, model_spec, prompt_spec,
                  tuples: Sequence[dict]) -> List[Optional[str]]:
    model = ctx.resolve_model(model_spec)
    prompt_text, prompt_id = ctx.resolve_prompt(prompt_spec)
    return _map_core(ctx, kind, model, prompt_text, prompt_id, tuples)


def _dedup_stage(ctx: SemanticContext, ser: Sequence[str]
                 ) -> tuple[List[str], List[int], List[int]]:
    """Stage 1 — predict only over distinct serialized inputs.

    Returns (order, first_idx, back): the distinct payloads in first-seen
    order, the original index carrying each, and the back-mapping from
    original positions to distinct positions."""
    if not ctx.enable_dedup:
        idx = list(range(len(ser)))
        return list(ser), idx, idx
    uniq: Dict[str, int] = {}
    order: List[str] = []
    first_idx: List[int] = []
    for i, s in enumerate(ser):
        if s not in uniq:
            uniq[s] = len(order)
            order.append(s)
            first_idx.append(i)
    return order, first_idx, [uniq[s] for s in ser]


def _cache_stage(ctx: SemanticContext, keys: Sequence[str],
                 rep: ExecutionReport
                 ) -> tuple[List[Optional[Any]], List[int]]:
    """Stage 2 — fill from the prediction cache; return the result slots
    plus the positions still needing a provider request."""
    results: List[Optional[Any]] = [None] * len(keys)
    todo: List[int] = []
    if not ctx.enable_cache:
        return results, list(range(len(keys)))
    for i, k in enumerate(keys):
        hit, val = ctx.cache.get(k)
        if hit:
            results[i] = val
            rep.cache_hits += 1
        else:
            todo.append(i)
    return results, todo


def _dispatch_stage(ctx: SemanticContext, model: ModelResource,
                    todo: List[int], keys: Sequence[str],
                    costs: List[int], prefix_tokens: int, call,
                    rep: ExecutionReport, pack_key=None, pack_rows=None,
                    pack_call=None) -> list:
    """Stage 3 — run the misses: batch-plan (with the model's calibrated
    headroom), then either hand the batches to the concurrent scheduler
    (overlapped per-model in-flight requests, single-flight key dedup,
    overflow split-and-requeue inside the engine) or fall back to the
    serial adaptive loop.  Both paths see identical batch plans and
    produce identical results and counts.  With a co-packable prefix
    identity active (``ctx.copack_eligible``), the scheduler may merge
    this dispatch's part-filled tail batch with another same-prefix
    job's — fewer, denser requests, same per-row results."""
    mb = ctx.max_batch if ctx.enable_batching else 1
    headroom = (ctx.batch_headroom(model.ref) if ctx.enable_batching
                else 1.0)
    window = (model.context_window if ctx.enable_batching
              else prefix_tokens + max(costs) + model.max_output_tokens + 1)
    if ctx.scheduler is not None:
        pack_kw = {}
        if pack_key is not None and ctx.copack_eligible(pack_key):
            pack_kw = dict(pack_key=pack_key, pack_rows=pack_rows,
                           pack_call=pack_call,
                           pack_linger=ctx.copack_linger(model.ref))
        job = ctx.scheduler.submit_map(
            model, [keys[i] for i in todo], costs, prefix_tokens, call,
            cache=ctx.cache if ctx.enable_cache else None,
            max_batch=mb, context_window=window,
            single_flight=ctx.enable_cache, headroom=headroom, **pack_kw)
        out, stats = job.result()
        rep.coalesced = job.coalesced
        rep.cache_hits += job.late_hits
        rep.packed = stats.packed
    else:
        out, stats = execute_serial(todo, costs, prefix_tokens, window,
                                    model.max_output_tokens, call,
                                    max_batch=mb, headroom=headroom)
        if ctx.enable_cache:
            for j, i in enumerate(todo):
                if out[j] is not None:
                    ctx.cache.put(keys[i], out[j])
    rep.requests, rep.retries, rep.nulls = (stats.requests, stats.retries,
                                            stats.nulls)
    rep.batch_sizes = stats.batch_sizes
    rep.latencies = stats.latencies
    ctx.record_calibration(model.ref, stats.requests, stats.retries,
                           sum(stats.batch_sizes), stats.latencies)
    return out


def _map_core(ctx: SemanticContext, kind: str, model: ModelResource,
              prompt_text: str, prompt_id: str,
              tuples: Sequence[dict]) -> List[Optional[str]]:
    rep = ExecutionReport(function=kind, n_tuples=len(tuples),
                          serialization=ctx.serialization)
    ctx.add_report(rep)
    if not tuples:
        return []

    ser = [serialize_tuple(t, ctx.serialization) for t in tuples]
    order, first_idx, back = _dedup_stage(ctx, ser)
    rep.n_unique = len(order)
    uniq_tuples = [tuples[i] for i in first_idx]

    keys = [cache_key(model.ref, prompt_id, kind, ctx.serialization, s)
            for s in order]
    results, todo = _cache_stage(ctx, keys, rep)

    if todo:
        prefix = build_prefix(kind, prompt_text, ctx.serialization)
        prefix_tokens = estimate_tokens(prefix)
        costs = [estimate_tokens(order[i]) for i in todo]

        # prefix identity: dispatches sharing this tuple render the SAME
        # static metaprompt prefix AND execute under the same model
        # limits, so their rows can ride one request (the scheduler's
        # co-packing stage; pipeline.copack_identity computes the
        # identical tuple from a plan node).  The provider instance and
        # the FULL resolved model (frozen dataclass — inline specs that
        # differ only in caps must not alias) are part of the identity.
        pack_key = (id(ctx.provider), model, kind, ctx.serialization,
                    prompt_text)
        pack_rows = [uniq_tuples[todo[j]] for j in range(len(todo))]

        def pack_call(rows: List[dict]) -> List[Optional[str]]:
            mp = build_metaprompt(kind, prompt_text, rows,
                                  ctx.serialization)
            raw = ctx.provider.complete(model, mp, len(rows))
            return _parse_rows(raw, len(rows))

        def call(batch_idx: List[int]) -> List[Optional[str]]:
            return pack_call([uniq_tuples[todo[j]] for j in batch_idx])

        out = _dispatch_stage(ctx, model, todo, keys, costs, prefix_tokens,
                              call, rep, pack_key=pack_key,
                              pack_rows=pack_rows, pack_call=pack_call)
        for j, i in enumerate(todo):
            results[i] = out[j]
    elif ctx.scheduler is not None:
        # nothing to dispatch (all cached/deduped) still counts as this
        # submitter's arrival: a rider parked on the shared identity
        # must not wait out its deadline for a tail that never comes
        ctx.copack_skip((id(ctx.provider), model, kind,
                         ctx.serialization, prompt_text))

    return [results[b] for b in back]


# ---------------------------------------------------------------------------
# public scalar functions
# ---------------------------------------------------------------------------
def llm_complete(ctx, model_spec, prompt_spec, tuples):
    return _map_function(ctx, "complete", model_spec, prompt_spec, tuples)


def llm_complete_json(ctx, model_spec, prompt_spec, tuples):
    raw = _map_function(ctx, "complete_json", model_spec, prompt_spec,
                        tuples)
    out = []
    for r in raw:
        try:
            out.append(json.loads(r) if r is not None else None)
        except json.JSONDecodeError:
            out.append(None)
    return out


_TRUE = {"true", "yes", "1"}


def llm_filter(ctx, model_spec, prompt_spec, tuples) -> List[bool]:
    raw = _map_function(ctx, "filter", model_spec, prompt_spec, tuples)
    mask = [str(r).strip().lower() in _TRUE if r is not None else False
            for r in raw]
    _, prompt_id = ctx.resolve_prompt(prompt_spec)
    ctx.record_selectivity(prompt_id, sum(mask), len(mask))
    rep = ctx.last_report()
    if rep is not None:
        rep.selectivity = sum(mask) / len(mask) if mask else None
    return mask


# ---------------------------------------------------------------------------
# fused multi-output pass (the plan optimizer's semantic-fusion rule)
# ---------------------------------------------------------------------------
MULTI_KINDS = ("filter", "complete", "complete_json")


def _decode_multi_value(kind: str, val) -> Any:
    if kind == "filter":
        if isinstance(val, bool):
            return val
        return str(val).strip().lower() in _TRUE
    if kind == "complete_json":
        if isinstance(val, (dict, list)):
            return val
        try:
            return json.loads(val) if val is not None else None
        except (json.JSONDecodeError, TypeError):
            return None
    return None if val is None else str(val)


def llm_multi(ctx, model_spec, subtasks: Sequence[dict],
              tuples: Sequence[dict]) -> List[List[Any]]:
    """One metaprompt pass answering several sub-tasks per tuple.

    ``subtasks`` is a list of ``{"kind": filter|complete|complete_json,
    "prompt": <prompt spec>}`` dicts sharing one model and one tuple
    schema.  Returns one result list per subtask, aligned with ``tuples``
    (filter -> bool, complete -> str|None, complete_json -> obj|None).
    """
    model = ctx.resolve_model(model_spec)
    kinds, texts, ids = [], [], []
    for st in subtasks:
        if st["kind"] not in MULTI_KINDS:
            raise ValueError(f"unfusable sub-task kind {st['kind']!r}")
        text, pid = ctx.resolve_prompt(st["prompt"])
        kinds.append(st["kind"])
        texts.append(text)
        ids.append(f"{st['kind']}:{pid}")
    prompt_text = build_multi_task(kinds, texts)
    prompt_id = "multi|" + "|".join(ids)
    raw = _map_core(ctx, "multi", model, prompt_text, prompt_id, tuples)

    per_task: List[List[Any]] = [[] for _ in subtasks]
    n_filters = [0] * len(subtasks)
    for r in raw:
        try:
            obj = json.loads(r) if r is not None else {}
        except json.JSONDecodeError:
            obj = {}
        if not isinstance(obj, dict):
            obj = {}
        for k, kind in enumerate(kinds):
            v = _decode_multi_value(kind, obj.get(f"t{k}"))
            per_task[k].append(v)
            if kind == "filter" and v:
                n_filters[k] += 1
    for k, kind in enumerate(kinds):
        if kind == "filter":
            ctx.record_selectivity(ids[k].split(":", 1)[1],
                                   n_filters[k], len(tuples))
    return per_task


def embedding_pack_key(ctx: SemanticContext, model: ModelResource):
    """Metaprompt-prefix identity of an embedding dispatch.  Embeddings
    have no prompt and no serialization framing (raw text payloads), so
    two dispatches co-pack exactly when they target the same provider
    and the same fully-resolved model — mirrored by
    ``pipeline.copack_identity`` for ``llm_embedding`` plan nodes and by
    the retrieval operators' corpus/query embed pairing."""
    return (id(ctx.provider), model, "embedding", "raw", "")


def llm_embedding(ctx, model_spec, tuples) -> np.ndarray:
    """Embedding with dedup + cache (no prompt; paper: 48x from batching).

    Shares the staged path: dedup -> cache -> batch-plan -> dispatch.
    Batches are planned by ``plan_batches`` against the model's context
    window with its calibrated headroom (embeddings decode no output
    tokens, so the whole budget is payload) — NOT shipped as one
    unplanned mega-batch — and per-batch stats feed the calibration
    sidecar, so the cost model learns embedding batch sizes too.  With
    a scheduler the embed batches ride the same concurrent engine (and
    single-flight registry) as the chat-completion map functions, and a
    part-filled tail batch may co-pack with another embed dispatch that
    shares this model (``embedding_pack_key``)."""
    model = ctx.resolve_model(model_spec)
    rep = ExecutionReport(function="embedding", n_tuples=len(tuples),
                          serialization=ctx.serialization)
    ctx.add_report(rep)
    texts = [serialize_tuple(t, ctx.serialization) if isinstance(t, dict)
             else str(t) for t in tuples]
    order, _, back = _dedup_stage(ctx, texts)
    rep.n_unique = len(order)
    keys = [cache_key(model.ref, "", "embedding", "raw", t) for t in order]
    vecs, todo = _cache_stage(ctx, keys, rep)
    if todo:
        costs = [estimate_tokens(order[i]) for i in todo]
        mb = ctx.max_batch if ctx.enable_batching else 1
        headroom = (ctx.batch_headroom(model.ref) if ctx.enable_batching
                    else 1.0)
        window = model.context_window

        def run(positions: List[int]) -> List[list]:
            em = ctx.provider.embed(model,
                                    [order[todo[p]] for p in positions])
            return [em[j].tolist() for j in range(len(positions))]

        if ctx.scheduler is not None:
            def plan(owned: List[int]) -> List[List[int]]:
                bp = plan_batches([costs[p] for p in owned], 0, window,
                                  0, mb, headroom=headroom)
                return [[owned[j] for j in b] for b in bp.batches]

            pack = None
            pack_key = embedding_pack_key(ctx, model)
            if ctx.copack_eligible(pack_key):
                def pack_call(rows: List[str]) -> List[list]:
                    em = ctx.provider.embed(model, rows)
                    return [em[j].tolist() for j in range(len(rows))]

                pack = {"key": pack_key,
                        "rows": [order[i] for i in todo],
                        "call": pack_call,
                        "budget": int(window * headroom),
                        "max_batch": mb, "weights": costs,
                        "linger_s": ctx.copack_linger(model.ref)}
            job = ctx.scheduler.submit(
                model, [keys[i] for i in todo], run,
                cache=ctx.cache if ctx.enable_cache else None,
                single_flight=ctx.enable_cache, plan=plan, pack=pack)
            out, stats = job.result()
            rep.coalesced = job.coalesced
            rep.cache_hits += job.late_hits
            rep.packed = stats.packed
        else:
            out, stats = execute_serial(todo, costs, 0, window, 0, run,
                                        max_batch=mb, headroom=headroom)
            if ctx.enable_cache:
                for j, i in enumerate(todo):
                    if out[j] is not None:
                        ctx.cache.put(keys[i], out[j])
        rep.requests, rep.retries = stats.requests, stats.retries
        rep.batch_sizes = stats.batch_sizes
        rep.latencies = stats.latencies
        ctx.record_calibration(model.ref, stats.requests, stats.retries,
                               sum(stats.batch_sizes), stats.latencies)
        for j, i in enumerate(todo):
            vecs[i] = out[j]
    elif ctx.scheduler is not None:
        # fully cache-served embed dispatch: still signal arrival so a
        # rider parked on the shared embedding identity flushes now
        ctx.copack_skip(embedding_pack_key(ctx, model))
    return np.asarray([vecs[b] for b in back], np.float32)


# ---------------------------------------------------------------------------
# aggregate functions
# ---------------------------------------------------------------------------
def llm_reduce(ctx, model_spec, prompt_spec, tuples,
               kind: str = "reduce") -> Optional[str]:
    model = ctx.resolve_model(model_spec)
    prompt_text, prompt_id = ctx.resolve_prompt(prompt_spec)
    mp = build_metaprompt(kind, prompt_text, list(tuples),
                          ctx.serialization)
    key = cache_key(model.ref, prompt_id, kind, ctx.serialization,
                    mp.suffix)
    if ctx.enable_cache:
        hit, val = ctx.cache.get(key)
        if hit:
            return val
    out = ctx.provider.complete(model, mp, 1)
    val = out[0] if out else None
    if ctx.enable_cache and val is not None:
        ctx.cache.put(key, val)
    return val


def llm_reduce_json(ctx, model_spec, prompt_spec, tuples):
    raw = llm_reduce(ctx, model_spec, prompt_spec, tuples,
                     kind="reduce_json")
    try:
        return json.loads(raw) if raw is not None else None
    except json.JSONDecodeError:
        return None


def llm_rerank(ctx, model_spec, prompt_spec, tuples,
               window: int = 10, stride: int = 5) -> List[int]:
    """Zero-shot listwise rerank (Ma et al. [arXiv:2305.02156]): sliding
    windows from the tail so the best candidates bubble to the front.
    Returns a permutation of tuple indices, most relevant first."""
    model = ctx.resolve_model(model_spec)
    prompt_text, prompt_id = ctx.resolve_prompt(prompt_spec)
    n = len(tuples)
    perm = list(range(n))
    if n <= 1:
        return perm

    def rank_window(idxs: List[int]) -> List[int]:
        rows = [tuples[i] for i in idxs]
        mp = build_metaprompt("rerank", prompt_text, rows, ctx.serialization)
        key = cache_key(model.ref, prompt_id, "rerank", ctx.serialization,
                        mp.suffix)
        if ctx.enable_cache:
            hit, val = ctx.cache.get(key)
            if hit:
                return [idxs[j] for j in val]
        raw = ctx.provider.complete(model, mp, 1)
        order = _parse_permutation(raw[0] if raw else "", len(idxs))
        if ctx.enable_cache:
            ctx.cache.put(key, order)
        return [idxs[j] for j in order]

    start = max(0, n - window)
    while True:
        seg = perm[start:start + window]
        perm[start:start + window] = rank_window(seg)
        if start == 0:
            break
        start = max(0, start - stride)
    return perm


def _parse_permutation(raw: str, n: int) -> List[int]:
    seen, order = set(), []
    for tok in re.split(r"[^\d]+", str(raw)):
        if tok and tok.isdigit():
            i = int(tok)
            if 0 <= i < n and i not in seen:
                order.append(i)
                seen.add(i)
    order += [i for i in range(n) if i not in seen]
    return order


def llm_first(ctx, model_spec, prompt_spec, tuples):
    perm = llm_rerank(ctx, model_spec, prompt_spec, tuples)
    return tuples[perm[0]] if tuples else None


def llm_last(ctx, model_spec, prompt_spec, tuples):
    perm = llm_rerank(ctx, model_spec, prompt_spec, tuples)
    return tuples[perm[-1]] if tuples else None
