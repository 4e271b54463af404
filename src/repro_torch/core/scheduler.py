"""Async provider scheduler: staged, concurrent dispatch of LLM requests.

PR 1's optimizer cut *how many* requests a plan issues (batching, caching,
dedup, fusion); this module cuts *how long* they take.  The monolithic
``dedup -> cache -> batch -> provider`` loop becomes explicit stages, and
the provider stage runs on a bounded worker pool so wall-clock tracks the
provider's concurrency limit instead of the batch count — the DBMS, not
the user, hides provider latency behind concurrent in-flight requests
(arXiv:2508.20912 §3, arXiv:2402.02643 §4).

Pieces:

  * ``RequestScheduler`` — one per ``SemanticContext`` (opt-in via the
    ``scheduler=`` knob; ``None`` keeps the serial path bit-identical).
    Owns a thread pool sized ``max_workers`` and a per-model semaphore
    honouring ``ModelResource.max_concurrency``.
  * dispatch queue — any number of plan nodes submit batch-request jobs
    concurrently; batches from different jobs interleave freely on the
    pool, so independent plan nodes overlap end-to-end.
  * single-flight dedup — identical cache keys submitted by concurrent
    jobs issue ONE provider request; late submitters attach to the
    in-flight entry and read its value when it resolves.
  * co-packing stage — jobs submitted via ``submit_map`` with a pack
    identity (model + metaprompt prefix) park their part-filled TAIL
    batch in a short-lived per-(model, prefix) packing queue instead of
    dispatching it immediately; tails from different jobs that share
    the prefix merge into one provider request (results demultiplexed
    back to each owning job), so the context window stays dense when
    many plan nodes dispatch concurrently.  The queue is LATENCY-FIRST:
    callers register how many same-identity submitters are in flight
    (``pack_expect``/``pack_retire``, driven by the context's
    ``copack_begin``/``copack_end`` refcounts), every arriving
    submitter decrements the expectation, and the pack flushes the
    moment the LAST expected tail lands (or the identity retires) —
    merging costs no wall-clock when all riders show up.  A parked
    segment is additionally bounded by a per-pack deadline: the
    calibrated expected-arrival window (``pack["linger_s"]``, derived
    from the model's observed request latency) when known, the
    configured ``pack_linger_s`` cap otherwise — so no tail is ever
    older than the window before dispatching exactly as it would have
    unpacked.  Overflow-split remainders re-enter the same queue when
    a mergeable partner is still plausible.  Per-tuple results are
    independent of batch composition, so merged execution is
    bit-identical to unpacked.
  * ``SpeculativeJoin`` — the bounded fan-out/join group behind every
    speculative plan rewrite (filter chains, map-past-filter,
    retrieval-aware rerank): heterogeneous speculative tasks (mask
    thunks, row completions, rerank warmups) run concurrently on a
    small set of dedicated runner threads, capped in count and in
    total in-flight rows so deep chains cannot oversubscribe past the
    scheduler's worker pool; a task that has not started yet can be
    **cancelled** the moment an upstream mask proves its rows dead,
    and never reaches the provider.  ``SpeculativeMaskJoin`` survives
    as the mask-specific facade.  The extra requests are bounded by
    recorded selectivity (the optimizer's wasted-request budget) and
    identical keys still coalesce through the single-flight registry.
  * adaptive overflow — ``ContextOverflowError`` splits the batch 10%
    (the paper §2.3 protocol) and requeues both halves on the pool; a
    single tuple that still overflows resolves to NULL.  The same split
    loop drives the serial fallback (``execute_serial``), so the two
    paths produce identical results, request counts and token counts —
    with one stats-only exception: a borrower of an overflow-NULLed key
    adopts the NULL (counted in its ``nulls``) instead of re-issuing a
    request that would fail identically, so its request/retry counts
    can undercut a strictly serial run of that pathological workload.

A copy of ``repro/core/scheduler.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from .batching import BatchStats, ContextOverflowError, plan_batches
from .resources import ModelResource

# Lock discipline (checked by tools/flocklint.py): every lock here is a
# leaf — no code path holds two at once, and provider dispatch / pool
# joins happen strictly outside lock bodies.  If nesting ever becomes
# necessary it must follow this acquisition order:
# flocklint: lock-order: _pack_lock < _lock < job._lock < scheduler._lock


def split_batch(batch: List[int]) -> tuple[List[int], List[int]]:
    """Adaptive 10% shrink: (head to retry, tail to requeue)."""
    keep = max(1, len(batch) - max(1, len(batch) // 10))
    return batch[:keep], batch[keep:]


def execute_serial(indices: Sequence, token_costs: Sequence[int],
                   prefix_tokens: int, context_window: int,
                   max_output_tokens: int,
                   call: Callable[[List[int]], list],
                   max_batch: int = 0,
                   headroom: float = 1.0) -> tuple[list, BatchStats]:
    """The scheduler-free fallback: plan batches, run them one at a time
    under the adaptive overflow protocol.  ``call(positions)`` receives
    positions into ``indices`` and returns per-position results."""
    results: list = [None] * len(indices)
    stats = BatchStats()
    plan = plan_batches(token_costs, prefix_tokens, context_window,
                        max_output_tokens, max_batch, headroom=headroom)
    work = list(plan.batches)
    while work:
        batch = work.pop(0)
        try:
            t0 = time.monotonic()
            out = call(batch)
            stats.latencies.append(time.monotonic() - t0)
            stats.requests += 1
            stats.batch_sizes.append(len(batch))
            for idx, val in zip(batch, out):
                results[idx] = val
        except ContextOverflowError:
            stats.retries += 1
            if len(batch) == 1:
                results[batch[0]] = None       # single tuple too large
                stats.nulls += 1
                continue
            head, tail = split_batch(batch)
            work.insert(0, tail)
            work.insert(0, head)
    return results, stats


# ---------------------------------------------------------------------------
# single-flight registry
# ---------------------------------------------------------------------------
class _InflightEntry:
    """One in-flight cache key.  The owning job resolves it; borrowing
    jobs block on the event instead of issuing a duplicate request.  If
    the owning request errored, borrowers re-raise instead of treating
    the missing value as a legitimate NULL."""
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None

    def resolve(self, value):
        self.value = value
        self.event.set()

    def resolve_error(self, exc: BaseException):
        self.error = exc
        self.event.set()


class _ModelGate:
    """Admission gate bounding one model's in-flight requests.

    Non-blocking by design: a batch that cannot enter is parked on the
    gate's pending queue and handed back when a slot frees, so pool
    threads never sleep waiting for a busy model — one low-concurrency
    model with a deep queue cannot starve other models' jobs out of the
    worker pool.

    Unlike a plain semaphore the limit can shrink after creation: when
    the same model resource is resolved with different
    ``max_concurrency`` values, the most restrictive one wins (exceeding
    the smallest advertised cap is never safe against a rate-limited
    provider)."""

    def __init__(self, limit: int):
        self._lock = threading.Lock()
        self.limit = max(1, limit)
        self.active = 0
        self.pending: List = []          # deferred (job, batch) tasks

    def shrink_to(self, limit: int):
        with self._lock:
            self.limit = max(1, min(self.limit, limit))

    def try_acquire(self, task) -> bool:
        """Take a slot, or park ``task`` for redelivery on release."""
        with self._lock:
            if self.active < self.limit:
                self.active += 1
                return True
            self.pending.append(task)
            return False

    def release_and_next(self):
        """Free the slot; if work is parked, keep the slot and return
        the next task for the caller to run inline.  A slot is only
        handed off while ``active`` respects the (possibly shrunk)
        limit — excess in-flight slots drain instead, so 'most
        restrictive wins' holds even mid-queue."""
        with self._lock:
            if self.pending and self.active <= self.limit:
                return self.pending.pop(0)
            self.active -= 1
            return None


# co-packing thresholds: a tail batch enters the packing queue only when
# its fill fraction leaves room worth merging into, and a merged batch
# this full dispatches immediately instead of waiting out the linger
_PACK_FILL_MAX = 0.85
_PACK_FLUSH_FILL = 0.9

# deadline policy for parked tails: with calibration data a rider is
# expected within ~one request service time (concurrently-dispatched
# group members start together), so the expected-arrival window is a
# fraction of the model's observed p50 request latency — floored so
# timer granularity cannot starve a real rider, and always capped by
# the scheduler's configured ``pack_linger_s`` (the uncalibrated
# fallback and hard upper bound)
PACK_LINGER_LATENCY_FRACTION = 0.5
PACK_LINGER_MIN_S = 0.002


class _PackSegment:
    """One job's parked tail batch inside a pending co-pack."""
    __slots__ = ("job", "positions", "rows", "weight")

    def __init__(self, job, positions, rows, weight):
        self.job = job
        self.positions = positions      # job-local positions (into keys)
        self.rows = rows                # provider-facing row payloads
        self.weight = weight            # budget weight (prompt + output)


class _PendingPack:
    """A short-lived per-(model, prefix) packing-queue entry: part-filled
    tail batches accumulate here until the merged batch is dense enough,
    the last expected same-identity rider arrives, or the per-pack
    deadline expires.  ``deadline`` is fixed at creation (merging never
    extends it), so no parked segment is ever older than one window."""
    __slots__ = ("key", "model", "budget", "max_batch", "call",
                 "segments", "tokens", "flushed", "timer", "deadline")

    def __init__(self, key, model, budget, max_batch, call, segment):
        self.key = key
        self.model = model
        self.budget = budget
        self.max_batch = max_batch
        self.call = call                # rows -> per-row results
        self.segments: List[_PackSegment] = [segment]
        self.tokens = segment.weight
        self.flushed = False
        self.timer: Optional[threading.Timer] = None
        self.deadline: float = 0.0      # monotonic flush-by time

    def size(self) -> int:
        return sum(len(s.positions) for s in self.segments)


@dataclass
class SchedulerStats:
    jobs: int = 0
    requests: int = 0
    retries: int = 0
    nulls: int = 0
    coalesced: int = 0          # keys served by another job's request
    max_inflight: int = 0       # peak concurrently-executing requests
    packed_requests: int = 0    # merged (co-packed) provider requests
    packed_batches: int = 0     # tail batches folded into merged requests
    repacked_tails: int = 0     # overflow-split remainders re-queued
    #                             into the packing queue
    spec_dispatched: int = 0    # speculative tasks that started running
    spec_cancelled: int = 0     # speculative tasks dropped before dispatch
    #                             (their rows were proven dead upstream)
    spec_wasted_rows: int = 0   # rows speculated on that the serial plan
    #                             would never have evaluated

    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, **deltas: int):
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)


class DispatchJob:
    """Future for one submitted batch-request job (one plan-node stage).

    ``result()`` blocks until every owned batch has executed (including
    overflow requeues) and every borrowed key has been resolved by its
    owning job, then returns ``(values, stats)`` aligned with the
    submitted key list.  ``coalesced`` counts borrowed keys."""

    def __init__(self, scheduler: "RequestScheduler", keys: Sequence[str],
                 run: Callable[[List[int]], list], model: ModelResource,
                 cache=None):
        self.scheduler = scheduler
        self.keys = list(keys)
        self.run = run
        self.model = model
        self.cache = cache
        self.pack: Optional[dict] = None    # co-pack opts (set by submit)
        self.values: List = [None] * len(self.keys)
        self.stats = BatchStats()
        self.coalesced = 0      # keys served by another job's request
        self.late_hits = 0      # keys found in cache at submit time
        self._borrowed: List[tuple[int, _InflightEntry]] = []
        self._owned_entries: Dict[int, _InflightEntry] = {}
        self._lock = threading.Lock()
        self._pending = 0
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    # ---- owner-side bookkeeping (called by scheduler workers) -------------
    def _batch_started(self, n: int = 1):
        with self._lock:
            self._pending += n

    def _batch_finished(self):
        with self._lock:
            self._pending -= 1
            if self._pending <= 0:
                self._done.set()

    def _fail(self, exc: BaseException):
        with self._lock:
            self._error = exc
            self._pending = 0
            self._done.set()
        # release owned single-flight entries so borrower jobs waiting on
        # this job's keys unblock — carrying the error, not a silent None
        for pos, entry in self._owned_entries.items():
            if not entry.event.is_set():
                entry.resolve_error(exc)
                key = self.keys[pos]
                with self.scheduler._lock:
                    if self.scheduler._inflight.get(key) is entry:
                        del self.scheduler._inflight[key]

    # ---- consumer side ----------------------------------------------------
    def result(self, timeout: Optional[float] = None
               ) -> tuple[list, BatchStats]:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        if not self._done.wait(timeout):
            raise TimeoutError("scheduler job did not complete in time")
        if self._error is not None:
            raise self._error
        for pos, entry in self._borrowed:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not entry.event.wait(remaining):
                raise TimeoutError(
                    "borrowed in-flight key did not resolve in time")
            if entry.error is not None:
                raise entry.error
            self.values[pos] = entry.value
            if entry.value is None:
                # the owner overflow-nulled this key; adopt the NULL and
                # account for it (the serial path would re-issue, fail
                # the same way, and count a null of its own)
                self.stats.nulls += 1
        return self.values, self.stats


class RequestScheduler:
    """Bounded concurrent dispatch engine shared by all plan nodes of a
    session.  Construct once, pass as ``SemanticContext(scheduler=...)``;
    ``shutdown()`` (or use as a context manager) drains the pool."""

    def __init__(self, max_workers: int = 16,
                 pack_linger_s: float = 0.02):
        self.max_workers = max_workers
        # how long a part-filled tail batch waits in the packing queue
        # for a same-prefix partner before dispatching alone
        self.pack_linger_s = pack_linger_s
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="flockjax-sched")
        self._lock = threading.Lock()
        self._inflight: Dict[str, _InflightEntry] = {}
        self._gates: Dict[str, _ModelGate] = {}
        self._packs: Dict[tuple, _PendingPack] = {}
        # rider-expectation registry: pack key -> outstanding same-
        # identity submitters announced via pack_expect().  Every
        # arriving submitter decrements; at zero no mergeable rider can
        # be in flight, so the parked pack flushes immediately (last-
        # tail-out).  Keys never registered stay in "unknown" mode and
        # fall back to pure deadline-based lingering.
        self._pack_expected: Dict[tuple, int] = {}
        self._pack_lock = threading.Lock()
        self._executing = 0
        self.stats = SchedulerStats()

    # ---- lifecycle ---------------------------------------------------------
    def shutdown(self, wait: bool = True):
        # flush parked tails first: their jobs' result() calls would
        # otherwise hang on batches the pool will never run
        with self._pack_lock:
            pending = list(self._packs.values())
        for p in pending:
            self._flush_pack(p)
        self._pool.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # ---- per-model concurrency gate ---------------------------------------
    def _model_gate(self, model: ModelResource) -> _ModelGate:
        limit = max(1, int(getattr(model, "max_concurrency", 1) or 1))
        with self._lock:
            gate = self._gates.get(model.ref)
            if gate is None:
                gate = _ModelGate(limit)
                self._gates[model.ref] = gate
            else:
                gate.shrink_to(limit)
            return gate

    # ---- submission --------------------------------------------------------
    def submit(self, model: ModelResource, keys: Sequence[str],
               run: Callable[[List[int]], list],
               batches: Optional[Sequence[List[int]]] = None, cache=None,
               single_flight: bool = True,
               plan: Optional[Callable[[List[int]],
                                       List[List[int]]]] = None,
               pack: Optional[dict] = None) -> DispatchJob:
        """Enqueue pre-planned ``batches`` (position lists into ``keys``)
        for concurrent execution.  With ``single_flight``, positions
        whose key is already in flight (submitted by ANOTHER job) are
        coalesced instead of re-issued, and positions whose key landed
        in ``cache`` since the caller's lookup are served from it —
        exactly the requests a serialized execution would have saved as
        cache hits, so request counts match the serial path.

        Duplicate keys WITHIN one job never self-coalesce (they only
        exist with dedup disabled, where the serial path issues every
        duplicate), and callers that disabled caching must pass
        ``single_flight=False``: coalescing is an extension of the
        prediction cache, and without it a borrower would share
        responses the caller asked to keep independent.

        ``plan`` (owned positions -> batches), when given, re-plans the
        batches AFTER coalescing so the surviving positions pack densely
        — filtering borrowed keys out of pre-planned ``batches`` would
        leave sparse batches and more requests than the serial path.

        ``pack`` opts the job's part-filled TAIL batch into the cross-job
        co-packing queue: ``{"key": prefix identity, "rows": per-position
        provider payloads, "call": rows -> per-row results, "weights":
        per-position budget weights, "budget": packed-request budget,
        "max_batch": per-request tuple cap}``.  Tails from different
        jobs sharing ``(model.ref, key)`` merge into one provider
        request, demultiplexed back by position."""
        job = DispatchJob(self, keys, run, model, cache)
        self.stats.add(jobs=1)

        owned_pos: set[int] = set()
        if not single_flight:
            owned_pos = set(range(len(job.keys)))
        else:
            # duplicate keys within a job (dedup disabled) inherit the
            # first occurrence's disposition: borrowed and late-hit
            # firsts would be cache hits for every duplicate on the
            # serial path (0 requests), owned firsts would be misses
            # for every duplicate (all requested) — count parity holds
            # either way
            disposition: Dict[str, tuple] = {}
            with self._lock:
                for pos, key in enumerate(job.keys):
                    disp = disposition.get(key)
                    if disp is None:
                        entry = self._inflight.get(key)
                        if entry is not None:
                            disp = ("borrow", entry)
                        else:
                            disp = ("own", None)
                            if cache is not None:
                                # landed in the cache since the
                                # caller's lookup: a late hit, not
                                # in-flight sharing
                                hit, val = cache.peek(key)
                                if hit:
                                    disp = ("hit", val)
                            if disp[0] == "own":
                                entry = _InflightEntry()
                                self._inflight[key] = entry
                                job._owned_entries[pos] = entry
                        disposition[key] = disp
                    kind, payload = disp
                    if kind == "borrow":
                        job._borrowed.append((pos, payload))
                    elif kind == "hit":
                        job.values[pos] = payload
                        job.late_hits += 1
                    else:
                        owned_pos.add(pos)
            if job._borrowed:
                job.coalesced = len(job._borrowed)
                self.stats.add(coalesced=len(job._borrowed))

        if plan is not None:
            owned_batches = plan(sorted(owned_pos)) if owned_pos else []
        else:
            owned_batches = [[p for p in b if p in owned_pos]
                             for b in (batches or [])]
            owned_batches = [b for b in owned_batches if b]
        parked: Optional[List[int]] = None
        job.pack = pack         # kept for overflow-remainder repacking
        if pack is not None and owned_batches:
            tail = owned_batches[-1]
            tail_w = sum(pack["weights"][p] for p in tail)
            if tail_w <= _PACK_FILL_MAX * pack["budget"]:
                parked = tail
                owned_batches = owned_batches[:-1]
        if not owned_batches and parked is None:
            # this submitter arrived with nothing to park (all coalesced
            # / cached, or a too-full tail of zero batches): riders
            # parked on the identity must not keep waiting for it
            if pack is not None:
                self.pack_arrived((model.ref, pack["key"]))
            job._done.set()
            return job
        job._batch_started(len(owned_batches) + (parked is not None))
        try:
            for b in owned_batches:
                self._pool.submit(self._run_batch, job, b)
        except BaseException as exc:  # flocklint: ignore[FLKL105]
            # e.g. pool already shut down: _fail releases this job's
            # registered in-flight entries (with the error) so no later
            # borrower hangs on them, then the caller sees the error
            job._fail(exc)
            raise
        if parked is not None:
            self._register_pack(job, parked, pack)
        elif pack is not None:
            # dispatched everything as full batches: still an arrival
            self.pack_arrived((model.ref, pack["key"]))
        return job

    def submit_map(self, model: ModelResource, keys: Sequence[str],
                   token_costs: Sequence[int], prefix_tokens: int,
                   run: Callable[[List[int]], list], cache=None,
                   max_batch: int = 0,
                   context_window: Optional[int] = None,
                   single_flight: bool = True, headroom: float = 1.0,
                   pack_key=None,
                   pack_rows: Optional[Sequence] = None,
                   pack_call: Optional[Callable[[list], list]] = None,
                   pack_linger: Optional[float] = None
                   ) -> DispatchJob:
        """Dispatch with context-window batch planning that runs AFTER
        single-flight coalescing, so the positions this job actually
        owns pack as densely as a serial execution would.

        ``headroom`` (from ``SemanticContext.batch_headroom``) shrinks
        the planned budget for models with observed overflow retries.
        ``pack_key``/``pack_rows``/``pack_call`` opt the job's
        part-filled tail batch into cross-job co-packing: ``pack_key``
        is the metaprompt-prefix identity shared by co-packable jobs,
        ``pack_rows[p]`` the provider payload for position ``p``, and
        ``pack_call(rows)`` one provider request over rows drawn from
        any number of same-prefix jobs.  ``pack_linger`` overrides the
        scheduler's default deadline for a tail parked by THIS job —
        the calibrated expected-arrival window — and never exceeds it
        in practice (callers clamp to ``pack_linger_s``)."""
        window = (context_window if context_window is not None
                  else model.context_window)

        def plan(owned: List[int]) -> List[List[int]]:
            bp = plan_batches([token_costs[p] for p in owned],
                              prefix_tokens, window,
                              model.max_output_tokens, max_batch,
                              headroom=headroom)
            return [[owned[j] for j in b] for b in bp.batches]

        pack = None
        if (pack_key is not None and pack_rows is not None
                and pack_call is not None):
            budget = int((window - prefix_tokens) * headroom)
            if budget > 0:
                pack = {"key": pack_key, "rows": pack_rows,
                        "call": pack_call, "budget": budget,
                        "max_batch": max_batch,
                        "linger_s": pack_linger,
                        "weights": [c + model.max_output_tokens
                                    for c in token_costs]}
        return self.submit(model, keys, run, cache=cache,
                           single_flight=single_flight, plan=plan,
                           pack=pack)

    # ---- co-packing stage --------------------------------------------------
    def pack_expect(self, key, n: int = 1):
        """Announce ``n`` same-identity submitters about to dispatch
        under pack ``key`` (``(model.ref, identity)``).  Driven by the
        context's ``copack_begin``: while the expectation is positive a
        parked pack lingers for its riders; once every expected
        submitter has arrived it flushes immediately."""
        if n <= 0:
            return
        with self._pack_lock:
            self._pack_expected[key] = self._pack_expected.get(key, 0) + n

    def pack_arrived(self, key):
        """One expected submitter has dispatched (or resolved with
        nothing to send).  When it was the last one, no mergeable rider
        can still be in flight — flush any pack parked under the key."""
        to_flush = None
        with self._pack_lock:
            if self._pack_note_arrival_locked(key) is True:
                to_flush = self._packs.get(key)
        if to_flush is not None:
            self._flush_pack(to_flush)

    def pack_retire(self, key, n: int = 1):
        """Withdraw up to ``n`` outstanding expectations (the group
        closed; some registered submitters never dispatched).  An
        identity with no expectations left cannot receive a rider, so a
        pack still parked under it flushes immediately instead of
        waiting out its deadline."""
        to_flush = None
        with self._pack_lock:
            cur = self._pack_expected.get(key)
            if cur is not None:
                cur -= n
                if cur > 0:
                    self._pack_expected[key] = cur
                else:
                    self._pack_expected.pop(key, None)
                    cur = 0
            if not cur:
                to_flush = self._packs.get(key)
        if to_flush is not None:
            self._flush_pack(to_flush)

    def _pack_note_arrival_locked(self, key) -> Optional[bool]:
        """Decrement the rider expectation for ``key`` (caller holds
        ``_pack_lock``).  True = that was the last expected submitter;
        False = riders still outstanding; None = key never registered
        (unknown mode: deadline-based lingering governs)."""
        n = self._pack_expected.get(key)
        if n is None:
            return None
        n -= 1
        if n <= 0:
            self._pack_expected.pop(key, None)
            return True
        self._pack_expected[key] = n
        return False

    def _register_pack(self, job: DispatchJob, positions: List[int],
                       pack: dict, arrival: bool = True,
                       opportunistic: bool = False) -> bool:
        """Park a part-filled tail batch in the per-(model, prefix)
        packing queue.  Merges into an already-parked compatible entry
        when the combined batch fits the budget; flushes immediately
        once the merged batch is dense enough OR the last expected
        same-identity submitter has arrived (last-tail-out), otherwise
        the per-pack deadline timer dispatches whatever accumulated.

        ``arrival=False`` registers without consuming a rider
        expectation (overflow-split remainders: their job already
        arrived at submit time).  ``opportunistic=True`` refuses to
        park — returns False — unless a pending pack or outstanding
        expectation makes a merge plausible, so a remainder with no
        conceivable partner requeues as a plain batch instead of
        idling until the deadline."""
        seg = _PackSegment(job, positions,
                           [pack["rows"][p] for p in positions],
                           sum(pack["weights"][p] for p in positions))
        key = (job.model.ref, pack["key"])
        flushes: List[_PendingPack] = []
        with self._pack_lock:
            if opportunistic and (key not in self._packs
                                  and self._pack_expected.get(key, 0)
                                  <= 0):
                return False
            last = (self._pack_note_arrival_locked(key) if arrival
                    else None)
            pending = self._packs.get(key)
            if pending is not None:
                fits = (pending.tokens + seg.weight
                        <= min(pending.budget, pack["budget"]))
                size = pending.size() + len(positions)
                for cap in (pending.max_batch, pack["max_batch"]):
                    if cap and size > cap:
                        fits = False
                if fits:
                    pending.segments.append(seg)
                    pending.tokens += seg.weight
                    pending.budget = min(pending.budget, pack["budget"])
                    if pack["max_batch"] and (not pending.max_batch
                                              or pack["max_batch"]
                                              < pending.max_batch):
                        pending.max_batch = pack["max_batch"]
                    if self._pack_is_full(pending) or last is True:
                        flushes.append(pending)
                    pending = seg = None
                else:
                    flushes.append(pending)  # full: dispatch, repark
                    pending = None
            if seg is not None and pending is None:
                pending = _PendingPack(key, job.model, pack["budget"],
                                       pack["max_batch"], pack["call"],
                                       seg)
                linger = float(pack.get("linger_s")
                               or self.pack_linger_s)
                pending.deadline = time.monotonic() + linger
                if last is True:
                    # the last expected submitter has no one to wait
                    # for: dispatch its lone tail without parking
                    flushes.append(pending)
                else:
                    self._packs[key] = pending
                    pending.timer = threading.Timer(
                        linger, self._flush_pack, (pending,))
                    pending.timer.daemon = True
                    pending.timer.start()
        for p in flushes:
            self._flush_pack(p)
        return True

    def _maybe_repack(self, job: DispatchJob,
                      positions: List[int]) -> bool:
        """Route an overflow-split remainder back into the packing
        queue when its job co-packs and a mergeable partner is still
        plausible (pending pack or outstanding rider expectation).
        Returns False — caller requeues as a plain batch — otherwise."""
        pack = job.pack
        if not pack or pack.get("budget", 0) <= 0:
            return False
        weight = sum(pack["weights"][p] for p in positions)
        if weight > _PACK_FILL_MAX * pack["budget"]:
            return False
        if not self._register_pack(job, positions, pack, arrival=False,
                                   opportunistic=True):
            return False
        self.stats.add(repacked_tails=1)
        return True

    @staticmethod
    def _pack_is_full(pending: _PendingPack) -> bool:
        """A merged batch that cannot usefully grow dispatches now
        instead of waiting out the linger: token fill near the budget,
        the per-request tuple cap reached, or no room left for even one
        more typical tuple."""
        if pending.tokens >= _PACK_FLUSH_FILL * pending.budget:
            return True
        size = pending.size()
        if pending.max_batch and size >= pending.max_batch:
            return True
        mean_weight = pending.tokens / max(size, 1)
        return pending.budget - pending.tokens < mean_weight

    def _flush_pack(self, pending: _PendingPack):
        """Dispatch a packing-queue entry: alone it runs as its job's
        ordinary batch (bit-identical to never having parked); merged it
        runs as ONE provider request demultiplexed across jobs."""
        with self._pack_lock:
            if pending.flushed:
                return
            pending.flushed = True
            if pending.timer is not None:
                pending.timer.cancel()
            if self._packs.get(pending.key) is pending:
                del self._packs[pending.key]
            segments = pending.segments
        try:
            if len(segments) == 1:
                self._pool.submit(self._run_batch, segments[0].job,
                                  segments[0].positions)
            else:
                self.stats.add(packed_requests=1,
                               packed_batches=len(segments))
                self._pool.submit(self._run_pack, pending)
        # pool shut down mid-linger  # flocklint: ignore[FLKL105]
        except BaseException as exc:
            for s in segments:
                s.job._fail(exc)

    # ---- worker ------------------------------------------------------------
    def _run_batch(self, job: DispatchJob, batch: List[int]):
        self._run_gated(job.model, ("batch", job, batch))

    def _run_pack(self, pending: _PendingPack):
        self._run_gated(pending.model, ("pack", pending))

    def _run_gated(self, model: ModelResource, task: tuple):
        """Pool-thread entry: admit the task through its model gate (or
        park it — pool threads never block on a busy model, so one
        low-concurrency model cannot starve other models' jobs), then
        run it and keep draining parked same-model work inline (the slot
        hands off without a pool round-trip)."""
        gate = self._model_gate(model)
        if not gate.try_acquire(task):
            return          # parked on the gate; drained on release
        while task is not None:
            # any escape — provider errors, cache-put I/O failures,
            # requeue after shutdown — fails the owning job(s), never
            # strands result()
            try:
                if task[0] == "batch":
                    self._execute_admitted(task[1], task[2])
                else:
                    self._execute_pack(task[1])
            # surfaced at result()  # flocklint: ignore[FLKL105]
            except BaseException as exc:
                if task[0] == "batch":
                    task[1]._fail(exc)
                else:
                    for s in task[1].segments:
                        s.job._fail(exc)
            task = gate.release_and_next()

    def _execute_pack(self, pending: _PendingPack):
        """Run one merged co-packed request and demultiplex the per-row
        results back to each owning job by position.  The provider
        request is attributed to the FIRST segment's job (requests,
        batch size, latency); riders count it under ``stats.packed`` —
        summed across jobs the accounting matches the provider exactly.
        On overflow the merge is undone: each tail requeues as its own
        ordinary batch and the per-job adaptive protocol takes over."""
        segs = []
        for s in pending.segments:
            with s.job._lock:
                dead = s.job._error is not None
            if not dead:
                segs.append(s)
        if not segs:
            return
        with self._lock:
            self._executing += 1
            if self._executing > self.stats.max_inflight:
                self.stats.max_inflight = self._executing
        rows = [r for s in segs for r in s.rows]
        t0 = time.monotonic()
        try:
            out = pending.call(rows)
        except ContextOverflowError:
            with segs[0].job._lock:
                segs[0].job.stats.retries += 1
            self.stats.add(retries=1)
            for s in segs:
                self._pool.submit(self._run_batch, s.job, s.positions)
            return
        finally:
            with self._lock:
                self._executing -= 1
        dt = time.monotonic() - t0
        off = 0
        for k, s in enumerate(segs):
            vals = out[off:off + len(s.positions)]
            off += len(s.positions)
            with s.job._lock:
                if k == 0:
                    s.job.stats.requests += 1
                    s.job.stats.batch_sizes.append(len(rows))
                    s.job.stats.latencies.append(dt)
                else:
                    s.job.stats.packed += 1
            for pos, val in zip(s.positions, vals):
                self._resolve(s.job, pos, val)
            s.job._batch_finished()
        self.stats.add(requests=1)

    def _execute_admitted(self, job: DispatchJob, batch: List[int]):
        with job._lock:
            dead = job._error is not None
        if dead:
            return      # job already failed; don't pay for its batches
        with self._lock:
            self._executing += 1
            if self._executing > self.stats.max_inflight:
                self.stats.max_inflight = self._executing
        t0 = time.monotonic()
        try:
            out = job.run(batch)
        except ContextOverflowError:
            with job._lock:
                job.stats.retries += 1
            self.stats.add(retries=1)
            if len(batch) == 1:
                self._resolve(job, batch[0], None)
                with job._lock:
                    job.stats.nulls += 1
                self.stats.add(nulls=1)
                job._batch_finished()
                return
            head, tail = split_batch(batch)
            job._batch_started(1)        # one batch became two
            self._pool.submit(self._run_batch, job, head)
            # the shrunken remainder is exactly a part-filled tail: let
            # it ride a pending same-identity pack when one is plausible
            # instead of paying a sparse request of its own
            if not self._maybe_repack(job, tail):
                self._pool.submit(self._run_batch, job, tail)
            return
        finally:
            with self._lock:
                self._executing -= 1
        with job._lock:
            job.stats.requests += 1
            job.stats.batch_sizes.append(len(batch))
            job.stats.latencies.append(time.monotonic() - t0)
        self.stats.add(requests=1)
        for pos, val in zip(batch, out):
            self._resolve(job, pos, val)
        job._batch_finished()

    def _resolve(self, job: DispatchJob, pos: int, value):
        job.values[pos] = value
        key = job.keys[pos]
        if job.cache is not None and value is not None:
            job.cache.put(key, value)
        entry = job._owned_entries.get(pos)
        if entry is not None:
            entry.resolve(value)
            with self._lock:
                if self._inflight.get(key) is entry:
                    del self._inflight[key]


# ---------------------------------------------------------------------------
# speculative fan-out/join dispatch group
# ---------------------------------------------------------------------------
# default cap on rows concurrently being speculated on across one join
# (each task declares how many rows it covers; tasks park until budget
# frees up, except when nothing is in flight — progress is guaranteed)
SPEC_INFLIGHT_ROWS_CAP = 4096


@dataclass
class SpecTask:
    """One unit of speculative work for a :class:`SpeculativeJoin`.

    ``rows`` is the number of input rows the thunk covers (drives the
    in-flight row cap and waste accounting); ``mandatory`` marks work
    the serial plan needs regardless (never cancelled, never counted
    as speculative dispatch)."""
    thunk: Callable[[], object]
    rows: int = 0
    label: str = ""
    mandatory: bool = False


class SpeculativeJoin:
    """Bounded fan-out/join for heterogeneous speculative tasks: filter
    masks, row completions, rerank warmups.

    Serial execution of a dependent edge pays the upstream round-trip
    before the downstream one; speculation runs both concurrently over
    the upstream INPUT and reconciles afterwards — outputs stay
    bit-identical (per-tuple results are independent of batch
    composition), at the cost of requests over rows the upstream stage
    would have eliminated (the wasted-request budget the optimizer
    bounds via recorded selectivity).

    Tasks run on a BOUNDED set of dedicated runner threads, not the
    scheduler's worker pool: each task blocks in
    ``DispatchJob.result()`` while its batches execute on the pool,
    and parking that wait on a pool thread could deadlock a small
    pool.  The runner count is capped relative to the scheduler's
    ``max_workers`` (and the total speculative in-flight rows by
    ``max_inflight_rows``), so a deep chain fans out a few members at
    a time instead of spawning one thread per member.  Batch dispatch
    itself still rides ``RequestScheduler.submit_map``: identical
    cache keys coalesce through the single-flight registry, every
    batch respects the per-model concurrency gates, and part-filled
    tails ride the co-packing queue.

    Cancellation: ``cancel(i)`` drops task *i* if it has not started —
    the thunk never runs and no request reaches the provider (counted
    in ``SchedulerStats.spec_cancelled``).  Thunks may cancel sibling
    tasks (an upstream mask resolving proves speculative rows dead).
    A task that fails with a non-overflow error fails the whole join
    and cancels everything not yet started (overflow handling stays
    inside the dispatch engine: an overflow-NULLed tuple resolves the
    same way it would serially)."""

    def __init__(self, scheduler: Optional["RequestScheduler"] = None,
                 max_runners: Optional[int] = None,
                 max_inflight_rows: Optional[int] = None):
        workers = scheduler.max_workers if scheduler is not None else 16
        self.max_runners = max_runners or max(2, min(8, workers // 2))
        self.max_inflight_rows = max_inflight_rows or SPEC_INFLIGHT_ROWS_CAP
        self.stats = scheduler.stats if scheduler is not None else None
        self._cond = threading.Condition()
        self._cancelled: set = set()
        self._started: set = set()
        self._inflight_rows = 0
        self.cancelled: List[int] = []      # indices dropped, in order

    # ---- cancellation ------------------------------------------------------
    def cancel(self, index: int) -> bool:
        """Drop task ``index`` if it has not started; returns True when
        the cancellation took effect (the thunk will never run)."""
        with self._cond:
            if index in self._started or index in self._cancelled:
                return False
            self._cancelled.add(index)
            return True

    def note_wasted(self, rows: int):
        """Record rows speculated on that the serial plan would never
        have evaluated (the caller knows after reconciling masks)."""
        if self.stats is not None and rows > 0:
            self.stats.add(spec_wasted_rows=rows)

    # ---- execution ---------------------------------------------------------
    def _admit(self, task: SpecTask, index: int) -> bool:
        """Claim the right to run ``index``; blocks for row budget.
        Returns False when the task was cancelled before starting."""
        with self._cond:
            while True:
                if index in self._cancelled and not task.mandatory:
                    return False
                if (self._inflight_rows == 0
                        or self._inflight_rows + task.rows
                        <= self.max_inflight_rows):
                    self._started.add(index)
                    self._inflight_rows += task.rows
                    return True
                self._cond.wait(0.05)

    def _retire(self, task: SpecTask):
        with self._cond:
            self._inflight_rows -= task.rows
            self._cond.notify_all()

    def run(self, tasks: Sequence[SpecTask]) -> list:
        """Run the tasks concurrently on bounded runner threads; returns
        results in task order (``None`` for cancelled tasks — their
        indices land in ``self.cancelled``)."""
        tasks = list(tasks)
        results: List = [None] * len(tasks)
        errors: List[BaseException] = []
        order = list(range(len(tasks)))
        next_lock = threading.Lock()

        def worker():
            while True:
                with next_lock:
                    if not order or errors:
                        return
                    k = order.pop(0)
                task = tasks[k]
                if not self._admit(task, k):
                    if self.stats is not None:
                        self.stats.add(spec_cancelled=1)
                    with next_lock:
                        self.cancelled.append(k)
                    continue
                if self.stats is not None and not task.mandatory:
                    self.stats.add(spec_dispatched=1)
                try:
                    results[k] = task.thunk()
                # re-raised on the caller  # flocklint: ignore[FLKL105]
                except BaseException as exc:
                    errors.append(exc)
                    with self._cond:     # fail fast: drop unstarted work
                        self._cancelled.update(
                            i for i in range(len(tasks))
                            if i not in self._started)
                finally:
                    self._retire(task)

        n_threads = min(len(tasks), self.max_runners)
        threads = [threading.Thread(target=worker,
                                    name=f"flockjax-spec-{i}")
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        self.cancelled.sort()
        return results


class SpeculativeMaskJoin:
    """Mask-specific facade over :class:`SpeculativeJoin` for
    ``llm_filter`` chains: fan every member out over the chain's INPUT
    tuple stream and reconcile the boolean masks with AND.  The
    surviving tuple stream is identical to serial chain execution
    (per-tuple verdicts are independent of batch composition), but the
    chain's critical path collapses toward one round-trip."""

    @staticmethod
    def run(thunks: Sequence[Callable[[], List[bool]]],
            scheduler: Optional["RequestScheduler"] = None,
            rows: int = 0) -> tuple[List[List[bool]], List[bool]]:
        """Run every member thunk concurrently; returns ``(member_masks,
        combined)`` where ``combined[i] = AND(member[i] for members)``."""
        join = SpeculativeJoin(scheduler)
        masks = join.run([SpecTask(th, rows=rows, label=f"member-{k}")
                          for k, th in enumerate(thunks)])
        lengths = {len(m) for m in masks}
        if len(lengths) > 1:
            raise ValueError(
                f"speculative members returned masks of differing "
                f"lengths {sorted(lengths)}")
        combined = [all(col) for col in zip(*masks)]
        return [list(m) for m in masks], combined


