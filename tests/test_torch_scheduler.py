"""The port's request scheduler (``repro_torch.core.scheduler``) against the
reference's (``repro.core.scheduler``) on the CPU, both on
``MockProvider``: overflow split-and-requeue, single-flight dedup,
``max_concurrency`` gates, the co-packing queue, the speculative joins and
the calibrated linger window.

Each case runs the same inputs through both packages and compares results
and counts exactly; ``batch_sizes`` under concurrent dispatch is in
completion order and compares as a multiset.  The cases of
``tests/test_{scheduler,copack,latency,speculative}.py`` that build no
``Pipeline`` are ported here with the reference's own assertions and
wall-clock margins.
"""

import threading
import time

import numpy as np
import pytest

from test_torch_core import parity, pstats, report, sub

MODEL = {"model": "m", "context_window": 700, "max_output_tokens": 8,
         "max_concurrency": 4}


def _resource(C, **kw):
    base = dict(name="m", version=1, arch="mock", context_window=4096,
                max_output_tokens=8, max_concurrency=4)
    base.update(kw)
    return C.ModelResource(**base)


def _counts(stats):
    return (stats.requests, stats.retries, stats.nulls,
            sorted(stats.batch_sizes), stats.packed)


# ---------------------------------------------------------------------------
# tests/test_scheduler.py
# ---------------------------------------------------------------------------
def test_scheduled_embedding_identical_to_serial():
    def scenario(C):
        texts = [f"passage {i}" for i in range(12)] * 2
        model = {"model": "e", "embedding_dim": 16}
        ctx_s = C.SemanticContext(provider=C.MockProvider())
        ref = C.llm_embedding(ctx_s, model, texts)
        with C.RequestScheduler() as sched:
            ctx_c = C.SemanticContext(provider=C.MockProvider(),
                                      scheduler=sched)
            out = C.llm_embedding(ctx_c, model, texts)
        assert out.shape == ref.shape
        assert (out == ref).all()
        assert ctx_c.provider.stats.calls == ctx_s.provider.stats.calls
        return out.tolist(), report(ctx_c.reports[-1], ordered=False)
    parity(scenario)


def _two_threads(target, gap=0.05):
    t1 = threading.Thread(target=target, args=(0,))
    t2 = threading.Thread(target=target, args=(1,))
    t1.start()
    time.sleep(gap)
    t2.start()
    t1.join()
    t2.join()


def test_single_flight_dedups_concurrent_identical_jobs():
    def scenario(C):
        rows = [{"t": f"row {i}"} for i in range(10)]
        model = dict(MODEL, context_window=4096)
        prov = C.MockProvider(latency_per_call_s=0.25)
        out = [None, None]
        with C.RequestScheduler() as sched:
            ctx = C.SemanticContext(provider=prov, scheduler=sched)

            def call(slot):
                out[slot] = C.llm_complete(ctx, model, {"prompt": "p"}, rows)

            _two_threads(call)
        assert out[0] == out[1]
        assert prov.stats.calls == 1
        assert sched.stats.coalesced == 10
        return out, pstats(prov), sorted(r.coalesced for r in ctx.reports)
    parity(scenario)


def test_single_flight_late_submitter_reads_cache():
    def scenario(C):
        rows = [{"t": "same"}]
        prov = C.MockProvider()
        with C.RequestScheduler() as sched:
            ctx = C.SemanticContext(provider=prov, scheduler=sched)
            a = C.llm_complete(ctx, MODEL, {"prompt": "p"}, rows)
            b = C.llm_complete(ctx, MODEL, {"prompt": "p"}, rows)
        assert a == b
        assert prov.stats.calls == 1
        return a, [report(r) for r in ctx.reports]
    parity(scenario)


@pytest.mark.parametrize("knob", ["enable_dedup", "enable_cache"])
def test_no_coalescing_when_dedup_or_cache_disabled(knob):
    def scenario(C):
        rows = [{"t": "same"}] * 6
        kw = {knob: False}
        ctx_s = C.SemanticContext(provider=C.MockProvider(), **kw)
        ref = C.llm_complete(ctx_s, MODEL, {"prompt": "p"}, rows)
        with C.RequestScheduler() as sched:
            ctx_c = C.SemanticContext(provider=C.MockProvider(),
                                      scheduler=sched, **kw)
            out = C.llm_complete(ctx_c, MODEL, {"prompt": "p"}, rows)
            assert out == ref
            assert ctx_c.provider.stats.calls == ctx_s.provider.stats.calls
            assert sched.stats.coalesced == 0
        return out, pstats(ctx_c.provider)
    parity(scenario)


def test_duplicate_keys_inherit_borrowed_disposition():
    def scenario(C):
        rows = [{"t": "same"}] * 6
        prov = C.MockProvider(latency_per_call_s=0.25)
        out = [None, None]
        with C.RequestScheduler() as sched:
            ctx = C.SemanticContext(provider=prov, scheduler=sched,
                                    enable_dedup=False)

            def call(slot):
                out[slot] = C.llm_complete(ctx, MODEL, {"prompt": "p"}, rows)

            _two_threads(call)
        assert out[0] == out[1]
        assert prov.stats.calls == 1
        return out, pstats(prov)
    parity(scenario)


def test_borrower_sees_owner_error_not_none():
    def scenario(C):
        rows = [{"t": f"row {i}"} for i in range(4)]

        def bad(kind, prefix, batch_rows):
            time.sleep(0.2)
            raise RuntimeError("provider down")

        errors = []
        with C.RequestScheduler() as sched:
            ctx = C.SemanticContext(provider=C.MockProvider(bad),
                                    scheduler=sched)

            def call(slot):
                try:
                    C.llm_complete(ctx, MODEL, {"prompt": "p"}, rows)
                except Exception as exc:        # noqa: BLE001 - recording
                    errors.append(exc)

            _two_threads(call)
        assert len(errors) == 2
        assert all(isinstance(e, RuntimeError) for e in errors)
        return [str(e) for e in errors]
    parity(scenario)


def test_overflow_splits_and_requeues_under_concurrency():
    def scenario(C):
        calls = []

        def run(batch):
            calls.append(list(batch))
            if len(batch) > 3:
                raise C.ContextOverflowError("too big")
            return [f"v{p}" for p in batch]

        with C.RequestScheduler(max_workers=4) as sched:
            job = sched.submit(_resource(C), [f"k{i}" for i in range(20)],
                               run, batches=[list(range(20))])
            values, stats = job.result(timeout=10)
        assert values == [f"v{i}" for i in range(20)]
        assert stats.retries > 0
        assert stats.nulls == 0
        assert sum(stats.batch_sizes) == 20
        assert all(s <= 3 for s in stats.batch_sizes)
        assert calls[0] == list(range(20))
        return values, _counts(stats), sorted(map(sorted, calls))
    parity(scenario)


def test_overflow_single_tuple_yields_null():
    def scenario(C):
        def run(batch):
            raise C.ContextOverflowError("always")

        with C.RequestScheduler(max_workers=2) as sched:
            job = sched.submit(_resource(C), ["a", "b"], run,
                               batches=[[0], [1]])
            values, stats = job.result(timeout=10)
        assert values == [None, None]
        assert stats.nulls == 2
        return values, _counts(stats)
    parity(scenario)


def test_overflow_end_to_end_matches_serial():
    def scenario(C):
        rows = [{"t": f"x{i}"} for i in range(6)] + [{"t": "y" * 4000}]
        model = {"model": "m", "context_window": 200, "max_output_tokens": 4}
        kw = dict(enable_dedup=False, enable_cache=False)
        ctx_s = C.SemanticContext(provider=C.MockProvider(), **kw)
        ref = C.llm_complete(ctx_s, model, {"prompt": "p"}, rows)
        with C.RequestScheduler() as sched:
            ctx_c = C.SemanticContext(provider=C.MockProvider(),
                                      scheduler=sched, **kw)
            out = C.llm_complete(ctx_c, model, {"prompt": "p"}, rows)
        assert out == ref
        assert out[-1] is None
        assert any(v is not None for v in out[:-1])
        assert ctx_c.reports[-1].nulls == ctx_s.reports[-1].nulls
        assert ctx_s.reports[-1].retries > 0
        return (out, report(ctx_s.reports[-1]),
                report(ctx_c.reports[-1], ordered=False))
    parity(scenario)


def test_max_concurrency_bounds_inflight_requests():
    def scenario(C):
        seen, live = [], [0]
        lock = threading.Lock()

        def run(batch):
            with lock:
                live[0] += 1
                seen.append(live[0])
            time.sleep(0.03)
            with lock:
                live[0] -= 1
            return [f"v{p}" for p in batch]

        with C.RequestScheduler(max_workers=16) as sched:
            job = sched.submit(_resource(C, max_concurrency=2),
                               [f"k{i}" for i in range(8)], run,
                               batches=[[i] for i in range(8)])
            values, stats = job.result(timeout=10)
        assert max(seen) <= 2
        assert sched.stats.max_inflight <= 2
        return values, _counts(stats)
    parity(scenario)


def test_coalesced_positions_repack_densely():
    def scenario(C):
        cache = C.PredictionCache()
        for i in range(0, 10, 2):
            cache.put(f"k{i}", f"cached{i}")
        with C.RequestScheduler() as sched:
            job = sched.submit_map(
                _resource(C, context_window=60, max_output_tokens=8),
                [f"k{i}" for i in range(10)], [10] * 10, 0,
                lambda batch: [f"v{p}" for p in batch], cache=cache)
            values, stats = job.result(timeout=10)
        assert values == [f"cached{i}" if i % 2 == 0 else f"v{i}"
                          for i in range(10)]
        assert job.late_hits == 5
        assert job.coalesced == 0
        assert stats.batch_sizes == [3, 2]
        return values, _counts(stats)
    parity(scenario)


def test_model_gate_most_restrictive_limit_wins():
    def scenario(C):
        with C.RequestScheduler() as sched:
            g1 = sched._model_gate(_resource(C, max_concurrency=8))
            g2 = sched._model_gate(_resource(C, max_concurrency=2))
            g3 = sched._model_gate(_resource(C, max_concurrency=8))
        assert g1 is g2 is g3
        assert g3.limit == 2
        return g3.limit
    parity(scenario)


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_gate_bounds_inflight_for_semantic_calls(limit):
    """``max_concurrency`` of a resolved model bounds the provider calls in
    flight during an ``llm_complete`` over many batches."""
    def scenario(C):
        live, peak = [0], [0]
        lock = threading.Lock()

        def slow(kind, prefix, rows):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.01)
            with lock:
                live[0] -= 1
            return None

        model = dict(MODEL, max_concurrency=limit, context_window=300)
        rows = [{"t": f"row {i} with a body of text"} for i in range(24)]
        with C.RequestScheduler(max_workers=8) as sched:
            ctx = C.SemanticContext(provider=C.MockProvider(slow),
                                    scheduler=sched)
            out = C.llm_complete(ctx, model, {"prompt": "p"}, rows)
        assert peak[0] <= limit
        assert sched.stats.max_inflight <= limit
        return out, report(ctx.reports[-1], ordered=False)
    parity(scenario)


# ---------------------------------------------------------------------------
# tests/test_copack.py: the packing queue
# ---------------------------------------------------------------------------
def _submit_packed_pair(C, sched, calls, fail_merged_over=None):
    model = _resource(C, context_window=1000)
    rows_a = [f"a{i}" for i in range(4)]
    rows_b = [f"b{i}" for i in range(4)]

    def pack_call(rows):
        if fail_merged_over is not None and len(rows) > fail_merged_over:
            raise C.ContextOverflowError("merged too large")
        calls.append(list(rows))
        return [f"r:{r}" for r in rows]

    def make_run(rows):
        def run(positions):
            return pack_call([rows[p] for p in positions])
        return run

    jobs = [sched.submit_map(
        model, [f"key-{r}" for r in rows], [20] * len(rows),
        prefix_tokens=100, run=make_run(rows), single_flight=False,
        pack_key="shared-prefix", pack_rows=rows, pack_call=pack_call)
        for rows in (rows_a, rows_b)]
    return jobs[0], jobs[1], rows_a, rows_b


def test_copack_merges_tails_into_one_request():
    def scenario(C):
        calls = []
        with C.RequestScheduler(pack_linger_s=0.5) as sched:
            ja, jb, rows_a, rows_b = _submit_packed_pair(C, sched, calls)
            va, sa = ja.result(timeout=10)
            vb, sb = jb.result(timeout=10)
        assert va == [f"r:{r}" for r in rows_a]
        assert vb == [f"r:{r}" for r in rows_b]
        assert len(calls) == 1
        assert sorted(calls[0]) == sorted(rows_a + rows_b)
        assert sched.stats.packed_requests == 1
        assert sched.stats.packed_batches == 2
        assert sa.requests + sb.requests == 1
        assert sa.packed + sb.packed == 1
        return va, vb, sorted(calls[0])
    parity(scenario)


def test_copack_lone_tail_flushes_after_linger():
    def scenario(C):
        calls = []

        def pack_call(rows):
            calls.append(list(rows))
            return [f"r:{r}" for r in rows]

        rows = ["x0", "x1"]
        with C.RequestScheduler(pack_linger_s=0.05) as sched:
            job = sched.submit_map(
                _resource(C), ["k0", "k1"], [10, 10], prefix_tokens=10,
                run=lambda ps: pack_call([rows[p] for p in ps]),
                single_flight=False, pack_key="p", pack_rows=rows,
                pack_call=pack_call)
            vals, stats = job.result(timeout=10)
        assert vals == ["r:x0", "r:x1"]
        assert len(calls) == 1
        assert sched.stats.packed_requests == 0
        return vals, _counts(stats)
    parity(scenario)


def test_copack_merged_overflow_unmerges():
    def scenario(C):
        calls = []
        with C.RequestScheduler(pack_linger_s=0.5) as sched:
            ja, jb, rows_a, rows_b = _submit_packed_pair(
                C, sched, calls, fail_merged_over=6)
            va, sa = ja.result(timeout=10)
            vb, sb = jb.result(timeout=10)
        assert va == [f"r:{r}" for r in rows_a]
        assert vb == [f"r:{r}" for r in rows_b]
        assert (sorted(map(sorted, calls))
                == sorted(map(sorted, [rows_a, rows_b])))
        assert sa.retries + sb.retries == 1
        assert sa.requests == sb.requests == 1
        return va, vb
    parity(scenario)


def test_copack_full_tail_not_parked():
    def scenario(C):
        calls = []
        rows = [f"x{i}" for i in range(4)]

        def pack_call(batch):
            calls.append(list(batch))
            return [f"r:{r}" for r in batch]

        t0 = time.monotonic()
        with C.RequestScheduler(pack_linger_s=5.0) as sched:
            job = sched.submit_map(
                _resource(C, context_window=210), [f"k{i}" for i in range(4)],
                [40] * 4, prefix_tokens=10,
                run=lambda ps: pack_call([rows[p] for p in ps]),
                single_flight=False, pack_key="p", pack_rows=rows,
                pack_call=pack_call)
            vals, stats = job.result(timeout=10)
        assert vals == [f"r:{r}" for r in rows]
        assert time.monotonic() - t0 < 4.0
        return vals, _counts(stats)
    parity(scenario)


def test_copack_last_tail_out_flushes_immediately():
    def scenario(C):
        calls = []
        key = (_resource(C, context_window=1000).ref, "shared-prefix")
        t0 = time.monotonic()
        with C.RequestScheduler(pack_linger_s=5.0) as sched:
            sched.pack_expect(key, 2)
            ja, jb, rows_a, rows_b = _submit_packed_pair(C, sched, calls)
            va, _ = ja.result(timeout=10)
            vb, _ = jb.result(timeout=10)
        assert time.monotonic() - t0 < 4.0
        assert va == [f"r:{r}" for r in rows_a]
        assert vb == [f"r:{r}" for r in rows_b]
        assert len(calls) == 1
        assert sorted(calls[0]) == sorted(rows_a + rows_b)
        assert sched.stats.packed_requests == 1
        return va, vb
    parity(scenario)


def test_copack_sole_expected_tail_skips_parking():
    def scenario(C):
        calls = []
        model = _resource(C)
        rows = ["x0", "x1"]

        def pack_call(batch):
            calls.append(list(batch))
            return [f"r:{r}" for r in batch]

        t0 = time.monotonic()
        with C.RequestScheduler(pack_linger_s=5.0) as sched:
            sched.pack_expect((model.ref, "p"), 1)
            job = sched.submit_map(
                model, ["k0", "k1"], [10, 10], prefix_tokens=10,
                run=lambda ps: pack_call([rows[p] for p in ps]),
                single_flight=False, pack_key="p", pack_rows=rows,
                pack_call=pack_call)
            vals, _ = job.result(timeout=10)
        assert vals == ["r:x0", "r:x1"]
        assert time.monotonic() - t0 < 4.0
        assert len(calls) == 1
        assert sched.stats.packed_requests == 0
        return vals
    parity(scenario)


def test_copack_retire_flushes_lone_parked_tail():
    def scenario(C):
        calls = []
        model = _resource(C)
        rows = ["x0", "x1"]

        def pack_call(batch):
            calls.append(list(batch))
            return [f"r:{r}" for r in batch]

        key = (model.ref, "p")
        t0 = time.monotonic()
        with C.RequestScheduler(pack_linger_s=5.0) as sched:
            sched.pack_expect(key, 2)
            job = sched.submit_map(
                model, ["k0", "k1"], [10, 10], prefix_tokens=10,
                run=lambda ps: pack_call([rows[p] for p in ps]),
                single_flight=False, pack_key="p", pack_rows=rows,
                pack_call=pack_call)
            time.sleep(0.05)
            sched.pack_retire(key, 1)
            vals, _ = job.result(timeout=10)
        assert vals == ["r:x0", "r:x1"]
        assert time.monotonic() - t0 < 4.0
        assert len(calls) == 1
        assert sched.stats.packed_requests == 0
        return vals
    parity(scenario)


def test_copack_overflow_remainder_repacks():
    def scenario(C):
        calls, failed = [], []
        model = _resource(C, context_window=1000)
        rows_b = [f"b{i}" for i in range(4)]
        rows_a = [f"a{i}" for i in range(8)]

        def pack_call(batch):
            if len(batch) == 8 and not failed:
                failed.append(True)
                raise C.ContextOverflowError("merged too large")
            calls.append(list(batch))
            return [f"r:{r}" for r in batch]

        def make_run(rows):
            def run(positions):
                return pack_call([rows[p] for p in positions])
            return run

        with C.RequestScheduler(pack_linger_s=0.5) as sched:
            jb = sched.submit_map(
                model, [f"kb{i}" for i in range(4)], [20] * 4,
                prefix_tokens=100, run=make_run(rows_b),
                single_flight=False, pack_key="p", pack_rows=rows_b,
                pack_call=pack_call)
            ja = sched.submit_map(
                model, [f"ka{i}" for i in range(8)], [90] * 8,
                prefix_tokens=100, run=make_run(rows_a),
                single_flight=False, pack_key="p", pack_rows=rows_a,
                pack_call=pack_call)
            va, sa = ja.result(timeout=10)
            vb, _ = jb.result(timeout=10)
        assert va == [f"r:{r}" for r in rows_a]
        assert vb == [f"r:{r}" for r in rows_b]
        assert sched.stats.repacked_tails >= 1
        assert sa.retries == 1
        assert any(set(c) & set(rows_a) and set(c) & set(rows_b)
                   for c in calls)
        return va, vb, sa.retries
    parity(scenario)


_COPACK_MODEL = {"model": "cp", "context_window": 100_000,
                 "max_output_tokens": 8, "max_concurrency": 8}


def test_llm_multi_copack_bit_identical_demux():
    def scenario(C):
        C.reset_global_catalog()
        subtasks = [{"kind": "filter", "prompt": {"prompt": "keep?"}},
                    {"kind": "complete", "prompt": {"prompt": "summarize"}}]
        rows_a = [{"a": f"first text number {i} with body"}
                  for i in range(22)]
        rows_b = [{"b": f"second text number {i} with body"}
                  for i in range(22)]
        serial = C.SemanticContext(provider=C.MockProvider(), max_batch=16)
        expect_a = C.llm_multi(serial, _COPACK_MODEL, subtasks, rows_a)
        expect_b = C.llm_multi(serial, _COPACK_MODEL, subtasks, rows_b)
        out = [None, None]
        with C.RequestScheduler(pack_linger_s=5.0) as sched:
            ctx = C.SemanticContext(provider=C.MockProvider(),
                                    scheduler=sched, max_batch=16)
            model = ctx.resolve_model(_COPACK_MODEL)
            texts = [ctx.resolve_prompt(st["prompt"])[0] for st in subtasks]
            ident = (id(ctx.provider), model, "multi", ctx.serialization,
                     C.build_multi_task([st["kind"] for st in subtasks],
                                        texts))

            def worker(slot, rows):
                out[slot] = C.llm_multi(ctx, _COPACK_MODEL, subtasks, rows)

            t0 = time.monotonic()
            ctx.copack_begin({ident: 2})
            try:
                threads = [threading.Thread(target=worker,
                                            args=(0, rows_a)),
                           threading.Thread(target=worker,
                                            args=(1, rows_b))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            finally:
                ctx.copack_end({ident: 2})
            elapsed = time.monotonic() - t0
        assert out[0] == expect_a
        assert out[1] == expect_b
        assert sched.stats.packed_requests >= 1
        assert elapsed < 4.0
        return out, pstats(serial.provider), pstats(ctx.provider)
    parity(scenario)


# ---------------------------------------------------------------------------
# tests/test_latency.py: the calibrated linger window
# ---------------------------------------------------------------------------
def test_copack_linger_calibrated_window():
    def scenario(C):
        sch = sub(C, "scheduler")
        with C.RequestScheduler(pack_linger_s=0.5) as sched:
            ctx = C.SemanticContext(provider=C.MockProvider(),
                                    scheduler=sched)
            assert ctx.copack_linger("m@1") is None
            ctx.record_calibration("m@1", requests=4, retries=0, tuples=8,
                                   latencies=[0.1] * 4)
            assert ctx.copack_linger("m@1") == pytest.approx(
                sch.PACK_LINGER_LATENCY_FRACTION * 0.1)
            ctx.record_calibration("slow@1", requests=4, retries=0,
                                   tuples=8, latencies=[10.0] * 4)
            assert ctx.copack_linger("slow@1") == 0.5
            ctx.record_calibration("fast@1", requests=4, retries=0,
                                   tuples=8, latencies=[1e-5] * 4)
            assert ctx.copack_linger("fast@1") == sch.PACK_LINGER_MIN_S
            got = [ctx.copack_linger(m) for m in ("m@1", "slow@1", "fast@1")]
        with C.RequestScheduler(pack_linger_s=0.5) as sched:
            ctx = C.SemanticContext(provider=C.MockProvider(),
                                    scheduler=sched, objective="cost")
            ctx.record_calibration("m@1", requests=4, retries=0, tuples=8,
                                   latencies=[0.1] * 4)
            assert ctx.copack_linger("m@1") is None
        ctx = C.SemanticContext(provider=C.MockProvider())
        ctx.record_calibration("m@1", requests=4, retries=0, tuples=8,
                               latencies=[0.1] * 4)
        assert ctx.copack_linger("m@1") is None
        return got
    parity(scenario)


def test_parked_tail_deadline_respects_calibrated_window():
    """A tail parked for a rider that never dispatches leaves on the
    calibrated deadline, not the configured 30 s linger.  The identity is
    built as ``_map_core`` builds it (the reference builds it from a plan
    node, which needs the engine half)."""
    def scenario(C):
        C.reset_global_catalog()
        rows = [{"a": f"text number {i} with body"} for i in range(22)]
        with C.RequestScheduler(pack_linger_s=30.0) as sched:
            ctx = C.SemanticContext(provider=C.MockProvider(),
                                    scheduler=sched, max_batch=16)
            model = ctx.resolve_model(_COPACK_MODEL)
            ctx.record_calibration(model.ref, requests=4, retries=0,
                                   tuples=64, latencies=[0.2] * 4)
            ident = (id(ctx.provider), model, "complete", ctx.serialization,
                     "summarize")
            t0 = time.monotonic()
            ctx.copack_begin({ident: 2})
            try:
                out = C.llm_complete(ctx, _COPACK_MODEL,
                                     {"prompt": "summarize"}, rows)
            finally:
                ctx.copack_end({ident: 2})
            elapsed = time.monotonic() - t0
        assert len(out) == len(rows) and all(v is not None for v in out)
        assert elapsed < 5.0
        assert sched.stats.packed_requests == 0
        return out, report(ctx.reports[-1], ordered=False)
    parity(scenario)


def test_objective_validation():
    def scenario(C):
        with pytest.raises(ValueError) as err:
            C.SemanticContext(provider=C.MockProvider(), objective="bogus")
        assert C.SemanticContext(provider=C.MockProvider()).objective \
            == "latency"
        return str(err.value)
    parity(scenario)


# ---------------------------------------------------------------------------
# tests/test_speculative.py: embedding dispatch feeds calibration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheduled", [False, True])
def test_embedding_dispatch_feeds_calibration(scheduled):
    def scenario(C):
        sched = C.RequestScheduler() if scheduled else None
        try:
            ctx = C.SemanticContext(provider=C.MockProvider(),
                                    scheduler=sched)
            out = C.llm_embedding(ctx, {"model": "e", "embedding_dim": 8},
                                  [f"passage {i}" for i in range(5)])
        finally:
            if sched is not None:
                sched.shutdown()
        assert ctx.calibration_stats["e@0"]["requests"] >= 1
        assert np.isfinite(ctx.calibrated_latency("e@0"))
        return out.tolist(), ctx.calibration_stats["e@0"]["requests"]
    parity(scenario)


# ---------------------------------------------------------------------------
# the speculative joins (the reference drives them through Pipeline plans)
# ---------------------------------------------------------------------------
def _marker_behaviour(C):
    """Filter verdicts by content: prompt ``has P<k>`` passes rows that
    carry ``P<k>``; a ``BOOM`` row overflows any batch holding it."""
    import re

    def behaviour(kind, prefix, rows):
        if kind != "filter":
            return None
        if any("BOOM" in r for r in rows):
            raise C.ContextOverflowError("poisoned row in batch")
        marker = re.search(r"has (P\d+)", prefix).group(1)
        return [f"{i}: {'true' if marker in r else 'false'}"
                for i, r in enumerate(rows)]
    return behaviour


def _marked_rows(seed, n=30):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        marks = [f"P{k}" for k in range(3) if rng.random() < 0.6]
        if rng.random() < 0.1:
            marks.append("BOOM")
        rows.append({"t": f"row {i} " + " ".join(marks)})
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_mask_join_equals_serial_chain(seed):
    """Members evaluated concurrently over the chain input, masks ANDed,
    give the serial chain's surviving rows."""
    def scenario(C):
        rows = _marked_rows(seed)
        model = {"model": "pm", "context_window": 400,
                 "max_output_tokens": 8, "max_concurrency": 4}
        prompts = [{"prompt": f"has P{k}"} for k in range(3)]
        serial = C.SemanticContext(provider=C.MockProvider(
            _marker_behaviour(C)))
        alive = list(range(len(rows)))
        for p in prompts:
            mask = C.llm_filter(serial, model, p, [rows[i] for i in alive])
            alive = [i for i, m in zip(alive, mask) if m]
        with C.RequestScheduler(max_workers=8) as sched:
            ctx = C.SemanticContext(provider=C.MockProvider(
                _marker_behaviour(C)), scheduler=sched)
            thunks = [lambda p=p: C.llm_filter(ctx, model, p, rows)
                      for p in prompts]
            members, combined = C.SpeculativeMaskJoin.run(
                thunks, scheduler=sched, rows=len(rows))
            spec = sched.stats
        assert [i for i, m in enumerate(combined) if m] == alive
        assert combined == [all(c) for c in zip(*members)]
        assert spec.spec_dispatched == 3 and spec.spec_cancelled == 0
        return alive, members, sorted(
            tuple(sorted(r.batch_sizes)) for r in ctx.reports)
    parity(scenario)


def test_speculative_mask_join_rejects_ragged_masks():
    def scenario(C):
        with pytest.raises(ValueError) as err:
            C.SpeculativeMaskJoin.run([lambda: [True, False],
                                       lambda: [True]])
        return str(err.value)
    parity(scenario)


def test_speculative_join_cancel_and_results_in_order():
    """A task cancelled before it starts never runs; results come back in
    task order with ``None`` for the cancelled one."""
    def scenario(C):
        ran = []
        gate = threading.Event()
        with C.RequestScheduler(max_workers=4) as sched:
            join = C.SpeculativeJoin(sched, max_runners=1)

            def first():
                ran.append(0)
                assert join.cancel(2)           # not started: dropped
                assert not join.cancel(0)       # running: too late
                gate.set()
                return "a"

            tasks = [C.SpecTask(first, rows=4, label="t0"),
                     C.SpecTask(lambda: ran.append(1) or "b", rows=4),
                     C.SpecTask(lambda: ran.append(2) or "c", rows=4),
                     C.SpecTask(lambda: ran.append(3) or "d", rows=4,
                                mandatory=True)]
            out = join.run(tasks)
            join.note_wasted(3)
            stats = sched.stats
        assert gate.is_set()
        assert out == ["a", "b", None, "d"]
        assert join.cancelled == [2]
        assert ran == [0, 1, 3]
        assert (stats.spec_dispatched, stats.spec_cancelled,
                stats.spec_wasted_rows) == (2, 1, 3)
        return out, ran, join.cancelled
    parity(scenario)


def test_speculative_join_failure_cancels_unstarted_work():
    def scenario(C):
        ran = []

        def boom():
            raise RuntimeError("member failed")

        join = C.SpeculativeJoin(None, max_runners=1)
        tasks = [C.SpecTask(boom)] + [
            C.SpecTask(lambda k=k: ran.append(k)) for k in range(3)]
        with pytest.raises(RuntimeError) as err:
            join.run(tasks)
        assert ran == []
        return str(err.value), ran
    parity(scenario)


@pytest.mark.parametrize("cap", [4, 8, 12])
def test_speculative_join_bounds_inflight_rows(cap):
    """Tasks park until their rows fit under ``max_inflight_rows`` (a task
    always runs when nothing is in flight)."""
    def scenario(C):
        live, peak = [0], [0]
        lock = threading.Lock()

        def task(rows):
            def thunk():
                with lock:
                    live[0] += rows
                    peak[0] = max(peak[0], live[0])
                time.sleep(0.02)
                with lock:
                    live[0] -= rows
                return rows
            return thunk

        join = C.SpeculativeJoin(None, max_runners=8, max_inflight_rows=cap)
        out = join.run([C.SpecTask(task(4), rows=4) for _ in range(8)])
        assert peak[0] <= cap
        assert out == [4] * 8
        return out
    parity(scenario)
