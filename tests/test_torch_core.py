"""The port's plan layer, core half (``repro_torch.core``), against the
reference (``repro.core``) on the CPU, both on ``MockProvider``.

Every case runs the same seeded inputs through both packages and compares
the results, the ``ExecutionReport``s (every field but the measured
``latencies``, of which only the count) and the ``ProviderStats`` counters
exactly.  The cases of ``tests/test_{core,copack,speculative,latency,
scheduler,properties}.py`` that build no ``Pipeline`` and need no
scheduler are ported here, each keeping the reference's own assertions
(run on the port) and margins; the scheduler's cases are in
``tests/test_torch_scheduler.py``.  Sidecar files written by one package
load in the other.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro_torch.core as T

# copies of the reference's property tests replay a fixed set of draws
SMALL = settings(max_examples=40, deadline=None, derandomize=True,
                 database=None)


def sub(C, name):
    """A submodule of a core package (``fusion`` is shadowed by the
    function of the same name in the package namespace)."""
    return importlib.import_module(f"{C.__name__}.{name}")


def report(rep, ordered=True):
    """An ``ExecutionReport`` as a plain dict: measured latencies by
    count only; under the scheduler ``batch_sizes`` is in completion
    order, so it compares as a multiset."""
    d = dataclasses.asdict(rep)
    d["latencies"] = len(d["latencies"])
    if not ordered:
        d["batch_sizes"] = sorted(d["batch_sizes"])
    return d


def pstats(provider):
    s = provider.stats.snapshot()
    s.pop("latency_s")
    return s


def parity(scenario, *args):
    """Run ``scenario(C, *args)`` on both packages; their observables must
    be equal.  Returns the port's."""
    ref = scenario(R, *args)
    port = scenario(T, *args)
    assert port == ref
    return port


def test_port_exports_every_reference_name():
    ref = {n for n in dir(R) if not n.startswith("_")}
    port = {n for n in dir(T) if not n.startswith("_")}
    assert ref - port == {"LocalJaxProvider"}
    assert "LocalTorchProvider" in port


# ---------------------------------------------------------------------------
# every semantic function: scheduler on/off x cache, dedup, batching on/off
# ---------------------------------------------------------------------------
_WORDS = ("join", "index", "vector", "scan", "duckdb", "query", "model",
          "cache", "batch", "prompt", "rerank", "fusion")
MATRIX_MODEL = {"model": "m", "context_window": 600, "max_output_tokens": 8,
                "embedding_dim": 16}


def _rows(seed=0, n=24, dups=8):
    rng = np.random.default_rng(seed)
    rows = [{"title": f"paper {k}",
             "abstract": " ".join(rng.choice(_WORDS, int(rng.integers(3, 12))))}
            for k in range(n)]
    return rows + [rows[int(i)] for i in rng.integers(0, n, dups)]


def _call(C, ctx, fn, rows):
    model, prompt = MATRIX_MODEL, {"prompt": "is it about joins?"}
    if fn == "multi":
        subtasks = [{"kind": "filter", "prompt": {"prompt": "keep?"}},
                    {"kind": "complete", "prompt": {"prompt": "summarize"}},
                    {"kind": "complete_json", "prompt": {"prompt": "tag"}}]
        return C.llm_multi(ctx, model, subtasks, rows)
    if fn == "embedding":
        return C.llm_embedding(ctx, model, rows).tolist()
    if fn in ("reduce", "reduce_json"):
        return getattr(C, f"llm_{fn}")(ctx, model, prompt, rows[:8])
    if fn == "rerank":
        return C.llm_rerank(ctx, model, prompt, rows[:16], window=6, stride=3)
    return getattr(C, f"llm_{fn}")(ctx, model, prompt, rows[:16]
                                   if fn in ("first", "last") else rows)


def _matrix_scenario(C, fn, scheduled, knobs):
    prov = C.MockProvider()
    sched = C.RequestScheduler(max_workers=4) if scheduled else None
    try:
        ctx = C.SemanticContext(provider=prov, scheduler=sched, **knobs)
        rows = _rows()
        first = _call(C, ctx, fn, rows)
        after_first = pstats(prov)
        second = _call(C, ctx, fn, rows)
    finally:
        if sched is not None:
            sched.shutdown()
    return {"out": [first, second], "first": after_first,
            "stats": pstats(prov),
            "reports": [report(r, ordered=not scheduled)
                        for r in ctx.reports],
            "selectivity": ctx.selectivity_stats,
            "calibration": {k: (v["requests"], v["retries"], v["tuples"])
                            for k, v in ctx.calibration_stats.items()}}


FUNCS = ("complete", "complete_json", "filter", "multi", "embedding",
         "reduce", "reduce_json", "rerank", "first", "last")
KNOBS = {"default": {}, "no_cache": {"enable_cache": False},
         "no_dedup": {"enable_dedup": False},
         "no_batching": {"enable_batching": False}}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("scheduled", [False, True], ids=["serial", "sched"])
@pytest.mark.parametrize("fn", FUNCS)
def test_semantic_function_matches_reference(fn, scheduled, knobs):
    got = parity(_matrix_scenario, fn, scheduled, KNOBS[knobs])
    first, second = got["out"]
    assert second == first
    if knobs != "no_cache":     # the second pass is served by the cache
        assert got["stats"] == got["first"]
    else:
        assert got["stats"]["calls"] == 2 * got["first"]["calls"]
    # scheduled and serial dispatch give the same results and counts
    if scheduled:
        serial = _matrix_scenario(T, fn, False, KNOBS[knobs])
        assert got["out"] == serial["out"]
        assert got["stats"] == serial["stats"]
        assert got["reports"] == [
            dict(r, batch_sizes=sorted(r["batch_sizes"]))
            for r in serial["reports"]]


# ---------------------------------------------------------------------------
# tests/test_core.py
# ---------------------------------------------------------------------------
def test_metaprompt_prefix_stable_across_batches():
    def scenario(C):
        m1 = C.build_metaprompt("filter", "is relevant?", [{"a": "x"}])
        m2 = C.build_metaprompt("filter", "is relevant?",
                                [{"a": "y"}, {"a": "z"}])
        assert m1.prefix == m2.prefix
        assert m1.suffix != m2.suffix
        return m1.text, m2.text
    parity(scenario)


@pytest.mark.parametrize("fmt", ["xml", "json", "markdown"])
def test_metaprompt_serializations(fmt):
    def scenario(C):
        mp = C.build_metaprompt("complete", "task", [{"a": 1, "b": "two"}],
                                fmt)
        assert "task" in mp.prefix
        assert "two" in mp.suffix
        return mp.prefix, mp.suffix
    parity(scenario)


def test_provider_context_overflow():
    def scenario(C):
        model = C.ModelResource(name="m", version=1, arch="mock",
                                context_window=10, max_output_tokens=5)
        mp = C.build_metaprompt("complete", "x" * 500, [{"a": "b"}])
        with pytest.raises(C.ContextOverflowError) as err:
            C.MockProvider().complete(model, mp, 1)
        return str(err.value)
    parity(scenario)


def test_filter_returns_booleans():
    def scenario(C):
        ctx = C.SemanticContext()
        out = C.llm_filter(ctx, {"model": "m"}, {"prompt": "p"},
                           [{"v": i} for i in range(10)])
        assert all(isinstance(b, bool) for b in out)
        return out, [report(r) for r in ctx.reports], pstats(ctx.provider)
    parity(scenario)


def test_reduce_and_json():
    def scenario(C):
        ctx = C.SemanticContext()
        rows = [{"v": i} for i in range(5)]
        s = C.llm_reduce(ctx, {"model": "m"}, {"prompt": "summarize"}, rows)
        assert isinstance(s, str)
        j = C.llm_reduce_json(ctx, {"model": "m"}, {"prompt": "summarize"},
                              rows)
        assert isinstance(j, dict)
        return s, j, pstats(ctx.provider)
    parity(scenario)


def test_rerank_first_last_consistent():
    def scenario(C):
        ctx = C.SemanticContext()
        rows = [{"doc": f"d{i}"} for i in range(7)]
        spec = ({"model": "m"}, {"prompt": "relevance"})
        perm = C.llm_rerank(ctx, *spec, rows)
        assert sorted(perm) == list(range(7))
        first = C.llm_first(ctx, *spec, rows)
        last = C.llm_last(ctx, *spec, rows)
        assert first == rows[perm[0]]
        assert last == rows[perm[-1]]
        return perm, first, last, pstats(ctx.provider)
    parity(scenario)


def test_rerank_windowed_over_long_lists():
    def scenario(C):
        ctx = C.SemanticContext()
        rows = [{"doc": f"d{i}"} for i in range(37)]
        perm = C.llm_rerank(ctx, {"model": "m"}, {"prompt": "q"}, rows,
                            window=10, stride=5)
        assert sorted(perm) == list(range(37))
        return perm, pstats(ctx.provider)
    parity(scenario)


def test_embedding_shape_and_dedup():
    def scenario(C):
        ctx = C.SemanticContext()
        e = C.llm_embedding(ctx, {"model": "e", "embedding_dim": 16},
                            ["a", "b", "a", "c", "b"])
        assert e.shape == (5, 16)
        np.testing.assert_allclose(e[0], e[2])
        assert ctx.reports[-1].n_unique == 3
        return e.tolist(), report(ctx.reports[-1])
    parity(scenario)


def test_catalog_persistence(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.json"
        c1 = C.Catalog(str(path))
        c1.create_model("m", arch="olmo-1b", context_window=123)
        c1.create_prompt("p", "text-v1")
        c1.update_prompt("p", "text-v2")
        c2 = C.Catalog(str(path))
        assert c2.get_model("m").context_window == 123
        assert c2.get_prompt("p").text == "text-v2"
        assert c2.get_prompt("p@1").text == "text-v1"
        return c2.get_model("m").ref, c2.get_prompt("p").ref
    parity(scenario)


def test_fusion_dispatch_unknown():
    def scenario(C):
        with pytest.raises(ValueError) as err:
            C.fusion("nope", np.ones(3))
        return str(err.value)
    parity(scenario)


def test_null_on_single_tuple_overflow():
    def scenario(C):
        ctx = C.SemanticContext()
        rows = [{"v": "x" * 10_000}, {"v": "small"}]
        out = C.llm_complete(ctx, {"model": "m", "context_window": 512,
                                   "max_output_tokens": 16},
                             {"prompt": "p"}, rows)
        assert out[0] is None
        assert out[1] is not None
        assert ctx.reports[-1].nulls == 1
        return out, report(ctx.reports[-1]), pstats(ctx.provider)
    parity(scenario)


# ---------------------------------------------------------------------------
# fusion (repro/core/fusion.py)
# ---------------------------------------------------------------------------
def _score_columns(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 10, 40)
    b = rng.uniform(0, 10, 40)
    b[rng.integers(0, 40, 6)] = np.nan      # rows one retriever missed
    c = np.round(rng.uniform(0, 3, 40))     # ties
    return a, b, c


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", sorted(R.FUSION_METHODS))
def test_fusion_matches_reference(method, seed):
    cols = _score_columns(seed)
    got = T.fusion(method, *cols)
    ref = R.fusion(method, *cols)
    np.testing.assert_array_equal(got, ref)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(T.max_normalize(cols[1]),
                                  R.max_normalize(cols[1]))


# ---------------------------------------------------------------------------
# tests/test_properties.py (the BM25 cases need the engine half)
# ---------------------------------------------------------------------------
@SMALL
@given(costs=st.lists(st.integers(1, 300), min_size=1, max_size=100),
       ctx_window=st.integers(50, 2000),
       out_tokens=st.integers(1, 50))
def test_batch_plan_partition(costs, ctx_window, out_tokens):
    def scenario(C):
        plan = C.plan_batches(costs, prefix_tokens=10,
                              context_window=ctx_window,
                              max_output_tokens=out_tokens)
        flat = [i for b in plan.batches for i in b]
        assert flat == list(range(len(costs)))
        budget = ctx_window - 10
        for b in plan.batches:
            if len(b) > 1:
                assert sum(costs[i] + out_tokens for i in b) <= budget
        return plan.batches, plan.est_tokens
    parity(scenario)


@SMALL
@given(n=st.integers(1, 60), cap=st.integers(1, 400))
def test_adaptive_backoff_terminates_and_covers(n, cap):
    def scenario(C):
        def call(batch):
            if len(batch) * 20 > cap:
                raise C.ContextOverflowError("too big")
            return [f"v{i}" for i in batch]

        results, stats = C.execute_serial(
            list(range(n)), [13] * n, prefix_tokens=0,
            context_window=10_000, max_output_tokens=7, call=call)
        if 20 > cap:
            assert all(r is None for r in results)
            assert stats.nulls == n
        else:
            assert all(r is not None for r in results)
        return results, (stats.requests, stats.retries, stats.nulls,
                         stats.batch_sizes)
    parity(scenario)


@SMALL
@given(vals=st.lists(st.sampled_from(["a", "b", "c", "d"]), min_size=1,
                     max_size=40))
def test_dedup_equals_no_dedup(vals):
    def scenario(C):
        tuples = [{"v": v} for v in vals]
        model = {"model": "m", "context_window": 100_000,
                 "max_output_tokens": 4}
        ctx1 = C.SemanticContext(enable_dedup=True)
        ctx2 = C.SemanticContext(enable_dedup=False, enable_cache=False)
        r1 = C.llm_complete(ctx1, model, {"prompt": "classify"}, tuples)
        r2 = C.llm_complete(ctx2, model, {"prompt": "classify"}, tuples)
        assert r1 == r2
        assert ctx1.reports[-1].n_unique == len(set(vals))
        return r1, report(ctx1.reports[-1]), report(ctx2.reports[-1])
    parity(scenario)


@SMALL
@given(vals=st.lists(st.text(alphabet="xyz", min_size=1, max_size=4),
                     min_size=1, max_size=20))
def test_cache_hit_equals_recompute(vals):
    def scenario(C):
        tuples = [{"v": v} for v in vals]
        model = {"model": "m", "context_window": 100_000,
                 "max_output_tokens": 4}
        ctx = C.SemanticContext()
        first = C.llm_complete(ctx, model, {"prompt": "classify"}, tuples)
        calls_before = ctx.provider.stats.calls
        second = C.llm_complete(ctx, model, {"prompt": "classify"}, tuples)
        assert second == first
        assert ctx.provider.stats.calls == calls_before
        return first, [report(r) for r in ctx.reports]
    parity(scenario)


def test_cache_lru_eviction():
    def scenario(C):
        c = C.PredictionCache(capacity=3)
        for i in range(5):
            c.put(f"k{i}", i)
        assert c.get("k0") == (False, None)
        assert c.get("k4") == (True, 4)
        return list(c._data.items()), c.stats
    parity(scenario)


scores = st.lists(st.floats(0, 10, allow_nan=False), min_size=2,
                  max_size=30)


@SMALL
@given(s=scores)
def test_fusion_permutation_consistency(s):
    def scenario(C):
        a = np.asarray(s)
        out = []
        for fn in (C.combsum, C.combmnz, C.combanz, C.combmed):
            f = fn(a, a)
            assert np.all(np.argsort(-f, kind="stable")
                          == np.argsort(-fn(a, a), kind="stable"))
            out.append(f.tolist())
        return out
    parity(scenario)


@SMALL
@given(s=scores)
def test_rrf_rank_monotonic(s):
    def scenario(C):
        a = np.asarray(s)
        f = C.rrf(a)
        fo = f[np.argsort(-a, kind="stable")]
        assert np.all(np.diff(fo) <= 1e-12)
        return f.tolist()
    parity(scenario)


@SMALL
@given(s=scores)
def test_combsum_commutative(s):
    def scenario(C):
        a = np.asarray(s)
        b = a[::-1].copy()
        assert np.allclose(C.combsum(a, b), C.combsum(b, a))
        return C.combsum(a, b).tolist()
    parity(scenario)


@SMALL
@given(d=st.dictionaries(st.sampled_from(["a", "b", "c"]),
                         st.text(max_size=8), min_size=1, max_size=3),
       fmt=st.sampled_from(["xml", "json", "markdown"]))
def test_serialization_deterministic(d, fmt):
    def scenario(C):
        assert C.serialize_tuple(d, fmt) == C.serialize_tuple(dict(d), fmt)
        return C.serialize_tuple(d, fmt)
    parity(scenario)


# ---------------------------------------------------------------------------
# tests/test_copack.py: batch planning, sidecars, headroom
# ---------------------------------------------------------------------------
def test_plan_batches_est_tokens_exclude_output_tokens():
    def scenario(C):
        plan = C.plan_batches([10, 10, 10], prefix_tokens=0,
                              context_window=10_000, max_output_tokens=100)
        assert plan.batches == [[0, 1, 2]]
        assert plan.est_tokens == [30]
        return plan.batches, plan.est_tokens
    parity(scenario)


def test_plan_batches_output_tokens_still_shape_the_budget():
    def scenario(C):
        plan = C.plan_batches([10, 10, 10], prefix_tokens=0,
                              context_window=121, max_output_tokens=50)
        assert plan.batches == [[0, 1], [2]]
        assert plan.est_tokens == [20, 10]
        return plan.batches, plan.est_tokens
    parity(scenario)


def test_plan_batches_headroom_shrinks_budget():
    def scenario(C):
        costs = [10] * 12
        full = C.plan_batches(costs, prefix_tokens=0, context_window=144,
                              max_output_tokens=2)
        half = C.plan_batches(costs, prefix_tokens=0, context_window=144,
                              max_output_tokens=2, headroom=0.5)
        assert len(full.batches) == 1
        assert len(half.batches) == 2
        assert (max(len(b) for b in half.batches)
                < max(len(b) for b in full.batches))
        return full.batches, half.batches
    parity(scenario)


def test_sidecar_save_does_not_clobber_sibling_tmp(tmp_path):
    def scenario(C):
        d = tmp_path / C.__name__
        d.mkdir()
        sentinel = d / "x.tmp"
        sentinel.write_text("do not touch")
        store = C.SelectivityStore(str(d / "x.sel"))
        store.save({"p@1": [1, 2]})
        assert sentinel.read_text() == "do not touch"
        assert store.load() == {"p@1": [1, 2]}
        cal = C.CalibrationStore(str(d / "x.cal"))
        cal.save({"m@1": {"requests": 1, "retries": 0, "tuples": 2,
                          "latency_s": [0.1]}})
        assert sentinel.read_text() == "do not touch"
        assert cal.load()["m@1"]["requests"] == 1
        return sorted(p.name for p in d.iterdir())
    parity(scenario)


def test_multidot_sidecar_paths_roundtrip(tmp_path):
    def scenario(C):
        d = tmp_path / C.__name__
        d.mkdir()
        store = C.SelectivityStore(str(d / "cache.jsonl.selectivity.json"))
        store.save({"p@1": [3, 10]})
        assert store.load() == {"p@1": [3, 10]}
        assert not (d / "cache.jsonl.selectivity.tmp").exists()
        assert not (d / "cache.tmp").exists()
        return sorted(p.name for p in d.iterdir())
    parity(scenario)


def test_prediction_cache_compact_uses_fullname_tmp(tmp_path):
    def scenario(C):
        d = tmp_path / C.__name__
        d.mkdir()
        sentinel = d / "cache.tmp"
        sentinel.write_text("unrelated")
        cache = C.PredictionCache(persist_path=str(d / "cache.jsonl"))
        cache.put("k", "v")
        cache.compact()
        assert sentinel.read_text() == "unrelated"
        assert C.PredictionCache(
            persist_path=str(d / "cache.jsonl")).get("k") == (True, "v")
        return (d / "cache.jsonl").read_text()
    parity(scenario)


def test_bound_observations_caps_total():
    def scenario(C):
        window = sub(C, "cache").SELECTIVITY_WINDOW
        assert C.bound_observations(10, 100) == (10, 100)
        p, t = C.bound_observations(9000, 10_000)
        assert t == window
        assert p == round(9000 * window / 10_000)
        return p, t
    parity(scenario)


def test_selectivity_relearns_after_distribution_shift():
    def scenario(C):
        ctx = C.SemanticContext(provider=C.MockProvider())
        ctx.record_selectivity("p@1", 900, 1000)
        for _ in range(30):
            ctx.record_selectivity("p@1", 10, 100)
        est = ctx.expected_selectivity("p@1")
        assert est < 0.2, f"windowed estimate did not re-learn: {est}"
        assert (ctx.selectivity_stats["p@1"][1]
                <= sub(C, "cache").SELECTIVITY_WINDOW)
        return est, ctx.selectivity_stats
    parity(scenario)


def test_selectivity_store_bounds_legacy_oversized_entries(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.json"
        path.write_text(json.dumps({"stats": {"p@1": [90_000, 100_000]}}))
        loaded = C.SelectivityStore(str(path)).load()
        assert loaded["p@1"][1] == sub(C, "cache").SELECTIVITY_WINDOW
        assert abs(loaded["p@1"][0] / loaded["p@1"][1] - 0.9) < 0.01
        return loaded
    parity(scenario)


def test_headroom_factor_thresholds():
    def scenario(C):
        cache = sub(C, "cache")
        assert C.headroom_factor(0, 0) == 1.0
        assert C.headroom_factor(cache.HEADROOM_MIN_OBS, 0) == 1.0
        assert C.headroom_factor(2, 1) == 1.0
        assert C.headroom_factor(8, 2) == pytest.approx(0.8)
        assert C.headroom_factor(1, 100) == cache.HEADROOM_MIN
        return [C.headroom_factor(r, x) for r in range(0, 40, 3)
                for x in range(0, 40, 5)]
    parity(scenario)


def test_headroom_read_path_from_calibration_sidecar(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        C.CalibrationStore(cache_path + ".calibration.json").save(
            {"m@0": {"requests": 30, "retries": 10, "tuples": 300,
                     "latency_s": [0.01]}})
        ctx = C.SemanticContext(
            cache=C.PredictionCache(persist_path=cache_path),
            provider=C.MockProvider())
        assert ctx.batch_headroom("m@0") == pytest.approx(0.75)
        assert ctx.batch_headroom("unknown@9") == 1.0
        rows = [{"t": f"row number {i} with some body text"}
                for i in range(40)]
        model = {"model": "m", "context_window": 700,
                 "max_output_tokens": 8}
        ctrl = C.SemanticContext(provider=C.MockProvider())
        C.llm_complete(ctrl, model, {"prompt": "p"}, rows)
        C.llm_complete(ctx, model, {"prompt": "p"}, rows)
        assert (max(ctx.last_report().batch_sizes)
                < max(ctrl.last_report().batch_sizes))
        return report(ctx.last_report()), report(ctrl.last_report())
    parity(scenario)


def test_headroom_avoids_overflow_retries_across_sessions(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        model = {"model": "tight", "context_window": 260,
                 "max_output_tokens": 2}

        def run(tag):
            ctx = C.SemanticContext(
                cache=C.PredictionCache(persist_path=cache_path),
                provider=C.MockProvider(), enable_dedup=False)
            rows = [{"t": f"{tag} row {i} and padding padding {i}"}
                    for i in range(48)]
            with ctx:
                C.llm_complete(ctx, model, {"prompt": "p"}, rows)
            return ctx.last_report()

        first = run("alpha")
        assert first.retries > 0
        second = run("beta")
        assert second.retries < first.retries
        return report(first), report(second)
    parity(scenario)


def test_calibration_counters_bounded():
    def scenario(C):
        ctx = C.SemanticContext(provider=C.MockProvider())
        for _ in range(40):
            ctx.record_calibration("m@1", requests=200, retries=10,
                                   tuples=2000, latencies=[0.01])
        rec = ctx.calibration_stats["m@1"]
        assert (rec["requests"] + rec["retries"]
                <= sub(C, "cache").CALIBRATION_COUNT_WINDOW + 1)
        assert rec["retries"] / (rec["requests"] + rec["retries"]) \
            == pytest.approx(10 / 210, rel=0.05)
        return rec
    parity(scenario)


# ---------------------------------------------------------------------------
# tests/test_speculative.py: the calibration sidecar's lifecycle
# ---------------------------------------------------------------------------
def test_calibration_store_roundtrip_and_corruption(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.json"
        store = C.CalibrationStore(str(path))
        assert store.load() == {}
        rec = {"m@1": {"requests": 4, "retries": 1, "tuples": 20,
                       "latency_s": [0.1, 0.2]}}
        store.save(rec)
        assert store.load() == rec
        path.write_text("{definitely not json")
        assert store.load() == {}
        path.write_text(json.dumps({"models": {
            "good@1": {"requests": 1, "retries": 0, "tuples": 2,
                       "latency_s": [0.5]},
            "bad1": {"requests": -3, "retries": 0, "tuples": 0,
                     "latency_s": []},
            "bad2": {"requests": 1, "retries": 0, "tuples": 1,
                     "latency_s": "oops"}}}))
        assert set(store.load()) == {"good@1"}
        return store.load()
    parity(scenario)


def test_calibration_persists_across_sessions(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        rows = [{"t": f"row {i}"} for i in range(8)]
        model = {"model": "m", "context_window": 8192,
                 "max_output_tokens": 8}
        with C.SemanticContext(
                cache=C.PredictionCache(persist_path=cache_path)) as ctx1:
            out = C.llm_complete(ctx1, model, {"prompt": "p"}, rows)
            assert ctx1.calibrated_latency("m@0") is not None
        ctx2 = C.SemanticContext(
            cache=C.PredictionCache(persist_path=cache_path))
        assert ctx2.calibrated_latency("m@0") is not None
        assert ctx2.calibration_stats["m@0"]["requests"] >= 1
        return out, ctx2.calibration_stats["m@0"]["requests"]
    parity(scenario)


def test_calibration_pruned_on_model_version_bump(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        catalog = C.Catalog()
        catalog.create_model("m", arch="mock")
        with C.SemanticContext(
                catalog=catalog,
                cache=C.PredictionCache(persist_path=cache_path)) as ctx1:
            ctx1.record_calibration("m@1", requests=3, retries=0, tuples=9,
                                    latencies=[0.1, 0.1, 0.1])
        catalog.update_model("m", context_window=9999)
        ctx2 = C.SemanticContext(
            catalog=catalog, cache=C.PredictionCache(persist_path=cache_path))
        assert "m@1" not in ctx2.calibration_stats
        assert ctx2.calibrated_latency("m@1") is None
        with C.SemanticContext(
                catalog=catalog,
                cache=C.PredictionCache(persist_path=cache_path)) as ctx3:
            ctx3.record_calibration("inline-model@0", requests=1,
                                    retries=0, tuples=2, latencies=[0.2])
        ctx4 = C.SemanticContext(
            catalog=catalog, cache=C.PredictionCache(persist_path=cache_path))
        assert "inline-model@0" in ctx4.calibration_stats
        return sorted(ctx4.calibration_stats)
    parity(scenario)


def test_calibration_latency_window_bounded():
    def scenario(C):
        ctx = C.SemanticContext()
        for _ in range(5):
            ctx.record_calibration("m@1", requests=100, retries=0,
                                   tuples=100, latencies=[0.01] * 100)
        assert (len(ctx.calibration_stats["m@1"]["latency_s"])
                == sub(C, "cache").CALIBRATION_WINDOW)
        assert ctx.calibration_stats["m@1"]["requests"] == 500
        return ctx.calibration_stats
    parity(scenario)


def test_calibrated_latency_percentiles():
    def scenario(C):
        ctx = C.SemanticContext()
        ctx.record_calibration("m@1", requests=4, retries=0, tuples=8,
                               latencies=[0.1, 0.2, 0.3, 0.4])
        assert ctx.calibrated_latency("m@1") == pytest.approx(0.25)
        assert ctx.calibrated_latency("m@1", pct=100) == pytest.approx(0.4)
        assert ctx.calibrated_latency("missing@1") is None
        assert ctx.calibrated_retry_rate("missing@1") == 0.0
        return [ctx.calibrated_latency("m@1", p) for p in (10, 50, 90)]
    parity(scenario)


def test_debounced_stats_flush_on_context_exit(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        sel_path = tmp_path / f"{C.__name__}.jsonl.selectivity.json"
        cal_path = tmp_path / f"{C.__name__}.jsonl.calibration.json"
        with C.SemanticContext(
                cache=C.PredictionCache(persist_path=cache_path)) as ctx:
            ctx.record_selectivity("p@1", 1, 2)
            ctx.record_selectivity("p@1", 1, 2)
            ctx.record_calibration("m@1", requests=1, retries=0, tuples=2,
                                   latencies=[0.1])
            ctx.record_calibration("m@1", requests=1, retries=0, tuples=2,
                                   latencies=[0.2])
            assert json.loads(sel_path.read_text())["stats"]["p@1"] == [1, 2]
            assert json.loads(cal_path.read_text())["models"]["m@1"][
                "requests"] == 1
        assert json.loads(sel_path.read_text())["stats"]["p@1"] == [2, 4]
        assert json.loads(cal_path.read_text())["models"]["m@1"][
            "requests"] == 2
        return sel_path.read_text(), cal_path.read_text()
    parity(scenario)


def test_corrupt_sidecars_recover_to_empty(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        (tmp_path / f"{C.__name__}.jsonl.selectivity.json").write_text(
            "<not json>")
        (tmp_path / f"{C.__name__}.jsonl.calibration.json").write_text(
            "[1, 2, 3]")
        ctx = C.SemanticContext(
            cache=C.PredictionCache(persist_path=cache_path))
        assert ctx.selectivity_stats == {}
        assert ctx.calibration_stats == {}
        with ctx:
            ctx.record_selectivity("p@1", 1, 4)
            ctx.record_calibration("m@1", requests=1, retries=0, tuples=1,
                                   latencies=[0.1])
        ctx2 = C.SemanticContext(
            cache=C.PredictionCache(persist_path=cache_path))
        assert ctx2.selectivity_stats == {"p@1": [1, 4]}
        assert ctx2.calibration_stats["m@1"]["requests"] == 1
        return ctx2.selectivity_stats
    parity(scenario)


def test_execution_reports_carry_latencies():
    def scenario(C):
        ctx = C.SemanticContext(provider=C.MockProvider())
        C.llm_complete(ctx, {"model": "m", "context_window": 8192,
                             "max_output_tokens": 8},
                       {"prompt": "p"}, [{"t": f"row {i}"} for i in range(6)])
        rep = ctx.last_report()
        assert rep.requests >= 1
        assert len(rep.latencies) == rep.requests
        assert all(isinstance(x, float) and x >= 0 for x in rep.latencies)
        assert np.isfinite(ctx.calibrated_latency("m@0"))
        return report(rep)
    parity(scenario)


# ---------------------------------------------------------------------------
# tests/test_latency.py: monotonic latency, calibration self-heal
# ---------------------------------------------------------------------------
def test_mock_provider_latency_survives_wall_clock_step(monkeypatch):
    def scenario(C):
        pm = sub(C, "provider")
        steps = iter([1e9 - 100.0 * i for i in range(64)])
        monkeypatch.setattr(pm.time, "time", lambda: next(steps))
        model = C.ModelResource(name="m", version=1, arch="mock",
                                context_window=4096, max_output_tokens=8,
                                max_concurrency=4)
        prov = pm.MockProvider()
        out = prov.complete(model, C.build_metaprompt(
            "complete", "p", [{"t": "x"}], "xml"), 1)
        assert len(out) == 1
        assert prov.stats.latency_s >= 0.0
        monkeypatch.undo()
        return out, pstats(prov)
    parity(scenario)


def test_calibration_latencies_nonnegative_under_clock_step(monkeypatch):
    def scenario(C):
        pm = sub(C, "provider")
        steps = iter([1e9 - 100.0 * i for i in range(4096)])
        monkeypatch.setattr(pm.time, "time", lambda: next(steps, 0.0))
        ctx = C.SemanticContext(provider=C.MockProvider())
        out = C.llm_complete(ctx, {"model": "cp", "context_window": 100_000,
                                   "max_output_tokens": 8},
                             {"prompt": "p"},
                             [{"t": f"row {i}"} for i in range(4)])
        for rec in ctx.calibration_stats.values():
            assert all(x >= 0 for x in rec["latency_s"])
        monkeypatch.undo()
        return out
    parity(scenario)


def test_calibration_store_drops_negative_latency_values(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.json"
        path.write_text(
            '{"models": {"m@1": {"requests": 10, "retries": 1, '
            '"tuples": 50, "latency_s": '
            '[0.1, -3.0, Infinity, NaN, true, "bogus", 0.2]}}}')
        loaded = C.CalibrationStore(str(path)).load()
        assert loaded["m@1"]["requests"] == 10
        assert loaded["m@1"]["retries"] == 1
        assert loaded["m@1"]["latency_s"] == [0.1, 0.2]
        return loaded
    parity(scenario)


def test_calibration_store_still_rejects_malformed_records(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.json"
        path.write_text(json.dumps({"models": {
            "a@1": {"requests": -1, "retries": 0, "tuples": 0,
                    "latency_s": []},
            "b@1": {"requests": 1, "retries": 0, "tuples": 2,
                    "latency_s": "oops"},
            "c@1": {"requests": 1, "retries": 0, "tuples": 2,
                    "latency_s": [0.3]}}}))
        loaded = C.CalibrationStore(str(path)).load()
        assert set(loaded) == {"c@1"}
        assert loaded["c@1"]["latency_s"] == [0.3]
        return loaded
    parity(scenario)


# ---------------------------------------------------------------------------
# tests/test_scheduler.py: shared counters and the persistence satellites
# ---------------------------------------------------------------------------
def test_provider_stats_thread_safety_stress():
    import threading

    def scenario(C):
        stats = sub(C, "provider").ProviderStats()

        def worker():
            for _ in range(2000):
                stats.add(calls=1, prompt_tokens=3, output_tokens=2)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert stats.calls == 8 * 2000
        assert stats.prompt_tokens == 3 * 8 * 2000
        assert stats.output_tokens == 2 * 8 * 2000
        return stats.snapshot()
    parity(scenario)


def test_prediction_cache_thread_safety_stress(tmp_path):
    import threading

    def scenario(C):
        path = str(tmp_path / f"{C.__name__}.jsonl")
        cache = C.PredictionCache(capacity=500, persist_path=path)

        def worker(tid):
            for i in range(400):
                key = f"k{(tid * 7 + i) % 300}"
                cache.put(key, f"v{i % 5}")
                cache.get(key)
                cache.peek(key)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(cache._data) <= 300
        cache.compact()
        reloaded = C.PredictionCache(persist_path=path)
        assert set(reloaded._data) == set(cache._data)
        return sorted(reloaded._data)
    parity(scenario)


def test_cache_noop_puts_do_not_grow_file(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.jsonl"
        cache = C.PredictionCache(persist_path=str(path))
        for _ in range(50):
            cache.put("k", "v")
        assert len(path.read_text().splitlines()) == 1
        cache.put("k", "v2")
        assert len(path.read_text().splitlines()) == 2
        return path.read_text()
    parity(scenario)


def test_cache_compact_rewrites_from_live_lru(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.jsonl"
        cache = C.PredictionCache(capacity=10, persist_path=str(path))
        for i in range(30):
            cache.put(f"k{i}", f"v{i}")
        assert len(path.read_text().splitlines()) == 30
        cache.compact()
        lines = path.read_text().splitlines()
        assert len(lines) == 10
        assert ({json.loads(ln)["k"] for ln in lines}
                == {f"k{i}" for i in range(20, 30)})
        assert C.PredictionCache(persist_path=str(path)).get("k29") \
            == (True, "v29")
        return path.read_text()
    parity(scenario)


MODEL = {"model": "m", "context_window": 700, "max_output_tokens": 8,
         "max_concurrency": 4}


def test_selectivity_persists_across_sessions(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        catalog = C.Catalog()
        catalog.create_prompt("joins", "is about joins")
        rows = [{"t": f"{'join' if i % 4 == 0 else 'scan'} {i}"}
                for i in range(16)]
        ctx1 = C.SemanticContext(
            catalog=catalog, cache=C.PredictionCache(persist_path=cache_path))
        mask = C.llm_filter(ctx1, MODEL, {"prompt_name": "joins"}, rows)
        ref = catalog.get_prompt("joins").ref
        sel = ctx1.expected_selectivity(ref, default=-1.0)
        assert sel >= 0.0
        assert (tmp_path / f"{C.__name__}.jsonl.selectivity.json").exists()
        ctx2 = C.SemanticContext(
            catalog=catalog, cache=C.PredictionCache(persist_path=cache_path))
        assert ctx2.expected_selectivity(ref, default=-1.0) == sel
        return mask, sel
    parity(scenario)


def test_selectivity_invalidated_on_prompt_version_bump(tmp_path):
    def scenario(C):
        C.reset_global_catalog()
        cache_path = str(tmp_path / f"{C.__name__}.jsonl")
        catalog = C.Catalog()
        catalog.create_prompt("joins", "is about joins")
        ctx1 = C.SemanticContext(
            catalog=catalog, cache=C.PredictionCache(persist_path=cache_path))
        old_ref = catalog.get_prompt("joins").ref
        ctx1.record_selectivity(old_ref, 3, 10)
        catalog.update_prompt("joins", "is strictly about join algorithms")
        ctx2 = C.SemanticContext(
            catalog=catalog, cache=C.PredictionCache(persist_path=cache_path))
        assert ctx2.expected_selectivity(old_ref, default=-1.0) == -1.0
        assert ctx2.expected_selectivity(catalog.get_prompt("joins").ref,
                                         default=-1.0) == -1.0
        return ctx2.selectivity_stats
    parity(scenario)


def test_selectivity_store_roundtrip_and_corruption(tmp_path):
    def scenario(C):
        path = tmp_path / f"{C.__name__}.json"
        store = C.SelectivityStore(str(path))
        assert store.load() == {}
        store.save({"p@1": [3, 10], "inline:x": [1, 2]})
        assert store.load() == {"p@1": [3, 10], "inline:x": [1, 2]}
        saved = path.read_text()
        path.write_text("{not json")
        assert store.load() == {}
        return saved
    parity(scenario)


# ---------------------------------------------------------------------------
# sidecar files written by one package load in the other
# ---------------------------------------------------------------------------
DIRECTIONS = pytest.mark.parametrize("src,dst", [(R, T), (T, R)],
                                     ids=["ref-to-port", "port-to-ref"])


@DIRECTIONS
def test_prediction_cache_file_crosses_packages(tmp_path, src, dst):
    path = str(tmp_path / "cache.jsonl")
    values = {"a": "text", "b": [3, 1, 2], "c": {"value": "v1"}, "d": 0.5,
              "e": [0.25, -1.0]}
    w = src.PredictionCache(persist_path=path)
    for k, v in values.items():
        w.put(src.cache_key("m@1", "inline:p", "complete", "xml", k), v)
    r = dst.PredictionCache(persist_path=path)
    for k, v in values.items():
        key = dst.cache_key("m@1", "inline:p", "complete", "xml", k)
        assert r.get(key) == (True, v)
    # the two packages write the same bytes for the same puts
    other = tmp_path / "other.jsonl"
    w2 = dst.PredictionCache(persist_path=str(other))
    for k, v in values.items():
        w2.put(dst.cache_key("m@1", "inline:p", "complete", "xml", k), v)
    assert other.read_bytes() == (tmp_path / "cache.jsonl").read_bytes()


@DIRECTIONS
def test_stat_sidecars_cross_packages(tmp_path, src, dst):
    sel = {"p@1": [3, 10], "inline:x": [1, 2]}
    cal = {"m@1": {"requests": 4, "retries": 1, "tuples": 20,
                   "latency_s": [0.1, 0.2]}}
    src.SelectivityStore(str(tmp_path / "s.json")).save(sel)
    src.CalibrationStore(str(tmp_path / "c.json")).save(cal)
    assert dst.SelectivityStore(str(tmp_path / "s.json")).load() == sel
    assert dst.CalibrationStore(str(tmp_path / "c.json")).load() == cal
    dst.SelectivityStore(str(tmp_path / "s2.json")).save(sel)
    dst.CalibrationStore(str(tmp_path / "c2.json")).save(cal)
    for a, b in (("s", "s2"), ("c", "c2")):
        assert ((tmp_path / f"{a}.json").read_bytes()
                == (tmp_path / f"{b}.json").read_bytes())


@DIRECTIONS
def test_index_store_crosses_packages(tmp_path, src, dst):
    rng = np.random.default_rng(5)
    base = rng.standard_normal((6, 8)).astype(np.float32)
    delta = rng.standard_normal((3, 8)).astype(np.float32)
    texts = [f"doc {i}" for i in range(9)]
    fp_base = src.corpus_fingerprint(texts[:6])
    fp_all = src.corpus_fingerprint(texts)
    assert dst.corpus_fingerprint(texts) == fp_all
    w = src.IndexStore(str(tmp_path / "idx.json"))
    w.put("e@1", fp_base, base)
    assert w.append_segment("e@1", fp_base, fp_all, delta)
    r = dst.IndexStore(str(tmp_path / "idx.json"))
    np.testing.assert_array_equal(r.get("e@1", fp_base), base)
    np.testing.assert_array_equal(r.get("e@1", fp_all),
                                  np.concatenate([base, delta]))
    assert sorted(r.entries("e@1")) == sorted(w.entries("e@1"))
    assert r.keys() == w.keys() and r.segment_keys() == w.segment_keys()


@DIRECTIONS
def test_catalog_file_crosses_packages(tmp_path, monkeypatch, src, dst):
    """A catalog persisted by either package loads in the other; the two
    files differ only in ``ModelResource.provider``'s default."""
    monkeypatch.setattr(sub(src, "resources").time, "time", lambda: 1234.5)
    for C, name in ((src, "a.json"), (dst, "b.json")):
        c = C.Catalog(str(tmp_path / name))
        c.create_model("m", arch="olmo-1b", context_window=640,
                       max_output_tokens=4)
        c.update_model("m", max_output_tokens=8)
        c.create_prompt("p", "is it about joins?")
        c.update_prompt("p", "is it about join algorithms?")
    loaded = dst.Catalog(str(tmp_path / "a.json"))
    assert loaded.get_model("m").ref == "m@2"
    assert loaded.get_model("m@1").max_output_tokens == 4
    assert loaded.get_model("m").provider == src.ModelResource(
        name="x", version=0, arch="mock").provider
    assert loaded.get_prompt("p").text == "is it about join algorithms?"
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    providers = {"local-jax", "local-torch"}
    for doc in (a, b):
        for versions in doc["models"].values():
            for rec in versions:
                assert rec.pop("provider") in providers
    assert a == b


@DIRECTIONS
def test_session_sidecars_serve_the_other_package(tmp_path, src, dst):
    """A session of one package persists its prediction cache, selectivity
    and calibration; a session of the other package on the same path
    answers every call from the cache with no provider request."""
    cache_path = str(tmp_path / "cache.jsonl")
    rows = _rows(seed=3)

    def session(C):
        C.reset_global_catalog()
        ctx = C.SemanticContext(
            provider=C.MockProvider(),
            cache=C.PredictionCache(persist_path=cache_path))
        with ctx:
            out = [C.llm_filter(ctx, MATRIX_MODEL, {"prompt": "joins?"},
                                rows),
                   C.llm_complete(ctx, MATRIX_MODEL, {"prompt": "sum"}, rows),
                   C.llm_embedding(ctx, MATRIX_MODEL, rows).tolist(),
                   C.llm_rerank(ctx, MATRIX_MODEL, {"prompt": "rank"},
                                rows[:12], window=6, stride=3)]
        return ctx, out

    ctx_w, out_w = session(src)
    ctx_r, out_r = session(dst)
    assert out_r == out_w
    assert ctx_w.provider.stats.calls > 0
    assert ctx_r.provider.stats.calls == 0
    # the reading session records its (cache-served) verdicts once more
    assert ctx_r.selectivity_stats == {
        k: [2 * a, 2 * b] for k, (a, b) in ctx_w.selectivity_stats.items()}
    assert ([r.cache_hits for r in ctx_r.reports]
            == [r.n_unique for r in ctx_r.reports])
