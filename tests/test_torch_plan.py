"""The slice on the CPU: the port's plan layer (``repro_torch.core``)
driving ``LocalTorchProvider`` against the reference's (``repro.core``)
driving ``LocalJaxProvider``, on one f32 smoke olmo-1b weight set bridged
with ``repro_torch.params.from_jax``.

Generation runs in f32, where greedy argmax is stable, so the semantic
functions must return identical strings, masks and permutations, with
identical ``ExecutionReport`` counts and provider counters, with and
without a scheduler.  ``llm_embedding`` agrees within 1e-4, the tolerance
of ``tests/test_torch_serving.py``.  A request longer than the engine's
2,048 slots is dropped by both engines with no error (ROADMAP.md, queue
C): its generation is empty in both packages.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# one intra-op thread per xdist worker keeps small CPU ops from
# oversubscribing the cores
torch.set_num_threads(1)

import repro.core as R
import repro_torch.core as T
from repro.configs import get_smoke_config as jax_smoke
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
GEN = {"model": "gen", "arch": "olmo-1b", "context_window": 300,
       "max_output_tokens": 4}
EMB = {"model": "emb", "arch": "olmo-1b"}
WORDS = ("join", "hash", "sort", "index", "vector", "query", "scan", "plan")


@pytest.fixture(scope="module")
def providers():
    """LocalJaxProvider and LocalTorchProvider(device="cpu") on one f32
    engine weight set."""
    jp = R.LocalJaxProvider()
    jp.engine = JaxEngine(jax_smoke("olmo-1b").replace(remat=False, **F32),
                          max_context=2048)
    tp = T.LocalTorchProvider(device="cpu")
    tp.engine = ServingEngine(
        get_smoke_config("olmo-1b").replace(**F32), device="cpu",
        max_context=2048,
        params=from_jax(jax.tree.map(np.asarray, jp.engine.params)))
    return {R: jp, T: tp}


def _table(seed=0, n=10, dups=2, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    rows = [{"title": f"paper {i}",
             "abstract": " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))}
            for i in range(n)]
    return rows + [dict(rows[int(i)]) for i in rng.integers(0, n, dups)]


def _counters(provider):
    s = provider.stats.snapshot()
    return {k: s[k] for k in ("calls", "prompt_tokens", "output_tokens")}


def _run(C, provider, scheduled, rows, model=GEN):
    """The slice's calls through ``C``'s SemanticContext on ``provider``:
    results, report counts and the provider counters they moved."""
    before = _counters(provider)
    sched = C.RequestScheduler(max_workers=4) if scheduled else None
    try:
        ctx = C.SemanticContext(provider=provider, scheduler=sched)
        out = {"filter": C.llm_filter(ctx, model, {"prompt": "joins?"}, rows),
               "complete": C.llm_complete(ctx, model, {"prompt": "topic"},
                                          rows),
               "reduce": C.llm_reduce(ctx, model, {"prompt": "sum up"},
                                      rows[:5]),
               "rerank": C.llm_rerank(ctx, model, {"prompt": "rank"},
                                      rows[:8], window=4, stride=2)}
    finally:
        if sched is not None:
            sched.shutdown()
    after = _counters(provider)
    reports = []
    for rep in ctx.reports:
        d = dataclasses.asdict(rep)
        d["latencies"] = len(d["latencies"])
        d["batch_sizes"] = sorted(d["batch_sizes"])
        reports.append(d)
    return {"out": out, "reports": reports,
            "stats": {k: after[k] - before[k] for k in after}}


@pytest.mark.parametrize("scheduled", [False, True], ids=["serial", "sched"])
def test_semantic_functions_on_local_providers_match(providers, scheduled):
    rows = _table()
    ref = _run(R, providers[R], scheduled, rows)
    got = _run(T, providers[T], scheduled, rows)
    assert got == ref
    # the plan batched, deduplicated, and every request generated
    assert got["reports"][0]["n_unique"] == 10
    assert got["stats"]["calls"] > 4
    assert got["stats"]["output_tokens"] > 0


def test_embedding_on_local_providers_match(providers):
    rows = _table(seed=1)
    texts = [r["abstract"] for r in rows]
    out = {}
    for C in (R, T):
        with C.RequestScheduler(max_workers=4) as sched:
            ctx = C.SemanticContext(provider=providers[C], scheduler=sched)
            out[C] = C.llm_embedding(ctx, EMB, texts)
            rep = dataclasses.asdict(ctx.reports[-1])
            out[C, "report"] = {k: rep[k] for k in (
                "n_tuples", "n_unique", "cache_hits", "requests", "retries",
                "batch_sizes")}
    assert out[T].shape == out[R].shape == (12, 64)
    np.testing.assert_allclose(out[T], out[R], atol=1e-4, rtol=1e-4)
    assert out[T, "report"] == out[R, "report"]


def test_context_window_past_engine_capacity_drops_requests(providers):
    """With a window past the engine's 2,048 slots, the plan packs every
    row into one request of ~2,500 bytes; both engines finish it with no
    generated token and no error, and the rows parse as the rendering of
    an empty generation (``''``), identically in both packages."""
    rows = _table(seed=2, n=12, dups=0, lo=30, hi=40)
    model = dict(GEN, context_window=8000)
    results = {}
    for C in (R, T):
        before = _counters(providers[C])
        ctx = C.SemanticContext(provider=providers[C])
        out = C.llm_complete(ctx, model, {"prompt": "topic"}, rows)
        mask = C.llm_filter(ctx, model, {"prompt": "joins?"}, rows)
        after = _counters(providers[C])
        results[C] = (out, mask, [r.batch_sizes for r in ctx.reports],
                      {k: after[k] - before[k] for k in after})
    out, mask, batches, stats = results[T]
    assert results[T] == results[R]
    assert batches == [[12], [12]]
    assert stats["prompt_tokens"] > 2 * 2048
    assert stats["calls"] == 2 and stats["output_tokens"] == 0
    assert out == ["''"] * 12 and mask == [False] * 12
