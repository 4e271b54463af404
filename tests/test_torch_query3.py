"""The slice on the CPU: paper Query 3 as one plan — ``hybrid_topk``
(embedding scan + BM25 + fusion) then ``llm_rerank(by=...)`` — through
the port's engine (``repro_torch.engine``) on ``LocalTorchProvider``
against the reference's (``repro.engine``) on ``LocalJaxProvider``, on
one f32 smoke olmo-1b weight set bridged with
``repro_torch.params.from_jax``.

Generation runs in f32, where greedy argmax is stable: the rerank
permutations, the retrieval ids and ranks and the ``ExecutionReport``
counts and provider counters must be identical; cosine scores agree
within 1e-5 (the vector-score tolerance of the engine's parity tests,
tighter than the 1e-4 at which ``tests/test_torch_plan.py`` holds the
embeddings themselves).  Before comparing, the reference's smallest gap
between adjacent cosine scores is asserted to be at least 10x that, so a
failure tells ambiguous data from a fault of the port.  The same plan on ``MockProvider`` sends the same requests as on
the local providers: the plan reads token estimates only.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as R
import repro.engine as RE
import repro_torch.core as T
import repro_torch.engine as TE
from repro.configs import get_smoke_config as jax_smoke
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
GEN = {"model": "gen", "arch": "olmo-1b", "context_window": 640,
       "max_output_tokens": 4}
EMB = {"model": "emb", "arch": "olmo-1b"}
TOL = 1e-5
ENGINE = {R: RE, T: TE}
WORDS = ("join", "hash", "sort", "index", "vector", "query", "scan",
         "plan", "cyclic", "triangle", "bm25", "embedding")


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


def corpus_and_questions(E, n=24, seed=0):
    rng = np.random.default_rng(seed)
    corpus = E.Table({
        "id": list(range(n)),
        "content": [f"passage {i}: " + " ".join(
            rng.choice(WORDS, int(rng.integers(1, 3 + 3 * (i % 6)))))
            for i in range(n)],
        "year": [2000 + i % 7 for i in range(n)]})
    questions = E.Table({"q": ["cyclic join algorithms",
                               "vector index scan"]})
    return corpus, questions


def query3(C, ctx, k=4, candidate_k=8):
    E = ENGINE[C]
    corpus, questions = corpus_and_questions(E)
    return (E.Pipeline(ctx, questions, "questions")
            .hybrid_topk("score", EMB, "q", corpus, k=k, doc_col="content",
                         candidate_k=candidate_k)
            .llm_rerank(GEN, {"prompt": "rank the passages by relevance"},
                        ["content"], by="q"))


def _reports(ctx):
    out = []
    for rep in ctx.reports:
        d = dataclasses.asdict(rep)
        d["latencies"] = len(d["latencies"])
        d["batch_sizes"] = sorted(d["batch_sizes"])
        out.append(d)
    return sorted(out, key=repr)


def _counters(provider):
    s = provider.stats.snapshot()
    return {k: s[k] for k in ("calls", "prompt_tokens", "output_tokens")}


def _run(C, provider, scheduled, device=None):
    """The plan on ``provider``: its table, its reports and the provider
    counters it moved."""
    before = _counters(provider)
    sched = C.RequestScheduler(max_workers=4) if scheduled else None
    kw = {"device": device} if device else {}
    try:
        ctx = C.SemanticContext(provider=provider, scheduler=sched, **kw)
        pipe = query3(C, ctx)
        assert pipe.check() == []
        t = pipe.collect(verify="strict")
    finally:
        if sched is not None:
            sched.shutdown()
    after = _counters(provider)
    return t, {"reports": _reports(ctx),
               "stats": {k: after[k] - before[k] for k in after}}, ctx


def _vector_ranking(C, provider, device=None):
    """The embedding retriever alone, at the plan's candidate depth."""
    kw = {"device": device} if device else {}
    ctx = C.SemanticContext(provider=provider, **kw)
    corpus, questions = corpus_and_questions(ENGINE[C])
    return (ENGINE[C].Pipeline(ctx, questions, "questions")
            .vector_topk("cos", EMB, "q", corpus, k=8, doc_col="content")
            .collect())


def test_vector_ranking_on_local_providers_match(providers):
    ref = _vector_ranking(R, providers[R])
    got = _vector_ranking(T, providers[T], device="cpu")
    cos = np.asarray(ref.column("cos")).reshape(2, 8)
    gap = np.abs(np.diff(cos, axis=1)).min()
    assert gap >= 10 * TOL, f"ambiguous data: a cosine gap of {gap:.3g}"
    assert got.column("id") == ref.column("id")
    assert got.column("cos_rank") == ref.column("cos_rank")
    np.testing.assert_allclose(got.column("cos"), ref.column("cos"),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("scheduled", [False, True], ids=["serial", "sched"])
def test_query3_plan_on_local_providers_match(providers, scheduled):
    ref, ref_reports, _ = _run(R, providers[R], scheduled)
    got, reports, ctx = _run(T, providers[T], scheduled, device="cpu")
    assert got.column_names == ref.column_names
    for col in got.column_names:
        if col == "score":
            # rrf over ranks: exact once the ranks are
            np.testing.assert_allclose(got.column(col), ref.column(col),
                                       atol=TOL, rtol=0)
        else:
            assert got.column(col) == ref.column(col), col
    assert reports == ref_reports
    # the plan retrieved k rows per question and reranked within each: a
    # request past the embeds, each generating
    assert len(got) == 8 and got.column("q")[::4] == [
        "cyclic join algorithms", "vector index scan"]
    embeds = sum(r["requests"] for r in reports["reports"]
                 if r["function"] == "embedding")
    assert reports["stats"]["calls"] > embeds
    assert reports["stats"]["output_tokens"] > 0
    # a second collect on the same context sends nothing
    calls = providers[T].stats.snapshot()["calls"]
    again = query3(T, ctx).collect()
    assert again.rows() == got.rows()
    assert providers[T].stats.snapshot()["calls"] == calls


def test_query3_requests_equal_mock_provider(providers):
    """The plan's requests on the local provider equal those on
    ``MockProvider``: it plans from token estimates alone."""
    _, local, _ = _run(T, providers[T], False, device="cpu")
    _, mock, _ = _run(T, T.MockProvider(), False, device="cpu")
    keys = ("function", "n_tuples", "n_unique", "requests", "retries",
            "batch_sizes")
    assert ([{k: r[k] for k in keys} for r in local["reports"]]
            == [{k: r[k] for k in keys} for r in mock["reports"]])
    assert local["stats"]["calls"] == mock["stats"]["calls"]
