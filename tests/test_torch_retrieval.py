"""The port's retrieval layer (``repro_torch.retrieval``: BM25, IVF,
``VectorIndex`` with its ANN route and segment appends, ``ensure_index``)
against the reference (``repro.retrieval``) on the CPU.

- BM25 and IVF are numpy in both packages: bit-identical.
- ``VectorIndex.topk_ann`` scans the host copy of the normalised corpus,
  which the port computes as the reference does: bit-identical, int64
  ids.  ``topk`` (the block-max scan, int32 ids) holds ids exactly and
  scores within 1e-5 of the reference's jnp scan.
- The cases of ``tests/test_ann.py`` and the BM25 properties of
  ``tests/test_properties.py`` run on both packages side by side
  (``torch_port_cases``); the two of ``test_ann.py`` that call JAX
  directly have counterparts here.
- ``ensure_index`` reaches each of its four sources, with ``IndexStore``
  sidecars written by one package and read by the other.
- A retrieval plan without a card and without ``device="cpu"`` raises.

The masked, unpruned ``corpus_filter`` branch at the Query 3 phase's
shape on the card is ``tests/test_torch_gpu.py::
test_full_ranking_branch_on_the_card``.
"""

import numpy as np
import pytest
from hypothesis import assume, given, settings
from hypothesis import strategies as st

import repro.core as RC
import repro.retrieval as RR
import repro_torch.core as TC
import repro_torch.engine as TE
import repro_torch.retrieval as TR
from repro.retrieval import ivf as rivf
from repro_torch.retrieval import ivf as tivf
from torch_port_cases import port_cases

torch = pytest.importorskip("torch")

SMALL = settings(max_examples=40, deadline=None, derandomize=True,
                 database=None)
SCORE_TOL = 1e-5
EMB = {"model": "e", "embedding_dim": 16, "context_window": 4096}

globals().update(port_cases("test_ann", [
    "test_ivf_full_probe_bit_identical_to_exact",
    "test_ivf_full_probe_bit_identical_property",
    "test_ivf_recall_meets_target_on_clustered_corpus",
    "test_ivf_incremental_append_equals_rebuild",
    "test_planning_prior_shapes",
    "test_vector_index_empty_and_k_cap",
    "test_ensure_index_append_embeds_only_delta",
    "test_ensure_index_append_across_sessions_via_store",
    "test_index_store_segment_roundtrip",
    "test_index_store_eviction_garbage_collects_segments",
    "test_index_store_segmented_corruption_recovery",
    "test_plan_forced_ivf_full_probe_matches_exact_plan",
    "test_plan_ann_auto_selects_by_corpus_size",
    "test_plan_without_ann_unchanged",
    "test_explain_renders_both_scan_frontiers",
    "test_plan_ann_param_validation",
    "test_hybrid_topk_with_ann_matches_exact_at_full_probe",
    "test_bm25_topk_node_uses_batched_scoring",
    "test_bm25_score_many_bit_identical"]))

globals().update(port_cases("test_properties", [
    "test_bm25_nonnegative_and_zero_without_overlap",
    "test_bm25_tf_monotonic"]))


def _unit(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-9)


def _clustered(rng, n, d, centers=8):
    mu = rng.standard_normal((centers, d)) * 4.0
    labels = rng.integers(0, centers, n)
    return (mu[labels] + rng.standard_normal((n, d))).astype(np.float32)


def assert_gap_then_close(ref_s, s, ref_i, i):
    """Ids exact, scores within ``SCORE_TOL``; a failure first tells a
    near-tie in the reference's ranking from a fault of the port."""
    ref_s, s = np.asarray(ref_s), np.asarray(s)
    gaps = np.abs(np.diff(ref_s, axis=1))
    assert gaps.size == 0 or gaps.min() >= 10 * SCORE_TOL, (
        f"ambiguous data: the reference's ranking holds a gap of "
        f"{gaps.min():.3g}")
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))
    np.testing.assert_allclose(s, ref_s, atol=SCORE_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the two cases of tests/test_ann.py that call JAX directly
# ---------------------------------------------------------------------------
def test_cosine_topk_k_exceeds_corpus_and_empty():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    c = rng.standard_normal((4, 8)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    s, i = TR.cosine_topk(torch.from_numpy(c), torch.from_numpy(q), 9)
    assert s.shape == (2, 4)                 # k > N: capped, no raise
    ref_s, ref_i = RR.cosine_topk(jnp.asarray(c), jnp.asarray(q), 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s),
                               atol=SCORE_TOL, rtol=0)
    s, i = TR.cosine_topk(torch.zeros((0, 8)), torch.from_numpy(q), 3)
    assert s.shape == (2, 0) and i.shape == (2, 0)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jnp", "pallas"])
def test_vector_index_kernel_route_matches_jnp(use_kernel):
    """The port's one route (block-max) against each of the reference's
    two single-device routes."""
    rng = np.random.default_rng(0)
    vs = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    ref_s, ref_i = RR.VectorIndex(vs, use_kernel=use_kernel).topk(q, 7)
    s, i = TR.VectorIndex(vs, device="cpu").topk(q, 7)
    assert i.dtype == np.int32
    assert_gap_then_close(ref_s, s, ref_i, i)


# ---------------------------------------------------------------------------
# BM25 and IVF: bit-identical
# ---------------------------------------------------------------------------
_VOCAB = ("join", "hash", "index", "vector", "scan", "query", "duckdb",
          "rerank", "fusion", "the", "of", "a", "B-tree", "LSM", "ann")


def _docs(seed, n=60):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_VOCAB, int(rng.integers(0, 14))))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bm25_bit_identical(seed):
    docs = _docs(seed)
    qs = ["join index", "vector ann fusion", "", "zebra", "the the of",
          "B-tree LSM hash"]
    ref, port = RR.BM25Index.build(docs), TR.BM25Index.build(docs)
    assert [TR.tokenize(d) for d in docs] == [RR.tokenize(d) for d in docs]
    assert port.score_many(qs).tobytes() == ref.score_many(qs).tobytes()
    for q in qs:
        assert port.score(q).tobytes() == ref.score(q).tobytes()


@pytest.mark.parametrize("n,d,nlist", [(500, 12, None), (900, 24, 17),
                                       (64, 4, 8), (3, 5, None)])
def test_ivf_bit_identical(n, d, nlist):
    rng = np.random.default_rng(n)
    vs = _unit(_clustered(rng, n, d))
    qs = _unit(rng.standard_normal((6, d)).astype(np.float32))
    ref, port = (rivf.IVFIndex.build(vs, nlist),
                 tivf.IVFIndex.build(vs, nlist))
    assert port.nlist == ref.nlist
    assert port.centroids.tobytes() == ref.centroids.tobytes()
    for nprobe in sorted({1, max(1, ref.nlist // 3), ref.nlist}):
        assert port.nprobe_for(0.9) == ref.nprobe_for(0.9)
        for a, b in zip(port.search(qs, min(10, n), nprobe),
                        ref.search(qs, min(10, n), nprobe)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # appends carry the quantizer over identically
    grown = np.concatenate([vs, _unit(_clustered(rng, 40, d))])
    pe, re_ = port.extended(grown, 40), ref.extended(grown, 40)
    for a, b in zip(pe.search(qs, 5, 2), re_.search(qs, 5, 2)):
        assert a.tobytes() == b.tobytes()


def test_ivf_planning_helpers_identical():
    assert tivf.IVF_MIN_DOCS == rivf.IVF_MIN_DOCS
    for n in (0, 1, 100, 5_000, 100_000, 1_000_000):
        assert tivf.default_nlist(n) == rivf.default_nlist(n)
    for nl in (1, 10, 316):
        for target in (0.5, 0.9, 0.95, 0.99):
            assert (tivf.planned_nprobe(nl, target)
                    == rivf.planned_nprobe(nl, target))
        for npb in (1, nl // 2 or 1, nl):
            assert tivf.planned_recall(npb, nl) == \
                rivf.planned_recall(npb, nl)
    assert (tivf.ivf_scan_flops(4, 100_000, 64, 316, 29)
            == rivf.ivf_scan_flops(4, 100_000, 64, 316, 29))
    x = _clustered(np.random.default_rng(5), 200, 6)
    assert tivf.kmeans(x, 9).tobytes() == rivf.kmeans(x, 9).tobytes()


# ---------------------------------------------------------------------------
# VectorIndex: ANN route, appends, raw
# ---------------------------------------------------------------------------
def test_vector_index_keeps_raw_and_host_corpus():
    rng = np.random.default_rng(1)
    vs = rng.standard_normal((50, 8)).astype(np.float32) * 3
    ref, port = RR.VectorIndex(vs), TR.VectorIndex(vs, device="cpu")
    assert port.raw.tobytes() == ref.raw.tobytes()
    assert port.host_vectors.tobytes() == ref.vectors.tobytes()
    assert port.vectors.device.type == "cpu" and len(port.vectors) == 50


@pytest.mark.parametrize("nprobe", [1, 3, None, "all"])
def test_topk_ann_matches_reference(nprobe):
    rng = np.random.default_rng(2)
    vs = _clustered(rng, 700, 16, centers=12)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    ref, port = RR.VectorIndex(vs), TR.VectorIndex(vs, device="cpu")
    nl = rivf.default_nlist(700)
    kw = {"nlist": nl, "nprobe": nl if nprobe == "all" else nprobe}
    rs, ri = ref.topk_ann(q, 9, **kw)
    ps, pi = port.topk_ann(q, 9, **kw)
    assert pi.dtype == np.int64 == ri.dtype
    assert ps.tobytes() == rs.tobytes() and pi.tobytes() == ri.tobytes()
    if nprobe == "all":                      # full probe == exact scan
        es, ei = port.topk(q, 9)
        assert_gap_then_close(rs, es, ri, ei)
    # empty query dimension and k past the corpus
    assert port.topk_ann(np.zeros((2, 0), np.float32), 3)[1].dtype == \
        np.int64
    assert port.topk_ann(q, 10_000, **kw)[1].shape == (5, 700)


def test_extended_equals_rebuild_and_keeps_device():
    rng = np.random.default_rng(3)
    vs = _clustered(rng, 300, 16)
    base = TR.VectorIndex(vs[:250], device="cpu")
    base.ivf(9)                               # the quantizer carries over
    grown = base.extended(vs[250:])
    full = TR.VectorIndex(vs, device="cpu")
    assert grown.device == base.device
    assert grown.raw.tobytes() == full.raw.tobytes()
    assert torch.equal(grown.vectors, full.vectors)
    assert len(base.vectors) == 250           # the base is untouched
    assert base.extended(np.zeros((0,), np.float32)) is base
    q = rng.standard_normal((3, 16)).astype(np.float32)
    for a, b in zip(grown.topk(q, 12), full.topk(q, 12)):
        np.testing.assert_array_equal(a, b)
    gs, gi = grown.topk_ann(q, 12, nprobe=grown.ivf().nlist)
    fs, fi = full.topk(q, 12)
    np.testing.assert_array_equal(gi, fi)
    # the reference's append over the same rows
    rgrown = RR.VectorIndex(vs[:250]).extended(vs[250:])
    assert rgrown.raw.tobytes() == grown.raw.tobytes()


# ---------------------------------------------------------------------------
# ensure_index: the four sources, sidecars across packages
# ---------------------------------------------------------------------------
def _texts(n):
    return [f"passage {i} about topic {i % 9} with searchable body"
            for i in range(n)]


def _embedded(ctx):
    return sum(r.n_tuples for r in ctx.reports
               if r.function == "embedding")


def _ctx(C, path, **kw):
    if C is TC:
        kw["device"] = "cpu"
    return C.SemanticContext(provider=C.MockProvider(), enable_cache=False,
                             index_path=path, **kw)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_ensure_index_sources_across_packages(tmp_path, writer):
    """One package builds and persists; the other reads the sidecar,
    appends to it and hands it back."""
    W, Wr = (RC, RR) if writer == "ref" else (TC, TR)
    O, Or = (TC, TR) if writer == "ref" else (RC, RR)
    path = str(tmp_path / "cache.jsonl.index.json")
    texts = _texts(40)

    ctx_w = _ctx(W, path)
    built, src = Wr.ensure_index(ctx_w, EMB, texts[:30])
    assert src == "built" and _embedded(ctx_w) == 30
    assert Wr.ensure_index(ctx_w, EMB, texts[:30]) == (built, "session")

    ctx_o = _ctx(O, path)
    stored, src = Or.ensure_index(ctx_o, EMB, texts[:30])
    assert src == "store" and _embedded(ctx_o) == 0
    assert stored.raw.tobytes() == built.raw.tobytes()
    grown, src = Or.ensure_index(ctx_o, EMB, texts)
    assert src == "appended" and _embedded(ctx_o) == 10

    ctx_w2 = _ctx(W, path)
    back, src = Wr.ensure_index(ctx_w2, EMB, texts)
    assert src == "store" and ctx_w2.provider.stats.calls == 0
    assert back.raw.tobytes() == grown.raw.tobytes()
    # the same rows as a from-scratch build in either package
    fresh, src = Or.ensure_index(_ctx(O, None), EMB, texts)
    assert src == "built" and fresh.raw.tobytes() == grown.raw.tobytes()


def test_ensure_index_places_the_index_on_the_context_device():
    ctx = TC.SemanticContext(provider=TC.MockProvider(), device="cpu")
    idx, _ = TR.ensure_index(ctx, EMB, _texts(12))
    assert idx.device.type == "cpu"
    assert TR.VectorIndex.build(ctx, EMB, _texts(5)).device.type == "cpu"
    grown, src = TR.ensure_index(ctx, EMB, _texts(20))
    assert src == "appended" and grown.device.type == "cpu"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_retrieval_plan_without_card_raises(no_cuda):
    """No fallback to the CPU: the index a plan builds lives on the card
    unless the context asks for the CPU."""
    corpus = TE.Table({"text": _texts(10)})
    qs = TE.Table({"q": ["topic 3"]})

    def plan(**kw):
        ctx = TC.SemanticContext(provider=TC.MockProvider(), **kw)
        return TE.Pipeline(ctx, qs, "q").vector_topk("s", EMB, "q",
                                                     corpus, k=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan().collect()
    assert len(plan(device="cpu").collect()) == 3


# ---------------------------------------------------------------------------
# the ranking itself, on hypothesis draws: ids exact, scores at 1e-5
# ---------------------------------------------------------------------------
@SMALL
@given(n=st.integers(1, 300), d=st.integers(2, 24), k=st.integers(1, 40),
       seed=st.integers(0, 10_000))
def test_vector_index_topk_matches_reference(n, d, k, seed):
    rng = np.random.default_rng(seed)
    vs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    ref_s, ref_i = RR.VectorIndex(vs).topk(q, k)
    s, i = TR.VectorIndex(vs, device="cpu").topk(q, k)
    gaps = np.abs(np.diff(ref_s, axis=1))
    # a draw holding a near-tie has no unambiguous order to hold
    assume(gaps.size == 0 or gaps.min() >= 10 * SCORE_TOL)
    assert_gap_then_close(ref_s, s, ref_i, i)
