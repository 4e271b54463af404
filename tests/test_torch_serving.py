"""The port's serving engine, provider and vector index against the JAX
package's, on identical weights, on the CPU.

Generation is compared in f32, where greedy argmax is stable: token ids
must be equal.  Embeddings agree within 1e-4 (f32 summation order);
top-k ids exactly, scores within 1e-5.  Scenarios follow
``tests/test_serving.py``.  The serving launcher (``launch/serve.py``)
runs in both packages on the smoke configs with the same arguments:
requests finished, tokens and engine steps equal (the port draws its own
weights, and no request stops early), and on ``--semantic`` the rows and
the reports' batch sizes.
"""

import re

import numpy as np
import pytest

# the JAX package and the port are compared where both are installed; on
# a machine with only one of them this module is skipped
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs in parallel workers: one intra-op thread per worker keeps
# these small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

import jax.numpy as jnp
from repro.configs import get_smoke_config as jax_smoke
from repro.core.metaprompt import build_metaprompt as jax_build_metaprompt
from repro.core.provider import LocalJaxProvider
from repro.core.resources import ModelResource as JaxModelResource
from repro.retrieval.vector import VectorIndex as JaxVectorIndex
from repro.retrieval.vector import cosine_topk as jax_cosine_topk
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import (LocalTorchProvider, ModelResource,
                              build_metaprompt)
from repro_torch.models import model as M
from repro_torch.params import from_jax
from repro_torch.retrieval import VectorIndex, cosine_topk
from repro_torch.serving.engine import ServingEngine

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _port_engine(jax_engine, **kw):
    cfg = get_smoke_config("olmo-1b").replace(**F32)
    params = from_jax(jax.tree.map(np.asarray, jax_engine.params))
    return ServingEngine(cfg, device="cpu", params=params, **kw)


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and the port's, f32 smoke olmo, the same weights."""
    cfg = jax_smoke("olmo-1b").replace(remat=False, **F32)
    je = JaxEngine(cfg, n_slots=2, max_context=64, chunk=8, seed=0)
    return je, _port_engine(je, n_slots=2, max_context=64, chunk=8)


def _oracle(cfg, params, prompt, n_new, cache_len=64):
    """One-shot prefill + decode steps with the port's model functions."""
    lg, cache, pos = M.prefill(cfg, params,
                               {"tokens": torch.tensor([prompt])}, cache_len)
    toks = [int(lg[0, -1].argmax())]
    for i in range(n_new - 1):
        lg, cache = M.decode_step(cfg, params, torch.tensor([[toks[-1]]]),
                                  cache, pos + i)
        toks.append(int(lg[0, 0].argmax()))
    return toks


def test_generate_matches_jax_engine_and_oracle(engines):
    je, te = engines
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, 256, 21)]
    out = te.generate(prompt, max_new_tokens=5)
    assert out == je.generate(prompt, max_new_tokens=5)
    assert out == _oracle(te.cfg, te.params, prompt, 5)


def test_concurrent_requests_match_jax_and_solo(engines):
    """Two in-flight requests produce JAX's tokens, and each equals the
    same request alone."""
    je, te = engines
    rng = np.random.default_rng(1)
    p1 = [int(t) for t in rng.integers(0, 256, 21)]
    p2 = [int(t) for t in rng.integers(0, 256, 13)]
    reqs = {}
    for name, eng in (("jax", je), ("torch", te)):
        r1, r2 = eng.submit(p1, 5), eng.submit(p2, 5)
        eng.run_until_idle()
        reqs[name] = (r1.generated, r2.generated)
    assert reqs["torch"] == reqs["jax"]
    assert reqs["torch"] == (te.generate(p1, 5), te.generate(p2, 5))


def test_more_requests_than_slots_match_jax(engines):
    je, te = engines
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, 256, 9)] for _ in range(5)]
    out = {}
    for name, eng in (("jax", je), ("torch", te)):
        reqs = [eng.submit(p, 3) for p in prompts]
        eng.run_until_idle()
        assert all(r.finished and len(r.generated) == 3 for r in reqs)
        out[name] = [r.generated for r in reqs]
    assert out["torch"] == out["jax"]


def test_oversized_request_rejected():
    cfg = get_smoke_config("olmo-1b")
    eng = ServingEngine(cfg, n_slots=1, max_context=32, chunk=8,
                        device="cpu")
    r = eng.submit(list(range(30)), max_new_tokens=10)
    eng.run_until_idle()
    assert r.finished and r.generated == []


def test_prefill_chunk_leaves_other_slots_untouched(engines):
    """Chunked prefill writes the working slot's cache rows in place and
    no other slot's."""
    _, te = engines
    te.run_until_idle()
    before = [t.clone() for t in _leaves(te.cache)]
    te.submit(list(range(20)), 2)
    te.step()                                     # one prefill chunk
    slot = next(i for i, r in enumerate(te.active) if r is not None)
    for b, a in zip(before, _leaves(te.cache)):
        others = [i for i in range(te.n_slots) if i != slot]
        torch.testing.assert_close(a[:, others], b[:, others], rtol=0,
                                   atol=0)
        assert not torch.equal(a[:, slot, :8], b[:, slot, :8])
    te.run_until_idle()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_embed_batch_matches_jax_and_is_normalised(engines):
    je, te = engines
    lists = [[1, 2, 3, 4], [5, 6, 7], list(range(40))]     # bucket 64
    out = te.embed_batch(lists)
    np.testing.assert_allclose(out, je.embed_batch(lists), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(te.embed([1, 2, 3, 4]), out[0], atol=1e-6)
    assert not np.allclose(out[0], out[1])


def test_chunked_prefill_equals_full_prefill(engines):
    _, te = engines
    cfg, params = te.cfg, te.params
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 256,
                                                                 (1, 16)))
    lg_full, _, _ = M.prefill(cfg, params, {"tokens": prompt}, 32)
    cache = M.init_cache(cfg, 1, 32)
    for c0 in range(0, 16, 8):
        lg, cache = M.prefill_chunk(cfg, params, prompt[:, c0:c0 + 8],
                                    cache, c0)
    torch.testing.assert_close(lg[:, -1], lg_full[:, -1], atol=2e-3,
                               rtol=2e-3)


# --------------------------------------------------------------------------
# providers
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def providers():
    """LocalJaxProvider and LocalTorchProvider on one f32 engine weight set
    (the JAX provider gets its f32 engine through its ``engine``
    attribute)."""
    jp = LocalJaxProvider()
    jp.engine = JaxEngine(jax_smoke("olmo-1b").replace(remat=False, **F32),
                          max_context=2048)
    tp = LocalTorchProvider(device="cpu")
    tp.engine = _port_engine(jp.engine, max_context=2048)
    return jp, tp


@pytest.mark.parametrize("function,n_rows", [("complete", 2), ("filter", 1),
                                             ("reduce", 3)])
def test_provider_complete_matches_jax(providers, function, n_rows):
    jp, tp = providers
    rows = [{"title": f"paper {i}", "abstract": "joins " * (i + 1)}
            for i in range(n_rows)]
    kw = dict(name="m", version=1, arch="olmo-1b", max_output_tokens=6)
    out = tp.complete(ModelResource(**kw),
                      build_metaprompt(function, "is it about joins?", rows),
                      n_rows)
    ref = jp.complete(JaxModelResource(**kw),
                      jax_build_metaprompt(function, "is it about joins?",
                                           rows), n_rows)
    assert out == ref
    assert len(out) == (n_rows if function != "reduce" else 1)
    assert tp.stats.snapshot()["output_tokens"] == \
        jp.stats.snapshot()["output_tokens"]


def test_provider_embed_matches_jax(providers):
    jp, tp = providers
    texts = ["joins in duckdb", "vector search", "x" * 70]
    kw = dict(name="e", version=1, arch="olmo-1b")
    out = tp.embed(ModelResource(**kw), texts)
    ref = jp.embed(JaxModelResource(**kw), texts)
    assert out.shape == (3, 64)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# vector index
# --------------------------------------------------------------------------
@pytest.mark.parametrize("N,D,Q,k", [(300, 16, 4, 10), (50, 8, 2, 64),
                                     (1, 4, 3, 5)])
def test_vector_index_topk_matches_jax(N, D, Q, k):
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    s, i = VectorIndex(vecs, device="cpu").topk(q, k)
    s_j, i_j = JaxVectorIndex(vecs).topk(q, k)
    assert s.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_array_equal(i, i_j)
    np.testing.assert_allclose(s, s_j, atol=1e-5, rtol=1e-5)
    c = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    s_c, i_c = cosine_topk(torch.from_numpy(c), torch.from_numpy(q), k,
                           block=16)
    s_cj, i_cj = jax_cosine_topk(jnp.asarray(c), jnp.asarray(q), k, block=16)
    np.testing.assert_array_equal(i_c.numpy(), np.asarray(i_cj))
    np.testing.assert_allclose(s_c.numpy(), np.asarray(s_cj), atol=1e-5,
                               rtol=1e-5)


def _duplicated_corpus(seed=0, n=4000, distinct=50, d=64, n_queries=8):
    """Rows drawn from a few distinct vectors: ranks tie in whole groups."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((distinct, d)).astype(np.float32)
    vecs = base[rng.integers(0, distinct, n)]
    return vecs, rng.standard_normal((n_queries, d)).astype(np.float32)


@pytest.mark.parametrize("k", [10, 100])
def test_vector_index_topk_ties_in_canonical_order(k):
    """Tied scores rank by doc id ascending, as the JAX jnp scan ranks
    them (the (score desc, id asc) order of the reference's retrieval
    operators)."""
    vecs, q = _duplicated_corpus()
    c = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    s_j, i_j = jax_cosine_topk(jnp.asarray(c), jnp.asarray(q), k)
    i_j, s_j = np.asarray(i_j), np.asarray(s_j)
    s, i = VectorIndex(vecs, device="cpu").topk(q, k)
    np.testing.assert_array_equal(i, i_j)
    np.testing.assert_allclose(s, s_j, atol=1e-5, rtol=1e-5)
    s_c, i_c = cosine_topk(torch.from_numpy(c), torch.from_numpy(q), k,
                           block=16)
    np.testing.assert_array_equal(i_c.numpy(), i_j)
    np.testing.assert_allclose(s_c.numpy(), s_j, atol=1e-5, rtol=1e-5)


def test_vector_index_empty_inputs():
    idx = VectorIndex(np.zeros((0,), np.float32), device="cpu")
    s, i = idx.topk(np.ones((2, 4), np.float32), 3)
    assert s.shape == i.shape == (2, 0)
    s, i = VectorIndex(np.ones((3, 4), np.float32), device="cpu").topk(
        np.ones((1, 4), np.float32), 0)
    assert s.shape == i.shape == (1, 0)


# --------------------------------------------------------------------------
# the serving launcher (launch/serve.py) against the reference's
# --------------------------------------------------------------------------
_SERVED = re.compile(r"^(\d+)/(\d+) requests, (\d+) tokens in [\d.]+s "
                     r"\([\d.]+ tok/s, (\d+) engine steps\)$")
_SEMANTIC = re.compile(r"^semantic path: (\d+) rows in [\d.]+s "
                       r"\([\d.]+ rows/s\); reports=(.*)$")


def _launch(run, argv, capsys, pattern):
    """The fields of the one line ``run(argv)`` prints (walls dropped)."""
    result = run(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    match = pattern.match(line)
    assert match, line
    return match.groups(), result


@pytest.mark.parametrize("argv", [
    [], ["--requests", "5", "--slots", "2", "--prompt-len", "20",
         "--max-new", "7"],
    ["--arch", "granite-8b", "--requests", "3", "--max-new", "5",
     "--max-context", "128"]])
def test_serve_launcher_matches_jax(argv, capsys):
    """The engine route of ``launch/serve.py`` on the smoke config: the
    same requests finished, tokens and engine steps as the reference's."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    ref, none = _launch(jax_serve.run, argv, capsys, _SERVED)
    got, result = _launch(serve.run, argv + ["--device", "cpu"], capsys,
                          _SERVED)
    assert none is None and got == ref
    done, n, toks, steps = map(int, got)
    assert (result["done"], result["requests"], result["tokens"],
            result["steps"]) == (done, n, toks, steps) and done == n


@pytest.mark.parametrize("argv", [
    ["--semantic"], ["--semantic", "--requests", "5", "--max-context",
                     "128"]])
def test_serve_launcher_semantic_matches_jax(argv, capsys):
    """The ``--semantic`` route through each package's local provider:
    the same rows and the same batch sizes of its reports."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    ref, _ = _launch(jax_serve.run, argv, capsys, _SEMANTIC)
    got, result = _launch(serve.run, argv + ["--device", "cpu"], capsys,
                          _SEMANTIC)
    assert got == ref
    assert result["rows"] == int(got[0])
    assert repr(result["batch_sizes"]) == got[1]


def test_serve_launcher_defaults_to_the_gpu(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(["--semantic"])
