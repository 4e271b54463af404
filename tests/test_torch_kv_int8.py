"""The port's int8 KV cache (``kv_quant="int8"``) against the JAX
package's, on the CPU, on the qwen1.5-32b and gemma3-12b smoke configs.

JAX draws the weights; ``repro_torch.params.from_jax`` carries them (and,
where a test starts from a JAX cache, that cache) over bit for bit.  The
cache holds int8 keys and values with f32 scales of one per (token,
head): ``quantize_kv`` and ``dequantize_kv`` are copies of the JAX
package's.  Tolerances:
- ``quantize_kv``: int8 values exact, scales within one f32 ulp;
  ``dequantize_kv`` exact (one f32 product, one rounding);
- logits: 1e-4 in f32 (summation order), 6e-2 in bf16 (the model
  tolerance of ``tests/test_kernels.py``);
- the cache in f32: int8 values within one quantization step, where a
  key or value computed in another summation order rounds to the other
  side of a step, and scales within 1e-4 relative; in bf16, where keys
  and values agree only to the model tolerance (a step or two of the
  int8 grid), the dequantized cache within 6e-2.
The JAX package's chunked prefill has no int8 path (``ROADMAP.md``, queue
C), so the port's is held to what the JAX decode step computes when it is
fed the same tokens one at a time, in f32, where the two agree to
summation order: the same logits per token and the same cache.
"""

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
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ServingEngine

ARCHS = ("qwen1.5-32b", "gemma3-12b")
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype, kv_quant="int8"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, kv_quant=kv_quant)
    return (jax_smoke(arch).replace(remat=False, **kw),
            get_smoke_config(arch).replace(**kw))


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) per (arch, dtype), drawn once."""
    out = {}
    for arch in ARCHS:
        for dtype in TOL:
            jcfg, _ = _cfgs(arch, dtype)
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            out[arch, dtype] = jp, from_jax(jax.tree.map(np.asarray, jp))
    return out


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _tree_pairs(jt, tt, path=""):
    if isinstance(jt, dict):
        assert set(jt) == set(tt), path
        for k in jt:
            yield from _tree_pairs(jt[k], tt[k], f"{path}/{k}")
    elif isinstance(jt, (list, tuple)):
        assert len(jt) == len(tt), path
        for i, (a, b) in enumerate(zip(jt, tt)):
            yield from _tree_pairs(a, b, f"{path}/{i}")
    else:
        yield path, jt, tt


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _cache_close(jc, tc, dtype):
    """In f32: int8 values within one quantization step, scales within
    1e-4 relative.  In bf16 the keys and values themselves agree only to
    the model tolerance, a step or two of the int8 grid: there the
    dequantized cache is held at 6e-2, as a bf16 cache is."""
    n = 0
    for path, a, b in _tree_pairs(jc, tc):
        a = np.asarray(a)
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        n += 1
    assert n > 0
    for si, stage in enumerate(tc):
        for name, block in stage.items():
            ja, ta = jc[si][name]["attn"], block["attn"]
            for kv in ("k", "v"):
                jq, js = np.asarray(ja[kv]), np.asarray(ja[f"{kv}_scale"])
                tq, ts = ta[kv].numpy(), ta[f"{kv}_scale"].numpy()
                where = f"{si}/{name}/{kv}"
                if dtype == "float32":
                    d = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
                    assert d.max() <= 1, (where, int(d.max()))
                    np.testing.assert_allclose(ts, js, rtol=TOL[dtype],
                                               atol=0, err_msg=where)
                else:
                    np.testing.assert_allclose(
                        tq.astype(np.float32) * ts,
                        jq.astype(np.float32) * js, rtol=TOL[dtype],
                        atol=TOL[dtype], err_msg=where)


# --------------------------------------------------------------------------
# quantization and the cache's structure
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 17, 4, 16))
         * rng.uniform(0.01, 20.0, (3, 17, 4, 1))).astype(np.float32)
    x[1, 3] = 0.0                        # a zero token: the 1e-8 floor
    x[2, 5, 1, 7] = 1e4                  # one large value in a head
    jq, js = JL.quantize_kv(jnp.asarray(x, jdt))
    tq, ts = L.quantize_kv(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == x.shape
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (3, 17, 4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    js = np.asarray(js)
    ulp = np.spacing(np.abs(js))
    assert (np.abs(ts.numpy() - js) <= ulp).all()
    assert float(ts[1, 3].max()) == pytest.approx(1e-8)
    assert int(tq.abs().max()) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (2, 9, 3, 16)).astype(np.int8)
    s = rng.uniform(1e-3, 0.5, (2, 9, 3, 1)).astype(np.float32)
    ref = JL.dequantize_kv(jnp.asarray(q), jnp.asarray(s), jdt)
    out = L.dequantize_kv(torch.from_numpy(q), torch.from_numpy(s), tdt)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
    # and it is the f32 product rounded once
    torch.testing.assert_close(
        out, (torch.from_numpy(q).float() * torch.from_numpy(s)).to(tdt),
        rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jc = JM.init_cache(jcfg, 3, 16)
    tc = M.init_cache(tcfg, 3, 16)
    n = 0
    for path, a, b in _tree_pairs(jc, tc):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        assert not b.any(), path
        n += 1
    assert n == 4 * len(tc) * len(tc[0])
    attn = tc[0]["b0"]["attn"]
    assert attn["k"].dtype == torch.int8
    assert tuple(attn["k_scale"].shape)[-1] == 1


def test_kv_quant_other_values_raise():
    cfg = get_smoke_config("qwen1.5-32b")
    for ok in ("none", "int8"):
        M.init_cache(cfg.replace(kv_quant=ok), 1, 8)
    with pytest.raises(NotImplementedError, match="kv_quant='fp8'"):
        M.init_cache(cfg.replace(kv_quant="fp8"), 1, 8)
    with pytest.raises(NotImplementedError, match="kv_quant='fp8'"):
        init_params(cfg.replace(kv_quant="fp8"), torch.Generator())


def test_normal_init_draws_one_layer_at_a_time(monkeypatch):
    """A stacked weight is drawn one layer (leading slice) at a time into
    a tensor allocated in ``param_dtype``; a matrix is drawn whole."""
    drawn = []
    randn = torch.randn

    def recording(shape, **kw):
        drawn.append(tuple(shape))
        return randn(shape, **kw)
    monkeypatch.setattr(torch, "randn", recording)
    g = torch.Generator().manual_seed(0)
    w = L.normal_init((5, 6, 7), 0.5, torch.bfloat16, g, None)
    assert drawn == [(6, 7)] * 5
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (5, 6, 7)
    assert w.float().std().item() == pytest.approx(0.5, rel=0.2)
    drawn.clear()
    assert L.normal_init((6, 7), 1.0, torch.bfloat16, g, None).shape == (6, 7)
    assert drawn == [(6, 7)]
    # a whole model: no draw is larger than one layer's matrix
    drawn.clear()
    cfg = get_smoke_config("qwen1.5-32b").replace(num_layers=4)
    init_params(cfg, torch.Generator().manual_seed(0))
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    assert max(int(np.prod(s)) for s in drawn) == max(d * f, d * V)
    assert drawn.count((d, f)) == 2 * cfg.num_layers        # w1, w3
    assert drawn.count((f, d)) == cfg.num_layers            # w2


# --------------------------------------------------------------------------
# the stack on the int8 cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(weights, arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = weights[arch, dtype]
    toks = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(
        np.int32)
    jl, jc, jn = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc, tn = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 32)
    assert tn == jn == 12
    _close(tl, jl, TOL[dtype])
    _cache_close(jc, tc, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(weights, arch, dtype):
    """From the same int8 cache (JAX's prefill of 12 tokens, carried over),
    decode steps to position 17, past gemma3's window of 8: logits, the
    int8 values and the scales agree with JAX's ``decode_step``."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = weights[arch, dtype]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 12)).astype(np.int32)
    _, jc, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
    tc = from_jax(jax.tree.map(np.asarray, jc))
    for step in range(6):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.array([12 + step, 12 + step], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        tl, tc2 = M.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        # written in place into the cache given
        assert all(a is b for a, b in zip(_leaves(tc2), _leaves(tc)))
        _close(tl, jl, TOL[dtype])
    _cache_close(jc, tc, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunks_match_jax_decode_chain(weights, arch):
    """The port's int8 chunked prefill (chunks of 8 from offsets 0 and 8,
    then 4 decode steps) against JAX's ``decode_step`` fed the same 20
    tokens one at a time, in f32: the logits of every token and the whole
    cache (gemma3's window of 8 cuts both chunks)."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = weights[arch, "float32"]
    prompt = np.random.default_rng(6).integers(0, 256, 20).astype(np.int32)
    jc, jl = JM.init_cache(jcfg, 1, 32), []
    for t in range(20):
        lg, jc = JM.decode_step(jcfg, jp, jnp.asarray(prompt[None, t:t + 1]),
                                jc, jnp.int32(t))
        jl.append(np.asarray(lg[0, 0]))
    tc, tl = M.init_cache(tcfg, 1, 32), []
    for c0 in (0, 8):
        lg, tc = M.prefill_chunk(tcfg, tp,
                                 torch.from_numpy(prompt[None, c0:c0 + 8]),
                                 tc, c0)
        tl.extend(lg[0])
    for t in range(16, 20):
        lg, tc = M.decode_step(tcfg, tp, torch.from_numpy(prompt[None, t:t + 1]),
                               tc, t)
        tl.append(lg[0, 0])
    _close(torch.stack(tl), np.stack(jl), TOL["float32"])
    _cache_close(jc, tc, "float32")


# --------------------------------------------------------------------------
# serving on the int8 cache
# --------------------------------------------------------------------------
def _engine(tcfg, tp, n_slots=2):
    return ServingEngine(tcfg, n_slots=n_slots, max_context=64, chunk=8,
                         device="cpu", params=tp)


@pytest.fixture(scope="module")
def served(weights):
    """Per arch: f32 configs, weights, prompts of 5, 20 and 37 tokens, and
    the JAX engine's 12 new tokens for each, served together on 2 slots
    with a chunk as long as the engine's context, so that every prompt
    token goes through the JAX decode step (its chunked prefill cannot
    run on int8)."""
    out = {}
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (5, 20, 37)]
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, "float32")
        jp, tp = weights[arch, "float32"]
        je = JaxEngine(jcfg, n_slots=2, max_context=64, chunk=64)
        je.params = jp
        reqs = [je.submit(p, 12) for p in prompts]
        je.run_until_idle()
        out[arch] = tcfg, tp, prompts, [r.generated for r in reqs]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(served, arch):
    """The port's engine with chunked prefill of 8 on the int8 cache
    generates the JAX engine's tokens (prefill through decode steps)."""
    tcfg, tp, prompts, want = served[arch]
    eng = _engine(tcfg, tp)
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.run_until_idle()
    assert [r.generated for r in reqs] == want
    assert all(len(g) == 12 for g in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_matches_fresh_engine(served, arch):
    """With one slot, each request after the first reuses the int8 rows
    of the one before (values and scales left past its positions): each
    still gets the tokens of a fresh engine."""
    tcfg, tp, prompts, want = served[arch]
    eng = _engine(tcfg, tp, n_slots=1)
    for p, w in zip(prompts[::-1], want[::-1]):
        assert eng.generate(p, 12) == w
    assert all(t.abs().max() > 0 for t in _leaves(eng.cache))
    assert eng.generate(prompts[0], 12) == want[0]


def test_jax_engine_chunked_prefill_fails_on_int8():
    """Records a fault of the reference (``ROADMAP.md``, queue C): the JAX
    engine's chunked prefill casts the chunk's keys and values to int8
    and returns no scales, so a prompt longer than the chunk stops on its
    first chunk.  When the reference is repaired this test fails, and is
    then changed to hold the port's engine to the JAX engine at chunk 8."""
    jcfg, _ = _cfgs("qwen1.5-32b", "float32")
    je = JaxEngine(jcfg, n_slots=2, max_context=64, chunk=8)
    with pytest.raises(ValueError, match="Dict key mismatch"):
        je.generate(list(range(20)), 4)
