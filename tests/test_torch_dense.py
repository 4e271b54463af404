"""The port's dense decoder at three more configurations (gemma3-12b,
granite-8b and qwen1.5-32b) against the JAX package's, on identical
weights, on the CPU.

JAX draws the weights of each smoke config (gemma3: 6 layers of 5 local
and 1 global, window 8, qk-norm, GeGLU, embed scale, tied embeddings;
granite: 2 layers, 4 query heads over 2 KV heads; qwen: 2 layers with
qkv bias); ``repro_torch.params.from_jax`` carries them over bit for bit,
and the same numpy token ids go through both packages.  The JAX forward
runs flash attention as Pallas in interpret mode (``use_pallas=True``).
Prompts are longer than gemma3's window of 8, so prefill, chunked prefill
and decode all cut by it.  Tolerances (``ROADMAP.md``): logits 1e-4 in
f32 (summation order only; ``tests/test_torch_model.py``) and 6e-2 in
bf16 (``tests/test_kernels.py``'s model tolerance); generated tokens
equal in f32 (in bf16 one rounding may flip an argmax of random
weights); embeddings within 1e-4 in f32.
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
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import (NOT_YET_PORTED, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ServingEngine

ARCHS = ("gemma3-12b", "granite-8b", "qwen1.5-32b")
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
# analytic parameter counts of the full configs (the JAX formula)
NUM_PARAMS = {"gemma3-12b": 11_765_022_720, "granite-8b": 8_254_390_272,
              "qwen1.5-32b": 35_196_436_480}


def _cfgs(arch, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
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


# --------------------------------------------------------------------------
# configs and weights
# --------------------------------------------------------------------------
def test_registry():
    assert list_archs() == ["olmo-1b", "falcon-mamba-7b", "recurrentgemma-9b",
                            "granite-8b", "gemma3-12b", "qwen1.5-32b",
                            "deepseek-moe-16b", "mixtral-8x7b",
                            "whisper-base", "phi-3-vision-4.2b"]
    assert NOT_YET_PORTED == ()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, smoke):
    j = jax_smoke(arch) if smoke else jax_get_config(arch)
    t = get_smoke_config(arch) if smoke else get_config(arch)
    for f in t.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    assert t.stages() == j.stages()
    assert t.num_params() == j.num_params()
    assert t.theta_local == j.theta_local
    assert t.resolved_head_dim == j.resolved_head_dim
    if not smoke:
        assert t.num_params() == NUM_PARAMS[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_is_bit_exact(weights, arch, dtype):
    jp, tp = weights[arch, dtype]
    n = 0
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.float().numpy(),
                                      a.astype(np.float32), err_msg=path)
        n += 1
    assert n > 10


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax(weights, arch):
    """The port's own draw: JAX's tree, shapes and dtypes, the JAX init's
    constants (norm scales of one, zero qkv biases, qk-norm scales of
    one), and weights at the JAX init's scale."""
    jp, _ = weights[arch, "bfloat16"]
    _, cfg = _cfgs(arch, "bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    again = init_params(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        if any(c in path for c in ("scale", "norm", "/bq", "/bk", "/bv")):
            np.testing.assert_array_equal(b.float().numpy(),
                                          a.astype(np.float32), err_msg=path)
    for a, b in zip(_leaves(tp), _leaves(again)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    std = tp["stages"][0]["b0"]["attn"]["wq"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax_pallas(weights, arch, dtype):
    """The full-sequence forward, whose attention is ``flash_attention``,
    against the JAX forward on its Pallas kernel (interpret mode)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = weights[arch, dtype]
    toks = np.random.default_rng(3).integers(0, 256, (2, 20)).astype(
        np.int32)
    ref, _ = JM.forward_train(jcfg.replace(use_pallas=True), jp,
                              {"tokens": jnp.asarray(toks)})
    out, aux = M.forward_train(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32 and out.shape == (2, 20, 256)
    assert float(aux) == 0.0
    _close(out, ref, TOL[dtype])


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
    for path, a, b in _tree_pairs(jc, tc):
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path
        _close(b, a, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunks_and_decode_match_jax(weights, arch, dtype):
    """A prefill_chunk chain (scalar and per-row offsets), then decode
    steps to position 26, past gemma3's window of 8 by 18: logits and the
    KV cache agree with JAX."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = weights[arch, dtype]
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, (2, 16)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 32)
    tc = M.init_cache(tcfg, 2, 32)
    for c0 in (0, 8):
        chunk = prompt[:, c0:c0 + 8]
        jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                                  jnp.int32(c0))
        tl, tc2 = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc, c0)
        # the cache is written in place into the one given
        assert all(a is b for a, b in zip(_leaves(tc2), _leaves(tc)))
        _close(tl, jl, TOL[dtype])
    offs = np.array([16, 16], np.int32)
    chunk = rng.integers(0, 256, (2, 3)).astype(np.int32)
    jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                              jnp.asarray(offs))
    tl, tc = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc,
                             torch.from_numpy(offs))
    _close(tl, jl, TOL[dtype])
    pos = np.array([19, 19], np.int32)
    for step in range(8):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos + step))
        tl, tc = M.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                               torch.from_numpy(pos + step))
        _close(tl, jl, TOL[dtype])
    for path, a, b in _tree_pairs(jc, tc):
        _close(b, a, TOL[dtype])


# --------------------------------------------------------------------------
# serving: the port's engine against the JAX engine
# --------------------------------------------------------------------------
def _jax_engine(jcfg, jp, **kw):
    je = JaxEngine(jcfg, n_slots=2, max_context=64, chunk=8, **kw)
    je.params = jp
    return je


def _engine(tcfg, tp, n_slots=2):
    return ServingEngine(tcfg, n_slots=n_slots, max_context=64, chunk=8,
                         device="cpu", params=tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_engine(weights, arch):
    """In f32, prompts of 5, 20 and 37 tokens with 12 new tokens each
    (chunked prefill of 8, the rest through decode; gemma3 runs 41 tokens
    past its window of 8), served together on 2 slots: the port's engine
    generates the JAX engine's tokens."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = weights[arch, "float32"]
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (5, 20, 37)]
    je = _jax_engine(jcfg, jp)
    want = [je.submit(p, 12) for p in prompts]
    je.run_until_idle()
    eng = _engine(tcfg, tp)
    got = [eng.submit(p, 12) for p in prompts]
    eng.run_until_idle()
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 12 for r in got)
    # a request served alone gets the same tokens
    assert _engine(tcfg, tp).generate(prompts[2], 12) == want[2].generated


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_batch_matches_jax_engine(weights, arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = weights[arch, "float32"]
    lists = [[1, 2, 3, 4], [5, 6, 7], list(range(40))]     # bucket 64
    out = _engine(tcfg, tp).embed_batch(lists)
    np.testing.assert_allclose(out, _jax_engine(jcfg, jp).embed_batch(lists),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
