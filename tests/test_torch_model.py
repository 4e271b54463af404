"""The port's dense model against the JAX package's, on identical weights.

JAX draws the weights (``M.init_params``); ``repro_torch.params.from_jax``
carries them over bit for bit.  Both packages run on the CPU with the same
numpy token ids.  Configurations: the olmo-1b smoke config, and a variant
with grouped KV heads (``num_kv_heads=2``), a sliding-window layer
(``pattern=("local", "attn")``, ``window_size=8``).  Tolerances: 1e-4 in
f32 (summation order only) and 6e-2 in bf16 (``tests/test_kernels.py``'s
model tolerance: bf16 rounding accumulated across layers).
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.steps import make_embed_step as jax_embed_step
from repro.training.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params, load_checkpoint
from repro_torch.serving.steps import make_embed_step

TOL = {"float32": 1e-4, "bfloat16": 6e-2}
VARIANTS = {"olmo": {},
            "gqa_local": {"num_kv_heads": 2, "pattern": ("local", "attn"),
                          "window_size": 8}}


def _cfgs(variant, dtype):
    kw = dict(VARIANTS[variant], param_dtype=dtype, compute_dtype=dtype)
    return (jax_smoke("olmo-1b").replace(remat=False, **kw),
            get_smoke_config("olmo-1b").replace(**kw))


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) per (variant, dtype), drawn once."""
    out = {}
    for variant in VARIANTS:
        for dtype in TOL:
            jcfg, _ = _cfgs(variant, dtype)
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            out[variant, dtype] = jp, from_jax(jax.tree.map(np.asarray, jp))
    return out


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


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


# --------------------------------------------------------------------------
# configs and weights
# --------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    j = jax_smoke("olmo-1b") if smoke else jax_get_config("olmo-1b")
    t = get_smoke_config("olmo-1b") if smoke else get_config("olmo-1b")
    for f in t.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    assert t.stages() == j.stages()
    assert t.num_params() == j.num_params()
    assert list_archs() == ["olmo-1b", "falcon-mamba-7b", "recurrentgemma-9b",
                            "granite-8b", "gemma3-12b", "qwen1.5-32b",
                            "deepseek-moe-16b", "mixtral-8x7b",
                            "whisper-base", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("lookup", [get_config, get_smoke_config],
                         ids=["full", "smoke"])
def test_unported_arch_raises(lookup):
    """No architecture of the JAX package is left unported: phi-3-vision-
    4.2b, the last one refused (whisper-base was the other case until the
    encoder-decoder was ported), is returned by both config lookups and
    its weights are drawn; a name the JAX package lacks raises
    ``KeyError``, and the weight draw refuses a frontend the port does
    not know."""
    cfg = lookup("phi-3-vision-4.2b")
    assert cfg.name.startswith(("phi-3-vision", "phi3v")) and \
        cfg.frontend == "vision"
    with pytest.raises(KeyError, match="unknown arch"):
        lookup("phi-3-vision")
    init_params(get_smoke_config("phi-3-vision-4.2b"), torch.Generator())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(get_smoke_config("olmo-1b").replace(frontend="video"),
                    torch.Generator())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_is_bit_exact(weights, dtype):
    jp, tp = weights["gqa_local", dtype]
    n = 0
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.float().numpy(),
                                      a.astype(np.float32), err_msg=path)
        n += 1
    assert n > 10


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_shapes_match_jax(weights, variant):
    jp, _ = weights[variant, "bfloat16"]
    _, cfg = _cfgs(variant, "bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    again = init_params(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _tree_pairs(jp, tp):
        assert tuple(b.shape) == np.asarray(a).shape, path
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path
    # seeded: the same generator state draws the same weights
    torch.testing.assert_close(tp["embed"], again["embed"], rtol=0, atol=0)
    std = tp["stages"][0]["b0"]["attn"]["wq"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_checkpoint_reader_matches_from_jax(weights, tmp_path):
    jp, tp = weights["olmo", "bfloat16"]
    CheckpointManager(str(tmp_path)).save(3, {"params": jp, "step": 3})
    loaded = load_checkpoint(tmp_path / "step_0000000003.npz")
    assert int(loaded["step"]) == 3
    # the flat .npz format keeps leaves only: empty norm dicts are dropped
    want = {p: a for p, a, _ in _tree_pairs(tp, tp)}
    got = {p: b for p, b, _ in _tree_pairs(loaded["params"],
                                          loaded["params"])}
    assert set(got) == set(want)
    for p, a in want.items():
        assert a.dtype == got[p].dtype, p
        torch.testing.assert_close(a, got[p], rtol=0, atol=0)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_jax(norm):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    p = {"rmsnorm": {"scale": scale}, "layernorm": {"scale": scale,
                                                    "bias": bias},
         "nonparam_ln": {}}[norm]
    jcfg, tcfg = _cfgs("olmo", "float32")
    ref = JL.norm_apply(jcfg.replace(norm=norm),
                        {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    out = L.norm_apply(tcfg.replace(norm=norm),
                       {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    _close(out, ref, "float32")
    _close(L.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x)),
           JL.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)), "float32")


def test_rope_and_plain_attention_match_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [9, 10, 11, 12, 13]], np.int32)
    _close(L.rope_apply(torch.from_numpy(q), torch.from_numpy(pos), 1e4),
           JL.rope_apply(jnp.asarray(q), jnp.asarray(pos), 1e4), "float32")
    for window in (0, 4):
        ref = JL.chunked_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), causal=True,
                                   window=window,
                                   q_offset=jnp.asarray(pos[:, 0]),
                                   block_k=8)
        out = L.chunked_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), causal=True,
                                  window=window,
                                  q_offset=torch.from_numpy(pos[:, 0]),
                                  block_k=8)
        _close(out, ref, "float32")
        ref = JL.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(pos[:, 0]),
                                  window=window)
        out = L.decode_attention(torch.from_numpy(q[:, :1]),
                                 torch.from_numpy(kc), torch.from_numpy(vc),
                                 torch.from_numpy(pos[:, 0]), window=window)
        _close(out, ref, "float32")


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_train_matches_jax(weights, variant, dtype):
    jcfg, tcfg = _cfgs(variant, dtype)
    jp, tp = weights[variant, dtype]
    toks = np.random.default_rng(7).integers(0, 256, (2, 20)).astype(np.int32)
    ref, _ = JM.forward_train(jcfg, jp, {"tokens": jnp.asarray(toks)})
    out, aux = M.forward_train(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32 and float(aux) == 0.0
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_chunks_and_decode_match_jax(weights, variant, dtype):
    """A prefill_chunk chain (scalar and per-row offsets), then decode
    steps at per-row positions: logits and cache agree with JAX."""
    jcfg, tcfg = _cfgs(variant, dtype)
    jp, tp = weights[variant, dtype]
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, 256, (2, 16)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 32)
    tc = M.init_cache(tcfg, 2, 32)
    for c0, off in ((0, 0), (8, 8)):              # scalar offsets
        chunk = prompt[:, c0:c0 + 8]
        jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                                  jnp.int32(off))
        tl, tc = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc, off)
        _close(tl, jl, dtype)
    offs = np.array([16, 16], np.int32)           # per-row offsets
    chunk = rng.integers(0, 256, (2, 4)).astype(np.int32)
    jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                              jnp.asarray(offs))
    tl, tc = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc,
                             torch.from_numpy(offs))
    _close(tl, jl, dtype)
    pos = np.array([20, 20], np.int32)
    for step in range(3):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos + step))
        tl, tc = M.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                               torch.from_numpy(pos + step))
        _close(tl, jl, dtype)
    for path, a, b in _tree_pairs(jc, tc):
        _close(b, a, dtype)


def test_prefill_matches_jax(weights):
    jcfg, tcfg = _cfgs("gqa_local", "float32")
    jp, tp = weights["gqa_local", "float32"]
    toks = np.random.default_rng(9).integers(0, 256, (1, 12)).astype(
        np.int32)
    jl, jc, jn = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc, tn = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 32)
    assert tn == jn == 12
    _close(tl, jl, "float32")
    for path, a, b in _tree_pairs(jc, tc):
        _close(b, a, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_embed_step_matches_jax_pallas(weights, variant, dtype):
    """The embed step (full-sequence stack, -1 padding, mean pool) against
    the JAX step on its Pallas flash-attention kernel."""
    jcfg, tcfg = _cfgs(variant, dtype)
    jp, tp = weights[variant, dtype]
    toks = np.full((3, 32), -1, np.int32)
    rng = np.random.default_rng(10)
    for i, n in enumerate((5, 32, 17)):
        toks[i, :n] = rng.integers(0, 256, n)
    ref = jax_embed_step(jcfg.replace(use_pallas=True))(
        jp, {"tokens": jnp.asarray(toks)})
    out = make_embed_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32 and out.shape == (3, tcfg.d_model)
    _close(out, ref, dtype)
