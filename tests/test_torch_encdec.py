"""The port's encoder-decoder (whisper-base) against the JAX package's, on
identical weights, on the CPU.

JAX draws the weights of whisper's smoke config (2 encoder and 2 decoder
layers, d 64, 4 heads of 16, LayerNorm with scale and bias, a plain
GELU-tanh MLP, V 256 tied, 16 frames) in f32 and in bf16;
``repro_torch.params.from_jax`` carries them over bit for bit, and the
same numpy frames and token ids go through both packages.  The JAX
encoder runs its non-causal flash attention as Pallas in interpret mode
(``use_pallas=True``) and through its plain path.  Tolerances
(``ROADMAP.md``): modules at the kernel tolerances of
``tests/test_kernels.py`` (2e-5 in f32, 2e-2 in bf16), logits at 1e-4 in
f32 (summation order only) and 6e-2 in bf16, generated tokens equal in
f32.

Also recorded, in both packages alike (``ROADMAP.md``, C.15): a serving
engine's default cache holds zero cross-attention keys and values (text
is served against them, so cross-attention adds nothing), and an embed
request, which carries no frames, raises ``KeyError: 'frames'``.
"""

from unittest import mock

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
from repro.core import LocalJaxProvider
from repro.core import ModelResource as JaxModelResource
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.steps import make_embed_step as jax_embed_step
from repro_torch.configs import (NOT_YET_PORTED, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.core import LocalTorchProvider, ModelResource
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.steps import make_embed_step

ARCH = "whisper-base"
DTYPES = ("float32", "bfloat16")
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py
LOGITS = {"float32": 1e-4, "bfloat16": 6e-2}
NUM_PARAMS = 70_595_072                           # the JAX formula, full
SLOTS, CONTEXT = 4, 64


def _cfgs(dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (jax_smoke(ARCH).replace(remat=False, **kw),
            get_smoke_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) per dtype, drawn once."""
    out = {}
    for dtype in DTYPES:
        jcfg, _ = _cfgs(dtype)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        out[dtype] = jp, from_jax(jax.tree.map(np.asarray, jp))
    return out


def _frames(seed, B, dtype, S=16, d=64):
    """N(0, 1) frames as numpy f32, and as each package's array in
    ``dtype``."""
    f = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return (jnp.asarray(f).astype(dtype),
            torch.from_numpy(f).to(getattr(torch, dtype)))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


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


def _layer(jp, tp, name, block="xattn", stage=0):
    """Layer 0 of a stage's ``block`` weights in both packages; ``name``
    is "stages" (the decoder) or "encoder"."""
    jst = jp["stages"] if name == "stages" else jp["encoder"]["stages"]
    tst = tp["stages"] if name == "stages" else tp["encoder"]["stages"]
    return (jax.tree.map(lambda a: a[0], jst[stage]["b0"][block]),
            M._index(tst[stage]["b0"][block], 0))


# --------------------------------------------------------------------------
# configs and weights
# --------------------------------------------------------------------------
def test_registry():
    assert list_archs()[-2:] == ["whisper-base", "phi-3-vision-4.2b"]
    assert NOT_YET_PORTED == ()


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    j = jax_smoke(ARCH) if smoke else jax_get_config(ARCH)
    t = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    for f in t.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    assert t.stages() == j.stages()
    assert t.encoder_stages() == j.encoder_stages() == (
        (("attn",), t.num_encoder_layers),)
    assert t.num_params() == j.num_params()
    if not smoke:
        assert t.num_params() == NUM_PARAMS


def test_full_init_tree_matches_jax_eval_shape():
    """whisper-base's own draw at full width, on the meta device (no
    memory): the JAX init's tree, shapes and dtypes, the encoder and the
    decoder's cross-attention included."""
    want = jax.eval_shape(lambda: JM.init_params(jax_get_config(ARCH),
                                                 jax.random.PRNGKey(0)))

    def meta_draw(shape, std, dtype, generator, device):
        return torch.empty(shape, dtype=dtype, device="meta")
    with mock.patch.object(L, "normal_init", meta_draw):
        got = init_params(get_config(ARCH), None, "meta")
    n = 0
    for path, a, b in _tree_pairs(want, got):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        n += 1
    assert n == len(jax.tree.leaves(want))
    assert set(got) == {"embed", "final_norm", "stages", "encoder"}
    assert set(got["stages"][0]["b0"]) == {"ln1", "attn", "ln_x", "xattn",
                                           "ln2", "ffn"}
    assert set(got["encoder"]["stages"][0]["b0"]) == {"ln1", "attn", "ln2",
                                                      "ffn"}


def test_init_params_smoke_values(weights):
    """The port's own draw at smoke width: JAX's tree, shapes and dtypes,
    the LayerNorms' scale one and bias zero, seeded, at the JAX init's
    scale."""
    jp, _ = weights["bfloat16"]
    _, cfg = _cfgs("bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    again = init_params(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        if "scale" in path or "bias" in path:
            np.testing.assert_array_equal(b.float().numpy(),
                                          a.astype(np.float32), err_msg=path)
    for a, b in zip(_leaves(tp), _leaves(again)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for block in ("attn", "xattn"):
        std = tp["stages"][0]["b0"][block]["wq"].float().std().item()
        assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


@pytest.mark.parametrize("dtype", DTYPES)
def test_from_jax_is_bit_exact(weights, dtype):
    jp, tp = weights[dtype]
    n = 0
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.float().numpy(),
                                      a.astype(np.float32), err_msg=path)
        n += 1
    assert n == len(jax.tree.leaves(jp)) > 30


# --------------------------------------------------------------------------
# the modules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seq,d,dtype", [(16, 64, "float32"),
                                         (16, 64, "bfloat16"),
                                         (1500, 512, "bfloat16")])
def test_sinusoid_pos_matches_jax(seq, d, dtype):
    """The encoder's positions, at smoke width and (as served, in bf16) at
    whisper-base's 1,500 x 512."""
    want = JL.sinusoid_pos(seq, d, dtype=getattr(jnp, dtype))
    got = L.sinusoid_pos(seq, d, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (seq, d)
    _close(got, want, TOLS[dtype])


def test_sinusoid_pos_full_width_f32_gap():
    """In f32 at 1,500 positions the two tables differ by more than
    TOLS: XLA's and torch's f32 ``exp`` differ by one ulp in some
    frequencies (both from the same f32 arguments), position p multiplies
    that ulp by p, and the f32 angle near 1,499 rounds to 2^-13.  The gap
    stays within that bound, and the frequencies within one ulp."""
    import math
    half = 256
    arg = -np.arange(half, dtype=np.float32) * np.float32(
        math.log(10_000.0) / (half - 1))
    jf = np.asarray(jnp.exp(jnp.asarray(arg)))
    tf = torch.exp(torch.from_numpy(arg)).numpy()
    ulps = np.abs(jf.view(np.int32) - tf.view(np.int32))
    assert ulps.max() <= 1
    want = np.asarray(JL.sinusoid_pos(1500, 512, dtype=jnp.float32))
    got = L.sinusoid_pos(1500, 512, dtype=torch.float32).numpy()
    bound = (1499 * float(np.abs(jf - tf).max()) + 2.0 ** -13
             + 4 * 2.0 ** -24)
    assert 0 < np.abs(got - want).max() <= bound


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_and_plain_gelu_mlp_match_jax(weights, dtype):
    """LayerNorm with a scale and a bias (drawn here, not the init's one
    and zero) and the plain (``glu=False``) GELU-tanh MLP: no served
    config used them before whisper."""
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    want = JL.norm_apply(jcfg, {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}, jx)
    got = L.norm_apply(tcfg, {"scale": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias)}, tx)
    assert got.dtype == tx.dtype
    _close(got, want, TOLS[dtype])
    jp, tp = weights[dtype]
    jffn, tffn = _layer(jp, tp, "stages", "ffn")
    assert set(tffn) == {"w1", "w2"}
    _close(L.ffn_apply(tcfg, tffn, tx), JL.ffn_apply(jcfg, jffn, jx,
                                                     JL.NULL_POLICY),
           TOLS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(weights, dtype):
    """``encode_cross_kv`` over an encoder output of 16 frames, then
    ``cross_attention`` of 5 decoder rows over those keys and values (no
    rope, no mask)."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    jx, tx = _layer(jp, tp, "stages")
    assert "bq" not in tx
    enc_j, enc_t = _frames(2, 2, dtype)
    ek, ev = JL.encode_cross_kv(jcfg, jx, enc_j, JL.NULL_POLICY)
    tk, tv = L.encode_cross_kv(tcfg, tx, enc_t)
    assert tk.shape == (2, 16, 4, 16) and tk.dtype == enc_t.dtype
    _close(tk, ek, TOLS[dtype])
    _close(tv, ev, TOLS[dtype])
    h_j, h_t = _frames(3, 2, dtype, S=5)
    want = JL.cross_attention(jcfg, jx, h_j, ek, ev, JL.NULL_POLICY)
    # the port's own keys and values, as its model uses them
    got = L.cross_attention(tcfg, tx, h_t, tk, tv)
    assert got.shape == (2, 5, 64)
    _close(got, want, TOLS[dtype])


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_run_encoder_matches_jax(weights, dtype, use_pallas):
    """The encoder (sinusoidal positions, 2 layers of non-causal attention
    with rope, final LayerNorm) against JAX's, whose attention runs on its
    Pallas kernel in interpret mode or on its plain path."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    fj, ft = _frames(4, 2, dtype)
    want = JM._run_encoder(jcfg.replace(use_pallas=use_pallas), jp, fj,
                           JL.NULL_POLICY)
    got = M._run_encoder(tcfg, tp, ft)
    assert got.shape == (2, 16, 64) and got.dtype == ft.dtype
    _close(got, want, TOLS[dtype])


def test_encoder_is_not_causal(weights):
    """A change to the last frame moves the encoder's first output row
    (its attention sees every frame) in both packages.  (The change is
    random: a constant added to a frame is what its LayerNorm removes.)"""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = weights["float32"]
    _, ft = _frames(4, 1, "float32")
    _, noise = _frames(41, 1, "float32", S=1)
    moved = ft.clone()
    moved[:, -1] += noise[:, 0]
    a, b = M._run_encoder(tcfg, tp, ft), M._run_encoder(tcfg, tp, moved)
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3
    ja = JM._run_encoder(jcfg, jp, jnp.asarray(ft.numpy()), JL.NULL_POLICY)
    jb = JM._run_encoder(jcfg, jp, jnp.asarray(moved.numpy()),
                         JL.NULL_POLICY)
    assert float(jnp.abs(ja[:, 0] - jb[:, 0]).max()) > 1e-3


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_train_matches_jax(weights, dtype, use_pallas):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    fj, ft = _frames(5, 2, dtype)
    toks = _tokens(6, (2, 12))
    ref, _ = JM.forward_train(jcfg.replace(use_pallas=use_pallas), jp,
                              {"tokens": jnp.asarray(toks), "frames": fj})
    out, aux = M.forward_train(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                          "frames": ft})
    assert out.dtype == torch.float32 and out.shape == (2, 12, 256)
    assert float(aux) == 0.0
    _close(out, ref, LOGITS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(weights, dtype):
    """``prefill`` over frames and 9 tokens, then 3 greedy decode steps,
    each package fed its own argmax: logits and every cache leaf (the
    cross-attention keys and values prefill wrote included) agree, and in
    f32 the tokens are equal; the decode logits also equal ``forward_train``'s
    teacher-forced logits over the same tokens, as the JAX package's own
    test holds it."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    fj, ft = _frames(7, 2, dtype)
    toks = _tokens(8, (2, 9))
    jl, jc, jn = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                       "frames": fj}, 32)
    tl, tc, tn = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                      "frames": ft}, 32)
    assert tn == jn == 9
    assert tuple(tc[0]["b0"]["xattn"]["k"].shape) == (2, 2, 16, 4, 16)
    _close(tl, jl, LOGITS[dtype])
    seq_j, seq_t = [toks], [toks]
    for i in range(3):
        nj = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        nt = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
        if dtype == "float32":
            assert np.array_equal(nt.numpy(), nj)
        seq_j.append(nj)
        seq_t.append(nt.numpy())
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nj), jc,
                                jnp.int32(9 + i))
        tl, tc = M.decode_step(tcfg, tp, nt, tc, 9 + i)
        _close(tl, jl, LOGITS[dtype])
    for path, a, b in _tree_pairs(jc, tc):
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path
        _close(b, a, LOGITS[dtype])
    # teacher forcing over the tokens the port fed itself
    full = torch.from_numpy(np.concatenate(seq_t, axis=1)[:, :12])
    tf, _ = M.forward_train(tcfg, tp, {"tokens": full, "frames": ft})
    _close(tl[:, 0], tf[:, 11].numpy(), LOGITS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_for_cache_matches_jax(weights, dtype):
    """Every leaf of the cache ``encode_for_cache`` returns: the
    cross-attention keys and values of 3 clips, the self-attention cache
    zero.  The leaves are the whole encoder's output projected, so bf16
    holds them at the stack's tolerance, as the other stacks' cache
    leaves are held (``tests/test_torch_dense.py``); the projection alone
    is held at the module tolerance in ``test_cross_attention_matches_jax``."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    fj, ft = _frames(9, 3, dtype)
    jc = JM.encode_for_cache(jcfg, jp, fj, 3, 32)
    tc = M.encode_for_cache(tcfg, tp, ft, 3, 32)
    n = 0
    for path, a, b in _tree_pairs(jc, tc):
        assert tuple(b.shape) == np.asarray(a).shape, path
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path
        if "/attn/" in path:
            assert not b.any(), path
        else:
            assert b.abs().max() > 0, path
        _close(b, a, TOLS[dtype] if dtype == "float32" else LOGITS[dtype])
        n += 1
    assert n == 4          # one stage of 2 layers: attn and xattn, k and v


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_chunk_over_encoded_cache_matches_jax(weights, dtype):
    """Chunked prefill over an ``encode_for_cache`` cache (a scalar and
    then per-row offsets), then decode steps: logits and the cache agree,
    and the cross-attention leaves are read in place, never written."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    fj, ft = _frames(10, 2, dtype)
    jc = JM.encode_for_cache(jcfg, jp, fj, 2, 32)
    tc = M.encode_for_cache(tcfg, tp, ft, 2, 32)
    xk = [s["b0"]["xattn"]["k"].clone() for s in tc]
    rng = np.random.default_rng(11)
    chunk = rng.integers(0, 256, (2, 8)).astype(np.int32)
    jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc, jnp.int32(0))
    tl, tc2 = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc, 0)
    assert all(a is b for a, b in zip(_leaves(tc2), _leaves(tc)))
    _close(tl, jl, LOGITS[dtype])
    offs = np.array([8, 8], np.int32)
    chunk = rng.integers(0, 256, (2, 4)).astype(np.int32)
    jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                              jnp.asarray(offs))
    tl, tc = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc,
                             torch.from_numpy(offs))
    _close(tl, jl, LOGITS[dtype])
    pos = np.array([12, 12], np.int32)
    for step in range(3):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos + step))
        tl, tc = M.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                               torch.from_numpy(pos + step))
        _close(tl, jl, LOGITS[dtype])
    for path, a, b in _tree_pairs(jc, tc):
        _close(b, a, LOGITS[dtype])
    assert all(torch.equal(a, s["b0"]["xattn"]["k"]) for a, s in zip(xk, tc))


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_step_with_frames_matches_jax(weights, dtype):
    """``make_embed_step`` over (tokens, frames) pairs, token -1 padding
    the shorter text: unit vectors, within the module tolerance of
    JAX's."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    fj, ft = _frames(12, 3, dtype)
    toks = _tokens(13, (3, 32))
    toks[1, 20:] = -1
    want = jax_embed_step(jcfg)(jp, {"tokens": jnp.asarray(toks),
                                     "frames": fj})
    got = make_embed_step(tcfg)(tp, {"tokens": torch.from_numpy(toks),
                                     "frames": ft})
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    _close(got, want, TOLS[dtype])


# --------------------------------------------------------------------------
# serving: the port's engine against the JAX engine
# --------------------------------------------------------------------------
def _jax_engine(jcfg, jp, chunk):
    je = JaxEngine(jcfg, n_slots=SLOTS, max_context=CONTEXT, chunk=chunk)
    je.params = jp
    return je


def _engine(tcfg, tp, chunk):
    return ServingEngine(tcfg, n_slots=SLOTS, max_context=CONTEXT,
                         chunk=chunk, device="cpu", params=tp)


PROMPT_LENS = (3, 10, 21, 6, 13)        # the fifth request reuses a slot


@pytest.mark.parametrize("cross", ["zero", "clips"])
@pytest.mark.parametrize("chunk", [4, 8])
def test_engine_matches_jax_engine(weights, chunk, cross):
    """In f32, 5 requests of 8 new tokens on 4 slots (chunked prefill of
    ``chunk``, the rest through decode), the fifth in a freed slot: on
    the default cache (zero cross-attention keys and values, as the JAX
    engine serves text) and on an ``encode_for_cache`` cache of 4 clips
    put in place before submitting (how the JAX package serves audio).
    The port's engine generates the JAX engine's tokens in the same
    slots; the fifth request equals its run in a fresh engine whose
    first slot holds the same clip."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = weights["float32"]
    fj, ft = _frames(14, SLOTS, "float32")
    prompts = [[int(t) for t in _tokens(15 + i, n)]
               for i, n in enumerate(PROMPT_LENS)]
    je, eng = _jax_engine(jcfg, jp, chunk), _engine(tcfg, tp, chunk)
    if cross == "clips":
        je.cache = JM.encode_for_cache(jcfg, jp, fj, SLOTS, CONTEXT)
        eng.cache = M.encode_for_cache(tcfg, tp, ft, SLOTS, CONTEXT)
    want = [je.submit(p, 8) for p in prompts]
    je.run_until_idle()
    got = [eng.submit(p, 8) for p in prompts]
    eng.run_until_idle()
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [r.slot for r in got] == [r.slot for r in want]
    assert all(len(r.generated) == 8 for r in got)
    fifth = got[4]
    assert fifth.slot in [r.slot for r in got[:4]]
    fresh = _engine(tcfg, tp, chunk)
    if cross == "clips":
        fresh.cache = M.encode_for_cache(
            tcfg, tp, torch.roll(ft, -fifth.slot, dims=0), SLOTS, CONTEXT)
    assert fresh.generate(prompts[4], 8) == fifth.generated


def test_clips_change_what_the_engine_generates(weights):
    """The cross-attention cache is read: the same requests generate other
    tokens over the clips than over the zero cache."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = weights["float32"]
    _, ft = _frames(14, SLOTS, "float32")
    prompts = [[int(t) for t in _tokens(15 + i, n)]
               for i, n in enumerate(PROMPT_LENS)]
    runs = []
    for cache in (None, M.encode_for_cache(tcfg, tp, ft, SLOTS, CONTEXT)):
        eng = _engine(tcfg, tp, 8)
        if cache is not None:
            eng.cache = cache
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run_until_idle()
        runs.append([r.generated for r in reqs])
    assert runs[0] != runs[1]


def test_reset_recurrent_rows_keeps_the_clip(weights):
    """Admitting a request resets only recurrent state: a slot's
    cross-attention keys and values stay as ``encode_for_cache`` wrote
    them, as in the JAX engine, whose ``_admit`` resets only ``pos``."""
    _, tcfg = _cfgs("float32")
    _, tp = weights["float32"]
    _, ft = _frames(16, SLOTS, "float32")
    cache = M.encode_for_cache(tcfg, tp, ft, SLOTS, CONTEXT)
    before = [t.clone() for t in _leaves(cache)]
    M.reset_recurrent_rows(tcfg, cache, 2)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(cache)))


# --------------------------------------------------------------------------
# ROADMAP C.15: the engines serve text on a zero cross cache and cannot
# embed, in both packages alike
# --------------------------------------------------------------------------
def test_default_cache_has_zero_cross_kv_in_both_packages(weights):
    jcfg, tcfg = _cfgs("float32")
    jp, tp = weights["float32"]
    je, eng = _jax_engine(jcfg, jp, 8), _engine(tcfg, tp, 8)
    jx = [s["b0"]["xattn"] for s in je.cache]
    tx = [s["b0"]["xattn"] for s in eng.cache]
    for j, t in zip(jx, tx):
        for name in ("k", "v"):
            assert np.asarray(j[name]).shape == tuple(t[name].shape) == (
                2, SLOTS, 16, 4, 16)
            assert not np.asarray(j[name]).any() and not t[name].any()
    # served text leaves them zero in both
    je.generate([1, 2, 3], 4)
    eng.generate([1, 2, 3], 4)
    assert not any(np.asarray(s["b0"]["xattn"]["k"]).any() for s in je.cache)
    assert not any(s["b0"]["xattn"]["k"].any() for s in eng.cache)


def test_embed_without_frames_raises_in_both_packages(weights):
    """``embed_batch`` and each local provider's ``embed`` raise
    ``KeyError: 'frames'``: an embed request carries text alone, and the
    embed step runs the encoder over frames first."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = weights["float32"]
    with pytest.raises(KeyError, match="frames"):
        _jax_engine(jcfg, jp, 8).embed_batch([[1, 2, 3]])
    with pytest.raises(KeyError, match="frames"):
        _engine(tcfg, tp, 8).embed_batch([[1, 2, 3]])
    with pytest.raises(KeyError, match="frames"):
        LocalJaxProvider(ARCH).embed(JaxModelResource("e", 1, ARCH), ["hi"])
    with pytest.raises(KeyError, match="frames"):
        LocalTorchProvider(ARCH, device="cpu").embed(
            ModelResource("e", 1, ARCH), ["hi"])
