"""The port's vision patch prefix (phi-3-vision-4.2b) against the JAX
package's, on identical weights, on the CPU.

phi-3-vision is a dense decoder whose batch may carry ``patches`` (B, P,
d), the stubbed image tower's patch embeddings, put in front of the token
embeddings.  JAX draws the weights of two configs, in f32 and in bf16:
the smoke config (2 layers, d 64, 4 heads of 16, V 256, 4 prefix tokens)
and the same widened to two heads of 96 (d 192), the full config's head
dim, which the port's attention kernels serve since their hd-96
instances.  ``repro_torch.params.from_jax`` carries the weights over bit
for bit, and the same numpy patches and token ids go through both
packages.  The JAX stack runs flash and decode attention as Pallas in
interpret mode (``use_pallas=True``); its serving engine, whose steps are
jitted, its plain path.  Tolerances (``ROADMAP.md``): modules and kernels
at ``tests/test_kernels.py``'s (2e-5 in f32, 2e-2 in bf16), logits at
1e-4 in f32 (summation order only) and 6e-2 in bf16, generated tokens
equal in f32.

Also recorded, in both packages alike (``ROADMAP.md``, C.16): the
serving engines and the local providers take no patches, so they
complete and embed text alone; an image reaches the model only through
``prefill`` over ``{"tokens", "patches"}`` and the embed step.
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
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.steps import make_embed_step as jax_embed_step
from repro_torch.configs import (NOT_YET_PORTED, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.core import LocalTorchProvider, ModelResource
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.steps import make_embed_step

ARCH = "phi-3-vision-4.2b"
DTYPES = ("float32", "bfloat16")
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py
LOGITS = {"float32": 1e-4, "bfloat16": 6e-2}
# analytic parameter counts (the JAX formula), full and smoke
NUM_PARAMS = {False: 3_820_879_872, True: 114_688}
# the smoke config, and the same at the full config's head dim of 96
WIDTHS = {"smoke": {},
          "hd96": dict(d_model=192, num_heads=2, num_kv_heads=2,
                       head_dim=96)}
CONTEXT = 64


def _cfgs(width, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **WIDTHS[width])
    return (jax_smoke(ARCH).replace(remat=False, **kw),
            get_smoke_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) per (width, dtype), drawn once."""
    out = {}
    for width in WIDTHS:
        for dtype in DTYPES:
            jcfg, _ = _cfgs(width, dtype)
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            out[width, dtype] = jp, from_jax(jax.tree.map(np.asarray, jp))
    return out


def _patches(seed, B, cfg):
    """``num_prefix_tokens`` patch embeddings a row, N(0, 1) at the token
    embeddings' scale (d^-0.5), as numpy f32."""
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.num_prefix_tokens, cfg.d_model)) * cfg.d_model ** -0.5
            ).astype(np.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _batches(toks, patches):
    """The same batch for each package: (jax dict, torch dict)."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if patches is not None:
        jb["patches"] = jnp.asarray(patches)
        tb["patches"] = torch.from_numpy(patches)
    return jb, tb


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
    assert list_archs()[-1] == ARCH and len(list_archs()) == 10
    assert NOT_YET_PORTED == ()


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    j = jax_smoke(ARCH) if smoke else jax_get_config(ARCH)
    t = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    for f in t.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    assert t.stages() == j.stages()
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.frontend == "vision"
    assert t.num_prefix_tokens == (4 if smoke else 144)
    assert t.num_params() == j.num_params() == NUM_PARAMS[smoke]


def test_full_init_tree_matches_jax_eval_shape():
    """phi-3-vision's own draw at full width, on the meta device (no
    memory): the JAX init's tree, shapes and dtypes.  The stubbed image
    tower has no weights in either package, so no leaf is added."""
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
    assert set(got) == {"embed", "final_norm", "stages", "lm_head"}
    assert sum(t.numel() for t in _leaves(got)) == \
        NUM_PARAMS[False] + 3072 * (2 * 32 + 1)     # + the norm scales


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_from_jax_is_bit_exact(weights, width, dtype):
    jp, tp = weights[width, dtype]
    n = 0
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.float().numpy(),
                                      a.astype(np.float32), err_msg=path)
        n += 1
    assert n > 10


def test_init_params_match_jax(weights):
    """The port's own draw at the hd-96 width: JAX's tree, shapes and
    dtypes, norm scales of one, seeded, at the JAX init's scale."""
    jp, _ = weights["hd96", "bfloat16"]
    _, cfg = _cfgs("hd96", "bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    again = init_params(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        if "scale" in path or "norm" in path:
            np.testing.assert_array_equal(b.float().numpy(),
                                          a.astype(np.float32), err_msg=path)
    for a, b in zip(_leaves(tp), _leaves(again)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    std = tp["stages"][0]["b0"]["attn"]["wq"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


# --------------------------------------------------------------------------
# the plain kernels at hd 96 against the JAX Pallas kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,S,H,KH,causal,window",
    [(1, 4 + 45, 2, 2, True, 0),         # a prefix of 4 and 45 tokens
     (2, 144 + 20, 2, 2, True, 0),       # the full prefix of 144 and 20
     (2, 70, 4, 1, True, 24),            # GQA 4 over 1, a window
     (1, 40, 2, 2, False, 0)])           # bidirectional
def test_plain_flash_hd96_matches_jax_pallas(B, S, H, KH, causal, window,
                                             dtype):
    """Sequences that are no multiple of the Pallas kernel's block of 32
    (the JAX wrapper pads them; the port's kernel masks the ragged
    edge)."""
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal((B, S, n, 96)).astype(np.float32)
               for n in (H, KH, KH))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
                    window=window, block_q=32, block_k=32, interpret=True)
    before = flash_attention.launches
    out = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          causal=causal, window=window)
    assert flash_attention.launches == before     # CPU: the plain version
    assert out.dtype == tdt and out.shape == (B, S, H, 96)
    _close(out, ref, TOLS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KH,window,pos",
                         [(2, 2, 0, [200, 37]),
                          (32, 32, 0, [255, 148]),      # phi-3-vision's heads
                          (4, 2, 64, [255, 100])])
def test_plain_decode_hd96_matches_jax_pallas(H, KH, window, pos, dtype):
    rng = np.random.default_rng(21)
    q = rng.standard_normal((2, 1, H, 96)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 256, KH, 96)).astype(np.float32)
              for _ in range(2))
    p = np.asarray(pos, np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_decode(*(jnp.asarray(x, jdt) for x in (q, kc, vc)),
                     jnp.asarray(p), window=window, block_s=64,
                     interpret=True)
    before = decode_attention.launches
    out = decode_attention(*(torch.from_numpy(x).to(tdt)
                             for x in (q, kc, vc)), torch.from_numpy(p),
                           window=window)
    assert decode_attention.launches == before
    _close(out, ref, TOLS[dtype])


# --------------------------------------------------------------------------
# the stack with the patch prefix
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_patches", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_assemble_input_matches_jax(weights, dtype, with_patches):
    """The patches, cast to the compute dtype, in front of the token
    embeddings, positions over the whole sequence; without patches the
    tokens alone."""
    jcfg, tcfg = _cfgs("hd96", dtype)
    jp, tp = weights["hd96", dtype]
    toks = _tokens(1, (2, 9))
    patches = _patches(2, 2, tcfg) if with_patches else None
    jb, tb = _batches(toks, patches)
    jx, jpos = JM._assemble_input(jcfg, jp, jb, JL.NULL_POLICY)
    tx, tpos = M._assemble_input(tcfg, tp, tb)
    P = tcfg.num_prefix_tokens if with_patches else 0
    assert tx.dtype == tcfg.compute_torch_dtype
    assert tx.shape == (2, P + 9, tcfg.d_model)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tpos[0].numpy(), np.arange(P + 9))
    _close(tx, jx, 0)
    if with_patches:
        torch.testing.assert_close(
            tx[:, :P], torch.from_numpy(patches).to(tx.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_train_with_patches_matches_jax_pallas(weights, width,
                                                       dtype):
    """The full-sequence forward over the prefix and 15 tokens (19
    positions), whose attention is ``flash_attention``, against the JAX
    forward on its Pallas kernel (interpret mode)."""
    jcfg, tcfg = _cfgs(width, dtype)
    jp, tp = weights[width, dtype]
    jb, tb = _batches(_tokens(3, (2, 15)), _patches(4, 2, tcfg))
    ref, _ = JM.forward_train(jcfg.replace(use_pallas=True), jp, jb)
    out, aux = M.forward_train(tcfg, tp, tb)
    assert out.dtype == torch.float32 and out.shape == (2, 19, 256)
    assert float(aux) == 0.0
    _close(out, ref, LOGITS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_prefill_with_patches_then_decode_matches_jax(weights, width,
                                                      dtype):
    """``prefill`` over the prefix and 11 tokens returns next_pos = P + S
    in both packages; its cache and logits, then 6 decode steps from
    there (both on their kernels: Pallas in interpret mode, the port's
    plain versions), agree with JAX."""
    jcfg, tcfg = _cfgs(width, dtype)
    jcfg = jcfg.replace(use_pallas=True)
    jp, tp = weights[width, dtype]
    P = tcfg.num_prefix_tokens
    jb, tb = _batches(_tokens(5, (2, 11)), _patches(6, 2, tcfg))
    jl, jc, jn = JM.prefill(jcfg, jp, jb, 32)
    tl, tc, tn = M.prefill(tcfg, tp, tb, 32)
    assert int(jn) == tn == P + 11
    _close(tl, jl, LOGITS[dtype])
    for path, a, b in _tree_pairs(jc, tc):
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path
        _close(b, a, LOGITS[dtype])
    rng = np.random.default_rng(7)
    for step in range(6):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        pos = np.full(2, tn + step, np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        tl, tc = M.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                               torch.from_numpy(pos))
        _close(tl, jl, LOGITS[dtype])
    for path, a, b in _tree_pairs(jc, tc):
        _close(b, a, LOGITS[dtype])


@pytest.mark.parametrize("width", list(WIDTHS))
def test_prefill_and_decode_match_teacher_forcing(weights, width):
    """In f32: ``prefill`` over the prefix and 13 tokens, then greedy-free
    decode of the next 3 given tokens, against ``forward_train``'s
    teacher-forced logits over the same patches and 16 tokens (the JAX
    package's own test of every config, ``tests/test_models.py``)."""
    _, tcfg = _cfgs(width, "float32")
    _, tp = weights[width, "float32"]
    P = tcfg.num_prefix_tokens
    toks = torch.from_numpy(_tokens(8, (2, 16)))
    patches = torch.from_numpy(_patches(9, 2, tcfg))
    full, _ = M.forward_train(tcfg, tp, {"tokens": toks, "patches": patches})
    lg, cache, pos = M.prefill(tcfg, tp, {"tokens": toks[:, :13],
                                          "patches": patches}, 32)
    assert pos == P + 13
    torch.testing.assert_close(lg[:, -1], full[:, P + 12], atol=1e-4,
                               rtol=1e-4)
    for i in range(3):
        lg, cache = M.decode_step(tcfg, tp, toks[:, 13 + i:14 + i], cache,
                                  torch.full((2,), pos + i,
                                             dtype=torch.int32))
        torch.testing.assert_close(lg[:, 0], full[:, P + 13 + i], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_embed_step_with_patches_matches_jax(weights, width, dtype):
    """``make_embed_step`` over (tokens, patches) pairs, token -1 padding
    the shorter texts: the prefix's rows are dropped before the mean, as
    in JAX; unit vectors within the module tolerance of JAX's."""
    jcfg, tcfg = _cfgs(width, dtype)
    jp, tp = weights[width, dtype]
    toks = _tokens(10, (3, 32))
    toks[1, 20:] = -1
    toks[2, 5:] = -1
    jb, tb = _batches(toks, _patches(11, 3, tcfg))
    want = jax_embed_step(jcfg)(jp, jb)
    got = make_embed_step(tcfg)(tp, tb)
    assert got.dtype == torch.float32 and got.shape == (3, tcfg.d_model)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    _close(got, want, TOLS[dtype])


def test_patches_change_the_embedding_and_the_text(weights):
    """The prefix is read: the same tokens embed and continue otherwise
    with an image in front than without."""
    _, tcfg = _cfgs("hd96", "float32")
    _, tp = weights["hd96", "float32"]
    toks = torch.from_numpy(_tokens(12, (2, 16)))
    patches = torch.from_numpy(_patches(13, 2, tcfg))
    step = make_embed_step(tcfg)
    with_img = step(tp, {"tokens": toks, "patches": patches})
    text = step(tp, {"tokens": toks})
    assert (with_img - text).abs().max() > 1e-3
    a, _, _ = M.prefill(tcfg, tp, {"tokens": toks, "patches": patches}, 32)
    b, _, _ = M.prefill(tcfg, tp, {"tokens": toks}, 32)
    assert (a - b).abs().max() > 1e-3


# --------------------------------------------------------------------------
# serving: the port's engine against the JAX engine (text, C.16)
# --------------------------------------------------------------------------
def _jax_engine(jcfg, jp):
    je = JaxEngine(jcfg, n_slots=2, max_context=CONTEXT, chunk=8)
    je.params = jp
    return je


def _engine(tcfg, tp):
    return ServingEngine(tcfg, n_slots=2, max_context=CONTEXT, chunk=8,
                         device="cpu", params=tp)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_generate_matches_jax_engine(weights, width):
    """In f32, prompts of 5, 20 and 37 tokens with 10 new tokens each
    (chunked prefill of 8, the rest through decode) on 2 slots: the port's
    engine generates the JAX engine's tokens, in the same slots."""
    jcfg, tcfg = _cfgs(width, "float32")
    jp, tp = weights[width, "float32"]
    rng = np.random.default_rng(14)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (5, 20, 37)]
    je = _jax_engine(jcfg, jp)
    want = [je.submit(p, 10) for p in prompts]
    je.run_until_idle()
    eng = _engine(tcfg, tp)
    got = [eng.submit(p, 10) for p in prompts]
    eng.run_until_idle()
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [r.slot for r in got] == [r.slot for r in want]
    assert all(len(r.generated) == 10 for r in got)
    assert _engine(tcfg, tp).generate(prompts[2], 10) == want[2].generated


@pytest.mark.parametrize("width", list(WIDTHS))
def test_embed_batch_matches_jax_engine(weights, width):
    jcfg, tcfg = _cfgs(width, "float32")
    jp, tp = weights[width, "float32"]
    lists = [[1, 2, 3, 4], [5, 6, 7], list(range(40))]     # bucket 64
    out = _engine(tcfg, tp).embed_batch(lists)
    np.testing.assert_allclose(out, _jax_engine(jcfg, jp).embed_batch(lists),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


# --------------------------------------------------------------------------
# ROADMAP C.16: the engines and providers serve text without the prefix,
# in both packages alike
# --------------------------------------------------------------------------
def test_engines_embed_text_without_the_prefix_in_both_packages(weights):
    """Each engine's ``embed_batch`` equals its embed step over the
    tokens alone (padded to the bucket with -1), not over any image."""
    jcfg, tcfg = _cfgs("smoke", "float32")
    jp, tp = weights["smoke", "float32"]
    lists = [[9, 8, 7, 6, 5], list(range(30))]               # bucket 32
    toks = np.full((2, 32), -1, np.int32)
    for i, t in enumerate(lists):
        toks[i, :len(t)] = t
    jb, tb = _batches(toks, None)
    np.testing.assert_allclose(_jax_engine(jcfg, jp).embed_batch(lists),
                               np.asarray(jax_embed_step(jcfg)(jp, jb)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_engine(tcfg, tp).embed_batch(lists),
                               make_embed_step(tcfg)(tp, tb).numpy(),
                               atol=1e-6, rtol=1e-6)


def test_providers_complete_and_embed_text_in_both_packages():
    """Each local provider on phi-3-vision's smoke config completes and
    embeds text: no call takes an image."""
    want_shape = (2, get_smoke_config(ARCH).d_model)
    for provider, resource in (
            (LocalJaxProvider(ARCH), JaxModelResource("v", 1, ARCH,
                                                      max_output_tokens=4)),
            (LocalTorchProvider(ARCH, device="cpu"),
             ModelResource("v", 1, ARCH, max_output_tokens=4))):
        emb = provider.embed(resource, ["a photo of a duck", "a pond"])
        assert emb.shape == want_shape and np.isfinite(emb).all()
        toks = provider.engine.generate([1, 2, 3], 4)
        assert len(toks) == 4


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_vision_config_defaults_to_cuda(no_cuda):
    """phi-3-vision's engine and provider, like every other config's, run
    on the GPU unless asked for the CPU."""
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalTorchProvider(ARCH)
    assert ServingEngine(cfg, device="cpu").device.type == "cpu"
    assert LocalTorchProvider(ARCH, device="cpu").engine.device.type == "cpu"
