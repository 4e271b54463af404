"""The port's Griffin path (recurrentgemma-9b: RG-LRU blocks and local
attention with one KV head) against the JAX package's, on identical
weights, on the CPU.

JAX draws the weights of the smoke config (3 layers ``rec, rec, local``,
d=64, 4 heads over 1 KV head of 16, window 8, 4 gate blocks);
``repro_torch.params.from_jax`` carries them over bit for bit.  The same
numpy inputs go through both packages.  The JAX side runs ``rg_lru`` and
``flash_attention`` as Pallas in interpret mode (``use_pallas=True``).
Prompts are longer than the window of 8, so prefill, chunked prefill and
decode all mask by it.  Tolerances:
- the plain ``rg_lru`` against the JAX kernel: 5x the kernel tolerances
  of ``tests/test_kernels.py`` (1e-4 f32, 0.1 bf16), as its rg_lru test
  uses;
- the RG-LRU core and block: 1e-4 in f32 (summation order);
- the stack: ``tests/test_torch_model.py``'s 1e-4 f32 and 6e-2 bf16;
- generation in f32: token ids equal; embeddings within 1e-4.
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
from repro.core.provider import LocalJaxProvider
from repro.core.resources import ModelResource as JaxModelResource
from repro.kernels.rg_lru.ops import rg_lru as jax_rg_lru
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.steps import make_embed_step as jax_embed_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import LocalTorchProvider, ModelResource
from repro_torch.kernels.rg_lru import ops as rglru_ops
from repro_torch.kernels.rg_lru.ref import rg_lru_ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.steps import make_embed_step

ARCH = "recurrentgemma-9b"
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
LRU_TOL = {"float32": 5 * 2e-5, "bfloat16": 5 * 2e-2}
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _cfgs(dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (jax_smoke(ARCH).replace(remat=False, **kw),
            get_smoke_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) per dtype, drawn once."""
    out = {}
    for dtype in TOL:
        jcfg, _ = _cfgs(dtype)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        out[dtype] = jp, from_jax(jax.tree.map(np.asarray, jp))
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


def _rec_leaves(cache):
    """The RG-LRU state leaves of a cache (conv and h of each rec layer)."""
    return [t for stage in cache for block in stage.values()
            for t in block.get("rec", {}).values()]


# --------------------------------------------------------------------------
# config, weights, cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    j = jax_smoke(ARCH) if smoke else jax_get_config(ARCH)
    t = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    for f in t.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    assert t.stages() == j.stages()
    assert t.num_params() == j.num_params()
    if not smoke:
        assert t.num_params() == 8_577_884_160
        assert t.stages() == ((("rec", "rec", "local"), 12),
                              (("rec", "rec"), 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
    # embed, final norm; per rec layer 2 norms, 10 RG-LRU and 3 FFN
    # leaves; the local layer 2 norms, 4 attention and 3 FFN leaves
    assert n == 2 + 2 * 15 + 9


def test_init_params_match_jax_shapes_and_constants(weights):
    jp, _ = weights["bfloat16"]
    _, cfg = _cfgs("bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
    jr, tr = jp["stages"][0]["b0"]["rec"], tp["stages"][0]["b0"]["rec"]
    for name in ("lam", "rg_a_b", "rg_x_b", "conv_b"):
        np.testing.assert_array_equal(tr[name].float().numpy(),
                                      np.asarray(jr[name], np.float32))
    bs = cfg.d_inner // cfg.rglru_blocks
    std = tr["rg_a"].float().std().item()
    assert abs(std - bs ** -0.5) < 0.15 * bs ** -0.5


def test_cache_matches_jax_structure():
    jcfg, tcfg = _cfgs("bfloat16")
    jc = JM.init_cache(jcfg, 3, 16)
    tc = M.init_cache(tcfg, 3, 16)
    for path, a, b in _tree_pairs(jc, tc):
        assert tuple(b.shape) == np.asarray(a).shape, path
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path
    assert tuple(tc[0]["b0"]["rec"]["h"].shape) == (1, 3, tcfg.d_inner)


def test_reset_recurrent_rows_zeroes_rec_state_only():
    _, tcfg = _cfgs("float32")
    cache = M.init_cache(tcfg, 3, 16)
    for t in _leaves(cache):
        t.normal_()
    kv = [t.clone() for stage in cache for block in stage.values()
          for t in block.get("attn", {}).values()]
    M.reset_recurrent_rows(tcfg, cache, 1)
    rec = _rec_leaves(cache)
    assert len(rec) == 4
    for t in rec:
        assert not t[:, 1].any()
        assert t[:, 0].abs().sum() > 0 and t[:, 2].abs().sum() > 0
    after = [t for stage in cache for block in stage.values()
             for t in block.get("attn", {}).values()]
    for a, b in zip(kv, after):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the recurrence and the block
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,di,chunk,bd",
                         [(2, 80, 48, 16, 16), (1, 200, 32, 64, 32)])
def test_rg_lru_plain_matches_jax_kernel(B, S, di, chunk, bd, dtype):
    """The inputs of ``tests/test_kernels.py``'s rg_lru case."""
    rng = np.random.default_rng(0)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    a = rng.uniform(0.5, 0.999, (B, S, di)).astype(np.float32)
    b = rng.standard_normal((B, S, di)).astype(np.float32)
    ref = jax_rg_lru(jnp.asarray(a, jdt), jnp.asarray(b, jdt), chunk=chunk,
                     block_d=bd, interpret=True)
    ta, tb = (torch.from_numpy(x).to(tdt) for x in (a, b))
    before = rglru_ops.rg_lru.launches
    out = rglru_ops.rg_lru(ta, tb)
    assert rglru_ops.rg_lru.launches == before      # CPU: plain path
    assert out.dtype == tdt and out.shape == (B, S, di)
    _close(out, ref, LRU_TOL[dtype])
    torch.testing.assert_close(rg_lru_ref(ta, tb), out, rtol=0, atol=0)


def test_rg_lru_raises_off_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain path."""
    a = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rglru_ops.rg_lru(a, a)


def _rec_params(weights):
    jp, tp = weights["float32"]
    return (jax.tree.map(lambda x: x[0], jp["stages"][0]["b0"]["rec"]),
            {k: v[0] for k, v in tp["stages"][0]["b0"]["rec"].items()})


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_core_matches_jax(weights, with_state):
    """Without a state, the JAX core runs its Pallas kernel and the port
    ``rg_lru``; with one, both run the stateful scan."""
    jcfg, tcfg = _cfgs("float32")
    jr, tr = _rec_params(weights)
    rng = np.random.default_rng(1)
    x_c = rng.standard_normal((2, 19, tcfg.d_inner)).astype(np.float32)
    h0 = rng.standard_normal((2, tcfg.d_inner)).astype(np.float32)
    jh, jl = JL._rglru_core(jcfg.replace(use_pallas=True), jr,
                            jnp.asarray(x_c),
                            jnp.asarray(h0) if with_state else None,
                            return_state=with_state)
    th, tl = L._rglru_core(tcfg, tr, torch.from_numpy(x_c),
                           torch.from_numpy(h0) if with_state else None,
                           return_state=with_state)
    assert th.dtype == torch.float32 and th.shape == x_c.shape
    _close(th, jh, TOL["float32"])
    if with_state:
        _close(tl, jl, TOL["float32"])
    else:
        assert tl is None and jl is None


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_rglru_block_matches_jax(weights, mode):
    jcfg, tcfg = _cfgs("float32")
    jr, tr = _rec_params(weights)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    if mode == "train":
        jy = JL.rglru_apply_train(jcfg.replace(use_pallas=True), jr,
                                  jnp.asarray(x), JL.NULL_POLICY)
        ty = L.rglru_apply_train(tcfg, tr, torch.from_numpy(x))
        _close(ty, jy, TOL["float32"])
        return
    conv = rng.standard_normal((2, tcfg.conv_width - 1,
                                tcfg.d_inner)).astype(np.float32)
    h = rng.standard_normal((2, tcfg.d_inner)).astype(np.float32)
    jy, jc = JL.rglru_apply_decode(jcfg, jr, jnp.asarray(x),
                                   {"conv": jnp.asarray(conv),
                                    "h": jnp.asarray(h)}, JL.NULL_POLICY)
    tc = {"conv": torch.from_numpy(conv.copy()),
          "h": torch.from_numpy(h.copy())}
    leaves = list(tc.values())
    ty, tc2 = L.rglru_apply_decode(tcfg, tr, torch.from_numpy(x), tc)
    # the state is written in place into the cache given
    assert all(a is b for a, b in zip(tc2.values(), leaves))
    _close(ty, jy, TOL["float32"])
    for k in ("conv", "h"):
        _close(tc2[k], jc[k], TOL["float32"])


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax_pallas(weights, dtype):
    """The full-sequence forward, whose recurrence is ``rg_lru`` and whose
    local attention is ``flash_attention``, against the JAX forward on its
    Pallas kernels."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    toks = np.random.default_rng(3).integers(0, 256, (2, 20)).astype(
        np.int32)
    ref, _ = JM.forward_train(jcfg.replace(use_pallas=True), jp,
                              {"tokens": jnp.asarray(toks)})
    out, aux = M.forward_train(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32 and out.shape == (2, 20, 256)
    assert float(aux) == 0.0
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(weights, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    toks = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(
        np.int32)
    jl, jc, jn = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc, tn = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 32)
    assert tn == jn == 12
    _close(tl, jl, TOL[dtype])
    for path, a, b in _tree_pairs(jc, tc):
        _close(b, a, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunks_and_decode_match_jax(weights, dtype):
    """A prefill_chunk chain (scalar and per-row offsets), then decode
    steps past the window: logits, the KV cache and the conv/h state agree
    with JAX."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
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
    for step in range(3):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos + step))
        tl, tc = M.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                               torch.from_numpy(pos + step))
        _close(tl, jl, TOL[dtype])
    for path, a, b in _tree_pairs(jc, tc):
        _close(b, a, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_step_matches_jax_pallas(weights, dtype):
    """The embed step (full-sequence stack, -1 padding, mean pool) against
    the JAX step on its Pallas kernels."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = weights[dtype]
    toks = np.full((3, 32), -1, np.int32)
    rng = np.random.default_rng(6)
    for i, n in enumerate((5, 32, 17)):
        toks[i, :n] = rng.integers(0, 256, n)
    ref = jax_embed_step(jcfg.replace(use_pallas=True))(
        jp, {"tokens": jnp.asarray(toks)})
    out = make_embed_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32 and out.shape == (3, tcfg.d_model)
    _close(out, ref, TOL[dtype])


# --------------------------------------------------------------------------
# serving: the engine against the JAX one-request oracle
# --------------------------------------------------------------------------
def _jax_oracle(cfg, params, prompt, n_new, cache_len=64):
    """``tests/test_serving.py``'s oracle: one prefill, then decode."""
    lg, cache, pos = JM.prefill(cfg, params,
                                {"tokens": jnp.asarray([prompt], jnp.int32)},
                                cache_len)
    toks = [int(jnp.argmax(lg[0, -1]))]
    for i in range(n_new - 1):
        lg, cache = JM.decode_step(cfg, params,
                                   jnp.asarray([[toks[-1]]], jnp.int32),
                                   cache, jnp.int32(pos + i))
        toks.append(int(jnp.argmax(lg[0, 0])))
    return toks


@pytest.fixture(scope="module")
def served(weights):
    """The f32 smoke config in both packages and the oracle's answers for
    three prompts (21, 13 and 4 tokens, 5 new tokens each: the first two
    are longer than the window).  The short one is the most sensitive to
    a state left over in its slot."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = weights["float32"]
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (21, 13, 4)]
    want = [_jax_oracle(jcfg, jp, p, 5) for p in prompts]
    return jcfg, tcfg, jp, tp, prompts, want


def _engine(tcfg, tp, n_slots=2):
    return ServingEngine(tcfg, n_slots=n_slots, max_context=64, chunk=8,
                         device="cpu", params=tp)


def test_generate_matches_jax_oracle_and_engine(served):
    jcfg, tcfg, jp, tp, prompts, want = served
    assert _engine(tcfg, tp).generate(prompts[0], 5) == want[0]
    # a fresh JAX engine serves its first request from a zero state
    je = JaxEngine(jcfg, n_slots=2, max_context=64, chunk=8)
    je.params = jp
    assert je.generate(prompts[0], 5) == want[0]


def test_reused_slot_matches_oracle(served):
    """With one slot, every request after the first reuses it: each must
    still get the one-request oracle's tokens (the "rec" state of the
    slot is zeroed on admission)."""
    _, tcfg, _, tp, prompts, want = served
    eng = _engine(tcfg, tp, n_slots=1)
    assert eng.generate(prompts[0], 5) == want[0]
    # the slot holds the first request's state until the next admission
    assert all(t.abs().max() > 0.1 for t in _rec_leaves(eng.cache))
    assert eng.generate(prompts[2], 5) == want[2]
    # and ends in the state of the same request served alone
    alone = _engine(tcfg, tp, n_slots=1)
    alone.generate(prompts[2], 5)
    for a, b in zip(_rec_leaves(eng.cache), _rec_leaves(alone.cache)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    reqs = [eng.submit(p, 5) for p in prompts]
    eng.run_until_idle()
    assert [r.generated for r in reqs] == want


def test_concurrent_requests_match_solo(served):
    """Requests in flight together each get the tokens of their solo run
    (more requests than slots, so a freed slot is reused)."""
    _, tcfg, _, tp, prompts, want = served
    eng = _engine(tcfg, tp, n_slots=2)
    reqs = [eng.submit(p, 5) for p in prompts]
    eng.run_until_idle()
    assert [r.generated for r in reqs] == want
    assert reqs[2].slot in (reqs[0].slot, reqs[1].slot)


def test_prefill_chunk_leaves_other_slots_untouched(served):
    """A prefill chunk writes the working slot's cache rows in place and
    no other slot's."""
    _, tcfg, _, tp, prompts, _ = served
    eng = _engine(tcfg, tp, n_slots=3)
    eng.generate(prompts[1], 3)          # leaves state in the first slot
    for t in _leaves(eng.cache):          # and marks the others
        t[:, 1:].normal_()
    before = [t.clone() for t in _leaves(eng.cache)]
    eng.submit(list(range(20)), 2)
    eng.step()                            # admission + one prefill chunk
    slot = next(i for i, r in enumerate(eng.active) if r is not None)
    others = [i for i in range(eng.n_slots) if i != slot]
    for b, a in zip(before, _leaves(eng.cache)):
        torch.testing.assert_close(a[:, others], b[:, others], rtol=0,
                                   atol=0)
        assert not torch.equal(a[:, slot], b[:, slot])


def test_embed_batch_matches_jax(served):
    jcfg, tcfg, jp, tp, _, _ = served
    je = JaxEngine(jcfg, n_slots=2, max_context=64, chunk=8)
    je.params = jp
    lists = [[1, 2, 3, 4], [5, 6, 7], list(range(40))]     # bucket 64
    out = _engine(tcfg, tp).embed_batch(lists)
    np.testing.assert_allclose(out, je.embed_batch(lists), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


# --------------------------------------------------------------------------
# providers
# --------------------------------------------------------------------------
def test_provider_embed_matches_jax(weights):
    """``LocalTorchProvider.embed`` against ``LocalJaxProvider.embed`` on
    the f32 smoke weights."""
    jp = weights["float32"][0]
    jprov = LocalJaxProvider(ARCH)
    jprov.engine = JaxEngine(jax_smoke(ARCH).replace(remat=False, **F32),
                             max_context=2048)
    jprov.engine.params = jp
    tprov = LocalTorchProvider(ARCH, device="cpu")
    tprov.engine = ServingEngine(
        get_smoke_config(ARCH).replace(**F32), max_context=2048,
        device="cpu", params=from_jax(jax.tree.map(np.asarray, jp)))
    texts = ["gated linear recurrences", "local attention", "x" * 70]
    kw = dict(name="e", version=1, arch=ARCH)
    out = tprov.embed(ModelResource(**kw), texts)
    ref = jprov.embed(JaxModelResource(**kw), texts)
    assert out.shape == (3, 64)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
