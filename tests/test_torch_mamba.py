"""The port's Mamba-1 path (falcon-mamba-7b) against the JAX package's, on
identical weights, on the CPU.

JAX draws the weights; ``repro_torch.params.from_jax`` carries them over
bit for bit.  The same numpy inputs go through both packages.  The JAX
selective-scan kernel runs as Pallas in interpret mode.  Tolerances:
- the plain ``ssm_scan`` against the JAX kernel: 5x the kernel tolerances
  of ``tests/test_kernels.py`` (1e-4 f32, 0.1 bf16), as its ssm test uses;
- ``causal_conv`` and ``linear_scan``: 2e-5 (f32 summation order);
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
from repro.core.metaprompt import build_metaprompt as jax_build_metaprompt
from repro.core.provider import LocalJaxProvider
from repro.core.resources import ModelResource as JaxModelResource
from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.steps import make_embed_step as jax_embed_step
from repro.training.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (LocalTorchProvider, ModelResource,
                              build_metaprompt)
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params, load_checkpoint
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.steps import make_embed_step

ARCH = "falcon-mamba-7b"
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
SCAN_TOL = {"float32": 5 * 2e-5, "bfloat16": 5 * 2e-2}
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


# --------------------------------------------------------------------------
# config and weights
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
        assert t.num_params() == 7_271_350_272


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
    assert n == 4 + 9     # embed, lm_head, two norm scales; 9 Mamba leaves


def test_init_params_match_jax_shapes_and_constants(weights):
    jp, _ = weights["bfloat16"]
    _, cfg = _cfgs("bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
    jm, tm = jp["stages"][0]["b0"]["mamba"], tp["stages"][0]["b0"]["mamba"]
    for name in ("dt_bias", "D", "conv_b"):
        np.testing.assert_array_equal(tm[name].float().numpy(),
                                      np.asarray(jm[name], np.float32))
    np.testing.assert_allclose(tm["A_log"].numpy(), np.asarray(jm["A_log"]),
                               rtol=1e-7, atol=0)
    std = tm["in_proj"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_checkpoint_reader_carries_f32_leaves(weights, tmp_path):
    jp, tp = weights["bfloat16"]
    CheckpointManager(str(tmp_path)).save(1, {"params": jp, "step": 1})
    loaded = load_checkpoint(tmp_path / "step_0000000001.npz")["params"]
    want = {p: a for p, a, _ in _tree_pairs(tp, tp)}
    got = {p: b for p, b, _ in _tree_pairs(loaded, loaded)}
    assert set(got) == set(want)
    for p, a in want.items():
        assert a.dtype == got[p].dtype, p
        torch.testing.assert_close(a, got[p], rtol=0, atol=0)
    assert got["/stages/0/b0/mamba/A_log"].dtype == torch.float32


def test_cache_matches_jax_structure():
    jcfg, tcfg = _cfgs("bfloat16")
    jc = JM.init_cache(jcfg, 3, 16)
    tc = M.init_cache(tcfg, 3, 16)
    for path, a, b in _tree_pairs(jc, tc):
        assert tuple(b.shape) == np.asarray(a).shape, path
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path


# --------------------------------------------------------------------------
# the selective scan and the layer primitives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,di,N,chunk,bd",
                         [(2, 80, 48, 8, 16, 16),
                          (1, 128, 64, 16, 32, 64),
                          (2, 33, 24, 4, 16, 8)])
def test_ssm_scan_plain_matches_jax_kernel(B, S, di, N, chunk, bd, dtype):
    """The inputs of ``tests/test_kernels.py``'s ssm case."""
    rng = np.random.default_rng(0)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, di))) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    Al = np.log(np.abs(rng.standard_normal((di, N))) + 0.5).astype(
        np.float32)
    D = rng.standard_normal((di,)).astype(np.float32)
    ref = jax_ssm_scan(*(jnp.asarray(a, jdt) for a in (x, dt, Bm, Cm)),
                       jnp.asarray(Al), jnp.asarray(D), chunk=chunk,
                       block_d=bd, interpret=True)
    args = [torch.from_numpy(a).to(tdt) for a in (x, dt, Bm, Cm)]
    before = ssm_ops.ssm_scan.launches
    out = ssm_ops.ssm_scan(*args, torch.from_numpy(Al), torch.from_numpy(D))
    assert ssm_ops.ssm_scan.launches == before      # CPU: plain path
    assert out.dtype == tdt and out.shape == (B, S, di)
    _close(out, ref, SCAN_TOL[dtype])
    torch.testing.assert_close(
        ssm_scan_ref(*args, torch.from_numpy(Al), torch.from_numpy(D)), out,
        rtol=0, atol=0)


def test_ssm_scan_raises_off_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain path."""
    x = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ssm_ops.ssm_scan(x, x, x[..., :4], x[..., :4],
                         torch.empty((16, 4), device="meta"),
                         torch.empty((16,), device="meta"))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jy, js = JL.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            jnp.asarray(st) if with_state else None)
    ty, ts = L.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b),
                           torch.from_numpy(st) if with_state else None)
    _close(ty, jy, 2e-5)
    _close(ts, js, 2e-5)


@pytest.mark.parametrize("S,chunk,with_h0", [(37, 8, False), (37, 8, True),
                                             (16, 64, True), (1, 4, True)])
def test_linear_scan_matches_jax(S, chunk, with_h0):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 0.999, (2, S, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, S, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jh, jl = JL.linear_scan(jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(h0) if with_h0 else None,
                            chunk=chunk)
    th, tl = L.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(h0) if with_h0 else None,
                           chunk=chunk)
    assert th.shape == (2, S, 6, 4)
    _close(th, jh, 2e-5)
    _close(tl, jl, 2e-5)


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax_pallas(weights, dtype):
    """The full-sequence forward, whose scan is ``ssm_scan``, against the
    JAX forward on its Pallas selective-scan kernel."""
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
    steps: logits and the conv/ssm state agree with JAX."""
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
        # the state is written in place into the cache given
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
    the JAX step on its Pallas selective-scan kernel."""
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
    three prompts (21, 13 and 4 tokens, 5 new tokens each).  The short
    one is the most sensitive to a state left over in its slot."""
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
    still get the one-request oracle's tokens."""
    _, tcfg, _, tp, prompts, want = served
    eng = _engine(tcfg, tp, n_slots=1)
    assert eng.generate(prompts[0], 5) == want[0]
    # the slot holds the first request's state until the next admission
    assert all(t.abs().max() > 0.1 for t in _leaves(eng.cache))
    assert eng.generate(prompts[2], 5) == want[2]
    # and ends in the state of the same request served alone
    alone = _engine(tcfg, tp, n_slots=1)
    alone.generate(prompts[2], 5)
    for a, b in zip(_leaves(eng.cache), _leaves(alone.cache)):
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
    """A prefill chunk writes the working slot's conv/ssm rows in place
    and no other slot's."""
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
def _providers(jp):
    """LocalJaxProvider and LocalTorchProvider on the f32 smoke weights;
    the JAX provider's engine is fresh, so its request starts from a zero
    state."""
    jprov = LocalJaxProvider(ARCH)
    jprov.engine = JaxEngine(jax_smoke(ARCH).replace(remat=False, **F32),
                             max_context=2048)
    jprov.engine.params = jp
    tprov = LocalTorchProvider(ARCH, device="cpu")
    tprov.engine = ServingEngine(
        get_smoke_config(ARCH).replace(**F32), max_context=2048,
        device="cpu", params=from_jax(jax.tree.map(np.asarray, jp)))
    return jprov, tprov


@pytest.fixture(scope="module")
def torch_provider(weights):
    """One port provider for every case: its engine is reused across
    requests, as a query's calls reuse it."""
    return _providers(weights["float32"][0])[1]


@pytest.mark.parametrize("function,n_rows", [("complete", 2), ("filter", 1),
                                             ("reduce", 3)])
def test_provider_complete_matches_jax(weights, torch_provider, function,
                                       n_rows):
    jprov, _ = _providers(weights["float32"][0])
    tprov = torch_provider
    assert tprov.engine.cfg.vocab_size == 256
    rows = [{"title": f"paper {i}", "abstract": "ssm " * (i + 1)}
            for i in range(n_rows)]
    kw = dict(name="m", version=1, arch=ARCH, max_output_tokens=4)
    out = tprov.complete(ModelResource(**kw),
                         build_metaprompt(function, "is it about scans?",
                                          rows), n_rows)
    ref = jprov.complete(JaxModelResource(**kw),
                         jax_build_metaprompt(function, "is it about scans?",
                                              rows), n_rows)
    assert out == ref
    assert len(out) == (n_rows if function != "reduce" else 1)


def test_provider_embed_matches_jax(weights, torch_provider):
    jprov, _ = _providers(weights["float32"][0])
    texts = ["selective scans", "state space models", "x" * 70]
    kw = dict(name="e", version=1, arch=ARCH)
    out = torch_provider.embed(ModelResource(**kw), texts)
    ref = jprov.embed(JaxModelResource(**kw), texts)
    assert out.shape == (3, 64)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_provider_full_config_vocab_and_context():
    """The full config's vocabulary (65,024) takes every byte token, and
    the provider's context limit is its engine's."""
    cfg = get_config(ARCH)
    assert cfg.vocab_size == cfg.padded_vocab == 65_024
    toks = LocalTorchProvider._tokenize("Mamba éè ☃", cfg.vocab_size)
    assert toks == list("Mamba éè ☃".encode())
    assert max(toks) < 256
    prov = LocalTorchProvider(ARCH, device="cpu", max_context=96)
    assert prov.engine.max_context == 96 and prov.engine.cfg.name == \
        "falcon-mamba-smoke"
    r = prov.engine.submit(list(range(90)), max_new_tokens=10)
    prov.engine.run_until_idle()
    assert r.finished and r.generated == []          # does not fit: refused
