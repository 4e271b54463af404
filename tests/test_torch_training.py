"""The port's training route against the JAX package's, on the CPU.

The same weights (drawn by JAX, carried over by ``from_jax``) and the same
numpy batches (``SyntheticTokenPipeline``) go through
``repro.models.model.loss_fn`` under ``jax.value_and_grad`` and through
``repro_torch.training.train_step.value_and_grad``, which differentiates
the port's ``loss_fn`` on its plain route (the JAX package's
``use_pallas=False`` route: no kernel has a backward in either package).
Tolerances, set beforehand: the loss to 1e-5 relative and each gradient
leaf to 1e-4 of that leaf's largest magnitude, in f32 (summation order
only); ``blocked_attention`` at the kernel tolerances of
``tests/test_kernels.py``; ``adamw_update`` on shared numpy grads to
1e-6; ``lr_schedule`` exactly (against the JAX function as written: under
``jit`` XLA turns its divisions by constants into products by their
reciprocals, which moves some rates by an ulp).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp
from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import optimizer as JO
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax
from repro_torch.training import optimizer as TO
from repro_torch.training.data import DataConfig, SyntheticTokenPipeline
from repro_torch.training.train_step import value_and_grad

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py

# family -> (arch, config changes held in both packages)
FAMILIES = {
    "olmo": ("olmo-1b", {}),
    "olmo-blocked": ("olmo-1b", {"attn_impl": "blocked", "attn_block_k": 8}),
    "granite": ("granite-8b", {}),
    "gemma3": ("gemma3-12b", {}),
    "deepseek-moe": ("deepseek-moe-16b", {}),
    "falcon-mamba": ("falcon-mamba-7b", {"scan_chunk": 8}),
    "falcon-mamba-chunk": ("falcon-mamba-7b", {"scan_chunk": 8,
                                               "ssm_fuse": "chunk"}),
    "recurrentgemma": ("recurrentgemma-9b", {"scan_chunk": 8}),
    "whisper": ("whisper-base", {}),
    "phi-3-vision": ("phi-3-vision-4.2b", {}),
}
SEQ = 20                    # ragged against the 8-wide blocks and chunks


def _cfgs(arch, **kw):
    return (jax_smoke(arch).replace(remat=False, **kw),
            get_smoke_config(arch).replace(**kw))


def _params(jcfg):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def _batch(cfg, B=2, S=SEQ, step=0):
    """numpy batch: pipeline tokens and labels (the last 3 labels of row 1
    ignored), random frames or patches where the config reads them."""
    b = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, S, B)).batch_at(step)
    b["labels"][1, -3:] = -1
    rng = np.random.default_rng(step + 7)
    if cfg.is_encoder_decoder:
        b["frames"] = (0.5 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "vision":
        b["patches"] = (cfg.d_model ** -0.5 * rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model))).astype(np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _hold_grads(jg, tg):
    jf, tf = _flat(jg), _flat(tg)
    assert set(jf) == set(tf)
    for path, a in jf.items():
        a = np.asarray(a, np.float32)
        b = tf[path].float().numpy()
        bound = GRAD_TOL * max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= bound, path


# --------------------------------------------------------------------------
# loss and gradients, family by family
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family):
    arch, kw = FAMILIES[family]
    jcfg, tcfg = _cfgs(arch, **F32, **kw)
    jp, tp = _params(jcfg)
    jb, tb = _both(_batch(tcfg))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    (tl, tm), tg = value_and_grad(tcfg, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for key in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if tcfg.num_experts:
        assert float(tm["aux_loss"]) > 0
    assert float(tm["tokens"]) == 2 * SEQ - 3
    _hold_grads(jg, tg)


def test_loss_drops_the_vision_prefix_rows():
    """The patches' rows are cut from the logits before the loss: the
    labels align with the text, and the loss equals the text rows'."""
    _, tcfg = _cfgs("phi-3-vision-4.2b", **F32)
    jcfg = _cfgs("phi-3-vision-4.2b", **F32)[0]
    _, tp = _params(jcfg)
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    total, m = M.loss_fn(tcfg, tp, b)
    logits, _ = M.forward_train(tcfg, tp, b, route="plain")
    text = logits[:, tcfg.num_prefix_tokens:]
    nll = torch.nn.functional.cross_entropy(
        text.reshape(-1, text.shape[-1]), b["labels"].reshape(-1).long(),
        ignore_index=-1)
    torch.testing.assert_close(m["loss"], nll, rtol=1e-6, atol=0)
    torch.testing.assert_close(total, m["loss"], rtol=0, atol=0)


def test_plain_route_matches_kernels_route_on_the_cpu():
    """On the CPU the kernels route runs the kernels' plain versions: the
    two routes' logits agree, and an unknown route is refused."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b", **F32)
    _, tp = _params(jcfg)
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    plain, _ = M.forward_train(tcfg, tp, b, route="plain")
    kernels, _ = M.forward_train(tcfg, tp, b, route="kernels")
    torch.testing.assert_close(plain, kernels, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="route"):
        M.forward_train(tcfg, tp, b, route="fused")


# --------------------------------------------------------------------------
# remat: the same numbers with and without it
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmo-1b", "falcon-mamba-7b",
                                  "deepseek-moe-16b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_number(arch, policy):
    jcfg, tcfg = _cfgs(arch, **F32)
    _, tp = _params(jcfg)
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    (l0, _), g0 = value_and_grad(tcfg.replace(remat=False), tp, b)
    (l1, _), g1 = value_and_grad(
        tcfg.replace(remat=True, remat_policy=policy), tp, b)
    assert float(l0) == float(l1)
    f0, f1 = _flat(g0), _flat(g1)
    assert set(f0) == set(f1)
    for path in f0:
        torch.testing.assert_close(f1[path], f0[path], rtol=0, atol=0,
                                   msg=path)


def test_remat_recomputes_the_layer():
    """With remat each repeat's forward runs again in the backward: the
    layer function is entered twice per repeat."""
    jcfg, tcfg = _cfgs("olmo-1b", **F32)
    _, tp = _params(jcfg)
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    calls = []
    real = M.apply_layer

    def counting(*a, **k):
        calls.append(k["mode"])
        return real(*a, **k)
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        M.apply_layer = counting
        try:
            value_and_grad(tcfg.replace(remat=remat), tp, b)
        finally:
            M.apply_layer = real
        assert len(calls) == want * tcfg.num_layers // 2


# --------------------------------------------------------------------------
# blocked attention and the fused scan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,hd,causal,window,block", [
    (2, 40, 4, 2, 16, True, 0, 16),          # ragged last blocks
    (1, 64, 4, 4, 32, True, 0, 16),
    (2, 48, 4, 1, 16, True, 12, 8),          # window skips far blocks
    (1, 33, 2, 2, 16, False, 0, 8),          # non-causal: every pair
])
def test_blocked_attention_matches_jax(B, S, H, KH, hd, causal, window,
                                       block, dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)))
    jdt = jnp.dtype(dtype)
    ref = JL.blocked_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
        window=window, block_q=block, block_k=block)
    tdt = getattr(torch, dtype)
    out = L.blocked_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, block_q=block, block_k=block)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOLS[dtype], rtol=TOLS[dtype])
    chunked = L.chunked_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, block_k=block)
    torch.testing.assert_close(out.float(), chunked.float(),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def test_fused_selective_scan_matches_jax():
    """The fused chunked scan and its last state, from a given state, in
    f32, against the JAX package's (ragged last chunk)."""
    _, tcfg = _cfgs("falcon-mamba-7b", **F32, scan_chunk=8)
    jcfg = jax_smoke("falcon-mamba-7b").replace(scan_chunk=8, **F32)
    rng = np.random.default_rng(4)
    B, S, di, N = 2, 21, tcfg.d_inner, tcfg.ssm_state
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    A_log = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1)))
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    jy, jh = JL.fused_selective_scan(jcfg, *map(jnp.asarray, (
        x, dt, Bm, Cm, A_log, D)), h0=jnp.asarray(h0))
    ty, th = L.fused_selective_scan(tcfg, *map(torch.from_numpy, (
        x, dt, Bm, Cm, A_log, D)), h0=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 100, 1000),
                                             (1e-3, 7, 50), (3e-4, 1, 6),
                                             (3e-4, 5, 50)])
def test_lr_schedule_matches_jax_exactly(lr, warmup, total):
    jhp = JO.HParams(lr=lr, warmup_steps=warmup, total_steps=total)
    thp = TO.HParams(lr=lr, warmup_steps=warmup, total_steps=total)
    for s in range(total + 20):
        want = np.float32(JO.lr_schedule(jhp, jnp.int32(s)))
        got = TO.lr_schedule(thp, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy() == want, s


def _opt_tree(rng):
    """A small params tree: bf16 and f32 leaves, a list of stages, an
    empty subtree (a non-parametric norm's)."""
    return {"embed": rng.standard_normal((8, 4)).astype(np.float32),
            "final_norm": {},
            "stages": [{"b0": {"w": rng.standard_normal((3, 4, 4)),
                               "scale": np.ones((3, 4))}}],
            "lm_head": rng.standard_normal((4, 8))}


def test_adamw_update_matches_jax():
    """Three steps on shared numpy grads (bf16 params, f32 master): the
    state, the grad norm and the rate to 1e-6, the new params within one
    bf16 rounding; the grads clip on the first step and not on the
    last."""
    rng = np.random.default_rng(6)
    tree = _opt_tree(rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tp = from_jax(jax.tree.map(np.asarray, jp))
    hp = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jopt, topt = JO.adamw_init(jp), TO.adamw_init(tp)
    norms = []
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * (10.0 if i == 0 else 0.03)
                                    ).astype(np.float32), tree)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
        tg = from_jax(jax.tree.map(np.asarray, jg))
        jp, jopt, jmet = JO.adamw_update(jp, jg, jopt, JO.HParams(**hp))
        tp, topt, tmet = TO.adamw_update(tp, tg, topt, TO.HParams(**hp))
        assert int(topt["step"]) == int(jopt["step"]) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-6)
        for part in ("master", "m", "v"):
            jf, tf = _flat(jopt[part]), _flat(topt[part])
            assert set(jf) == set(tf)
            for path, a in jf.items():
                np.testing.assert_allclose(tf[path].numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-12)
        jf, tf = _flat(jp), _flat(tp)
        for path, a in jf.items():
            assert tf[path].dtype == torch.bfloat16
            np.testing.assert_allclose(tf[path].float().numpy(),
                                       np.asarray(a, np.float32),
                                       rtol=2 ** -8, atol=0)
        norms.append(float(jmet["grad_norm"]))
    assert norms[0] > 1.0 > norms[-1]       # clipped, then not


# --------------------------------------------------------------------------
# the kernels refuse autograd (on the card; the helper is device-free)
# --------------------------------------------------------------------------
def test_refuse_grad_names_the_kernel():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        _build.refuse_grad("flash_attention", torch.ones(3), x)
    with torch.no_grad():
        _build.refuse_grad("flash_attention", x)
    _build.refuse_grad("flash_attention", torch.ones(3), None)


def test_serving_entry_points_compute_without_grad():
    """Params that require grad do not put the serving paths under
    autograd: the engine, the embed step and the model's serving entry
    points run under ``torch.no_grad()``."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.steps import make_embed_step
    jcfg, tcfg = _cfgs("olmo-1b", **F32)
    _, tp = _params(jcfg)
    live = TO.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    eng = ServingEngine(tcfg, n_slots=2, max_context=64, device="cpu",
                        params=live)
    assert len(eng.generate([1, 2, 3], max_new_tokens=3)) == 3
    assert eng.embed_batch([[1, 2], [3]]).shape == (2, tcfg.d_model)
    toks = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    emb = make_embed_step(tcfg)(live, {"tokens": toks})
    logits, cache, pos = M.prefill(tcfg, live, {"tokens": toks}, 8)
    step, _ = M.decode_step(tcfg, live, toks[:, :1], cache, pos)
    assert not any(t.requires_grad for t in (emb, logits, step))
    # the training forward does build a graph on the same params
    assert M.loss_fn(tcfg, live, {"tokens": toks.long(),
                                  "labels": toks.long()})[0].requires_grad
