"""The port's MoE FFN and the MoE decoders (deepseek-moe-16b,
mixtral-8x7b) against the JAX package's, on identical weights, on the CPU.

Three configurations: the deepseek-moe-16b smoke config (8 experts top-2
plus one shared expert), the mixtral-8x7b smoke config (8 experts top-2,
no shared expert, sliding window of 8 over 2 KV heads) and the deepseek
smoke config widened to the full model's routing, 64 experts top-6, so
that a group of 16 or 32 tokens drops assignments.  JAX draws the weights;
``repro_torch.params.from_jax`` carries them over bit for bit, and the
same numpy inputs go through both packages.  The JAX forward runs flash
attention as Pallas in interpret mode (``use_pallas=True``).

Tolerances (``ROADMAP.md``): the MoE layer 2e-5 in f32 and 2e-2 in bf16
(``tests/test_kernels.py``'s ``TOLS``), the router loss 1e-5, logits 1e-4
in f32 (summation order only, as ``tests/test_torch_dense.py``) and 6e-2
in bf16, embeddings 1e-4 in f32, generated tokens equal in f32.

The engines are compared at the same ``chunk``: capacity follows the
dispatch group's length, so a prefill chunk may drop assignments that
the 4-token decode group never drops, and the JAX engine's tokens follow
``chunk`` (``ROADMAP.md`` C.12).  An embed row is a group whose length is
the batch's bucket, so a text's embedding follows its batch-mates
(C.14).  Both are the reference's behaviour, recorded here and copied.
"""

import contextlib
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import (NOT_YET_PORTED, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ServingEngine

WIDE = dict(num_experts=64, top_k=6)          # deepseek-moe-16b's routing
CASES = ("deepseek", "mixtral", "deepseek64")
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
AUX_TOL = 1e-5
# the full configs' analytic counts (the JAX formula)
NUM_PARAMS = {"deepseek-moe-16b": 16_879_452_160,
              "mixtral-8x7b": 46_702_526_464}
ACTIVE_PARAMS = {"deepseek-moe-16b": 2_830_630_912,
                 "mixtral-8x7b": 12_879_659_008}
GROUP_SIZES = (1, 4, 8, 32, 128, 2048)
# the 20-token prompt of the chunk records (ROADMAP.md C.12)
PROMPT = [int(t) for t in np.random.default_rng(0).integers(0, 250, 20)]


def _arch(case):
    return "mixtral-8x7b" if case == "mixtral" else "deepseek-moe-16b"


def _cfgs(case, dtype):
    arch = _arch(case)
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    if case == "deepseek64":
        kw.update(WIDE)
    return (jax_smoke(arch).replace(remat=False, **kw),
            get_smoke_config(arch).replace(remat=False, **kw))


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) per (case, dtype), drawn once; the JAX
    draw of ``PRNGKey(0)`` is the JAX engine's ``seed=0``."""
    out = {}
    for case in CASES:
        for dtype in TOLS:
            jcfg, _ = _cfgs(case, dtype)
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            out[case, dtype] = jp, from_jax(jax.tree.map(np.asarray, jp))
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


def _layer_moe(weights, case, dtype, layer=0):
    """Layer ``layer``'s MoE weights in both packages."""
    jp, tp = weights[case, dtype]
    jm = jax.tree.map(lambda a: a[layer], jp["stages"][0]["b0"]["moe"])
    return jm, M._index(tp["stages"][0]["b0"]["moe"], layer)


def _inputs(seed, shape, dtype):
    """The same values in both packages: (jax array, torch tensor)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return xj, xt


def _groups(x):
    """The dispatch groups of the JAX package under ``NULL_POLICY``: batch
    rows, or one group of the batch for a decode step."""
    B, S, d = x.shape
    return x.reshape(1, B, d) if S == 1 and B > 1 else x


def _jax_dropped(jcfg, jm, xj):
    """Assignments each group drops under the JAX package's own routing
    (its router product, softmax and ``lax.top_k``): an expert keeps its
    first C takers."""
    xg = _groups(xj)
    C = jcfg.moe_capacity(xg.shape[1])
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", xg.astype(jnp.float32),
                                      jm["router"]), axis=-1)
    _, eidx = jax.lax.top_k(probs, jcfg.top_k)
    counts = np.asarray(jax.nn.one_hot(eidx.reshape(xg.shape[0], -1),
                                       jcfg.num_experts).sum(axis=1))
    return np.maximum(counts - C, 0).sum(axis=-1).astype(int).tolist()


def _oracle(cfg, p, x):
    """The MoE layer token by token in float64, written from its
    definition: per group, each (token, choice) in token-major order takes
    a slot of its expert while the expert has fewer than C takers, and a
    token's output is the gate-weighted sum of its kept experts' FFNs plus
    the shared FFN.  Returns (y (B, S, d), dropped per group)."""
    def f64(t):
        return t.double().numpy()

    def ffn(w1, w3, w2, v):
        u = v @ w1
        h = (u / (1 + np.exp(-u)) if cfg.act == "silu"
             else 0.5 * u * (1 + np.tanh(np.sqrt(2 / np.pi)
                                         * (u + 0.044715 * u ** 3))))
        if cfg.glu:
            h = h * (v @ w3)
        return h @ w2

    xg = _groups(f64(x))
    G, T, d = xg.shape
    E, K, C = cfg.num_experts, cfg.top_k, cfg.moe_capacity(T)
    router = f64(p["router"])
    w1, w2 = f64(p["w1"]), f64(p["w2"])
    w3 = f64(p["w3"]) if cfg.glu else [None] * E
    y = np.zeros_like(xg)
    dropped = []
    for g in range(G):
        logits = xg[g] @ router
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        takers = np.zeros(E, int)
        for t in range(T):
            top = np.argsort(-probs[t], kind="stable")[:K]
            gates = probs[t, top] / max(probs[t, top].sum(), 1e-9)
            for e, gate in zip(top, gates):
                if takers[e] < C:
                    y[g, t] += gate * ffn(w1[e], w3[e], w2[e], xg[g, t])
                takers[e] += 1
        dropped.append(int(np.maximum(takers - C, 0).sum()))
    if cfg.num_shared_experts:
        s = p["shared"]
        y = y + ffn(f64(s["w1"]), f64(s["w3"]) if cfg.glu else None,
                    f64(s["w2"]), xg)
    return y.reshape(x.shape), dropped


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
@pytest.mark.parametrize("case", CASES)
def test_config_matches_jax(case, smoke):
    """Every field of the port's config equals the JAX config's, and so do
    the parameter counts and the capacities of groups of 1 to 2,048."""
    jcfg, tcfg = _cfgs(case, "bfloat16")
    if not smoke:
        jcfg, tcfg = jax_get_config(_arch(case)), get_config(_arch(case))
        if case == "deepseek64":
            # the widened smoke routing is the full model's own
            assert (tcfg.num_experts, tcfg.top_k) == (64, 6)
    for f in tcfg.__dataclass_fields__:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.stages() == jcfg.stages()
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.active_params() == jcfg.active_params()
    for s in GROUP_SIZES:
        assert tcfg.moe_capacity(s) == jcfg.moe_capacity(s), s
    if not smoke:
        assert tcfg.num_params() == NUM_PARAMS[tcfg.name]
        assert tcfg.active_params() == ACTIVE_PARAMS[tcfg.name]


def test_deepseek_capacities():
    """deepseek-moe-16b's slots per expert: 4 for a decode group of 4 and
    for a prefill chunk of 32, 16 at an embed bucket of 128, 240 at
    2,048."""
    cfg = get_config("deepseek-moe-16b")
    assert [cfg.moe_capacity(s) for s in GROUP_SIZES] == [
        4, 4, 4, 4, 16, 240]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_from_jax_is_bit_exact(weights, case, dtype):
    jp, tp = weights[case, dtype]
    n = 0
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.float().numpy(),
                                      a.astype(np.float32), err_msg=path)
        n += 1
    assert n > 10
    moe = tp["stages"][0]["b0"]["moe"]
    assert "ffn" not in tp["stages"][0]["b0"]
    assert moe["router"].dtype == torch.float32
    assert moe["w1"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("case", CASES)
def test_init_params_match_jax(weights, case):
    """The port's own draw: JAX's tree, shapes and dtypes (the router in
    f32 under bf16 weights), norm scales of one, the JAX init's scales,
    and the same draw from the same seed."""
    jp, _ = weights[case, "bfloat16"]
    _, cfg = _cfgs(case, "bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    again = init_params(cfg, torch.Generator().manual_seed(0))
    for path, a, b in _tree_pairs(jp, tp):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        if "scale" in path:
            np.testing.assert_array_equal(b.float().numpy(),
                                          a.astype(np.float32), err_msg=path)
    for (_, a, b) in _tree_pairs(tp, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    moe = tp["stages"][0]["b0"]["moe"]
    assert moe["router"].dtype == torch.float32
    d, fe = cfg.d_model, cfg.moe_d_ff
    for name, fan_in in (("router", d), ("w1", d), ("w3", d), ("w2", fe)):
        std = moe[name].float().std().item()
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------
SHAPES = [(2, 16), (1, 32), (4, 1)]


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_jax(weights, case, dtype, B, S):
    """Layer 0's ``moe_apply`` on the same inputs: outputs, router loss and
    the assignments each dispatch group drops.  Under 64 experts top-6 the
    groups of 16 and 32 tokens drop; the decode group of 4 never does."""
    jcfg, tcfg = _cfgs(case, dtype)
    jm, tm = _layer_moe(weights, case, dtype)
    xj, xt = _inputs(10 * B + S, (B, S, tcfg.d_model), dtype)
    yj, auxj = jax.jit(lambda p, x: JL.moe_apply(jcfg, p, x,
                                                 JL.NULL_POLICY))(jm, xj)
    yt, auxt = L.moe_apply(tcfg, tm, xt)
    assert yt.dtype == xt.dtype and yt.shape == (B, S, tcfg.d_model)
    assert auxt.dtype == torch.float32 and auxt.dim() == 0
    _close(yt, yj.astype(jnp.float32), TOLS[dtype])
    assert abs(float(auxt) - float(auxj)) < AUX_TOL
    dropped = L.moe_route(tcfg, tm["router"], L.moe_groups(xt))["dropped"]
    assert dropped.tolist() == _jax_dropped(jcfg, jm, xj)
    if S == 1:
        assert dropped.tolist() == [0]
    elif case == "deepseek64":
        assert sum(dropped.tolist()) > 0


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_oracle(weights, case, B, S):
    """In f32 against the token-by-token oracle: outputs within 2e-5 and
    the same drops per group."""
    _, tcfg = _cfgs(case, "float32")
    _, tm = _layer_moe(weights, case, "float32", layer=1)
    _, xt = _inputs(20 + B, (B, S, tcfg.d_model), "float32")
    want, dropped = _oracle(tcfg, tm, xt)
    y, _ = L.moe_apply(tcfg, tm, xt)
    np.testing.assert_allclose(y.numpy(), want, atol=TOLS["float32"],
                               rtol=TOLS["float32"])
    route = L.moe_route(tcfg, tm["router"], L.moe_groups(xt))
    assert route["dropped"].tolist() == dropped


def test_moe_route_slots():
    """The slotting's invariants on a group that drops: each kept
    assignment owns one slot of its expert, the table and the gates of
    the slots are its inverse, and a dropped one points at ``E * C``."""
    cfg = get_smoke_config("deepseek-moe-16b").replace(
        param_dtype="float32", compute_dtype="float32", **WIDE)
    router = torch.randn(cfg.d_model, cfg.num_experts,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    r = L.moe_route(cfg, router, x)
    E, K, C = cfg.num_experts, cfg.top_k, cfg.moe_capacity(32)
    slot, eidx = r["slot"][0], r["eidx"][0]
    kept = slot < E * C
    assert int((~kept).sum()) == int(r["dropped"][0]) > 0
    assert torch.equal(slot[kept] // C, eidx[kept])
    assert len(set(slot[kept].tolist())) == int(kept.sum())
    tok = torch.arange(32)[:, None].expand(32, K)
    assert torch.equal(r["table"][0, slot[kept]], tok[kept])
    assert int((r["table"][0] == 32).sum()) == E * C - int(kept.sum())
    assert torch.equal(r["counts"][0], torch.bincount(eidx.reshape(-1),
                                                      minlength=E))


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------
# Over a stack, each layer's input differs between the packages by bf16
# rounding, and a token whose k-th and (k+1)-th router probabilities are
# that close picks another expert in each package: its output, and through
# attention and capacity every later token of its row, legitimately
# differ.  The stack tests record both packages' routing and hold every
# token before its row's first such flip; each flip must be a near tie.
NEAR_TIE = 0.05      # router logit gap of a flip (the JAX side's)
INF = np.iinfo(np.int64).max


def _jax_tensor(t):
    return jnp.asarray(t.float().numpy(), jnp.dtype(str(t.dtype)[6:]))


@contextlib.contextmanager
def _routing(jcfg):
    """Records each MoE call's router probabilities in both packages as
    (tokens, E) arrays in (row, position) order: the JAX package's by a
    debug callback (its layers run inside a scan), the port's from
    ``moe_route``.  Each of the port's ``moe_apply`` calls is also held
    against the JAX package's on the same inputs, at the layer tolerance.
    Yields (jax list, port list, held calls: ok flags)."""
    jax_probs, port_probs, calls = [], [], []
    jax_moe, port_moe, port_route = JL.moe_apply, L.moe_apply, L.moe_route

    def record(a):
        jax_probs.append(np.asarray(a).reshape(-1, a.shape[-1]))

    def jax_rec(cfg, p, x, policy):
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                          p["router"]), axis=-1)
        jax.debug.callback(record, probs, ordered=True)
        return jax_moe(cfg, p, x, policy)

    def port_rec(cfg, router, x):
        r = port_route(cfg, router, x)
        port_probs.append(r["probs"].reshape(-1, cfg.num_experts).numpy())
        return r

    jax_layer = jax.jit(lambda p, x: jax_moe(jcfg, p, x, JL.NULL_POLICY)[0])

    def port_held(cfg, p, x):
        y, aux = port_moe(cfg, p, x)
        ref = jax_layer(jax.tree.map(_jax_tensor, p), _jax_tensor(x))
        tol = TOLS[cfg.compute_dtype]
        calls.append(np.allclose(y.float().numpy(),
                                 np.asarray(ref.astype(jnp.float32)),
                                 atol=tol, rtol=tol))
        return y, aux
    with mock.patch.object(JL, "moe_apply", jax_rec), \
            mock.patch.object(L, "moe_route", port_rec), \
            mock.patch.object(L, "moe_apply", port_held):
        yield jax_probs, port_probs, calls


def _flips(routes, K, shape):
    """(B, S) mask of the tokens whose top-k expert set differs between
    the packages in any call recorded since the last read (each call of
    ``shape``); asserts that each is a near tie.  Empties the record."""
    jax_probs, port_probs, _ = routes
    assert len(jax_probs) == len(port_probs) > 0
    flips = np.zeros(shape, bool)
    for a, b in zip(jax_probs, port_probs):
        ta = np.argsort(-a, axis=-1, kind="stable")[:, :K]
        tb = np.argsort(-b, axis=-1, kind="stable")[:, :K]
        differs = np.array([set(u) != set(v) for u, v in zip(ta, tb)])
        ranked = np.log(-np.sort(-a, axis=-1))
        gap = ranked[:, K - 1] - ranked[:, K]
        assert np.all(gap[differs] < NEAR_TIE), gap[differs]
        flips |= differs.reshape(shape)
    jax_probs.clear()
    port_probs.clear()
    return flips


class _Held:
    """Logits and caches held at ``tol`` on every token before its row's
    first routing flip (by absolute position), counting what was held."""

    def __init__(self, routes, K, B, dtype):
        self.routes, self.K, self.dtype = routes, K, dtype
        self.flip_at = np.full(B, INF)
        self.held = self.total = 0

    def logits(self, t, j, positions, layer_shape=None):
        """t, j: (B, S', V) logits of tokens at ``positions`` (B, S');
        the call's MoE layers saw tokens of ``layer_shape`` (default
        ``positions.shape``)."""
        shape = positions.shape if layer_shape is None else layer_shape
        flips = _flips(self.routes, self.K, shape)
        at = np.broadcast_to(np.arange(shape[1]), shape) + (
            positions[:, :1] if layer_shape is None else 0)
        self.flip_at = np.minimum(self.flip_at,
                                  np.where(flips, at, INF).min(axis=1))
        if self.dtype == "float32":
            assert not flips.any()
        ok = positions < self.flip_at[:, None]
        self.held += int(ok.sum())
        self.total += ok.size
        _close(t[torch.from_numpy(ok)], np.asarray(j)[ok],
               LOGITS_TOL[self.dtype])

    def caches(self, jc, tc):
        """Every cache leaf (repeats, B, S, ...) at each row's positions
        before its first flip."""
        for path, a, b in _tree_pairs(jc, tc):
            assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}", path
            for row, n in enumerate(np.minimum(self.flip_at, b.shape[2])):
                _close(b[:, row, :n], np.asarray(a)[:, row, :n],
                       LOGITS_TOL[self.dtype])

    def check_layers(self):
        """Something was held, and every MoE call of the port held against
        the JAX package's on the same inputs."""
        calls = self.routes[2]
        assert self.held > 0 and len(calls) > 0 and all(calls), calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_forward_train_matches_jax_pallas(weights, case, dtype):
    """The full-sequence forward (flash attention, one dispatch group a
    row) against the JAX forward on its Pallas kernel (interpret mode):
    logits, and the summed router loss (1e-5 in f32; in bf16 each layer's
    input, and so its router probabilities, differ by bf16 rounding, and
    the loss is held at the layer tolerance)."""
    jcfg, tcfg = _cfgs(case, dtype)
    jp, tp = weights[case, dtype]
    toks = np.random.default_rng(3).integers(0, 256, (2, 20)).astype(
        np.int32)
    with _routing(jcfg) as routes:
        ref, ref_aux = JM.forward_train(jcfg.replace(use_pallas=True), jp,
                                        {"tokens": jnp.asarray(toks)})
        out, aux = M.forward_train(tcfg, tp,
                                   {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32 and out.shape == (2, 20, 256)
    held = _Held(routes, tcfg.top_k, 2, dtype)
    held.logits(out, ref, np.broadcast_to(np.arange(20), (2, 20)))
    held.check_layers()
    assert aux.dtype == torch.float32 and float(aux) > 0
    aux_tol = AUX_TOL if dtype == "float32" else TOLS[dtype]
    assert abs(float(aux) - float(ref_aux)) < aux_tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax(weights, case, dtype):
    jcfg, tcfg = _cfgs(case, dtype)
    jp, tp = weights[case, dtype]
    toks = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(
        np.int32)
    with _routing(jcfg) as routes:
        jl, jc, jn = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
        tl, tc, tn = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                               32)
    assert tn == jn == 12
    held = _Held(routes, tcfg.top_k, 2, dtype)
    held.logits(tl, jl, np.full((2, 1), 11), layer_shape=(2, 12))
    held.check_layers()
    held.caches(jc, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_chunks_and_decode_match_jax(weights, case, dtype):
    """A prefill_chunk chain (chunks of 8 at scalar offsets, one of 3 at
    per-row offsets), then decode steps of the 2 rows as one group to
    position 26, past mixtral smoke's window of 8 by 18: logits and the
    KV cache agree with JAX."""
    jcfg, tcfg = _cfgs(case, dtype)
    jp, tp = weights[case, dtype]
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, (2, 16)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 32)
    tc = M.init_cache(tcfg, 2, 32)
    with _routing(jcfg) as routes:
        # traced here, so that the routing record is in the traced steps
        jax_chunk = jax.jit(lambda *a: JM.prefill_chunk(jcfg, *a))
        jax_decode = jax.jit(lambda *a: JM.decode_step(jcfg, *a))
        held = _Held(routes, tcfg.top_k, 2, dtype)
        for c0 in (0, 8):
            chunk = prompt[:, c0:c0 + 8]
            jl, jc = jax_chunk(jp, jnp.asarray(chunk), jc, jnp.int32(c0))
            tl, tc = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc,
                                     c0)
            held.logits(tl, jl, np.broadcast_to(np.arange(c0, c0 + 8),
                                                (2, 8)))
        offs = np.array([16, 16], np.int32)
        chunk = rng.integers(0, 256, (2, 3)).astype(np.int32)
        jl, jc = jax_chunk(jp, jnp.asarray(chunk), jc, jnp.asarray(offs))
        tl, tc = M.prefill_chunk(tcfg, tp, torch.from_numpy(chunk), tc,
                                 torch.from_numpy(offs))
        held.logits(tl, jl, offs[:, None] + np.arange(3))
        pos = np.array([19, 19], np.int32)
        for step in range(8):
            tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
            jl, jc = jax_decode(jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos + step))
            tl, tc = M.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                                   torch.from_numpy(pos + step))
            held.logits(tl, jl, (pos + step)[:, None])
    held.check_layers()
    held.caches(jc, tc)


# --------------------------------------------------------------------------
# serving: the port's engine against the JAX engine at the same chunk
# --------------------------------------------------------------------------
def _jax_engine(jcfg, jp, chunk, **kw):
    je = JaxEngine(jcfg, chunk=chunk, **kw)
    je.params = jp
    return je


def _engine(tcfg, tp, chunk, **kw):
    return ServingEngine(tcfg, chunk=chunk, device="cpu", params=tp, **kw)


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("case", CASES)
def test_generate_matches_jax_engine(weights, case, chunk):
    """In f32, the 20-token prompt with 8 new tokens on the engines'
    default 4 slots and 2,048 positions: at chunk 4 and 8 whole chunks go
    through chunked prefill and the rest through 4-token decode groups,
    at chunk 32 every prompt token through decode.  The port's engine
    generates the JAX engine's tokens at the same chunk."""
    jcfg, tcfg = _cfgs(case, "float32")
    jp, tp = weights[case, "float32"]
    want = _jax_engine(jcfg, jp, chunk).generate(PROMPT, 8)
    got = _engine(tcfg, tp, chunk).generate(PROMPT, 8)
    assert got == want and len(got) == 8


@pytest.mark.parametrize("case", CASES)
def test_requests_together_and_in_reused_slots(weights, case):
    """In f32, prompts of 5, 20, 37, 12 and 26 tokens served together on 2
    slots at chunk 8 (the later ones take freed slots): the port's engine
    generates the JAX engine's tokens, and each request the tokens it
    gets alone in a fresh engine (a decode group of up to 4 tokens drops
    nothing, and a prefill chunk is its own group)."""
    jcfg, tcfg = _cfgs(case, "float32")
    jp, tp = weights[case, "float32"]
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (5, 20, 37, 12, 26)]
    kw = dict(n_slots=2, max_context=64)
    je = _jax_engine(jcfg, jp, 8, **kw)
    want = [je.submit(p, 10) for p in prompts]
    je.run_until_idle()
    eng = _engine(tcfg, tp, 8, **kw)
    got = [eng.submit(p, 10) for p in prompts]
    eng.run_until_idle()
    assert [r.generated for r in got] == [r.generated for r in want]
    assert {r.slot for r in got[2:]} <= {0, 1}
    for p, r in zip(prompts, got):
        assert _engine(tcfg, tp, 8, **kw).generate(p, 10) == r.generated


@pytest.mark.parametrize("case", CASES)
def test_embed_batch_matches_jax_engine(weights, case):
    jcfg, tcfg = _cfgs(case, "float32")
    jp, tp = weights[case, "float32"]
    lists = [[1, 2, 3, 4], [5, 6, 7], list(range(40))]     # bucket 64
    out = _engine(tcfg, tp, 8).embed_batch(lists)
    np.testing.assert_allclose(
        out, _jax_engine(jcfg, jp, 8).embed_batch(lists), atol=1e-4,
        rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


# --------------------------------------------------------------------------
# the reference's MoE behaviour, recorded (ROADMAP.md C.12, C.14)
# --------------------------------------------------------------------------
def test_jax_engine_tokens_follow_chunk(weights):
    """C.12: on deepseek smoke in f32, the JAX engine's tokens for the
    20-token prompt at chunk 8 (two 8-token chunks, 4 slots an expert for
    16 assignments over 8 experts) differ from those at chunk 4 and 32
    (every group small enough to keep all its assignments); the port's
    equal the JAX engine's at each chunk."""
    jcfg, tcfg = _cfgs("deepseek", "float32")
    jp, tp = weights["deepseek", "float32"]
    jax_tokens, port_tokens = {}, {}
    for chunk in (4, 8, 32):
        jax_tokens[chunk] = _jax_engine(jcfg, jp, chunk).generate(PROMPT, 8)
        port_tokens[chunk] = _engine(tcfg, tp, chunk).generate(PROMPT, 8)
    assert jax_tokens[4] == jax_tokens[32] == [182, 72, 168, 217, 53, 193,
                                               94, 138]
    assert jax_tokens[8] == [182, 72, 168, 217, 53, 164, 164, 164]
    assert port_tokens == jax_tokens


def test_embedding_follows_bucket(weights):
    """C.14: under 64 experts top-6, a 100-token text embedded alone
    (bucket 128, 16 slots an expert) and beside a 200-token text (bucket
    256, 32 slots) gets two different embeddings, in both packages alike
    (pad tokens route and take capacity in their row's group)."""
    jcfg, tcfg = _cfgs("deepseek64", "float32")
    jp, tp = weights["deepseek64", "float32"]
    rng = np.random.default_rng(11)
    text = [int(t) for t in rng.integers(0, 256, 100)]
    longer = [int(t) for t in rng.integers(0, 256, 200)]
    je, eng = _jax_engine(jcfg, jp, 8), _engine(tcfg, tp, 8)
    embs = {}
    for bucket, batch in ((128, [text]), (256, [text, longer])):
        want = je.embed_batch(batch)[0]
        got = eng.embed_batch(batch)[0]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        embs[bucket] = want, got
    for i in range(2):
        a, b = embs[128][i], embs[256][i]
        assert float(a @ b) < 0.9999 and np.abs(a - b).max() > 1e-3
