"""The port's sharded model (``repro_torch.models.sharding``, the policy
hooks, the padded config, ZeRO-1, ``build_trainer(mesh=)``) against the
JAX package's, on the CPU.

The reference runs in one subprocess with eight host devices (as
``tests/test_distributed.py`` runs it): its specs for every config at
``shard_multiple`` 1 and 4 on meshes (8, 1), (2, 4) and (1, 8), its
padded head and vocabulary counts, a padded granite-smoke forward and
loss, the hook names its layers call, and its own elastic case
(``test_elastic_reshard_continues_training``: granite-smoke at
``shard_multiple=4`` trained 6 steps on (2, 4), a checkpoint after 3,
continued on (4, 2)) in f32 and in bf16; it saves its ``PRNGKey(0)``
weights and its checkpoint for the port, which continues the reference's
checkpoint on its own (4, 2) mesh too.  The port runs the same case in eight gloo
processes (``tests/torch_sharding_cases.py``), with mixtral-smoke and
falcon-mamba-smoke mesh steps and the MoE decode grouping beside it.

Tolerances, set beforehand: specs and padded counts exactly; the f32
losses to ``LOSS_RTOL`` 1e-5 relative (``tests/test_torch_training.py``);
each continued loss to the uninterrupted run's at 1e-3 relative, the
reference's own tolerance for its elastic case; the bf16 losses to the
reference's at 6e-2 (the bf16 trajectory tolerance of
``tests/test_torch_training_steps.py``); a mesh step's loss to the
one-device step's at ``LOSS_RTOL``, its gradients and AdamW's moments after
it to ``GRAD_TOL`` 1e-4 of each leaf's largest magnitude, and the second
step's loss at ``LOSS_RTOL``; the padded forward at the f32 model
tolerance 1e-4.  The null policy is held bitwise to the
port as it was before the hooks (the commit ``PRE_HOOKS``, read from
git).  The processes each test starts carry a timeout.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp
from repro.training.checkpoint import CheckpointManager as JaxManager
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.training import optimizer as TO

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
ELASTIC_RTOL, BF16_TOL, MODEL_TOL = 1e-3, 6e-2, 1e-4
MESHES = [(8, 1), (2, 4), (1, 8)]
MULTIPLES = (1, 4)
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
# granite-smoke with 6 heads over 2 KV heads and a vocabulary of 250:
# padded at shard_multiple 4 to 8 heads and 252 rows
PADDED = {"num_heads": 6, "vocab_size": 250, "shard_multiple": 4}
PRE_HOOKS = "d703c2440ee2a6be3fc0ab31f78119d3d48e0e81"
TIMEOUT = 420

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config, get_smoke_config, list_archs
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.models import sharding as S
    from repro.training import HParams, adamw_init, make_train_step, opt_specs
    from repro.training.checkpoint import CheckpointManager
    from repro.training.data import DataConfig, SyntheticTokenPipeline

    out_dir, meshes, multiples, padded = json.loads(sys.argv[1])
    F32 = {"param_dtype": "float32", "compute_dtype": "float32"}

    def enc(t):
        if isinstance(t, P):
            return [list(e) if isinstance(e, tuple) else e for e in t]
        if isinstance(t, dict):
            return {k: enc(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [enc(v) for v in t]
        return t

    res = {"specs": {}, "padded": {}}
    for arch in list_archs():
        for sm in (1, 4, 8, 16):
            c = get_config(arch, shard_multiple=sm)
            res["padded"][f"{arch}|{sm}"] = [
                c.padded_num_heads, c.padded_num_kv_heads, c.padded_vocab]
        for sm in multiples:
            cfg = get_config(arch, shard_multiple=sm)
            sds = jax.eval_shape(
                lambda: M.init_params(cfg, jax.random.PRNGKey(0)))
            for shape in meshes:
                mesh = make_mesh(tuple(shape), ("data", "model"))
                ps = S.param_specs(cfg, mesh)
                res["specs"][f"{arch}|{sm}|{shape}"] = {
                    "param": enc(ps), "opt": enc(opt_specs(ps, sds, mesh)),
                    "cache": {b: enc(S.cache_specs(cfg, mesh, b))
                              for b in (8, 1)},
                    "batch": {f"{b}|{k}": enc(S.batch_specs(cfg, mesh, b, k))
                              for b in (8, 6)
                              for k in ("train", "prefill", "decode")},
                    "policy": {b: dict({n: enc(s) for n, s in
                                        S.MeshPolicy(mesh, cfg, b)
                                        .specs.items()},
                                       dp_size=S.MeshPolicy(mesh, cfg, b)
                                       .dp_size)
                               for b in (8, 6)}}

    def save_params(path, params):
        flat = {}
        def walk(t, pre):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, pre + k + "/")
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    walk(v, pre + str(i) + "/")
            else:
                flat[pre[:-1]] = np.asarray(t, np.float32)
        walk(params, "")
        np.savez(path, **flat)

    # the padded forward and loss
    cfg = get_smoke_config("granite-8b").replace(remat=False, **F32,
                                                 **padded)
    params = M.init_params(cfg, jax.random.PRNGKey(1))
    save_params(out_dir + "/padded_params.npz", params)
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 12, 2))
    b = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
    logits, _ = M.forward_train(cfg, params, b)
    total, _ = M.loss_fn(cfg, params, b)
    np.savez(out_dir + "/padded_out.npz", logits=np.asarray(logits),
             loss=np.asarray(total))

    # the hook names, one layer at a time
    class Rec:
        dp_size = 1
        def __init__(self):
            self.names = []
        def __call__(self, x, name):
            self.names.append(name)
            return x
    # traced, not run: make_jaxpr over abstract weights and caches
    hooks = {}
    for arch in ("granite-8b", "mixtral-8x7b", "falcon-mamba-7b",
                 "recurrentgemma-9b", "whisper-base"):
        c = get_smoke_config(arch).replace(remat=False, unroll_layers=True,
                                           **F32)
        p = jax.eval_shape(lambda: M.init_params(c, jax.random.PRNGKey(2)))
        bb = {"tokens": jnp.zeros((2, 8), jnp.int32),
              "labels": jnp.zeros((2, 8), jnp.int32)}
        if c.is_encoder_decoder:
            bb["frames"] = jnp.zeros((2, c.encoder_seq, c.d_model))
        rec = Rec()
        jax.make_jaxpr(lambda p, b: M.loss_fn(c, p, b, rec))(p, bb)
        hooks[arch + "|train"] = rec.names
        if c.is_encoder_decoder:
            cache = jax.eval_shape(
                lambda p: M.encode_for_cache(c, p, bb["frames"], 2, 16), p)
        else:
            cache = jax.eval_shape(lambda: M.init_cache(c, 2, 16))
        rec = Rec()
        jax.make_jaxpr(lambda p, cc: M.decode_step(
            c, p, jnp.zeros((2, 1), jnp.int32), cc, jnp.int32(3), rec))(
                p, cache)
        hooks[arch + "|decode"] = rec.names
    res["hooks"] = hooks

    # the reference's own elastic case (tests/test_distributed.py)
    hp = HParams(lr=1e-3, warmup_steps=1, total_steps=10)
    res["elastic"] = {}
    for dtype in ("f32", "bf16"):
        cfg = get_smoke_config("granite-8b").replace(
            remat=False, shard_multiple=4, **(F32 if dtype == "f32" else {}))
        data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 16, 8))

        def build(mesh):
            policy = S.MeshPolicy(mesh, cfg, 8)
            pspecs = S.param_specs(cfg, mesh)
            sds = jax.eval_shape(
                lambda: M.init_params(cfg, jax.random.PRNGKey(0)))
            ospecs = opt_specs(pspecs, sds, mesh)
            bspecs = S.batch_specs(cfg, mesh, 8, "train")
            psh = S.to_shardings(mesh, pspecs)
            osh = S.to_shardings(mesh, ospecs)
            step = jax.jit(make_train_step(cfg, hp, policy),
                           in_shardings=(psh, osh,
                                         S.to_shardings(mesh, bspecs)),
                           out_shardings=(psh, osh, None))
            return step, pspecs, ospecs

        def put(tree, mesh, specs):
            return jax.tree.map(
                lambda a, s: jax.device_put(
                    jnp.asarray(a), jax.sharding.NamedSharding(mesh, s)),
                tree, specs, is_leaf=lambda x: not isinstance(x, (dict, list)))

        init = M.init_params(cfg, jax.random.PRNGKey(0))
        save_params(out_dir + f"/ref_params_{dtype}.npz", init)
        mesh_a = make_mesh((2, 4), ("data", "model"))
        step_a, pspecs_a, ospecs_a = build(mesh_a)
        params = put(init, mesh_a, pspecs_a)
        opt = put(adamw_init(params), mesh_a, ospecs_a)
        ref = []
        for i in range(6):
            batch = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
            params, opt, m = step_a(params, opt, batch)
            ref.append(float(m["loss"]))
            if i == 2:
                mgr = CheckpointManager(out_dir + f"/jax_ckpt_{dtype}",
                                        keep=1)
                mgr.save(3, {"params": params, "opt": opt})
        mesh_b = make_mesh((4, 2), ("data", "model"))
        step_b, pspecs_b, ospecs_b = build(mesh_b)
        state = mgr.restore_latest()
        params_b = put(state["params"], mesh_b, pspecs_b)
        opt_b = put(state["opt"], mesh_b, ospecs_b)
        cont = []
        for i in range(3, 6):
            batch = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
            params_b, opt_b, m = step_b(params_b, opt_b, batch)
            cont.append(float(m["loss"]))
        res["elastic"][dtype] = {"ref": ref, "elastic": cont}
    with open(out_dir + "/reference.json", "w") as f:
        json.dump(res, f)
    print("ok")
""")

NULL_RUN = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    from repro_torch.training import HParams, adamw_init, make_train_step
    from repro_torch.training.data import DataConfig, SyntheticTokenPipeline

    out = {}
    for arch in ("granite-8b", "mixtral-8x7b", "falcon-mamba-7b"):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 12, 4))
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
        new, _, m = make_train_step(cfg, HParams(lr=1e-3, warmup_steps=1))(
            params, adamw_init(params), batch)
        out[arch + "_loss"] = m["loss"].numpy()
        out[arch + "_embed"] = new["embed"].view(torch.int16).numpy()
        logits, cache, pos = M.prefill(
            cfg, params, {"tokens": batch["tokens"][:, :6]}, 16)
        logits, _ = M.decode_step(cfg, params, logits.argmax(-1), cache,
                                  pos)
        out[arch + "_decode"] = logits.numpy()
    np.savez(sys.argv[1], **out)
""")


def _run(cmd, env, timeout=TIMEOUT):
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding_reference")
    arg = json.dumps([str(d), MESHES, list(MULTIPLES), PADDED])
    _run([sys.executable, "-c", REFERENCE, arg],
         dict(os.environ, JAX_PLATFORMS="cpu"))
    return d


@pytest.fixture(scope="module")
def reference(ref_dir):
    return json.loads((ref_dir / "reference.json").read_text())


@pytest.fixture(scope="module")
def port(ref_dir):
    """The port's eight-process runs (``torch_sharding_cases``)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    _run([sys.executable, "-c",
          "import sys, torch_sharding_cases as C; C.main(sys.argv[1])",
          str(ref_dir)], env)
    return json.loads((ref_dir / "port.json").read_text())


def _enc(t):
    """A spec tree as the reference's subprocess writes it (JSON)."""
    if isinstance(t, dict):
        return {k: _enc(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_enc(v) for v in t]
    if isinstance(t, tuple):
        return [list(e) if isinstance(e, tuple) else e for e in t]
    return t


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 8)


# --------------------------------------------------------------------------
# specs and padding
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sm", MULTIPLES)
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(reference, arch, sm, shape):
    want = reference["specs"][f"{arch}|{sm}|{list(shape)}"]
    cfg = get_config(arch, shard_multiple=sm)
    mesh = _mesh(shape)
    ps = S.param_specs(cfg, mesh)
    assert _enc(ps) == want["param"]
    from repro_torch.launch.train import param_shapes
    assert _enc(TO.opt_specs(ps, param_shapes(cfg), mesh)) == want["opt"]
    for b in (8, 1):
        assert _enc(S.cache_specs(cfg, mesh, b)) == want["cache"][str(b)]
    for b in (8, 6):
        for kind in ("train", "prefill", "decode"):
            assert (_enc(S.batch_specs(cfg, mesh, b, kind))
                    == want["batch"][f"{b}|{kind}"])
        policy = S.MeshPolicy(mesh, cfg, b)
        assert dict(_enc(policy.specs), dp_size=policy.dp_size) \
            == want["policy"][str(b)]


def test_to_shardings_places_each_named_axis():
    """A mesh dim named at tensor dim i shards dim i; a tuple of names
    shards one dim over both mesh dims, in mesh order; others replicate."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 4))
    cfg = get_smoke_config("granite-8b").replace(shard_multiple=4)
    pl = S.to_shardings(mesh, S.param_specs(cfg, mesh))
    assert pl["embed"] == (Replicate(), Shard(0))
    assert pl["lm_head"] == (Replicate(), Shard(1))
    assert pl["stages"][0]["b0"]["attn"]["wq"] == (Replicate(), Shard(2))
    assert pl["stages"][0]["b0"]["attn"]["wk"] == (Replicate(), Replicate())
    assert pl["stages"][0]["b0"]["ffn"]["w2"] == (Replicate(), Shard(1))
    assert S.placements(mesh, S.P(None, ("data", "model")), 3) == (
        Shard(1), Shard(1))
    assert S.placements(mesh, S.P(("data",), None), 2) == (
        Shard(0), Replicate())


@pytest.mark.parametrize("spec,shape,data,want", [
    ((None, "model"), (8, 16), 2, ("data", "model")),
    (("model", None), (16, 8), 4, ("model", "data")),
    ((None, None), (3, 8), 4, (None, "data")),     # 3 does not divide
    ((None,), (2,), 4, (None,)),                   # below the axis size
    ((), (8, 6), 2, ("data", None)),               # short spec padded
    ((None, "model", None), (36, 4096, 32), 2, ("data", "model", None)),
])
def test_zero1_spec_matches_reference(spec, shape, data, want):
    from jax.sharding import PartitionSpec as P
    from repro.training.optimizer import _zero1_spec
    ref = _zero1_spec(P(*spec), shape, data)
    assert TO._zero1_spec(spec, shape, data) == want == tuple(ref)


@pytest.mark.parametrize("arch", list_archs())
def test_padded_counts_match_reference(reference, arch):
    for sm in (1, 4, 8, 16):
        cfg = get_config(arch, shard_multiple=sm)
        assert [cfg.padded_num_heads, cfg.padded_num_kv_heads,
                cfg.padded_vocab] == reference["padded"][f"{arch}|{sm}"]
        assert cfg.shard_multiple == sm
    assert get_config(arch) == get_config(arch, shard_multiple=1)


def test_padded_forward_and_loss_match_reference(ref_dir):
    """granite-smoke padded to 8 heads and 252 vocabulary rows: the
    reference's weights draw the padded shapes, the port's forward and
    masked loss match, and the port's own draw has the same shapes."""
    from repro_torch.params import init_params, load_checkpoint
    cfg = get_smoke_config("granite-8b").replace(remat=False, **F32,
                                                 **PADDED)
    assert (cfg.padded_num_heads, cfg.padded_vocab) == (8, 252)
    params = load_checkpoint(ref_dir / "padded_params.npz")
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert TO.tree_map(lambda t: tuple(t.shape), drawn) == TO.tree_map(
        lambda t: tuple(t.shape), params)
    assert params["embed"].shape == (252, cfg.d_model)
    assert params["stages"][0]["b0"]["attn"]["wq"].shape[2] == 8
    from repro_torch.training.data import DataConfig, SyntheticTokenPipeline
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 12, 2))
    b = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    want = np.load(ref_dir / "padded_out.npz")
    logits, _ = M.forward_train(cfg, params, b, route="plain")
    np.testing.assert_allclose(logits.numpy(), want["logits"],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    total, _ = M.loss_fn(cfg, params, b)
    np.testing.assert_allclose(float(total), float(want["loss"]),
                               rtol=LOSS_RTOL)
    # the padded rows are masked: the loss is the unpadded vocabulary's
    lse = torch.logsumexp(logits[..., :cfg.vocab_size], -1)
    assert torch.isfinite(lse).all()


def test_padded_vocab_is_masked_in_greedy_decoding():
    from repro_torch.serving.engine import _mask_vocab
    cfg = get_smoke_config("granite-8b").replace(**PADDED)
    logits = torch.zeros((3, cfg.padded_vocab))
    logits[:, cfg.vocab_size:] = 10.0
    logits[:, 7] = 1.0
    assert _mask_vocab(cfg, logits).argmax(-1).tolist() == [7, 7, 7]
    plain = get_smoke_config("granite-8b")
    same = torch.randn((2, plain.vocab_size))
    assert _mask_vocab(plain, same) is same


# --------------------------------------------------------------------------
# the hooks
# --------------------------------------------------------------------------
class _Recorder(L.NullPolicy):
    def __init__(self):
        self.names = []

    def __call__(self, x, name):
        self.names.append(name)
        return x


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_hooks_are_the_references(reference, arch, mode):
    """The port calls the policy under the reference's names, in its order,
    layer by layer (the reference unrolled: one trace per layer)."""
    cfg = get_smoke_config(arch).replace(**F32)
    from repro_torch.params import init_params
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rec = _Recorder()
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    if mode == "train":
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros((2, cfg.encoder_seq, cfg.d_model))
        M.loss_fn(cfg, p, batch, rec)
    else:
        if cfg.is_encoder_decoder:
            cache = M.encode_for_cache(
                cfg, p, torch.zeros((2, cfg.encoder_seq, cfg.d_model)), 2, 16)
        else:
            cache = M.init_cache(cfg, 2, 16)
        M.decode_step(cfg, p, tokens[:, :1], cache, 3, rec)
    assert rec.names == reference["hooks"][f"{arch}|{mode}"]


def test_null_policy_is_bitwise_the_code_before_the_hooks(tmp_path):
    """One train step and one prefill + decode step of three families,
    with the null policy, bitwise the port at ``PRE_HOOKS``."""
    old = tmp_path / "old"
    old.mkdir()
    arch = subprocess.run(["git", "-C", str(ROOT), "archive", PRE_HOOKS,
                           "src/repro_torch"], capture_output=True)
    if arch.returncode != 0:
        pytest.skip(f"commit {PRE_HOOKS} is not in this checkout's history")
    subprocess.run(["tar", "-x", "-C", str(old)], input=arch.stdout,
                   check=True)
    outs = {}
    for name, src in (("old", old / "src"), ("new", ROOT / "src")):
        path = tmp_path / f"{name}.npz"
        _run([sys.executable, "-c", NULL_RUN, str(path)],
             dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1"))
        outs[name] = dict(np.load(path))
    assert set(outs["old"]) == set(outs["new"])
    for k, v in outs["old"].items():
        np.testing.assert_array_equal(outs["new"][k], v, err_msg=k)


# --------------------------------------------------------------------------
# the reference's own case, over eight processes
# --------------------------------------------------------------------------
def test_elastic_f32_matches_reference(port, reference):
    got, want = port["elastic"]["f32"], reference["elastic"]["f32"]
    np.testing.assert_allclose(got["ref"], want["ref"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["elastic"], want["elastic"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["elastic"], got["ref"][3:],
                               rtol=ELASTIC_RTOL, atol=ELASTIC_RTOL)
    # the reference's own checkpoint, restored onto the port's (4, 2)
    np.testing.assert_allclose(got["from_jax"], want["elastic"],
                               rtol=LOSS_RTOL)
    # restored onto (4, 2): the embedding's rows over "model" (mesh dim
    # 1); the stacked wq's master: its heads over "model", ZeRO-1's "data"
    # on d (the 2 stacked layers do not divide over 4)
    assert got["placements"]["embed"] == ["Replicate", "Shard(0)"]
    assert got["placements"]["master_wq"] == ["Shard(1)", "Shard(2)"]


def test_elastic_bf16_matches_reference(port, reference):
    """The reference's case as it runs it, in bf16: the continuation on
    (4, 2) holds to the uninterrupted run at the reference's 1e-3, and
    the trajectory to the reference's at the bf16 tolerance."""
    got, want = port["elastic"]["bf16"], reference["elastic"]["bf16"]
    np.testing.assert_allclose(got["elastic"], got["ref"][3:],
                               rtol=ELASTIC_RTOL, atol=ELASTIC_RTOL)
    np.testing.assert_allclose(got["ref"], want["ref"], atol=BF16_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["elastic"], want["elastic"],
                               atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(got["from_jax"], want["elastic"],
                               atol=BF16_TOL, rtol=0)
    assert got["ref"][-1] < got["ref"][0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mesh_checkpoint_restores_in_jax(port, ref_dir, dtype):
    """The port's checkpoint, written from rank 0 of mesh (2, 4), restores
    in the JAX package's ``CheckpointManager`` as the full state the mesh
    held (gathered by the port when it saved)."""
    state = JaxManager(str(ref_dir / f"ckpt_{dtype}")).restore_latest()
    held = np.load(ref_dir / f"port_state_{dtype}.npz")
    flat = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{pre}{k}/")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{pre}{i}/")
        else:
            flat[pre[:-1]] = t
    walk(state, "")
    assert set(flat) == set(held.files)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v, held[k].dtype), held[k],
                                      err_msg=k)
    assert int(flat["opt/step"]) == 3
    assert np.asarray(flat["params/embed"]).dtype == (
        jnp.bfloat16 if dtype == "bf16" else np.float32)


# --------------------------------------------------------------------------
# other families
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "falcon-mamba-7b"])
def test_mesh_step_matches_one_device(port, arch):
    """Two steps against the one-device steps: the losses of both and the
    first's aux loss at ``LOSS_RTOL``; its grad norm, gradients and
    AdamW's moments after it (each placed by ZeRO-1 over "data") at
    ``GRAD_TOL``.  The moments are linear in the gradient (m) and in its
    square (v); the weights themselves are not compared, since the first
    update g / (|g| + eps) turns a gradient near eps into a step of up to
    lr whatever the gradients' agreement.  The second loss is what the
    updated weights give."""
    r = port["families"][arch]
    np.testing.assert_allclose(*r["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(*r["loss2"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(*r["aux_loss"], rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(*r["grad_norm"], rtol=GRAD_TOL)
    assert r["grads_err"] <= GRAD_TOL
    assert r["m_err"] <= GRAD_TOL
    assert r["v_err"] <= GRAD_TOL


def test_moe_decode_groups_by_dp_size(port):
    r = port["families"]["moe_decode"]
    assert r["dp_size"] == 2
    assert r["y_err"] <= GRAD_TOL
    np.testing.assert_allclose(*r["aux"], rtol=LOSS_RTOL)
    assert r["differs_from_one_group"]


def test_process_mesh_refuses_without_its_ranks_or_cards(port):
    """No fallback: a shape the process group does not fill, or a card
    mesh where there is no card, raises; so does a mesh without a group."""
    from repro_torch.launch.mesh import make_process_mesh
    r = port["refusals"]
    assert r["ranks"] and "needs 16 ranks" in r["ranks"]
    assert r["cuda"] and "no CUDA device" in r["cuda"]
    with pytest.raises(RuntimeError, match="no process group"):
        make_process_mesh((1, 1), ("data", "model"), "cpu")


def test_moe_groups_follow_dp_size():
    x = torch.arange(8 * 3, dtype=torch.float32).view(8, 1, 3)
    assert L.moe_groups(x).shape == (1, 8, 3)
    assert L.moe_groups(x, 4).shape == (4, 2, 3)
    assert L.moe_groups(x, 16).shape == (8, 1, 3)
    assert L.moe_groups(x.view(2, 4, 3), 4).shape == (2, 4, 3)
    assert L.NULL_POLICY.dp_size == 1
    assert L.NULL_POLICY(x, "act") is x
