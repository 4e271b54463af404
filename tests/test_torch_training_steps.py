"""The port's trainer around the loss, against the JAX package's, on the
CPU: train steps (a bf16 loss trajectory, gradient accumulation), the
data pipeline, checkpoints read across the two packages, the resume drill
through ``repro_torch.launch.train`` and serving from a checkpoint.

Tolerances, set beforehand: a 5-step bf16 loss trajectory at 6e-2 (the
bf16 model tolerance of ``tests/test_kernels.py``: AdamW's first steps
move a parameter by about lr whatever its gradient's size, so a bf16
rounding that flips a small gradient's sign moves it by 2 lr; the losses
are held, not the params); ``accum_steps=4`` against 1 at 5e-3 as
``tests/test_training.py`` holds the JAX trainer; batches, checkpoints,
resumed losses and served tokens exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro.training import adamw_init as jax_adamw_init
from repro.training import make_train_step as jax_train_step
from repro.training.checkpoint import CheckpointManager as JaxManager
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokenPipeline as JaxPipeline
from repro.training.optimizer import HParams as JaxHParams
from repro_torch.configs import get_smoke_config
from repro_torch.core import LocalTorchProvider
from repro_torch.launch.train import build_trainer
from repro_torch.launch.train import run as train_run
from repro_torch.params import from_jax, init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import HParams, adamw_init, make_eval_step, \
    make_train_step
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import (DataConfig, StragglerWatchdog,
                                       SyntheticTokenPipeline)
from repro_torch.training.optimizer import tree_leaves

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


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


def _bits(a) -> np.ndarray:
    """The raw bytes of an array or tensor (bf16 as its 16-bit pattern)."""
    if torch.is_tensor(a):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a.view(np.uint8) if a.ndim else a.reshape(1).view(np.uint8)


def _same_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for path in fa:
        np.testing.assert_array_equal(_bits(fa[path]), _bits(fb[path]),
                                      err_msg=path)


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------
def test_bf16_loss_trajectory_matches_jax():
    """olmo smoke in bf16, 5 AdamW steps from the same weights on the same
    batches: the port's losses within 6e-2 of the JAX trainer's."""
    jcfg = jax_smoke("olmo-1b").replace(remat=False)
    tcfg = get_smoke_config("olmo-1b")
    hp = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    jstep = jax.jit(jax_train_step(jcfg, JaxHParams(**hp)))
    tstep = make_train_step(tcfg, HParams(**hp))
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    data = SyntheticTokenPipeline(DataConfig(tcfg.vocab_size, 32, 4))
    jl, tl = [], []
    for i in range(5):
        b = data.batch_at(i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert tree_leaves(tp)[0].dtype == torch.bfloat16
    np.testing.assert_allclose(tl, jl, atol=6e-2, rtol=0)
    assert tl[-1] < tl[0]


def test_grad_accumulation_matches_full_batch():
    """As ``tests/test_training.py`` holds the JAX trainer: 4 microbatches
    against the whole batch, the loss and the first leaf after one step
    within 5e-3 (f32 grads summed against bf16 grads)."""
    cfg = get_smoke_config("olmo-1b")
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 16, 8))
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    outs = {}
    for accum in (1, 4):
        hp = HParams(lr=1e-3, warmup_steps=1, total_steps=10,
                     accum_steps=accum)
        step, _ = build_trainer(cfg, hp)
        p2, _, m = step(params, adamw_init(params), batch)
        outs[accum] = (float(m["total_loss"]),
                       tree_leaves(p2)[0].float().numpy())
    assert abs(outs[1][0] - outs[4][0]) < 5e-3
    np.testing.assert_allclose(outs[1][1], outs[4][1], atol=5e-3)


def test_eval_step_matches_jax():
    jcfg = jax_smoke("granite-8b").replace(remat=False, **F32)
    tcfg = get_smoke_config("granite-8b").replace(**F32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    b = SyntheticTokenPipeline(DataConfig(tcfg.vocab_size, 16, 2)).batch_at(3)
    _, want = JM.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_eval_step(tcfg)(from_jax(jax.tree.map(np.asarray, jp)),
                               {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5)
    assert not got["loss"].requires_grad


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (256, 32, 4, 0, 1), (50_304, 64, 8, 3, 4), (100, 8, 8, 3, 2)])
def test_data_batches_are_the_jax_packages_bitwise(vocab, seq, batch, seed,
                                                   hosts):
    for host in range(hosts):
        ours = SyntheticTokenPipeline(DataConfig(vocab, seq, batch, seed),
                                      host, hosts)
        ref = JaxPipeline(JaxDataConfig(vocab, seq, batch, seed), host,
                          hosts)
        for step in (0, 1, 7, 1000):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_straggler_watchdog_flags_outlier(monkeypatch):
    """Ten 2 ms steps, then one of 50 ms: only the last is flagged.  The
    watchdog reads a fake clock, so the machine's load cannot move a
    step across the 3x-median threshold."""
    from types import SimpleNamespace
    from repro_torch.training import data
    now = [0.0]
    monkeypatch.setattr(data, "time",
                        SimpleNamespace(monotonic=lambda: now[0]))
    wd = StragglerWatchdog(threshold=3.0)
    for _ in range(10):
        wd.start()
        now[0] += 0.002
        assert not wd.stop()
    wd.start()
    now[0] += 0.05
    assert wd.stop()
    assert wd.flagged_steps == [11]


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------
def _trained_port_state(cfg, steps=2):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, HParams(lr=1e-3, warmup_steps=1,
                                        total_steps=10))
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 16, 2))
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        params, opt, _ = step(params, opt, b)
    return {"params": params, "opt": opt}


@pytest.mark.parametrize("arch", ["olmo-1b", "falcon-mamba-7b"])
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    """bf16 params, f32 master and moments, the int32 step: the JAX
    package's manager reads the port's file bit for bit, and the tree has
    the JAX params' keys (olmo's empty norm subtrees absent in both)."""
    cfg = get_smoke_config(arch)
    state = _trained_port_state(cfg)
    CheckpointManager(str(tmp_path)).save(2, state, {"arch": cfg.name})
    got = JaxManager(str(tmp_path)).restore_latest()
    _same_trees(got, state)
    assert str(got["params"]["embed"].dtype) == "bfloat16"
    assert got["opt"]["step"].dtype == np.int32 and got["opt"]["step"] == 2
    jp = JM.init_params(jax_smoke(arch), jax.random.PRNGKey(0))
    assert set(_flat(got["params"])) == set(
        k for k, v in _flat(jax.tree.map(np.asarray, jp)).items())
    assert JaxManager(str(tmp_path)).metadata(2)["arch"] == cfg.name


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-9b"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    jcfg = jax_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    state = {"params": jp, "opt": jax_adamw_init(jp)}
    JaxManager(str(tmp_path)).save(5, state)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5
    got = mgr.restore_latest()
    _same_trees(got, jax.tree.map(np.asarray, state))
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32


def test_checkpoint_roundtrip_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    w = torch.arange(6.0).reshape(2, 3)
    state = {"params": {"w": w},
             "opt": {"step": np.int32(7),
                     "stages": [{"a": np.ones(3)}, {"a": np.zeros(2)}]}}
    mgr.save(7, state)
    w.add_(100.0)              # the saved copy was taken before save returned
    mgr.wait()
    out = mgr.restore_latest()
    assert int(out["opt"]["step"]) == 7
    torch.testing.assert_close(out["params"]["w"],
                               torch.arange(6.0).reshape(2, 3))
    assert isinstance(out["opt"]["stages"], list)
    for s in (8, 9, 10):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.list_steps() == [9, 10]


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp file (a crash mid-save) is never restored."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)})
    (tmp_path / "step_0000000002.tmp.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    torch.testing.assert_close(mgr.restore_latest()["x"], torch.ones(2))


# --------------------------------------------------------------------------
# the launcher: the resume drill
# --------------------------------------------------------------------------
def test_fault_tolerance_resume_is_bitwise(tmp_path):
    """Die at step 7, resume -> the same losses as the uninterrupted run,
    bitwise (as ``tests/test_training.py`` holds the JAX launcher)."""
    args = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "12", "--global-batch", "2", "--seq-len", "16", "--ckpt-every",
            "4", "--log-every", "100"]
    seen = []
    full = train_run(args + ["--ckpt-dir", str(tmp_path / "a")],
                     on_step=lambda step, p, m, s: seen.append(step))
    assert seen == list(range(12))
    with pytest.raises(SystemExit):
        train_run(args + ["--ckpt-dir", str(tmp_path / "b"),
                          "--die-at-step", "7"])
    resumed = train_run(args + ["--ckpt-dir", str(tmp_path / "b"),
                                "--resume", "auto"])
    assert len(resumed) == 8                  # from step 4
    np.testing.assert_array_equal(np.asarray(full[-4:]),
                                  np.asarray(resumed[-4:]))
    a = CheckpointManager(str(tmp_path / "a")).restore_latest()
    b = CheckpointManager(str(tmp_path / "b")).restore_latest()
    _same_trees(a, b)


# --------------------------------------------------------------------------
# serving from a checkpoint
# --------------------------------------------------------------------------
def test_engine_checkpoint_matches_params(tmp_path):
    """A checkpoint the port's trainer wrote serves what the same params
    serve, and the provider passes ``checkpoint=`` to its engine."""
    args = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "3", "--global-batch", "2", "--seq-len", "16", "--ckpt-dir",
            str(tmp_path)]
    last = {}
    train_run(args, on_step=lambda step, p, m, s: last.update(params=p))
    cfg = get_smoke_config("olmo-1b")
    from_ckpt = ServingEngine(cfg, checkpoint=str(tmp_path), device="cpu")
    _same_trees(from_ckpt.params, last["params"])
    given = ServingEngine(cfg, params=last["params"], device="cpu")
    prompts = [[5, 6, 7, 8], list(range(40, 80))]
    assert ([from_ckpt.generate(p, 8) for p in prompts]
            == [given.generate(p, 8) for p in prompts])
    np.testing.assert_array_equal(from_ckpt.embed_batch(prompts),
                                  given.embed_batch(prompts))
    prov = LocalTorchProvider(checkpoint=str(tmp_path), device="cpu")
    _same_trees(prov.engine.params, last["params"])
    with pytest.raises(FileNotFoundError):
        ServingEngine(cfg, checkpoint=str(tmp_path / "none"), device="cpu")


def test_jax_checkpoint_serves_the_seeded_engines_tokens(tmp_path):
    """A JAX olmo smoke checkpoint (its non-parametric norms' empty
    subtrees are not in the file) served by the port's engine gives the
    tokens of the JAX engine seeded with the same weights (f32)."""
    jcfg = jax_smoke("olmo-1b").replace(**F32)
    jeng = JaxEngine(jcfg, seed=0)
    JaxManager(str(tmp_path)).save(1, {"params": jeng.params})
    teng = ServingEngine(get_smoke_config("olmo-1b").replace(**F32),
                         checkpoint=str(tmp_path), device="cpu")
    assert "ln1" not in teng.params["stages"][0]["b0"]
    prompts = [[1, 2, 3, 4, 5], list(range(60, 100)), [200] * 33]
    for p in prompts:
        assert teng.generate(p, 10) == jeng.generate(p, 10)
