"""The port's mesh runs of ``tests/test_torch_sharding.py``, in one
process per rank over gloo on the CPU (``repro_torch.launch.mesh.
run_processes``).  Started by the test as

    python -c "import torch_sharding_cases as C; C.main(dir)"

with ``src`` and ``tests`` on the path; ``dir`` holds the reference's
bridged weights (``ref_params_<dtype>.npz``) and takes the results
(``port.json``, the elastic run's checkpoint under ``ckpt_<dtype>``, the
gathered state it saved in ``port_state_<dtype>.npz``).

Cases:
  * ``elastic``: the reference's own case (``tests/test_distributed.py``):
    granite-smoke at ``shard_multiple=4``, remat off, lr 1e-3, 6 steps on
    mesh (2, 4) of batches of 8 x 16, a checkpoint after step 3, restored
    onto mesh (4, 2) for steps 3-5; in f32 and in bf16, from the
    reference's ``PRNGKey(0)`` weights;
  * ``families``: two train steps of mixtral-smoke (MoE, the experts'
    d_ff over "model") and of falcon-mamba-smoke (the inner dim over
    "model") on mesh (2, 4) in f32, against the same steps on one device;
    and mixtral-smoke's ``moe_apply`` on a decode batch (8 rows of one
    token: ``dp_size`` 2 groups of 4) against one device with a policy
    of ``dp_size`` 2;
  * ``cards_main``: on four cards under NCCL (``tests/test_torch_gpu.py``),
    two f32 train steps of granite-smoke (KV heads over "model" too)
    and of mixtral-smoke on mesh (2, 2) against the same steps on each
    card alone.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import Shard

from repro_torch.launch.mesh import make_process_mesh, run_processes
from repro_torch.training.optimizer import tree_leaves

WORLD = 8
ELASTIC_STEPS, ELASTIC_SAVE = 6, 3
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _batch(vocab, step, B=8, S=16):
    from repro_torch.training.data import DataConfig, SyntheticTokenPipeline
    b = SyntheticTokenPipeline(DataConfig(vocab, S, B)).batch_at(step)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ref_params(out: Path, dtype: str, cfg):
    """The reference's weights (saved in f32), in the config's dtypes."""
    from repro_torch.params import init_params, load_checkpoint
    like = init_params(cfg, None, "meta")
    tree = load_checkpoint(out / f"ref_params_{dtype}.npz")

    def cast(t, m):
        if isinstance(t, dict):
            return {k: cast(t[k], m[k]) for k in m}
        if isinstance(t, list):
            return [cast(a, b) for a, b in zip(t, m)]
        return t.to(m.dtype)
    return cast(tree, like)


def elastic(rank, out: Path, dtype: str):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as T
    from repro_torch.models import sharding as S
    from repro_torch.training import HParams
    from repro_torch.training.checkpoint import CheckpointManager
    cfg = get_smoke_config("granite-8b").replace(
        remat=False, shard_multiple=4, **(F32 if dtype == "f32" else {}))
    hp = HParams(lr=1e-3, warmup_steps=1, total_steps=10)
    full = _ref_params(out, dtype, cfg)
    ckdir = out / f"ckpt_{dtype}"
    mesh_a = make_process_mesh((2, 4), ("data", "model"), "cpu")
    step_a, (ps_a, os_a) = T.build_trainer(cfg, hp, mesh_a, 8, 16)
    params = S.put(full, mesh_a, ps_a)
    opt = T.place_opt(params, mesh_a, os_a)
    ref = []
    for i in range(ELASTIC_STEPS):
        params, opt, m = step_a(params, opt, _batch(cfg.vocab_size, i))
        ref.append(float(m["loss"]))
        if i + 1 == ELASTIC_SAVE:
            CheckpointManager(ckdir, keep=1).save(
                ELASTIC_SAVE, {"params": params, "opt": opt})
            saved = T.gather({"params": params, "opt": opt})
            if rank == 0:
                from repro_torch.training.checkpoint import _flatten
                np.savez(out / f"port_state_{dtype}.npz", **{
                    k: (v.float() if v.is_floating_point() else v).numpy()
                    for k, v in _flatten(saved).items()})
    mesh_b = make_process_mesh((4, 2), ("data", "model"), "cpu")
    step_b, (ps_b, os_b) = T.build_trainer(cfg, hp, mesh_b, 8, 16)
    state = T.restore_on_mesh(CheckpointManager(ckdir, keep=1), mesh_b,
                              {"params": ps_b, "opt": os_b})
    placed = {k: tuple(v.placements) for k, v in
              (("embed", state["params"]["embed"]),
               ("master_wq",
                state["opt"]["master"]["stages"][0]["b0"]["attn"]["wq"]))}
    params, opt = state["params"], state["opt"]
    cont = []
    for i in range(ELASTIC_SAVE, ELASTIC_STEPS):
        params, opt, m = step_b(params, opt, _batch(cfg.vocab_size, i))
        cont.append(float(m["loss"]))
    # the reference's own checkpoint of its (2, 4) run, onto (4, 2)
    state = T.restore_on_mesh(CheckpointManager(out / f"jax_ckpt_{dtype}"),
                              mesh_b, {"params": ps_b, "opt": os_b})
    params, opt = state["params"], state["opt"]
    from_jax = []
    for i in range(ELASTIC_SAVE, ELASTIC_STEPS):
        params, opt, m = step_b(params, opt, _batch(cfg.vocab_size, i))
        from_jax.append(float(m["loss"]))
    return {"ref": ref, "elastic": cont, "from_jax": from_jax,
            "placements": {k: [f"Shard({p.dim})" if isinstance(p, Shard)
                               else type(p).__name__ for p in v]
                           for k, v in placed.items()}}


def _two_steps(cfg, hp, params, mesh=None):
    """Two train steps from a fresh AdamW state, on one device or over
    ``mesh``: (the first step's gradients, AdamW's ``m`` and ``v`` after
    it, as full tensors; its metrics; the second step's loss)."""
    from repro_torch.launch import train as T
    from repro_torch.models import sharding as S
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.train_step import value_and_grad
    batch, batch2 = (_batch(cfg.vocab_size, i) for i in (0, 1))
    dev = S.gather(params)["embed"].device
    batch, batch2 = ({k: v.to(dev) for k, v in b.items()}
                     for b in (batch, batch2))
    if mesh is None:
        policy, step, opt = None, make_train_step(cfg, hp), adamw_init(params)
    else:
        B, L = batch["tokens"].shape
        step, (ps, os_) = T.build_trainer(cfg, hp, mesh, B, L)
        params = S.put(params, mesh, ps)
        policy, opt = S.MeshPolicy(mesh, cfg, B), T.place_opt(params, mesh,
                                                              os_)
    _, grads = (value_and_grad(cfg, params, batch) if policy is None else
                value_and_grad(cfg, params, batch, policy))
    params, opt, m = step(params, opt, batch)
    # the second step updates the moments in place: copy them first
    moments = {k: [t.clone() for t in tree_leaves(S.gather(opt[k]))]
               for k in ("m", "v")}
    _, _, m2 = step(params, opt, batch2)
    return S.gather(grads), moments, m, float(m2["loss"])


def _held(mesh_run, one_run):
    """The figures ``test_mesh_step_matches_one_device`` holds: each
    step's loss, the first step's grad norm, the gradients and AdamW's
    moments after it (max over leaves of max|a - b| / max|b|)."""
    gm, mm, m1, l2m = mesh_run
    g1, m11, m1_, l21 = one_run
    return {"loss": [float(m1["loss"]), float(m1_["loss"])],
            "loss2": [l2m, l21],
            "grad_norm": [float(m1["grad_norm"]), float(m1_["grad_norm"])],
            "grads_err": _worst(gm, g1),
            "m_err": _worst(mm["m"], m11["m"]),
            "v_err": _worst(mm["v"], m11["v"])}


def _worst(a, b):
    """max over leaves of max|a - b| / max|b|."""
    return max(float((x.float() - y.float()).abs().max()
                     / y.float().abs().max().clamp_min(1e-30))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def families(rank):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as S
    from repro_torch.params import init_params
    from repro_torch.training import HParams
    hp = HParams(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_process_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    for arch in ("mixtral-8x7b", "falcon-mamba-7b"):
        cfg = get_smoke_config(arch).replace(remat=False, **F32)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        one = _two_steps(cfg, hp, params)
        run = _two_steps(cfg, hp, params, mesh=mesh)
        out[arch] = _held(run, one)
        out[arch]["aux_loss"] = [float(run[2]["aux_loss"]),
                                 float(one[2]["aux_loss"])]
    # the decode grouping: 8 rows of one token in dp_size 2 groups of 4
    cfg = get_smoke_config("mixtral-8x7b").replace(**F32)
    moe = init_params(cfg, torch.Generator().manual_seed(1),
                      "cpu")["stages"][0]["b0"]["moe"]
    moe = {k: v[0] for k, v in moe.items()}
    # one token repeated: every row routes alike, so one group of 8 drops
    # what two groups of 4 keep
    x = torch.randn((1, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).repeat(8, 1, 1)

    class TwoGroups(L.NullPolicy):
        dp_size = 2
    y1, aux1 = L.moe_apply(cfg, moe, x, TwoGroups())
    policy = S.MeshPolicy(mesh, cfg, 8)
    specs = S.param_specs(cfg, mesh)["stages"][0]["b0"]["moe"]
    placed = S.put(moe, mesh, {k: s[1:] for k, s in specs.items()})
    ym, auxm = L.moe_apply(cfg, placed, policy(x, "act"), policy)
    ym, auxm = S.full(ym), S.full(auxm)
    one_group, _ = L.moe_apply(cfg, moe, x)
    out["moe_decode"] = {
        "dp_size": policy.dp_size,
        "y_err": float((ym - y1).abs().max() / y1.abs().max()),
        "aux": [float(auxm), float(aux1)],
        "differs_from_one_group": bool(
            not torch.allclose(one_group, y1, atol=1e-6))}
    return out


def _cards_worker(rank, dev, out):
    from repro_torch.configs import get_smoke_config
    from repro_torch.params import init_params
    from repro_torch.training import HParams
    from repro_torch.training.optimizer import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = HParams(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_process_mesh((2, 2), ("data", "model"))
    res = {}
    for arch, kw in (("granite-8b", {"num_kv_heads": 4}),
                     ("mixtral-8x7b", {})):
        cfg = get_smoke_config(arch).replace(remat=False, **F32, **kw)
        params = tree_map(lambda t: t.to(dev), init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        run = _two_steps(cfg, hp, params, mesh=mesh)
        res[arch] = _held(run, _two_steps(cfg, hp, params))
        res[arch]["device"] = str(run[0]["embed"].device)
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def cards_main(out, world=4):
    """The four-card case (NCCL, one process a card)."""
    run_processes(_cards_worker, world, None, (str(out),))


def refusals() -> dict:
    """What ``make_process_mesh`` raises for a shape the group does not
    fill and for the cards where there are none."""
    out = {}
    for name, call in (
            ("ranks", lambda: make_process_mesh((4, 4), ("data", "model"),
                                                "cpu")),
            ("cuda", lambda: make_process_mesh((2, 4), ("data", "model")))):
        try:
            call()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


def _worker(rank, device, out):
    torch.set_num_threads(1)
    out = Path(out)
    res = {"elastic": {d: elastic(rank, out, d) for d in ("f32", "bf16")},
           "families": families(rank), "refusals": refusals()}
    if rank == 0:
        (out / "port.json").write_text(json.dumps(res))


def main(out):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    run_processes(_worker, WORLD, "cpu", (str(out),))


if __name__ == "__main__":
    main(sys.argv[1])
