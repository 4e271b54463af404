"""Training launcher: data, checkpoint/resume, fault tolerance (port of
``repro/launch/train.py``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --device cpu --steps 50 --ckpt-dir /tmp/ck --resume auto
  (without ``--device`` the same entry point runs on the GPU; without
  ``--smoke`` at the architecture's full width.)

Fault tolerance drill: run N steps -> die (``--die-at-step``) -> rerun
with ``--resume auto`` -> the losses continue bitwise, because data
batches are pure functions of the step and the checkpoint stores
(params, opt, step).

Differences from the JAX package: ``--device`` (default: the GPU, as
every entry point of the port, ``repro_torch.device``) and ``--layers``
(cut the depth to that many layers; 0 keeps the config's); weights are
the port's draw (``repro_torch.params.init_params`` from ``--seed``), not
``jax.random``'s; the straggler watchdog times each step to the loss on
the host (the JAX trainer times the step's dispatch); ``run`` also takes
``on_step``, called after each step with (step, params, metrics, step
seconds).  ``run`` has no mesh flag, as the JAX package's has none.

Over a mesh (``build_trainer(cfg, hp, mesh=...)``, ``mesh`` a
``launch.mesh.ProcessMesh``, called on every rank): the step takes the
params and the optimizer state as ``DTensor``s placed by the returned
specs (``sharding.put`` slices a full tree, held alike on every rank,
locally; ``place_opt`` builds a fresh state on the mesh) and the batch in full on every rank (placed by
``batch_specs`` inside the step), and returns them placed the same way,
as the reference's ``in_shardings`` and ``out_shardings`` place them.
``gather`` takes a placed tree back to full tensors.  A checkpoint saves
full tensors from rank 0 (``CheckpointManager.save`` gathers a
``DTensor`` state leaf by leaf) and ``restore_on_mesh`` reads one back
onto any mesh, leaf by leaf: a checkpoint written on one mesh restores
on another, and in either package.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import sharding as S
from repro_torch.params import init_params
from repro_torch.training import HParams, adamw_init, make_train_step
from repro_torch.training.optimizer import F32, opt_specs
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import (DataConfig, StragglerWatchdog,
                                       SyntheticTokenPipeline)


def param_shapes(cfg):
    """The params' tree on the meta device: shapes without storage (the
    reference's ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, None, "meta")


def build_trainer(cfg, hp, mesh=None, global_batch=8, seq_len=64):
    """Returns (train_step_fn, None) on one device, or over ``mesh``
    (train_step_fn, (pspecs, ospecs)): the params' and the optimizer
    state's specs (ZeRO-1)."""
    if mesh is None:
        return make_train_step(cfg, hp), None
    policy = S.MeshPolicy(mesh, cfg, global_batch)
    pspecs = S.param_specs(cfg, mesh)
    ospecs = opt_specs(pspecs, param_shapes(cfg), mesh)
    inner = make_train_step(cfg, hp, policy)

    def step(params, opt, batch):
        params = S.put(params, mesh, pspecs)
        opt = S.put(opt, mesh, ospecs)
        return inner(params, opt, batch)
    return step, (pspecs, ospecs)


def place_opt(params, mesh, ospecs):
    """A fresh AdamW state (``adamw_init``) for placed or full ``params``,
    built leaf by leaf on the mesh by ``ospecs``: each rank holds only its
    ZeRO-1 shards of the master weights and moments."""
    master = S.map_specs(
        lambda p, spec: S.put_leaf(p.detach().to(F32), mesh, spec), params,
        ospecs["master"])
    zeros = [S.map_specs(lambda m, _: torch.zeros_like(m), master, ospecs[k])
             for k in ("m", "v")]
    return {"step": torch.zeros((), dtype=torch.int32, device=mesh.device),
            "master": master, "m": zeros[0], "v": zeros[1]}


def restore_on_mesh(mgr, mesh, specs, step=None):
    """A checkpoint of ``mgr`` (the latest, or ``step``) read leaf by leaf
    onto ``mesh``; ``specs``: {"params": pspecs, "opt": ospecs}."""
    step = mgr.latest_step() if step is None else step
    return mgr.restore(step, mesh.device,
                       place=S.placer(mesh, specs, mesh.device))


gather = S.gather


def run(argv=None, on_step=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--die-at-step", type=int, default=-1,
                    help="simulate a node failure (fault-tolerance drill)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    hp = HParams(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                 total_steps=args.steps, accum_steps=args.accum_steps)
    step_fn, _ = build_trainer(cfg, hp)

    data = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed))

    params = init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt = adamw_init(params)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume == "auto" and mgr.latest_step() >= 0:
        del params, opt
        state = mgr.restore_latest(dev)
        params, opt = state["params"], state["opt"]
        start_step = int(mgr.latest_step())
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    watchdog = StragglerWatchdog()
    losses = []
    for step in range(start_step, args.steps):
        if step == args.die_at_step:
            print(f"[failure-drill] dying at step {step} (simulated)")
            raise SystemExit(42)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        watchdog.start()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        straggled = watchdog.stop()
        losses.append(loss)
        if on_step is not None:
            on_step(step, params, metrics, watchdog.times[-1])
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"med_step {watchdog.median_s * 1e3:.0f}ms"
                  + (" [STRAGGLER]" if straggled else ""), flush=True)
        if mgr and ((step + 1) % args.ckpt_every == 0
                    or step == args.steps - 1):
            mgr.save(step + 1, {"params": params, "opt": opt},
                     {"arch": cfg.name, "loss": loss})
    return losses


if __name__ == "__main__":
    run()
