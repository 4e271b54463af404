"""granite-8b trained over the four cards of one host: the port's sharded
model (``repro_torch.models.sharding``), ZeRO-1 and ``build_trainer(mesh=)``
in one process per card under NCCL.

    python3 tools/sharded_train_cards.py --ckpt-dir DIR

Three phases, each on every card:

(a) ``cut``: granite-8b at full width cut to 2 layers (0.84 B
    parameters) in f32.  Rank 0 runs 2 steps of 8 x 512 tokens on its
    card alone; then the same 2 steps run on meshes (1, 4), (2, 2) and
    (4, 1) from the same weights (drawn on each card from one seed,
    checked alike by a checksum).  Each mesh's losses are held to the
    card's at ``LOSS_RTOL`` 1e-5, its first step's gradients and grad
    norm and every weight after the 2 steps to ``GRAD_TOL`` 1e-4 of each
    leaf's largest magnitude (the trainer's tolerances,
    ``tests/test_torch_training.py``).  Then the same in bf16, the losses
    at 1e-3 relative.
(b) ``full``: granite-8b at full width and depth (36 layers, 8.25 B
    parameters, bf16, remat) trains 6 steps of 8 x 512 on mesh (1, 4),
    then on (2, 2), from the same weights.  Each step's loss, grad norm
    and wall (host clock, the cards synchronised) and each card's peak
    memory; the bytes each card holds of parameters, gradients (as the
    step's backward hands them to AdamW) and optimizer state, beside the
    count the specs give, and the card's share of the whole state
    (params, grads, master, m, v: 16 bytes a parameter, 132 GB).  Fails
    on a non-finite loss, on a card whose param or optimizer bytes are
    not the specs' count, whose optimizer state is not a quarter of the
    whole (ZeRO-1 over "data" and "model"), or, on (1, 4), whose whole
    state is not a quarter (on (2, 2) the params and grads are halves:
    ZeRO-1 shards only the optimizer state over "data").
(c) ``elastic``: the (2, 2) run of (b) saves a checkpoint after step 3
    (full tensors from rank 0, ``CheckpointManager``); it is restored
    onto (1, 4) and trains steps 3-5, whose losses must match the
    uninterrupted run's at 1e-3 relative (the reference's
    ``test_elastic_reshard_continues_training``).  Save and restore are
    timed; the checkpoint (115.5 GB) goes to ``--ckpt-dir`` and is
    deleted after.

The schedule is ``HParams()``'s (lr 3e-4 after 100 warmup steps): the
first steps' rates are 3e-6 and 6e-6, the start of a real run.

Prints one JSON line a record on rank 0, the cards' names and power
limits, and ``{"ok": true, ...}`` last; writes the records to
``--records`` (default ``build/sharded_train_cards.json``).  ``--device
cpu --smoke``
rehearses the same control flow on the CPU over gloo (granite-smoke,
short sequences).
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh, run_processes  # noqa
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.training import HParams, adamw_init  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.data import (DataConfig,  # noqa: E402
                                       SyntheticTokenPipeline)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

WORLD = 4
AXES = ("data", "model")
CUT_MESHES = ((1, 4), (2, 2), (4, 1))
FULL_MESHES = ((1, 4), (2, 2))
ELASTIC_FROM, ELASTIC_TO = (2, 2), (1, 4)
CUT_LAYERS, CUT_STEPS = 2, 2
FULL_STEPS, SAVE_AT = 6, 3
BATCH, SEQ = 8, 512
LOSS_RTOL, GRAD_TOL, BF16_RTOL, ELASTIC_RTOL = 1e-5, 1e-4, 1e-3, 1e-3
SEED = 0
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
RECORDS = []
RECORDS_PATH = [ROOT / "build" / "sharded_train_cards.json"]


def cards_line() -> list:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def log(rank, **rec):
    """One record: printed on rank 0 and the records so far rewritten to
    the records file (a failed run keeps them)."""
    if rank == 0:
        RECORDS.append(rec)
        print(json.dumps(rec), flush=True)
        path = RECORDS_PATH[0]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(RECORDS, indent=1))


def check(ok: bool, what):
    if not ok:
        raise RuntimeError(f"sharded_train_cards: {what}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def base_config(smoke: bool):
    if smoke:        # KV heads over "model" too, as granite-8b's 8
        return get_smoke_config("granite-8b").replace(shard_multiple=4,
                                                      num_kv_heads=4)
    return get_config("granite-8b", shard_multiple=4)


def draw(cfg, dev):
    """The weights from SEED on ``dev``, and a check that every rank drew
    the same (the sum of each leaf's f64 sum, gathered)."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    total = sum(float(t.sum(dtype=torch.float64))
                for t in tree_leaves(params))
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, total)
    check(len(set(sums)) == 1, f"ranks drew different weights: {sums}")
    return params


def batches(cfg, steps, seq, dev):
    data = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, seq, BATCH))
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(i).items()} for i in range(steps)]


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def leafwise_worst(rank, placed_tree, ref_leaves) -> float:
    """The worst leaf's max|mesh - card| / max|card|: each ``DTensor``
    leaf gathered in turn on every rank, compared on rank 0 (whose
    ``ref_leaves`` hold the card's run)."""
    worst = 0.0
    for i, leaf in enumerate(tree_leaves(placed_tree)):
        full = S.full(leaf)
        if rank == 0:
            worst = max(worst, rel_err(full, ref_leaves[i]))
        del full
    return worst


# --------------------------------------------------------------------------
# (a) the cut config on every mesh against one card
# --------------------------------------------------------------------------
def phase_cut(rank, dev, smoke, seq):
    hp = HParams()
    out = {}
    for dtype, kw in (("f32", F32), ("bf16", BF16)):
        cfg = base_config(smoke).replace(num_layers=CUT_LAYERS, **kw)
        params = draw(cfg, dev)
        data = batches(cfg, CUT_STEPS, seq, dev)
        card = None
        if rank == 0:                         # the same steps on one card
            t0 = time.perf_counter()
            _, g1 = TS.value_and_grad(cfg, params, data[0])
            g1 = tree_leaves(g1)
            step = make_train_step(cfg, hp)
            p, o, losses, gnorms = params, adamw_init(params), [], []
            for b in data:
                p, o, m = step(p, o, b)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            card = {"losses": losses, "grad_norms": gnorms,
                    "params": tree_leaves(p), "grads": g1}
            del o
            log(rank, phase="cut", dtype=dtype, mesh="card", losses=losses,
                grad_norms=gnorms, wall_s=time.perf_counter() - t0,
                params=cfg.num_params())
        dist.barrier()
        for shape in CUT_MESHES:
            mesh = make_process_mesh(shape, AXES, dev)
            step, (ps, os_) = T.build_trainer(cfg, hp, mesh, BATCH, seq)
            placed = S.put(params, mesh, ps)
            opt = T.place_opt(placed, mesh, os_)
            rec = {"phase": "cut", "dtype": dtype, "mesh": list(shape)}
            if dtype == "f32":
                _, gm = TS.value_and_grad(cfg, placed, data[0],
                                          S.MeshPolicy(mesh, cfg, BATCH))
                rec["grads_err"] = leafwise_worst(
                    rank, gm, card and card["grads"])
                del gm
            losses, gnorms = [], []
            t0 = time.perf_counter()
            for b in data:
                placed, opt, m = step(placed, opt, b)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            sync(dev)
            rec.update(losses=losses, grad_norms=gnorms,
                       wall_s=time.perf_counter() - t0)
            if dtype == "f32":
                rec["params_err"] = leafwise_worst(
                    rank, placed, card and card["params"])
            if rank == 0:
                lr = [abs(a - b) / abs(b)
                      for a, b in zip(losses, card["losses"])]
                gr = [abs(a - b) / abs(b)
                      for a, b in zip(gnorms, card["grad_norms"])]
                rec.update(loss_rel=max(lr), grad_norm_rel=max(gr))
                log(rank, **rec)
                if dtype == "f32":
                    check(rec["loss_rel"] <= LOSS_RTOL, rec)
                    check(rec["grad_norm_rel"] <= GRAD_TOL, rec)
                    check(rec["grads_err"] <= GRAD_TOL, rec)
                    check(rec["params_err"] <= GRAD_TOL, rec)
                else:
                    check(rec["loss_rel"] <= BF16_RTOL, rec)
            out[f"{dtype}_{shape[0]}x{shape[1]}"] = rec
            del placed, opt
        del params, card
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# (b) full width on (1, 4) and (2, 2); (c) the elastic drill
# --------------------------------------------------------------------------
def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree's tensors (a ``DTensor``'s
    local shard)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def spec_bytes(mesh, spec_tree, shape_tree, itemsize) -> int:
    """The bytes one rank holds of a tree of the shapes in ``shape_tree``
    (tensors or sizes) placed by ``spec_tree``, ``itemsize`` bytes an
    element (a number, or a function of the leaf)."""
    if isinstance(shape_tree, dict):
        return sum(spec_bytes(mesh, spec_tree[k], v, itemsize)
                   for k, v in shape_tree.items())
    if isinstance(shape_tree, (list, tuple)) and not isinstance(
            shape_tree, torch.Size):
        return sum(spec_bytes(mesh, s, v, itemsize)
                   for s, v in zip(spec_tree, shape_tree))
    shape = tuple(shape_tree.shape)
    n = 1
    for d in shape:
        n *= d
    spec = tuple(spec_tree) + (None,) * (len(shape) - len(spec_tree))
    for entry in spec:
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                n //= mesh.shape[name]
    size = itemsize(shape_tree) if callable(itemsize) else itemsize
    return n * size


class GradBytes:
    """Wraps ``adamw_update`` in the train step's module for a run:
    records the bytes this rank holds of the gradients it is handed (the
    backward's placements, before ZeRO-1's redistribution)."""

    def __init__(self):
        self.real = TS.adamw_update
        self.bytes = None

    def __enter__(self):
        def wrapped(params, grads, state, hp):
            if self.bytes is None:
                self.bytes = local_bytes(grads)
            return self.real(params, grads, state, hp)
        TS.adamw_update = wrapped
        return self

    def __exit__(self, *exc):
        TS.adamw_update = self.real


def state_bytes(mesh, cfg, ps, os_, params, opt):
    """Held and counted bytes of this rank's params and optimizer state
    (master, m, v)."""
    shapes = T.param_shapes(cfg)
    size = lambda t: t.element_size()  # noqa: E731
    want_p = spec_bytes(mesh, ps, shapes, size)
    want_o = 3 * spec_bytes(mesh, os_["master"], shapes, 4)
    have_o = sum(local_bytes(opt[k]) for k in ("master", "m", "v"))
    whole_o = 3 * 4 * sum(t.numel() for t in tree_leaves(shapes))
    whole_p = sum(t.numel() * t.element_size() for t in tree_leaves(shapes))
    return {"params": local_bytes(params), "params_specs": want_p,
            "opt": have_o, "opt_specs": want_o, "opt_whole": whole_o,
            "params_whole": whole_p}


def train_on(rank, dev, cfg, shape, data, steps, params=None, opt=None,
             save=None):
    """``steps`` (indices into ``data``) on a fresh mesh of ``shape``;
    the weights drawn (``params`` None) or given placed.  Returns the
    records, the per-card memory and bytes."""
    mesh = make_process_mesh(shape, AXES, dev)
    hp = HParams()
    step, (ps, os_) = T.build_trainer(cfg, hp, mesh, BATCH,
                                      data[0]["tokens"].shape[1])
    if params is None:
        full = draw(cfg, dev)
        params = S.put(full, mesh, ps)
        del full
        opt = T.place_opt(params, mesh, os_)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    held = state_bytes(mesh, cfg, ps, os_, params, opt)
    losses = []
    with GradBytes() as gb:
        for i in steps:
            sync(dev)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, data[i])
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            sync(dev)
            wall = time.perf_counter() - t0
            log(rank, phase="full", mesh=list(shape), step=i, loss=loss,
                grad_norm=gnorm, lr=float(m["lr"]), wall_s=wall)
            check(math.isfinite(loss), (shape, i, loss))
            losses.append(loss)
            if save is not None and i + 1 == SAVE_AT:
                t0 = time.perf_counter()
                CheckpointManager(save, keep=1).save(
                    SAVE_AT, {"params": params, "opt": opt},
                    {"arch": cfg.name, "mesh": list(shape)})
                log(rank, phase="elastic", save_s=time.perf_counter() - t0,
                    mesh=list(shape))
    held["grads"] = gb.bytes
    held["grads_specs"] = held["params_specs"]
    held["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, held)
    whole = 2 * cards[0]["params_whole"] + cards[0]["opt_whole"]
    share = [(c["params"] + c["grads"] + c["opt"]) / whole for c in cards]
    log(rank, phase="full", mesh=list(shape), cards=cards,
        state_gb=[s * whole / 1e9 for s in share], whole_gb=whole / 1e9,
        state_share=share)
    if rank == 0:
        for r, c in enumerate(cards):
            check(c["params"] == c["params_specs"], (r, c))
            check(c["opt"] == c["opt_specs"], (r, c))
            check(abs(c["opt"] / c["opt_whole"] - 0.25) < 0.01, (r, c))
            if shape[1] == WORLD:       # all of it over "model"
                check(abs(share[r] - 0.25) < 0.01, (r, share))
    return losses, cards, mesh, (ps, os_), params, opt


def phase_full(rank, dev, smoke, seq, ckdir):
    cfg = base_config(smoke)
    data = batches(cfg, FULL_STEPS, seq, dev)
    runs = {}
    for shape in FULL_MESHES:
        save = ckdir if shape == ELASTIC_FROM else None
        losses, cards, *_ , params, opt = train_on(
            rank, dev, cfg, shape, data, range(FULL_STEPS), save=save)
        runs[f"{shape[0]}x{shape[1]}"] = {"losses": losses, "cards": cards}
        del params, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # (c) the drill: the (2, 2) checkpoint restored onto (1, 4)
    mesh = make_process_mesh(ELASTIC_TO, AXES, dev)
    _, (ps, os_) = T.build_trainer(cfg, HParams(), mesh, BATCH, seq)
    t0 = time.perf_counter()
    state = T.restore_on_mesh(CheckpointManager(ckdir, keep=1), mesh,
                              {"params": ps, "opt": os_})
    sync(dev)
    log(rank, phase="elastic", restore_s=time.perf_counter() - t0,
        mesh=list(ELASTIC_TO), step=int(state["opt"]["step"]))
    cont, *_ = train_on(rank, dev, cfg, ELASTIC_TO, data,
                        range(SAVE_AT, FULL_STEPS), params=state["params"],
                        opt=state["opt"])
    want = runs[f"{ELASTIC_FROM[0]}x{ELASTIC_FROM[1]}"]["losses"][SAVE_AT:]
    rel = [abs(a - b) / abs(b) for a, b in zip(cont, want)]
    log(rank, phase="elastic", continued=cont, uninterrupted=want,
        loss_rel=max(rel))
    check(max(rel) <= ELASTIC_RTOL, (cont, want))
    runs["elastic"] = {"continued": cont, "uninterrupted": want}
    return runs


def worker(rank, dev, args):
    RECORDS_PATH[0] = Path(args.records)
    torch.manual_seed(SEED)
    phase_cut(rank, dev, args.smoke, args.seq)
    phase_full(rank, dev, args.smoke, args.seq, args.ckpt_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="",
                    help="where (c) writes its checkpoint (default: a "
                         "temporary directory under build/)")
    ap.add_argument("--device", default=None,
                    help="'cpu' rehearses over gloo (default: the cards)")
    ap.add_argument("--smoke", action="store_true",
                    help="granite-smoke instead of granite-8b")
    ap.add_argument("--records", default=str(RECORDS_PATH[0]),
                    help="where the JSON records go")
    ap.add_argument("--seq", type=int, default=SEQ)
    args = ap.parse_args(argv)
    if args.device is None:
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu to rehearse)")
        if torch.cuda.device_count() < WORLD:
            sys.exit(f"needs {WORLD} cards, {torch.cuda.device_count()} "
                     "visible")
    made = not args.ckpt_dir
    if made:
        (ROOT / "build").mkdir(exist_ok=True)
        args.ckpt_dir = tempfile.mkdtemp(prefix="sharded_train_",
                                         dir=ROOT / "build")
    t0 = time.perf_counter()
    try:
        run_processes(worker, WORLD, args.device, (args,))
    finally:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    print(json.dumps({"wall_s": time.perf_counter() - t0}))
    if args.device is None:
        for line in cards_line():
            print(line)
    kind = (torch.cuda.get_device_name(0) if args.device is None
            else "cpu")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if args.device is None else "cpu", "kind": kind,
        "count": torch.cuda.device_count() if args.device is None
        else WORLD}}))


if __name__ == "__main__":
    main()
