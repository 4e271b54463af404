"""AdamW with f32 master weights (port of ``repro/training/optimizer.py``).

Live params stay in their dtype (bf16 in the configs); the optimizer
state carries an f32 master copy and the first and second moments, under
the JAX package's keys (``step``, ``master``, ``m``, ``v``), so the
``opt`` subtree of a checkpoint restores in either package.  Trees are the
params' nested dicts and lists of tensors; leaves are visited in
``jax.tree`` order (dict keys sorted), so sums over leaves add in the JAX
package's order.

ZeRO-1 over a mesh: ``opt_specs`` adds a "data" axis on the first
evenly divisible replicated dim of each tensor's spec (``_zero1_spec``),
so the 12 bytes/param of the state are spread over the whole mesh
rather than the model axis alone.  With the state placed by those specs
(``DTensor``s, ``models/sharding.py``), ``adamw_update`` redistributes
each gradient to its state's placement (a reduce-scatter over "data"
where the gradient is a partial sum, a local slice where it is
replicated), updates ``master``, ``m`` and ``v`` on their shards, and
redistributes the new master, cast to the param's dtype, to the param's
placement (an all-gather over "data"): what GSPMD materialises from the
JAX trainer's in and out shardings.

Differences from the JAX package: ``adamw_update`` writes the new
moments and master weights into the state it is given and returns that
state (the JAX trainer donates the old state to its jitted step, which
amounts to the same); the new params are fresh tensors.  The step
counter stays a plain tensor on every rank under a mesh.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import map_specs

F32 = torch.float32


@dataclass(frozen=True)
class HParams:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    accum_steps: int = 1             # gradient-accumulation microbatches


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree, dict keys in sorted order
    (``jax.tree.leaves``'s order); empty dicts have none."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


@functools.lru_cache(maxsize=None)
def _cosf():
    """The C library's single-precision cosine, which XLA's CPU backend
    calls for an f32 ``cos`` (``None`` where no C math library is found;
    the cosine is then the double one rounded to f32)."""
    name = ctypes.util.find_library("m")
    if name is None:
        return None
    fn = ctypes.CDLL(name).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _cos_f32(x: np.float32) -> np.float32:
    fn = _cosf()
    return np.float32(fn(x) if fn is not None else math.cos(x))


def lr_schedule(hp: HParams, step):
    """Linear warmup, then cosine decay to 10% of ``hp.lr``: the JAX
    package's f32 arithmetic, op for op, on the host (numpy f32 scalars,
    the cosine as the C library's ``cosf``), so the rate is the JAX
    package's bit for bit on the CPU.  Returns an f32 0-d tensor on
    ``step``'s device (a tensor ``step`` is read once, a sync on the
    card)."""
    f = np.float32
    s = f(int(step))
    warm = s / f(max(hp.warmup_steps, 1))
    prog = np.clip((s - f(hp.warmup_steps))
                   / f(max(hp.total_steps - hp.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1) + _cos_f32(f(math.pi) * prog))
    lr = f(hp.lr) * np.minimum(warm, f(1)) * np.maximum(cos, f(0.1))
    return torch.tensor(lr, dtype=F32,
                        device=step.device if torch.is_tensor(step) else None)


def adamw_init(params):
    return {
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
        "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                            device=p.device), params),
    }


def global_norm(tree):
    """sqrt of the sum over leaves (in tree order) of their sums of
    squares; a ``DTensor`` leaf's sum is gathered to a plain scalar."""
    total = 0
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(F32)))
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, hp: HParams):
    """One AdamW step: clip by the global norm, update the f32 moments and
    master weights (in ``state``, in place), cast the master back to each
    param's dtype.  Returns (new params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = lr_schedule(hp, step)
    grads = tree_map(_to_state_placement, grads, state["master"])
    gnorm = global_norm(grads)
    scale = torch.clamp_max(hp.grad_clip / (gnorm + 1e-9), 1.0)
    bc1 = 1 - hp.b1 ** step.to(F32)
    bc2 = 1 - hp.b2 ** step.to(F32)

    def upd(p, g, m, v, master):
        g = g.to(F32) * scale
        m.mul_(hp.b1).add_((1 - hp.b1) * g)
        v.mul_(hp.b2).add_((1 - hp.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
        master.sub_(lr * (u + hp.weight_decay * master))
        new = master.to(p.dtype, copy=True)
        if isinstance(p, DTensor) and new.placements != p.placements:
            new = new.redistribute(p.device_mesh, p.placements)
        return new

    new_params = tree_map(upd, params, grads, state["m"], state["v"],
                          state["master"])
    state["step"] = step
    return new_params, state, {"grad_norm": gnorm, "lr": lr}


def _to_state_placement(g, master):
    """A gradient redistributed to its optimizer state's placement (a
    reduce-scatter or a local slice under ZeRO-1); a plain one as it is."""
    if isinstance(master, DTensor) and tuple(g.placements) != tuple(
            master.placements):
        return g.redistribute(master.device_mesh, master.placements)
    return g


def _zero1_spec(spec, shape, data_size: int):
    """Add 'data' on the first replicated dim that divides evenly."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (s, n) in enumerate(zip(entries, shape)):
        if s is None and n % data_size == 0 and n >= data_size:
            entries[i] = "data"
            break
    return tuple(entries)


def opt_specs(param_spec_tree, param_shapes, mesh):
    """Optimizer-state specs (ZeRO-1 over the 'data' axis).
    ``param_shapes``: the params' tree of tensors (``device="meta"`` will
    do)."""
    data_size = mesh.shape["data"]
    sharded = map_specs(lambda t, spec: _zero1_spec(spec, t.shape, data_size),
                        param_shapes, param_spec_tree)
    return {"step": (), "master": sharded, "m": sharded, "v": sharded}
