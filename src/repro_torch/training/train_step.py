"""Train and eval steps with optional gradient accumulation (port of
``repro/training/train_step.py``).

Plain functions on the params' tensor tree: the model is not wrapped in
an ``nn.Module``.  Gradients come from ``torch.autograd.grad`` through
``loss_fn`` on the plain route, which launches no kernel, as the JAX
package's training route (``use_pallas=False``) runs no Pallas kernel;
they are in each param's dtype.  Every param of every config reaches the
loss; one that did not would raise here (``jax.grad`` would give it
zeros).  A ``policy`` (``models/sharding.py``'s ``MeshPolicy``) runs the
step over a mesh: the params, the optimizer state and the batch are
``DTensor``s placed by their specs (``launch/train.py``'s
``build_trainer``), the loss and the metrics come back as plain tensors
held alike on every rank.  Differences from the JAX package: no ``jit``;
the microbatches of ``accum_steps`` run in a Python loop where the JAX
package scans them.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NULL_POLICY

from .optimizer import HParams, adamw_update, tree_leaves, tree_map

F32 = torch.float32


def value_and_grad(cfg: ModelConfig, params, batch, policy=NULL_POLICY):
    """((total loss, metrics), grads) of ``M.loss_fn`` at ``params``; the
    grads have the params' tree, the values are detached (plain tensors,
    also under a mesh, where the grads are ``DTensor``s).  Under a
    ``MeshPolicy`` a batch of full tensors is placed by its
    ``batch_specs`` first (a local slice on each rank)."""
    mesh = getattr(policy, "mesh", None)
    if mesh is not None:
        batch = S.put(batch, mesh, S.batch_specs(
            cfg, mesh, batch["tokens"].shape[0], "train"))
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, metrics = M.loss_fn(cfg, live, batch, policy)
        total = S.full(total)
        grads = torch.autograd.grad(total, leaves)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    return ((total.detach(),
             {k: S.full(v).detach() for k, v in metrics.items()}),
            tree_map(lambda p: by_leaf[id(p)], live))


def make_train_step(cfg: ModelConfig, hp: HParams, policy=NULL_POLICY):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    With hp.accum_steps > 1 the global batch is split along the batch dim
    into microbatches run one after another, their f32 grads summed and
    averaged, as the JAX package accumulates them (its metrics keep the
    last microbatch's ``loss``, ``aux_loss`` and ``tokens``)."""

    def train_step(params, opt_state, batch):
        if hp.accum_steps > 1:
            n = hp.accum_steps
            micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                             params)
            l_sum = torch.zeros((), dtype=F32,
                                device=tree_leaves(params)[0].device)
            for i in range(n):
                (lval, aux), g = value_and_grad(
                    cfg, params, {k: v[i] for k, v in micro.items()},
                    policy)
                grads = tree_map(torch.add, grads, g)
                l_sum = l_sum + lval
            grads = tree_map(lambda g: g / n, grads)
            lval = l_sum / n
        else:
            (lval, aux), grads = value_and_grad(cfg, params, batch, policy)
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, hp)
        metrics = {"total_loss": lval, **aux, **opt_metrics}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, policy=NULL_POLICY):
    @torch.no_grad()
    def eval_step(params, batch):
        mesh = getattr(policy, "mesh", None)
        if mesh is not None:
            batch = S.put(batch, mesh, S.batch_specs(
                cfg, mesh, batch["tokens"].shape[0], "train"))
        _, metrics = M.loss_fn(cfg, params, batch, policy)
        return {k: S.full(v) for k, v in metrics.items()}
    return eval_step
