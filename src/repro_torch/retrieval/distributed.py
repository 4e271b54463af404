"""Mesh-sharded corpus scan: the hybrid-search vector index past one card
(port of ``repro/retrieval/distributed.py``).

The paper's Query 3 scans every passage embedding; a corpus larger than
one card shards across a mesh (``repro_torch.launch.mesh``).  Corpus rows
split into contiguous shards over the mesh's corpus axes, one shard a
device, in the reference's order and sizes: ``rows_local = ceil(N /
shards)`` rows each, the last shard shorter, a shard empty when N <
shards.  ``make_sharded_topk(mesh, k)`` binds the scan: the queries are
normalised once and copied to each shard's device, each shard runs the
block-max prune of ``kernels/topk_sim`` on its own card
(``topk_normalised``: the kernel on a CUDA shard, its plain version on a
CPU one), and only the (Q, shards * kl) candidates, ``kl = min(k,
rows_local)``, move to the mesh's first device, where one stable sort
merges them.  That copy is the payload of the reference's all-gather.

The mesh is single-controller, as the reference's: this process launches
every shard's work in turn without a host sync, so the cards run at
once, and the candidates move by device-to-device copies, with no
process group.  PyTorch orders a copy between two cards after the work
already queued on both, so the queries go to every card before any scan
and the candidates come back after every scan is queued: a copy between
two shards' scans would make each card wait for the one before.

Differences from the JAX package: the bound scan takes the placed shards
(``shard_corpus``), whose rows are already unit-norm, and does not
normalise or copy the corpus per call (the reference normalises the whole
corpus inside every call); its scores differ from the single-card
route's (which normalises the index's rows once more) by an ulp of that
normalisation.  Ties come in (score desc, id asc) order: within a shard
``topk_normalised`` gives it, and the merge keeps it because the
candidates are concatenated in shard order, that is in id order, and
sorted stably (the reference's final ``lax.top_k`` may break a tie
between shards either way).  ``block`` is kept for the reference's
signature: the shard-local prune uses the kernel's ``block_n``, and the
result depends on neither.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.topk_sim.ops import topk_normalised

F32 = torch.float32


def _normalise(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-9)


def sharded_topk(corpus, queries, k: int):
    """corpus: (N, D); queries: (Q, D).  Returns (scores (Q, k), indices
    (Q, k)) in (score desc, id asc) order: normalise, an f32 product, a
    stable sort.  The plain formulation, and the oracle of the sharded
    route."""
    s = _normalise(queries).to(F32) @ _normalise(corpus).to(F32).T
    k = min(k, corpus.shape[0])
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    return top_s[:, :k], top_i[:, :k]


def _flat_axes(mesh, corpus_axes) -> tuple:
    axes = corpus_axes or tuple(mesh.axis_names)
    if isinstance(axes, str):
        axes = (axes,)
    flat = []
    for a in axes:
        flat.extend(a if isinstance(a, (tuple, list)) else (a,))
    return tuple(flat)


def shard_devices(mesh, corpus_axes=None) -> list:
    """The device of each corpus shard, by shard index: the shard index
    runs over the corpus axes in their given order (the first slowest), as
    the reference's ``axis_index`` sum; along the mesh's other axes, where
    the reference replicates a shard, the port keeps one copy, at index 0."""
    axes = _flat_axes(mesh, corpus_axes)
    names = list(mesh.axis_names)
    order = [names.index(a) for a in axes] + [
        i for i, n in enumerate(names) if n not in axes]
    devs = np.transpose(mesh.devices, order)
    n = math.prod(devs.shape[:len(axes)])
    return list(devs.reshape(n, -1)[:, 0])


def shard_bounds(n_rows: int, n_shards: int) -> list:
    """[(start, stop)] of each shard: ``ceil(n_rows / n_shards)`` rows
    each, the last shorter, the trailing ones empty when there are fewer
    rows than shards."""
    rows_local = -(-n_rows // n_shards)
    return [(min(s * rows_local, n_rows), min((s + 1) * rows_local, n_rows))
            for s in range(n_shards)]


def shard_corpus(mesh, vectors, corpus_axes=None) -> list:
    """Split the rows of ``vectors`` (numpy or a tensor, (N, D)) into the
    mesh's corpus shards and copy each to its device, as f32.  A shard is
    a view of the rows until it is copied, so no device and no host
    buffer holds a second whole corpus."""
    devices = shard_devices(mesh, corpus_axes)
    t = torch.from_numpy(vectors) if isinstance(vectors, np.ndarray) \
        else vectors
    return [t[a:b].to(device=d, dtype=F32)
            for (a, b), d in zip(shard_bounds(t.shape[0], len(devices)),
                                 devices)]


def merge_candidates(cand_s, cand_i, k: int):
    """The top ``k`` of the gathered (Q, shards * kl) candidates, in
    (score desc, id asc) order: the shards' candidates come in id order
    and each shard's in that order, so a stable sort keeps it."""
    top_s, at = torch.sort(cand_s, dim=1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(cand_i, 1, at[:, :k])


def make_sharded_topk(mesh, k: int, *, corpus_axes=None, block: int = 2048):
    """Bind the sharded scan over ``mesh``: ``fn(shards, queries) ->
    (scores (Q, k) f32, ids (Q, k) int32)`` on the mesh's first device.
    ``shards`` are ``shard_corpus(mesh, unit_rows, corpus_axes)``;
    ``queries`` (Q, D) on any device.  ``k`` is capped at N."""
    del block            # the reference's signature (module docstring)
    devices = shard_devices(mesh, corpus_axes)
    first = mesh.devices.flat[0]

    def fn(shards, queries):
        if len(shards) != len(devices):
            raise ValueError(f"sharded topk: {len(shards)} shards for a "
                             f"mesh of {len(devices)}")
        N = sum(s.shape[0] for s in shards)
        bounds = shard_bounds(N, len(devices))
        if [s.shape[0] for s in shards] != [b - a for a, b in bounds]:
            raise ValueError("sharded topk: shards not in shard_corpus's "
                             "layout")
        Q = queries.shape[0]
        kk = min(k, N)
        if kk == 0 or Q == 0:
            return (torch.zeros((Q, kk), dtype=F32, device=first),
                    torch.zeros((Q, kk), dtype=torch.int32, device=first))
        kl = min(kk, -(-N // len(devices)))
        qn = _normalise(queries.to(F32))
        # queries out, scans, candidates back: three passes, no host sync
        # and no copy between two scans (module docstring)
        q_on = {dev: qn.to(dev, non_blocking=True) for dev in devices}
        local = []
        for shard, dev, (start, _) in zip(shards, devices, bounds):
            s, i = topk_normalised(shard, q_on[dev], kl)
            i = i + start
            pad = kl - s.shape[1]        # a short or empty shard: never
            if pad:                      # chosen, as kk <= real candidates
                s = torch.cat([s, torch.full((Q, pad), float("-inf"),
                                             dtype=F32, device=dev)], 1)
                i = torch.cat([i, torch.full((Q, pad), -1,
                                             dtype=torch.int32,
                                             device=dev)], 1)
            local.append((s, i))
        cand_s = torch.cat([s.to(first, non_blocking=True)
                            for s, _ in local], 1)
        cand_i = torch.cat([i.to(first, non_blocking=True)
                            for _, i in local], 1)
        return merge_candidates(cand_s, cand_i, kk)

    return fn
