"""The port's sharded serving runs of ``tests/test_torch_sharded_serving.py``,
in one process per rank over gloo on the CPU (``repro_torch.launch.mesh.
run_processes``).  Started by the test as

    python -c "import torch_sharded_serving_cases as C; C.main(dir)"

with ``src`` and ``tests`` on the path; ``dir`` holds each case's weights
(``params_<case>.npz``, drawn by ``write_inputs``) and takes the results
(``port.npz``: logits, next tokens and gathered cache leaves by case;
``port.json``: each cache leaf's placements, local shape and whether its
storage stayed the one the step was given, after every step).

A case (``CASES``) runs what the JAX package's ``build_cell`` wires for a
mesh ("data", "model"): ``make_prefill_step`` over B prompts of
``PROMPT`` tokens into a ``CACHE``-slot cache, then ``steps`` greedy
``make_decode_step`` calls, then, where ``chunk``, one ``prefill_chunk`` of
``CHUNK`` tokens at the per-row offsets ``CHUNK_OFFSETS`` (a chunk that
crosses a sequence shard's edge), or else the embed step
(``make_embed_step(cfg, policy)``) over the prompts.  The reference side
(``REFERENCE`` in the test) runs the same on eight host devices.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

WORLD = 8
PROMPT, CACHE, CHUNK = 20, 64, 8
CHUNK_OFFSETS = (12, 20, 9, 16, 3, 14, 18, 11)
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
# name: (arch, config overrides, mesh, batch, decode steps, chunk)
CASES = {
    "mixtral_b8_2x4": ("mixtral-8x7b", {}, (2, 4), 8, 3, True),
    "mixtral_b8_4x2": ("mixtral-8x7b", {}, (4, 2), 8, 3, True),
    "mixtral_b1_2x4": ("mixtral-8x7b", {}, (2, 4), 1, 3, True),
    # a vocabulary of 250, padded to 252 rows at shard_multiple 4
    "granite_b8_2x4": ("granite-8b", {"vocab_size": 250}, (2, 4), 8, 3, True),
    "granite_b8_4x2": ("granite-8b", {"vocab_size": 250}, (4, 2), 8, 3, True),
    "granite_b1_2x4": ("granite-8b", {"vocab_size": 250}, (2, 4), 1, 3, True),
    "olmo": ("olmo-1b", {}, (2, 4), 8, 1, False),
    "gemma3": ("gemma3-12b", {}, (2, 4), 8, 1, False),
    "qwen": ("qwen1.5-32b", {}, (2, 4), 8, 1, False),
    "deepseek": ("deepseek-moe-16b", {}, (2, 4), 8, 1, False),
    "phi3v": ("phi-3-vision-4.2b", {}, (2, 4), 8, 1, False),
}


def case_config(name):
    """The case's config: the smoke config at ``shard_multiple`` 4 in f32
    (shared by both sides; the reference builds its own from the same
    fields)."""
    from repro_torch.configs import get_smoke_config
    arch, kw, *_ = CASES[name]
    return get_smoke_config(arch).replace(shard_multiple=4, remat=False,
                                          **F32, **kw)


def case_inputs(name):
    """(tokens (B, PROMPT), patches (B, P, d) or None, chunk tokens (B,
    CHUNK), chunk offsets (B,)) from numpy, seeded by the case."""
    cfg = case_config(name)
    B = CASES[name][3]
    rng = np.random.default_rng(sorted(CASES).index(name))
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    patches = None
    if cfg.frontend == "vision":
        patches = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    chunk = rng.integers(0, cfg.vocab_size, (B, CHUNK)).astype(np.int32)
    offsets = np.asarray(CHUNK_OFFSETS[:B], dtype=np.int32)
    return tokens, patches, chunk, offsets


def flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def write_inputs(out: Path):
    """Each case's weights, drawn by the port from a seeded generator and
    saved flat (f32) for both sides."""
    from repro_torch.params import init_params
    for i, name in enumerate(sorted(CASES)):
        params = init_params(case_config(name),
                             torch.Generator().manual_seed(100 + i), "cpu")
        np.savez(out / f"params_{name}.npz",
                 **{k: v.numpy() for k, v in flatten(params).items()})


def _params(out: Path, name, like):
    flat = np.load(out / f"params_{name}.npz")

    def build(t, pre):
        if isinstance(t, dict):
            return {k: build(v, f"{pre}{k}/") for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, f"{pre}{i}/") for i, v in enumerate(t)]
        return torch.from_numpy(flat[pre[:-1]]).to(t.dtype)
    return build(like, "")


def _leaf_record(before, after):
    """Each cache leaf's placements, local shape and whether the step kept
    its storage (``before``: the local tensors' data pointers)."""
    rec = {}
    for k, t in flatten(after).items():
        rec[k] = {"placements": [f"Shard({p.dim})" if hasattr(p, "dim")
                                 else type(p).__name__ for p in t.placements],
                  "local": list(t.to_local().shape),
                  "in_place": (before is not None and before[k]
                               == t.to_local().data_ptr())}
    return rec


def _ptrs(cache):
    return {k: t.to_local().data_ptr() for k, t in flatten(cache).items()}


def run_case(name, out: Path):
    """The case on its mesh: (arrays by key, cache records by step)."""
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.params import init_params
    from repro_torch.serving.steps import (make_decode_step, make_embed_step,
                                           make_prefill_step)
    arch, _, shape, B, steps, chunk = CASES[name]
    cfg = case_config(name)
    mesh = make_process_mesh(shape, ("data", "model"), "cpu")
    policy = S.MeshPolicy(mesh, cfg, B)
    params = S.put(_params(out, name, init_params(cfg, None, "meta")), mesh,
                   S.param_specs(cfg, mesh))
    tokens, patches, chunk_tokens, offsets = case_inputs(name)
    bspecs = S.batch_specs(cfg, mesh, B, "prefill")
    batch = {"tokens": torch.from_numpy(tokens)}
    if patches is not None:
        batch["patches"] = torch.from_numpy(patches)
    batch = S.put(batch, mesh, bspecs)
    res, recs = {}, {}
    o = make_prefill_step(cfg, CACHE, policy)(params, batch)
    cache, pos, tok = o["cache"], o["pos"], o["next_token"]
    res["prefill_logits"] = S.full(o["logits"])
    res["next_0"] = tok
    recs["prefill"] = _leaf_record(None, cache)
    decode = make_decode_step(cfg, policy)
    for i in range(steps):
        before = _ptrs(cache)
        tok_in = S.put_leaf(tok, mesh, S.P(S._dp(mesh, B), None))
        o = decode(params, tok_in, cache, pos + i)
        recs[f"decode_{i}"] = _leaf_record(before, o["cache"])
        cache, tok = o["cache"], o["next_token"]
        res[f"decode_logits_{i}"] = S.full(o["logits"])
        res[f"next_{i + 1}"] = tok
    res.update({f"cache/{k}": v for k, v in
                flatten(S.gather(cache)).items()})
    if chunk:
        before = _ptrs(cache)
        logits, cache = M.prefill_chunk(cfg, params,
                                        torch.from_numpy(chunk_tokens), cache,
                                        torch.from_numpy(offsets), policy)
        recs["chunk"] = _leaf_record(before, cache)
        res["chunk_logits"] = S.full(logits)
        res.update({f"chunk_cache/{k}": v for k, v in
                    flatten(S.gather(cache)).items()})
    else:
        res["embed"] = make_embed_step(cfg, policy)(params, batch)
    return res, recs


def _worker(rank, device, out):
    torch.set_num_threads(1)
    out = Path(out)
    arrays, records = {}, {}
    for name in sorted(CASES):
        res, recs = run_case(name, out)
        arrays.update({f"{name}/{k}": v.numpy() for k, v in res.items()})
        records[name] = recs
    if rank == 0:
        np.savez(out / "port.npz", **arrays)
        (out / "port.json").write_text(json.dumps(records))


CARD_PROMPT, CARD_CACHE, CARD_STEPS = 300, 1024, 4


def _cards_worker(rank, dev, out):
    """The cut mixtral-8x7b (full width, 2 layers, f32) on mesh (1, 4)
    against rank 0's card alone."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as S
    from repro_torch.params import init_params
    from repro_torch.serving.steps import make_decode_step, make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mixtral-8x7b").replace(num_layers=2, **F32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, CARD_PROMPT),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)

    def run(params, policy, batch):
        o = make_prefill_step(cfg, CARD_CACHE, policy)(params, batch)
        logits, toks, launches = [S.full(o["logits"])], [o["next_token"]], []
        cache, pos, tok = o["cache"], o["pos"], o["next_token"]
        decode = make_decode_step(cfg, policy)
        for i in range(CARD_STEPS):
            before = decode_ops.decode_attention.launches
            o = decode(params, tok, cache, pos + i)
            launches.append(decode_ops.decode_attention.launches - before)
            tok = o["next_token"]
            logits.append(S.full(o["logits"]))
            toks.append(tok)
        return logits, toks, launches
    card = run(params, L.NULL_POLICY, {"tokens": tokens}) if rank == 0 \
        else None
    mesh = make_process_mesh((1, 4), ("data", "model"))
    placed = S.put(params, mesh, S.param_specs(cfg, mesh))
    del params
    logits, toks, launches = run(
        placed, S.MeshPolicy(mesh, cfg, 4),
        S.put({"tokens": tokens}, mesh, S.batch_specs(cfg, mesh, 4,
                                                      "prefill")))
    every = [None] * 4
    dist.all_gather_object(every, launches)
    if rank == 0:
        Path(out).write_text(json.dumps({
            "logits_err": [float((a - b).abs().max())
                           for a, b in zip(logits, card[0])],
            "tokens_equal": [bool(torch.equal(a, b))
                             for a, b in zip(toks, card[1])],
            "decode_launches": every}))


def cards_main(out, world=4):
    """The four-card case (NCCL, one process a card)."""
    from repro_torch.launch.mesh import run_processes
    run_processes(_cards_worker, world, None, (str(out),))


def main(out):
    from repro_torch.launch.mesh import run_processes
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    run_processes(_worker, WORLD, "cpu", (str(out),))


if __name__ == "__main__":
    main(sys.argv[1])
