"""mixtral-8x7b served over the four cards of one host: the port's sharded
serving steps (``make_prefill_step`` and ``make_decode_step`` under a
``MeshPolicy``, the sequence-sharded KV cache, the decode kernel on each
card's shard merged across the cards) in one process per card under
NCCL.

    python3 tools/sharded_serve_cards.py [--records PATH]

mixtral-8x7b (46.7 B parameters, 93.4 GB in bf16) fits no single card.
Its prompts are 4 x 12,000 tokens into a cache of
``SHAPES["decode_32k"].seq_len`` = 32,768 slots: on mesh (1, 4) each card
holds 8,192 positions, so the window of 4,096 spans shards 0 and 1 and
shards 2 and 3 hold no valid key (the merge of empty shards).  The
weights are drawn one layer at a time from one seed on every card (each
card keeps only its shards at full depth).

(a) ``cut``: mixtral at full width cut to 2 layers (3.2 B parameters),
    in f32, then in bf16 dropless (``dropless``).  Rank 0 runs the steps
    on its card alone (``NULL_POLICY``): the prefill, then 16 greedy
    decode steps.  The same steps run on meshes (1, 4), (2, 2) and
    (4, 1) from the same weights, teacher-forced on the card's tokens.
    The MoE decode groups by the data axis's size (C.12), so the card's
    steps for a mesh group alike (a null policy of that ``dp_size``).
    Every MoE layer's top-k experts are recorded on both sides, so that
    a route that flips near a tie can be told from a fault.  Held in f32:
    the prefill's and each decode step's logits within 1e-4, the greedy
    tokens exact, every cache leaf after the steps, gathered, within 1e-4
    of its largest magnitude.  Held in bf16: the logits as the repo holds
    bf16 logits at ``LOGITS_TOL`` 6e-2 (``|a - b| <= LOGITS_TOL (1 +
    |b|)``; the bf16 spacing of a logit near 4.5 is 0.03), the tokens
    logged; each cache leaf layer by layer, every position within
    ``CACHE_TOL`` 2e-2 of the leaf's largest magnitude unless the token
    at that position took other experts in an earlier layer (layer 0's
    K/V precede every route, so none of it may differ); and each card's
    decode-kernel call (its shard's range form, with the lse) against the
    plain version on the same inputs (o at ``TOLS`` 2e-2, lse at 1e-3).
(b) ``full``: mixtral at full width and depth (32 layers, bf16), dropless
    (a prefill row of 12,000 tokens could drop assignments that a decode
    group of 4 keeps, and the full-sequence forward below could not stand
    in for the steps), on (1, 4) then (2, 2): the prefill, 16 greedy
    decode steps, then the decode logits held to teacher forcing on the
    same mesh (the full-sequence forward over prompt and generated
    tokens, at each generated position; no single card can give the
    reference): every (row, step) whose token took the same experts in
    every layer on both sides within ``LOGITS_TOL`` as above, at least
    one such pair, the others logged with their flips; then 4 steps at
    temperature 0.7 from a seeded generator (valid ids) and one at
    temperature 0 against greedy.  Logged per card: the bytes of params
    and cache beside the specs' count (fails unless equal), the peak
    memory, the prefill's wall; per decode step: the wall, the
    device-busy share from ``torch.profiler`` (one trace over the steps,
    cut into steps at a marker kernel) and the decode and flash launches
    (fails unless 32 decode launches a step and 32 flash a prefill).

A failed check is printed and the run goes on; the run fails at its
end if any check failed (a rank that raises exits at once, so the others
cannot wait for it in a collective).  Prints one JSON line a record on
rank 0, the cards' names and power limits, and ``{"ok": true, ...}``
last; writes the records to ``--records`` (default
``build/sharded_serve_cards.json``).  ``--device cpu --smoke`` rehearses
the same control flow on the CPU over gloo (mixtral-smoke, 40-token
prompts into 128 slots; its bf16 figures are logged only, as the smoke
config's router, d 64, flips near ties).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_range_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.launch.mesh import make_process_mesh, run_processes  # noqa
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving.steps import (make_decode_step,  # noqa: E402
                                       make_prefill_step)
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa
from sharded_train_cards import cards_line, local_bytes, spec_bytes  # noqa

WORLD = 4
AXES = ("data", "model")
ARCH = "mixtral-8x7b"
CUT_MESHES = ((1, 4), (2, 2), (4, 1))
FULL_MESHES = ((1, 4), (2, 2))
BATCH, PROMPT = 4, 12_000
CACHE = SHAPES["decode_32k"].seq_len
SMOKE_PROMPT, SMOKE_CACHE = 40, 128
CUT_LAYERS, CUT_STEPS = 2, 16
FULL_STEPS, SAMPLE_STEPS, TEMPERATURE = 16, 4, 0.7
F32_TOL, LOGITS_TOL = 1e-4, 6e-2
CACHE_TOL = {"f32": 1e-4, "bf16": 2e-2}
KERNEL_TOL, LSE_TOL = 2e-2, 1e-3    # chip_smoke.py's TOLS[bf16], SHARD_LSE_TOL
SEED = 0
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
MARK_CYCLES = 1000       # the marker kernel between profiled steps
# written in PERF.md before the first four-card run
PREDICTED = {"decode_step_device_ms_min": {"1x4": 7.0, "2x2": 13.9},
             "prefill_wall_s": [0.5, 5.0]}
RECORDS = []
RECORDS_PATH = [ROOT / "build" / "sharded_serve_cards.json"]
FAILED = []              # this rank's failed checks, raised at the end


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
    """A failed check is printed and kept: the run goes on to record every
    phase, and fails at its end (``worker``)."""
    if not ok:
        FAILED.append(what)
        print(json.dumps({"failed": str(what)[:4000]}), flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def logits_close(a, b) -> bool:
    """bf16 logits held as the repo holds them at ``LOGITS_TOL``
    (``chip_smoke.compare_decode_rounding``): atol and rtol both."""
    return bool(torch.allclose(a.float(), b.float(), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL))


def base_config(smoke: bool):
    if smoke:
        return get_smoke_config(ARCH).replace(shard_multiple=4)
    return get_config(ARCH)


def dropless(cfg):
    """``cfg`` with the capacity of every dispatch group at its token count
    (``capacity_factor`` = E / top_k): no token loses an expert, as
    Mixtral routes, so the grouping of a decode batch (``dp_size`` groups)
    and of a full sequence (a group a row) cannot change what a token
    computes."""
    return cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)


class DataGroups(L.NullPolicy):
    """The null policy with the MoE decode grouped as a mesh of
    ``dp_size`` data shards groups it (C.12)."""

    def __init__(self, dp_size: int):
        self.dp_size = dp_size


class Routes:
    """``L.moe_route`` wrapped (put in place by ``mock.patch``): between
    ``begin(decode)`` and ``end()`` each call's top-k experts, sorted, are
    kept as (rows, S, K) on the device (a decode group's tokens are
    rows)."""

    def __init__(self):
        self.route, self.calls, self.decode = L.moe_route, None, False

    def __call__(self, cfg, router, x):
        r = self.route(cfg, router, x)
        if self.calls is not None:
            e = r["eidx"].sort(dim=-1).values
            self.calls.append(e.reshape(-1, 1, e.shape[-1]) if self.decode
                              else e)
        return r

    def begin(self, decode: bool):
        self.calls, self.decode = [], decode

    def end(self) -> list:
        calls, self.calls = self.calls, None
        return calls


def all_rows(mesh, calls) -> list:
    """Every rank's recorded routes of its rows, as the whole batch's on
    every rank (the ranks of one data coordinate hold the same rows)."""
    coord = mesh.device_mesh.get_coordinate()[0]
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (coord, [c.cpu() for c in calls]))
    by = dict(got)
    return [torch.cat([by[d][i] for d in sorted(by)])
            for i in range(len(calls))]


def flipped(a, b):
    """(rows, S): the tokens whose top-k experts differ."""
    return (a.to(b.device) != b).any(dim=-1)


class HeldDecode:
    """``decode_ops.decode_attention_range`` wrapped: each call's (o, lse)
    also held against the plain version on the same inputs."""

    def __init__(self):
        self.fn, self.errs = decode_ops.decode_attention_range, []

    def __call__(self, q, k, v, lo, hi, window=0):
        o, lse = self.fn(q, k, v, lo, hi, window=window)
        if window > 0:
            lo = torch.maximum(lo, hi - (window - 1))
        ref, ref_lse = decode_attention_range_ref(q, k, v, lo, hi)
        fin = torch.isfinite(ref_lse)
        self.errs.append((
            float((o.float() - ref.float()).abs().max()),
            float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any()
            else 0.0,
            bool(torch.allclose(o.float(), ref.float(), atol=KERNEL_TOL,
                                rtol=KERNEL_TOL))
            and bool(torch.equal(fin, torch.isfinite(lse)))))
        return o, lse


def draw(cfg, dev, mesh=None):
    """The weights from SEED: layer r drawn alone on every rank from SEED
    + r (``init_params`` of a 1-layer config; the embedding, head and
    final norm from layer 0's draw), whole, or over ``mesh`` each rank
    keeping only its shards of each layer.  A checksum of layer 0's draw,
    gathered, checks that every rank drew the same."""
    one = cfg.replace(num_layers=1)
    check(len(cfg.stages()) == 1, "one stage of layers")
    specs = S.param_specs(cfg, mesh) if mesh is not None else None
    meta = init_params(cfg, None, "meta")
    out = None
    for r in range(cfg.num_layers):
        layer = init_params(
            one, torch.Generator(device=dev).manual_seed(SEED + r), dev)
        if out is None:
            total = sum(float(t.sum(dtype=torch.float64))
                        for t in tree_leaves(layer))
            sums = [None] * dist.get_world_size()
            dist.all_gather_object(sums, total)
            check(len(set(sums)) == 1, f"ranks drew different weights {sums}")
            out = {k: (v if mesh is None else S.put(v, mesh, specs[k]))
                   for k, v in layer.items() if k != "stages"}
            out["stages"] = [{}]
        _put_layer(out["stages"][0], meta["stages"][0],
                   layer["stages"][0], None if specs is None else specs["stages"][0], r,
                   mesh, dev)
        del layer
    return out


def _put_layer(dst, meta, src, spec, r, mesh, dev):
    """Layer r of the stacked stage tree ``dst`` (made at the first layer,
    like ``meta``, whole or placed by ``spec``) from ``src``, a 1-layer
    draw: each rank copies its shard of each leaf."""
    for k, m in meta.items():
        if isinstance(m, dict):
            _put_layer(dst.setdefault(k, {}), m, src[k],
                       None if spec is None else spec[k], r, mesh, dev)
            continue
        if k not in dst:
            dst[k] = (torch.empty(m.shape, dtype=m.dtype, device=dev)
                      if mesh is None else
                      S.zeros(m.shape, m.dtype, mesh, spec[k], dev))
        piece = src[k][0]
        if mesh is not None:
            piece = S._local_slice(piece, mesh.device_mesh, S.placements(
                mesh, spec[k][1:], piece.ndim))
        (dst[k].to_local() if mesh is not None else dst[k])[r].copy_(piece)


def prompts(cfg, dev, n):
    g = torch.Generator(device=dev).manual_seed(SEED + 1000)
    return torch.randint(0, cfg.vocab_size, (BATCH, n), generator=g,
                         device=dev)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


class Launches:
    """The flash and decode wrappers' launch counts since ``reset``."""

    def reset(self):
        self.base = (flash_ops.flash_attention.launches,
                     decode_ops.decode_attention.launches)

    def read(self) -> dict:
        return {"flash_attention": flash_ops.flash_attention.launches
                - self.base[0],
                "decode_attention": decode_ops.decode_attention.launches
                - self.base[1]}


# --------------------------------------------------------------------------
# (a) the cut config on every mesh against one card
# --------------------------------------------------------------------------
def card_steps(cfg, params, prefill, dp_size, steps):
    """The card's greedy decode steps from a copy of the prefill's cache:
    (logits of each step, tokens fed to each step, the cache after)."""
    cache = _clone(prefill["cache"])
    decode = make_decode_step(cfg, DataGroups(dp_size))
    tok, logits, fed = prefill["next_token"], [], []
    for i in range(steps):
        fed.append(tok)
        o = decode(params, tok, cache, prefill["pos"] + i)
        logits.append(o["logits"])
        tok = o["next_token"]
    return logits, fed, cache


def cache_by_layer(mesh_cache, card_cache, flips, tol) -> list:
    """Each cache leaf (repeats, B, L, KH, hd), layer by layer: the largest
    error at a position over the leaf's largest magnitude, everywhere and
    at the positions whose token took the same experts in every earlier
    layer (``flips[r]``: (B, L), a flip in a layer before r), and how many
    positions lie over ``tol`` with no such flip to explain them."""
    out = []
    for i, (a, b) in enumerate(zip(tree_leaves(mesh_cache),
                                   tree_leaves(card_cache))):
        for r in range(a.shape[0]):
            x, y = a[r].float(), b[r].float()
            err = ((x - y).abs().amax(dim=(-2, -1))
                   / y.abs().max().clamp_min(1e-30))
            same = ~flips[r]
            out.append({"leaf": i, "layer": r, "err": float(err.max()),
                        "err_same_route": float(err[same].max()) if same.any()
                        else 0.0,
                        "over_tol": int((err > tol).sum()),
                        "over_tol_same_route": int(((err > tol) & same)
                                                   .sum()),
                        "flipped_positions": int(flips[r].sum())})
    return out


def phase_cut(rank, dev, smoke, prompt, cache_len, dtype):
    """The cut in ``dtype`` on the card (rank 0) and on every mesh."""
    out, routes = {}, Routes()
    cfg = base_config(smoke).replace(
        num_layers=CUT_LAYERS, **{"f32": F32, "bf16": BF16}[dtype])
    if dtype == "bf16":
        cfg = dropless(cfg)
    params = draw(cfg, dev)
    tokens = prompts(cfg, dev, prompt)
    card = card_pre = None
    with mock.patch.object(L, "moe_route", routes):
        if rank == 0:
            routes.begin(False)
            t0 = time.perf_counter()
            card = make_prefill_step(cfg, cache_len)(params,
                                                     {"tokens": tokens})
            sync(dev)
            log(rank, phase="cut", dtype=dtype, mesh="card",
                params=cfg.num_params(),
                capacity_factor=float(cfg.capacity_factor),
                prefill_wall_s=time.perf_counter() - t0)
            card_pre = routes.end()
        for shape in CUT_MESHES:
            out[f"{dtype}_{shape[0]}x{shape[1]}"] = cut_on_mesh(
                rank, dev, cfg, dtype, shape, params, tokens, card,
                card_pre, routes, smoke, prompt, cache_len)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    del params, card
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cut_on_mesh(rank, dev, cfg, dtype, shape, params, tokens, card,
                card_pre, routes, smoke, prompt, cache_len):
    mesh = make_process_mesh(shape, AXES, dev)
    policy = S.MeshPolicy(mesh, cfg, BATCH)
    ref = card_dec = None
    if rank == 0:
        routes.begin(True)
        ref = card_steps(cfg, params, card, policy.dp_size, CUT_STEPS)
        card_dec = routes.end()
    fed = [t.clone() for t in ref[1]] if rank == 0 else \
        [torch.empty((BATCH, 1), dtype=torch.int32, device=dev)
         for _ in range(CUT_STEPS)]
    for t in fed:
        dist.broadcast(t, 0)
    placed = S.put(params, mesh, S.param_specs(cfg, mesh))
    batch = S.put({"tokens": tokens}, mesh,
                  S.batch_specs(cfg, mesh, BATCH, "prefill"))
    routes.begin(False)
    t0 = time.perf_counter()
    o = make_prefill_step(cfg, cache_len, policy)(placed, batch)
    sync(dev)
    wall = time.perf_counter() - t0
    mesh_pre = routes.end()
    logits = [S.full(o["logits"])]
    toks = [o["next_token"]]
    cache, pos = o["cache"], o["pos"]
    decode = make_decode_step(cfg, policy)
    held = HeldDecode()
    routes.begin(True)
    with mock.patch.object(decode_ops, "decode_attention_range", held):
        for i, t in enumerate(fed):
            o = decode(placed, t, cache, pos + i)
            logits.append(S.full(o["logits"]))
            toks.append(o["next_token"])
    mesh_dec = all_rows(mesh, routes.end())
    mesh_pre = all_rows(mesh, mesh_pre)
    gathered = S.gather(cache)
    kernel = [None] * dist.get_world_size()
    dist.all_gather_object(kernel, held.errs)
    rec = {"phase": "cut", "dtype": dtype, "mesh": list(shape),
           "dp_size": policy.dp_size, "prefill_wall_s": wall}
    if rank == 0:
        n = len(card_pre)                      # MoE layers: calls a step
        step_flips = [flipped(m[:, -1:], c[:, -1:])[:, 0] for m, c in zip(
            mesh_pre, card_pre)]
        per_step = [step_flips] + [
            [flipped(mesh_dec[i * n + r], card_dec[i * n + r])[:, 0]
             for r in range(n)] for i in range(CUT_STEPS)]
        # flips[r]: (B, L) the positions whose token took other experts in
        # a layer before r, from the prefill and each decode step
        B, Lc = BATCH, cache_len
        by_layer = []
        for r in range(n):
            f = torch.zeros((B, Lc), dtype=torch.bool, device=dev)
            f[:, :prompt] = flipped(mesh_pre[r], card_pre[r])
            for i in range(CUT_STEPS):
                f[:, prompt + i] = per_step[1 + i][r]
            by_layer.append(f)
        before = [torch.zeros((B, Lc), dtype=torch.bool, device=dev)]
        for r in range(1, n):
            before.append(before[-1] | by_layer[r - 1])
        want = [card["logits"], *ref[0]]
        errs = [float((a - b).abs().max()) for a, b in zip(logits, want)]
        close = [logits_close(a, b) for a, b in zip(logits, want)]
        # the mesh's greedy token after the prefill and each step against
        # the card's (the tokens fed; the last step's is fed nowhere)
        same = [bool(torch.equal(a, b)) for a, b in zip(toks, ref[1])]
        layers = cache_by_layer(gathered, ref[2], before, CACHE_TOL[dtype])
        calls = [c for errs_r in kernel for c in errs_r]
        rec.update(
            logits_err=errs, logits_close=close,
            logit_scale=max(float(b.abs().max()) for b in want),
            tokens_equal=same,
            route_flips_by_step=[[int(f.sum()) for f in fl]
                                 for fl in per_step],
            prefill_route_flips=[int(flipped(m, c).sum())
                                 for m, c in zip(mesh_pre, card_pre)],
            cache_err=max(x["err"] for x in layers), cache_by_layer=layers,
            kernel_calls=len(calls),
            kernel_o_err=max((c[0] for c in calls), default=None),
            kernel_lse_err=max((c[1] for c in calls), default=None),
            kernel_ok=all(c[2] for c in calls))
        log(rank, **rec)
        if dtype == "f32":
            check(max(errs) <= F32_TOL and all(same), rec)
            check(rec["cache_err"] <= CACHE_TOL[dtype], rec)
        elif not smoke:
            # the smoke config's router (d 64) flips near ties in bf16:
            # its bf16 figures are logged only
            check(all(close), rec)
            check(all(x["over_tol_same_route"] == 0 for x in layers), rec)
        check(rec["kernel_ok"] and (rec["kernel_lse_err"] or 0) <= LSE_TOL
              and (dev.type == "cpu" or len(calls) == WORLD * CUT_STEPS
                   * cfg.num_layers), rec)
    del placed, cache, gathered, o
    return rec


# --------------------------------------------------------------------------
# (b) full width and depth on (1, 4) and (2, 2)
# --------------------------------------------------------------------------
def profiled_steps(dev, n, run) -> tuple:
    """``run(i)`` for i < n, each between two synchronisations: (walls s,
    device-busy shares, outputs).  One ``torch.profiler`` trace holds the
    n steps; a marker kernel (``torch.cuda._sleep``) launched before each
    step cuts the trace's CUDA kernels into steps, and a step's busy time
    is the union of its kernels' intervals (None on the CPU, or where the
    markers are not found)."""
    walls, outs = [], []
    if dev.type != "cuda":
        for i in range(n):
            t0 = time.perf_counter()
            outs.append(run(i))
            walls.append(time.perf_counter() - t0)
        return walls, [None] * n, outs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            torch.cuda._sleep(MARK_CYCLES)
            sync(dev)
            t0 = time.perf_counter()
            outs.append(run(i))
            sync(dev)
            walls.append(time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    marks = [j for j, (_, _, name) in enumerate(spans) if "spin" in name]
    if len(marks) != n:
        return walls, [None] * n, outs
    shares = []
    for i, j in enumerate(marks):
        busy, end = 0.0, -float("inf")
        for a, b, _ in spans[j + 1:marks[i + 1] if i + 1 < n else None]:
            if b > end:
                busy += b - max(a, end)
                end = b
        shares.append(busy / 1e6 / walls[i])
    return walls, shares, outs


def phase_full(rank, dev, shape, smoke, prompt, cache_len):
    cfg = dropless(base_config(smoke).replace(**BF16))
    mesh = make_process_mesh(shape, AXES, dev)
    policy = S.MeshPolicy(mesh, cfg, BATCH)
    pspecs = S.param_specs(cfg, mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = draw(cfg, dev, mesh)
    sync(dev)
    draw_s = time.perf_counter() - t0
    meta = init_params(cfg, None, "meta")
    size = lambda t: t.element_size()  # noqa: E731
    tokens = prompts(cfg, dev, prompt)
    batch = S.put({"tokens": tokens}, mesh,
                  S.batch_specs(cfg, mesh, BATCH, "prefill"))
    count, routes = Launches(), Routes()
    count.reset()
    sync(dev)
    with mock.patch.object(L, "moe_route", routes):
        routes.begin(False)
        t0 = time.perf_counter()
        o = make_prefill_step(cfg, cache_len, policy)(params, batch)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        pre_routes = all_rows(mesh, routes.end())
    prefill_launches = count.read()
    cache, pos = o["cache"], o["pos"]
    cache_meta = M.init_cache(cfg, BATCH, cache_len, "meta")
    card = {"params": local_bytes(params),
            "params_specs": spec_bytes(mesh, pspecs, meta, size),
            "cache": local_bytes(cache),
            "cache_specs": spec_bytes(mesh, S.cache_specs(cfg, mesh, BATCH),
                                      cache_meta, size),
            "prefill_wall_s": prefill_s, "draw_s": draw_s,
            "prefill_launches": prefill_launches}
    logits, generated = [S.full(o["logits"])], []
    decode = make_decode_step(cfg, policy)
    launches = []
    state = {"tok": o["next_token"]}

    def step(i):
        generated.append(state["tok"])
        count.reset()
        out = decode(params, state["tok"], cache, pos + i)
        launches.append(count.read())
        state["tok"] = out["next_token"]
        return S.full(out["logits"])

    with mock.patch.object(L, "moe_route", routes):
        routes.begin(True)
        walls, shares, outs = profiled_steps(dev, FULL_STEPS, step)
        dec_routes = all_rows(mesh, routes.end())
    logits += outs
    tok = state["tok"]
    steps = [{"step": i, "wall_s": w, "device_busy": b, **n}
             for i, (w, b, n) in enumerate(zip(walls, shares, launches))]
    card["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, {"card": card, "steps": steps})
    log(rank, phase="full", mesh=list(shape), layers=cfg.num_layers,
        params=cfg.num_params(), prompt=[BATCH, prompt],
        cache=cache_len, cards=[c["card"] for c in cards],
        predicted=PREDICTED)
    for i in range(FULL_STEPS):
        log(rank, phase="full_step", mesh=list(shape), step=i,
            cards=[c["steps"][i] for c in cards])
    for r, c in enumerate(cards):
        check(c["card"]["params"] == c["card"]["params_specs"], (r, c["card"]))
        check(c["card"]["cache"] == c["card"]["cache_specs"], (r, c["card"]))
        if dev.type != "cuda":          # the CPU runs the plain versions
            continue
        check(c["card"]["prefill_launches"] == {
            "flash_attention": cfg.num_layers, "decode_attention": 0},
            (r, c["card"]["prefill_launches"]))
        for s in c["steps"]:
            check(s["flash_attention"] == 0
                  and s["decode_attention"] == cfg.num_layers, (r, s))
    # teacher forcing on the same mesh: the full-sequence forward over the
    # prompt and the generated tokens, its logits at each generated
    # position (position p predicts token p + 1), its routes recorded
    seq = torch.cat([tokens, *(t.to(tokens.dtype) for t in generated)],
                    dim=1)
    tf_batch = S.put({"tokens": seq}, mesh,
                     S.batch_specs(cfg, mesh, BATCH, "prefill"))
    with torch.no_grad(), mock.patch.object(L, "moe_route", routes):
        routes.begin(False)
        tf, _ = M.forward_train(cfg, params, tf_batch, route="kernels",
                                policy=policy)
        tf_routes = all_rows(mesh, routes.end())
    tf = S.full(tf[:, prompt - 1:])
    n = cfg.num_layers
    # (B, 1 + steps): the token whose logits these are (the prompt's last,
    # then each decode step's) took other experts than the forward's at
    # its position in some layer
    flips = torch.stack([
        torch.stack([flipped(pre_routes[r][:, prompt - 1],
                             tf_routes[r][:, prompt - 1])
                     for r in range(n)]).any(dim=0)] + [
        torch.stack([flipped(dec_routes[i * n + r][:, 0],
                             tf_routes[r][:, prompt + i])
                     for r in range(n)]).any(dim=0)
        for i in range(FULL_STEPS)], dim=1)
    errs = [float((a[:, 0] - tf[:, i]).abs().max())
            for i, a in enumerate(logits)]
    pair_close = [[logits_close(a[b, 0], tf[b, i]) for b in range(BATCH)]
                  for i, a in enumerate(logits)]
    same_route = [[not bool(flips[b, i]) for b in range(BATCH)]
                  for i in range(len(logits))]
    held = [c for cs, ss in zip(pair_close, same_route)
            for c, s in zip(cs, ss) if s]
    del tf
    # sampling at temperature 0.7 from a seeded generator, then one step
    # at temperature 0 against greedy (the same step twice: its cache
    # write is the same both times)
    g = torch.Generator(device=dev).manual_seed(SEED + 2000)
    sampled, at = [], pos + FULL_STEPS
    for i in range(SAMPLE_STEPS):
        o = decode(params, tok, cache, at + i, rng=g, temperature=TEMPERATURE)
        tok = o["next_token"]
        sampled.append(tok.flatten().tolist())
    at += SAMPLE_STEPS
    greedy = decode(params, tok, cache, at)["next_token"]
    zero = decode(params, tok, cache, at, rng=g, temperature=0.0)
    rec = {"phase": "full_checks", "mesh": list(shape),
           "teacher_forcing_err": errs,
           "teacher_forcing_close": pair_close,
           "route_flipped_rows_by_step": [int(f) for f in flips.sum(dim=0)],
           "held_pairs": len(held), "held_pairs_close": sum(held),
           "sampled": sampled,
           "temperature_zero_is_greedy": bool(torch.equal(
               greedy, zero["next_token"]))}
    log(rank, **rec)
    check(smoke or (held and all(held)), rec)
    check(all(0 <= t < cfg.vocab_size for row in sampled for t in row), rec)
    check(rec["temperature_zero_is_greedy"], rec)
    del params, cache, o
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def worker(rank, dev, args):
    RECORDS_PATH[0] = Path(args.records)
    torch.backends.cuda.matmul.allow_tf32 = False
    prompt, cache_len = ((SMOKE_PROMPT, SMOKE_CACHE) if args.smoke
                         else (PROMPT, CACHE))
    # the f32 cut last: a call cut short by its time limit loses the
    # phase an earlier run has already shown
    phase_cut(rank, dev, args.smoke, prompt, cache_len, "bf16")
    for shape in FULL_MESHES:
        phase_full(rank, dev, shape, args.smoke, prompt, cache_len)
    phase_cut(rank, dev, args.smoke, prompt, cache_len, "f32")
    if FAILED:
        raise RuntimeError(f"sharded_serve_cards: {len(FAILED)} failed "
                           f"checks on rank {rank}: {FAILED}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' rehearses over gloo (default: the cards)")
    ap.add_argument("--smoke", action="store_true",
                    help="mixtral-smoke, short prompts, instead of "
                    "mixtral-8x7b")
    ap.add_argument("--records", default=str(RECORDS_PATH[0]),
                    help="where the JSON records go")
    args = ap.parse_args(argv)
    if args.device is None:
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu to rehearse)")
        if torch.cuda.device_count() < WORLD:
            sys.exit(f"needs {WORLD} cards, {torch.cuda.device_count()} "
                     "visible")
        from repro_torch.kernels import _build
        _build.build()            # once, before the processes load it
    t0 = time.perf_counter()
    run_processes(worker, WORLD, args.device, (args,))
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
