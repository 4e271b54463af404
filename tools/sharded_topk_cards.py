"""The mesh-sharded exact scan over every visible card, at the size of MS
MARCO's passage corpus (8,841,823 passages) at olmo-1b's width of 2048 in
f32: 72.4 GB normalised, more than one H100 holds, 18.1 GB a card over
four.

    python3 tools/sharded_topk_cards.py

The corpus is drawn on the cards from a seed and copied into one host
array, and ``VectorIndex(mesh=make_mesh((cards,), ("data",)))`` normalises
it on the host (its raw and normalised copies, 2 x 72.4 GB, and numpy's
temporary of the norm) and places one shard a card; the placement alone
is timed once more.  Then, for 8 queries at k 100 and 4 at k 32 (Query
3's ``candidate_k``):

- ``VectorIndex.topk`` launches block_max_scores once a card (counted
  from 0 before the call), and its ids equal a kernel-free oracle's: the
  plain ``cosine_topk`` over each shard on its card, then a host merge in
  (score desc, id asc); near-ties within 1e-6 are counted, scores held at
  1e-5;
- each shard's kernel and shard-local route (``topk_normalised``) in
  device ms on its own card (CUDA events, median of 20) beside
  the shard's bound (its bytes over 3.35 TB/s) and the kernel's plain
  version on the first card (median of 5), the whole call's wall
  (host clock, every card synchronised) and the gather's device ms (the
  candidates' copies to the first card, timed on its stream).

Prints one JSON line a phase, the cards' names and power limits, and
``{"ok": true, ...}`` last.  Exits non-zero without a CUDA device or when
a check fails.
"""

from __future__ import annotations

import json
import resource
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
MSMARCO_PASSAGES = 8_841_823
DIM = 2048                           # olmo-1b's width
CALLS = 20                           # timed calls a measurement
CASES = ((8, 100), (4, 32))          # (queries, k)
NEAR_TIE = 1e-6
SCORE_TOL = 1e-5
SEED = 0


def cards_line() -> list:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def draw_corpus(cards, n_rows, dim, bounds) -> np.ndarray:
    """(n_rows, dim) f32 on the host: each shard's rows drawn on its card
    from seed SEED + shard and copied into one preallocated array, one
    thread a card."""
    raw = np.empty((n_rows, dim), np.float32)

    def fill(s, dev, a, b):
        g = torch.Generator(device=dev).manual_seed(SEED + s)
        rows = torch.randn((b - a, dim), generator=g, device=dev)
        torch.from_numpy(raw[a:b]).copy_(rows)

    threads = [threading.Thread(target=fill, args=(s, dev, a, b))
               for s, (dev, (a, b)) in enumerate(zip(cards, bounds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return raw


def sync_all(cards):
    for dev in cards:
        torch.cuda.synchronize(dev)


def oracle(shards, bounds, q, k):
    """The kernel-free top-k: ``cosine_topk`` on each shard on its card,
    ids offset by the shard's first row, merged on the host in (score
    desc, id asc)."""
    from repro_torch.retrieval import cosine_topk
    parts = [cosine_topk(shard, q.to(shard.device), k)
             for shard in shards]
    s = np.concatenate([p[0].cpu().numpy() for p in parts], axis=1)
    i = np.concatenate([p[1].cpu().numpy().astype(np.int64) + a
                        for p, (a, _) in zip(parts, bounds)], axis=1)
    order = np.stack([np.lexsort((ids, -sc)) for sc, ids in zip(s, i)])
    return (np.take_along_axis(s, order, 1)[:, :k],
            np.take_along_axis(i, order, 1)[:, :k])


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_topk_cards: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk_sim import ops as topk_ops
    from repro_torch.kernels.topk_sim.ref import block_max_scores_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.retrieval import VectorIndex
    from repro_torch.retrieval import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    names = cards_line()
    n_cards = torch.cuda.device_count()
    C.log(phase="cards", cards=names, count=n_cards, torch=torch.__version__,
          cuda=torch.version.cuda)
    t0 = time.perf_counter()
    C.log(phase="build", library=_build.build().name,
          seconds=time.perf_counter() - t0)

    mesh = make_mesh((n_cards,), ("data",))
    cards = list(mesh.devices.flat)
    bounds = D.shard_bounds(MSMARCO_PASSAGES, n_cards)
    t0 = time.perf_counter()
    raw = draw_corpus(cards, MSMARCO_PASSAGES, DIM, bounds)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = VectorIndex(raw, mesh=mesh)
    del raw
    sync_all(cards)
    index_s = time.perf_counter() - t0
    shards = index._placed(mesh)
    # the placement alone, once more, into copies that are then freed
    t0 = time.perf_counter()
    again = D.shard_corpus(mesh, index.host_vectors)
    sync_all(cards)
    place_s = time.perf_counter() - t0
    del again
    torch.cuda.empty_cache()
    C.log(phase="index", rows=MSMARCO_PASSAGES, dim=DIM,
          corpus_gb=MSMARCO_PASSAGES * DIM * 4 / 1e9, draw_s=draw_s,
          index_build_s=index_s, placement_s=place_s,
          host_peak_rss_gb=resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
          shard_rows=[t.shape[0] for t in shards],
          shard_devices=[str(t.device) for t in shards],
          device_allocated_gb=[torch.cuda.memory_allocated(d) / 1e9
                               for d in cards],
          whole_corpus_tensor=index.vectors is not None)
    C.check(index.vectors is None and [t.device for t in shards] == cards,
            "the index is not one shard a card")

    bm = topk_ops.block_max_scores
    g = torch.Generator(device=cards[0]).manual_seed(SEED + 100)
    for Q, k in CASES:
        q = torch.randn((Q, DIM), generator=g, device=cards[0])
        q_host = q.cpu().numpy()
        bm.launches = 0
        s, i = index.topk(q_host, k)
        launches = bm.launches
        o_s, o_i = oracle(shards, bounds, q, k)
        agree, ties = C.ranks_agree(i, o_i, o_s, NEAR_TIE / 10)
        err = float(np.abs(s - o_s).max())
        kl = min(k, -(-MSMARCO_PASSAGES // n_cards))
        qn = q / q.norm(dim=-1, keepdim=True)
        q_on = [qn.to(d) for d in cards]
        kernel = [C.event_ms(lambda t=t, x=x: bm(t, x), CALLS, device=d)
                  for d, t, x in zip(cards, shards, q_on)]
        local = [C.event_ms(lambda t=t, x=x: D.topk_normalised(t, x, kl),
                            CALLS, device=d)
                 for d, t, x in zip(cards, shards, q_on)]
        plain = C.event_ms(lambda: block_max_scores_ref(shards[0], q_on[0]),
                           5, device=cards[0])
        cand = [D.topk_normalised(t, x, kl) for t, x in zip(shards, q_on)]
        sync_all(cards)
        gather = C.event_ms(lambda: (
            torch.cat([c[0].to(cards[0]) for c in cand], 1),
            torch.cat([c[1].to(cards[0]) for c in cand], 1)), CALLS,
            device=cards[0])
        fn = D.make_sharded_topk(mesh, k)
        walls = []
        for _ in range(CALLS):
            sync_all(cards)
            t0 = time.perf_counter()
            fn(shards, q)
            sync_all(cards)
            walls.append((time.perf_counter() - t0) * 1e3)
        index_walls = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            index.topk(q_host, k)
            index_walls.append((time.perf_counter() - t0) * 1e3)
        bound = [t.shape[0] * DIM * 4 / C.HBM_BYTES_PER_S * 1e3
                 for t in shards]
        row = dict(
            queries=Q, k=k, kl=kl, launches=launches,
            ids_equal_oracle=bool(np.array_equal(i, o_i)),
            ids_agree=agree, near_ties=ties, max_score_err=err,
            shard_kernel_ms=[statistics.median(x) for x in kernel],
            shard_plain_ms=statistics.median(plain),
            shard_route_ms=[statistics.median(x) for x in local],
            shard_bound_ms=bound, gather_ms=statistics.median(gather),
            call_wall_ms=dict(median=statistics.median(walls),
                              min=min(walls), max=max(walls)),
            index_topk_wall_ms=dict(median=statistics.median(index_walls),
                                    min=min(index_walls)))
        C.log(phase="sharded_topk", **row)
        C.check(launches == n_cards, f"block_max_scores launched "
                f"{launches} times in a call on {n_cards} cards")
        C.check(agree and err <= SCORE_TOL, f"the sharded scan differs "
                f"from the kernel-free oracle: {row}")
    C.log(phase="total", wall_s=time.perf_counter() - t_start)
    for line in names:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n_cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
