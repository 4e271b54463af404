"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught and hidden):
  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` (one nvcc per source, all at once, linked into
     one shared library); each flash- and decode-attention instance's
     registers, local bytes, shared bytes and resident blocks per SM (a
     bf16 instance must keep no local memory and be resident);
  2. each kernel against its plain PyTorch version at the main path's
     shapes (olmo-1b: flash attention on a 64-text embed batch of 128
     tokens, decode attention over 4 slots x 2048 positions (without and
     with a window of 512, and at short positions), the block-max scan
     over 100,000 x 2048 f32 passages; falcon-mamba-7b: the selective
     scan of a 64-text embed batch of 128 tokens, di=8192, N=16;
     recurrentgemma-9b: flash attention of 16 query heads over one KV head
     of 256 on its embed batch, decode attention at that width over 4
     slots x 4096 positions with its window of 2048, the RG-LRU recurrence
     of its embed batch, di=4096, f32), with CUDA-event times of the
     kernel, the plain version and, where one exists, one PyTorch library
     call computing the same function; bounds from the card's peak rates.
     Flash and decode attention and their SDPA yardsticks are timed in
     interleaved pairs (median and min, and their ratio); decode attention
     and its yardstick also by their device time (``torch.profiler``: the
     kernels one call launches, summed, median over calls).  Top-100 ids
     must equal the plain version's exactly, on a random corpus and on one
     whose rows repeat 1,000 distinct vectors (ties rank by id);
  3. the main path at full olmo-1b width through the user's entry points
     (LocalTorchProvider.embed, VectorIndex.topk, LocalTorchProvider.complete,
     ServingEngine.submit/run_until_idle), with every kernel's launch count
     read from this run alone;
  4. one full-width decode step (each decode-attention call held against
     the plain version in bf16, the logits in f32, as in phase 7) and one
     embed batch through the kernels against the same through the plain
     versions;
  5. a traced window of the engine serving 4 requests at once: device
     time by kernel group and the device's idle share;
  6. olmo-1b freed, the falcon-mamba-7b path at full width through the
     same entry points (one 64-passage embed request, a device-resident
     index, top-k, 2 RAG completions, 5 raw requests on 4 slots), the
     selective scan's launches read from this run alone; each raw request
     against the same request served alone from a fresh state (a reused
     slot must not carry its last occupant's state); one embed batch
     through the kernel against the same through the plain scan;
  7. falcon-mamba-7b freed, the recurrentgemma-9b path the same way: its
     embed requests launch rg_lru once per "rec" layer (26) and flash
     attention once per "local" layer (12), each decode step decode
     attention once per "local" layer (12), counted in this phase alone;
     each raw request against a fresh engine (the "rec" state of a
     reused slot is zeroed); an embed batch through the kernels against
     the plain versions; a decode step whose decode-attention calls are
     each held against the plain version on the same inputs in bf16, and
     whose logits are held against the plain path in f32 (in bf16 one
     rounding of one attention output already moves them past the
     tolerance at this depth; the script measures that floor);
  8. the script's wall time, a ``{"kernels": [...]}`` line (each kernel's
     launches summed over the paths, and by path), then the card, then the
     result line.

Weights are random, drawn from a fixed seed (no checkpoint is needed).
Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# exp2 results per clock per SM on the special-function units (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0); the clock is the card's maximum SM clock, read from nvidia-smi
SFU_EXP_PER_CLOCK_PER_SM = 16
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
LOGITS_TOL = 6e-2                                    # bf16 model tolerance


def log(**kw):
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def time_pairs_ms(fn, lib, flush, pairs=50, warmup=3):
    """Device times in ms of ``fn`` and ``lib`` (the same function through
    a library call) in ``pairs`` interleaved pairs, who goes first
    alternating, from CUDA events, the L2 cache flushed before every call:
    (times of fn, times of lib), pair by pair."""
    for _ in range(warmup):
        fn()
        lib()
    events = []
    for i in range(pairs):
        rec = {}
        order = (("fn", fn), ("lib", lib))
        for name, f in order if i % 2 else order[::-1]:
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            rec[name] = (a, b)
        events.append(rec)
    torch.cuda.synchronize()
    return ([r["fn"][0].elapsed_time(r["fn"][1]) for r in events],
            [r["lib"][0].elapsed_time(r["lib"][1]) for r in events])


def time_ms(fn, flush, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms from CUDA events, the L2 cache
    flushed before every timed call (the main path finds its inputs cold)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def ids_match(ids, ref_ids) -> bool:
    """Equal top-k ids at every rank (both rank by score desc, id asc)."""
    return torch.equal(ids.cpu().long(), ref_ids.cpu().long())


def ptxas_spills(text: str) -> dict:
    """{(kernel name, template ints): (spill store bytes, spill load bytes)}
    of the attention instances in ``nvcc -Xptxas -v`` output."""
    spills, current = {}, None
    for line in text.splitlines():
        named = re.search(r"entry function '.*((?:flash_fwd|decode)_\w+?"
                          r"_kernel)I((?:Li\d+E)+)E", line)
        if named:
            current = (named.group(1),
                       tuple(int(x) for x in re.findall(r"Li(\d+)E",
                                                        named.group(2))))
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found and current:
            spills[current] = (int(found.group(1)), int(found.group(2)))
    return spills


# per attention kernel: its instances as (name, dtype, template ints after
# hd); the first is the bf16 instance the models run
INSTANCES = {
    "flash_attention": (("flash_fwd_mma_kernel", torch.bfloat16, ()),
                        ("flash_fwd_f32_kernel", torch.float32, ())),
    "decode_attention": (("decode_mma_kernel", torch.bfloat16, ()),
                         ("decode_partial_kernel", torch.float32, (8,)))}


def attention_instances(_build):
    """Phase 1: each flash- and decode-attention instance's registers,
    local bytes, shared bytes and resident blocks per SM (CUDA runtime),
    and the spills ``nvcc -Xptxas -v`` reported for it when this process
    built the library (None when an earlier process did; logged only).  A
    bf16 instance, the one the models run, must keep no local memory (no
    spills) and be resident.  One bf16 decode instance per head dim serves
    every G in ``GROUPS`` (the G heads are the rows of one MMA tile); it is
    given with its largest ring."""
    import importlib
    logs = _build.BUILD_LOG.get("log", {})
    for kernel, instances in INSTANCES.items():
        ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
        spills = ptxas_spills(logs.get(f"{kernel}.cu", ""))
        rows = []
        for name, dt, rest in instances:
            for hd in ops.HEAD_DIMS:
                st, ld = spills.get((name, (hd, *rest)), (None, None))
                row = dict(kernel=name, hd=hd, **ops.instance_info(hd, dt),
                           spill_store_bytes=st, spill_load_bytes=ld)
                if kernel == "decode_attention":
                    row["groups"] = (list(ops.GROUPS) if dt == torch.bfloat16
                                     else list(rest))
                rows.append(row)
        log(phase=f"{kernel.split('_')[0]}_instances", instances=rows)
        for r in rows:
            if r["kernel"] == instances[0][0]:
                check(r["local_bytes"] == 0,
                      f"{kernel} spills at hd {r['hd']}: {r}")
                check(r["blocks_per_sm"] > 0, f"{kernel} at hd {r['hd']} "
                      f"cannot be resident: {r}")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions at main-path shapes
# --------------------------------------------------------------------------
def check_flash(dev, flush, KH=16, hd=128, window=0, seed=SEED):
    """Flash attention on a 64-text embed batch of 128 tokens, 16 query
    heads: olmo-1b's (16 KV heads of 128) by default, recurrentgemma-9b's
    with ``KH=1, hd=256, window=2048``."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, L, H, dt = 64, 128, 16, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, L, H, hd), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, L, KH, hd), generator=g, device=dev).to(dt)
            for _ in range(2))

    def kern():
        return flash_attention(q, k, v, causal=True, window=window)

    def plain():
        return attention_ref(q, k, v, causal=True, window=window)
    out, ref = kern(), plain()
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), atol=TOLS[dt],
                        rtol=TOLS[dt])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # a window of at least L masks nothing beyond the causal mask
    check(window == 0 or window >= L, "SDPA yardstick needs window >= L")
    gqa = {} if KH == H else {"enable_gqa": True}
    k_ms, lib_ms = time_pairs_ms(
        kern, lambda: sdpa(qt, kt, vt, is_causal=True, **gqa), flush)
    med, lib_med = statistics.median(k_ms), statistics.median(lib_ms)
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    flops = 4 * B * H * (L * (L + 1) // 2) * hd
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    shape = (f"q,k,v ({B}, {L}, {H}, {hd}) bf16 causal" if KH == H else
             f"q ({B}, {L}, {H}, {hd}), k,v ({B}, {L}, {KH}, {hd}) bf16 "
             f"causal, window {window}")
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80",
        shape=shape,
        max_abs_err=err, atol=TOLS[dt], rtol=TOLS[dt], ok=ok,
        ms=med, ms_min=min(k_ms), plain_ms=time_ms(plain, flush, iters=5),
        library_ms=lib_med, library_ms_min=min(lib_ms),
        library="F.scaled_dot_product_attention"
        + ("" if KH == H else "(enable_gqa)"),
        timed_pairs=len(k_ms), ratio_to_library=med / lib_med,
        ratio_to_library_min=min(k_ms) / min(lib_ms),
        bound_ms=b_ms, bound_by=b_by)
    log(**row)
    return row


def _device_kernels(run) -> list:
    """(start us, duration us, name) of each CUDA kernel ``run()``
    launched, from ``torch.profiler``, in time order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def device_times_ms(fn, flush, calls=20):
    """Calls of ``fn`` by their device time from ``torch.profiler``: the
    durations of the CUDA kernels a call launched, summed.  The L2 flush
    before each call is one kernel, named from a trace of flushes alone;
    the timed trace is cut at each flush.  The profiler may miss the first
    kernels of a trace, so what precedes the first flush is dropped and
    ``calls - 2`` whole calls suffice.  Returns (ms of each call, kernels
    per call, kernel names)."""
    def flushes():
        for _ in range(3):
            flush.zero_()
    names = []
    for _ in range(3):
        names = [name for _, _, name in _device_kernels(flushes)]
        if names:
            break
    check(bool(names), "the profiler recorded no kernel of the L2 flush")
    flush_name = max(set(names), key=names.count)
    fn()

    def timed():
        for _ in range(calls):
            flush.zero_()
            fn()
    per_call = []
    for _, us, name in _device_kernels(timed):
        if name == flush_name:
            per_call.append([])
        elif per_call:             # kernels before the first flush: dropped
            per_call[-1].append((us, name))
    per_call = [ks for ks in per_call if ks]
    check(calls - 2 <= len(per_call) <= calls, f"the profiler's trace holds "
          f"{len(per_call)} of {calls} calls (cut at {flush_name[:60]})")
    return ([sum(us for us, _ in ks) / 1e3 for ks in per_call],
            [len(ks) for ks in per_call],
            sorted({name for ks in per_call for _, name in ks}))


def check_decode(dev, flush, S=2048, KH=16, hd=128,
                 positions=(1900, 1024, 300, 37), windows=(0, 512),
                 seed=SEED + 1):
    """Decode attention over 4 slots, 16 query heads: olmo-1b's (16 KV
    heads of 128, a 2048-slot cache) by default, recurrentgemma-9b's with
    ``KH=1, hd=256`` and positions past its window of 2048.  The kernel and
    masked SDPA are timed in 50 interleaved pairs (CUDA events around each
    call) and by their device time (the kernels one call launches)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, H, dt = 4, 16, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(dt)
    kc, vc = (torch.randn((B, S, KH, hd), generator=g, device=dev).to(dt)
              for _ in range(2))
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    gqa = {} if KH == H else {"enable_gqa": True}
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for window in windows:
        def kern():
            return decode_attention(q, kc, vc, pos, window=window)

        def plain():
            return decode_attention_ref(q, kc, vc, pos, window=window)
        out, ref = kern(), plain()
        err = max_err(out, ref)
        ok = torch.allclose(out.float(), ref.float(), atol=TOLS[dt],
                            rtol=TOLS[dt])
        k_pos = torch.arange(S, device=dev)
        valid = k_pos[None, :] <= pos[:, None].long()
        if window:
            valid &= pos[:, None].long() - k_pos[None, :] < window
        mask = valid[:, None, None, :]

        def lib():
            return sdpa(qt, kt, vt, attn_mask=mask, **gqa)
        k_ms, lib_ms = time_pairs_ms(kern, lib, flush)
        med, lib_med = statistics.median(k_ms), statistics.median(lib_ms)
        dev_ms, dev_launches, dev_names = device_times_ms(kern, flush)
        lib_dev_ms, _, _ = device_times_ms(lib, flush)
        dev_med = statistics.median(dev_ms)
        lib_dev_med = statistics.median(lib_dev_ms)
        n_valid = int(valid.sum())              # what this data must read
        nbytes = (2 * n_valid * KH * hd + 2 * q.numel()) * q.element_size() \
            + pos.numel() * 4
        flops = 4 * n_valid * H * hd
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        row = dict(
            name="decode_attention", route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:56",
            shape=f"q ({B}, 1, {H}, {hd}), cache ({B}, {S}, {KH}, {hd}) "
                  f"bf16, pos {pos.tolist()}, window {window}",
            max_abs_err=err, atol=TOLS[dt], rtol=TOLS[dt], ok=ok,
            ms=med, ms_min=min(k_ms), plain_ms=time_ms(plain, flush, iters=5),
            library_ms=lib_med, library_ms_min=min(lib_ms),
            library="F.scaled_dot_product_attention(mask"
            + (", enable_gqa)" if gqa else ")"),
            timed_pairs=len(k_ms), ratio_to_library=med / lib_med,
            ratio_to_library_min=min(k_ms) / min(lib_ms),
            device_ms=dev_med, library_device_ms=lib_dev_med,
            device_ratio_to_library=dev_med / lib_dev_med,
            device_timed_calls=len(dev_ms),
            kernel_launches_per_call=statistics.median(dev_launches),
            device_kernels=dev_names,
            bound_ms=b_ms, bound_by=b_by, n_valid=n_valid,
            full_cache_bound_ms=(2 * kc.numel() * 2) / HBM_BYTES_PER_S * 1e3)
        log(**row)
        rows.append(row)
    return rows


def check_decode_rows(dev, flush):
    """Phase 2's decode-attention rows: olmo-1b's shape without and with a
    window of 512 and at short positions (early decode of short prompts),
    then recurrentgemma-9b's (16 query heads over one KV head of 256, 4096
    slots, positions past its window of 2048)."""
    olmo = check_decode(dev, flush)
    short = check_decode(dev, flush, positions=(107, 87, 67, 47),
                         windows=(0,))
    rg = check_decode(dev, flush, S=4096, KH=1, hd=256,
                      positions=(4000, 2500, 2100, 37), windows=(2048,),
                      seed=SEED + 8)
    return olmo + short, rg


def check_topk(dev, flush):
    from repro_torch.kernels.topk_sim.ops import block_max_scores, topk_sim
    from repro_torch.kernels.topk_sim.ref import (block_max_scores_ref,
                                                  topk_sim_ref)
    N, D, Q, k, bn = 100_000, 2048, 8, 100, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    corpus = torch.randn((N, D), generator=g, device=dev)
    queries = torch.randn((Q, D), generator=g, device=dev)
    cn = corpus / corpus.norm(dim=-1, keepdim=True)
    qn = queries / queries.norm(dim=-1, keepdim=True)
    out = block_max_scores(cn, qn, block_n=bn)
    ref = block_max_scores_ref(cn, qn, block_n=bn)
    err = max_err(out, ref)
    ok = torch.allclose(out, ref, atol=TOLS[torch.float32],
                        rtol=TOLS[torch.float32])
    s, i = topk_sim(corpus, queries, k)
    s_ref, i_ref = topk_sim_ref(corpus, queries, k)
    ids_ok = ids_match(i, i_ref)
    # rows repeating 1,000 distinct vectors: whole groups tie, by id
    distinct = torch.randn((1000, D), generator=g, device=dev)
    dup = distinct[torch.randint(0, 1000, (N,), generator=g, device=dev)]
    del distinct
    dup_ok = ids_match(topk_sim(dup, queries, k)[1],
                       topk_sim_ref(dup, queries, k)[1])
    del dup
    n_blocks = out.shape[1]
    nbytes = (N * D + Q * D + Q * n_blocks) * 4
    b_ms, b_by = bound_ms(nbytes, 2 * Q * N * D, torch.float32)
    row = dict(
        name="topk_sim.block_max_scores", route="cuda",
        source="src/repro_torch/csrc/topk_sim.cu",
        replaces="src/repro/kernels/topk_sim/kernel.py:64",
        shape=f"corpus ({N}, {D}) f32, queries ({Q}, {D}), block_n {bn}; "
              f"top-{k} ids vs plain: {'exact' if ids_ok else 'DIFFER'}; "
              f"on rows of 1,000 distinct vectors: "
              f"{'exact' if dup_ok else 'DIFFER'}",
        max_abs_err=err, atol=TOLS[torch.float32], rtol=TOLS[torch.float32],
        ok=ok and ids_ok and dup_ok, ids_exact=ids_ok,
        duplicated_corpus_ids_exact=dup_ok,
        ms=time_ms(lambda: block_max_scores(cn, qn, block_n=bn), flush),
        plain_ms=time_ms(lambda: block_max_scores_ref(cn, qn, block_n=bn),
                         flush, iters=5),
        topk_ms=time_ms(lambda: topk_sim(corpus, queries, k), flush,
                        iters=5),
        topk_plain_ms=time_ms(lambda: topk_sim_ref(corpus, queries, k),
                              flush, iters=5),
        library_ms=None, library=None, bound_ms=b_ms, bound_by=b_by)
    log(**row)
    return row


SSM_SCAN_TOL = 5 * TOLS[torch.bfloat16]   # tests/test_kernels.py ssm case


def check_ssm(dev, flush):
    """The selective scan at falcon-mamba-7b's embed shape: 64 texts of
    128 tokens, d_inner 8192, state 16, bf16, with the init's A_log, D
    and dt_bias (dt = softplus(N(0, 1) - 2))."""
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    B, S, di, N, dt_ = 64, 128, 8192, 16, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn((B, S, di), generator=g, device=dev).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=g, device=dev) - 2.0).to(dt_)
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev).to(dt_)
              for _ in range(2))
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev)).expand(di, N).contiguous()
    D = torch.ones(di, dtype=torch.float32, device=dev)
    args = (x, dt, Bm, Cm, A_log, D)
    out = ssm_scan(*args)
    ref = ssm_scan_ref(*args)
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), atol=SSM_SCAN_TOL,
                        rtol=SSM_SCAN_TOL)
    n = B * S * di * N
    nbytes = (3 * B * S * di + 2 * B * S * N) * 2 + (di * N + di) * 4
    flops = 6 * n + 3 * B * S * di   # per state: 2 products, 2 FMAs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_hz()
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32_flops": flops / PEAK_FLOPS[torch.float32] * 1e3,
             "exps": n / (sms * SFU_EXP_PER_CLOCK_PER_SM * clock) * 1e3}
    b_ms = max(parts.values())
    row = dict(
        name="ssm_scan", route="cuda",
        source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan/kernel.py:59",
        shape=f"x, dt ({B}, {S}, {di}), Bm, Cm ({B}, {S}, {N}) bf16",
        max_abs_err=err, atol=SSM_SCAN_TOL, rtol=SSM_SCAN_TOL, ok=ok,
        ms=time_ms(lambda: ssm_scan(*args), flush),
        plain_ms=time_ms(lambda: ssm_scan_ref(*args), flush, iters=5),
        library_ms=None, library=None, bound_ms=b_ms,
        bound_by="bytes" if parts["bytes"] == b_ms else "operations",
        bound_parts_ms=parts, bytes=nbytes, f32_flops=flops, exps=n,
        sms=sms, max_sm_clock_hz=clock)
    log(**row)
    return row


RG_LRU_TOL = {dt: 5 * t for dt, t in TOLS.items()}  # tests/test_kernels.py


def check_rg_lru(dev, flush):
    """The RG-LRU recurrence at recurrentgemma-9b's embed shape: 64 texts
    of 128 tokens, d_inner 4096, f32 gates as the model computes them
    (a = exp(-8 r softplus(2)), b = sqrt(1 - a^2) i x with r, i sigmoid
    gates and x ~ N(0, 1))."""
    from repro_torch.kernels.rg_lru.ops import rg_lru
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref
    B, S, di, dt = 64, 128, 4096, torch.float32
    g = torch.Generator(device=dev).manual_seed(SEED + 6)

    def draw():
        return torch.randn((B, S, di), generator=g, device=dev)
    log_a = -8.0 * torch.sigmoid(draw()) * torch.nn.functional.softplus(
        torch.tensor(2.0, device=dev))
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * log_a), 1e-6)) \
        * torch.sigmoid(draw()) * draw()
    del log_a
    out = rg_lru(a, b)
    ref = rg_lru_ref(a, b)
    err = max_err(out, ref)
    tol = RG_LRU_TOL[dt]
    ok = torch.allclose(out, ref, atol=tol, rtol=tol)
    nbytes = 3 * a.numel() * a.element_size()     # read a, b; write h
    b_ms, b_by = bound_ms(nbytes, 2 * a.numel(), dt)
    row = dict(
        name="rg_lru", route="cuda", source="src/repro_torch/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru/kernel.py:43",
        shape=f"a, b ({B}, {S}, {di}) f32",
        max_abs_err=err, atol=tol, rtol=tol, ok=ok,
        ms=time_ms(lambda: rg_lru(a, b), flush),
        plain_ms=time_ms(lambda: rg_lru_ref(a, b), flush, iters=5),
        library_ms=None, library=None, bound_ms=b_ms, bound_by=b_by)
    log(**row)
    return row


# --------------------------------------------------------------------------
# phase 3: the main path at full width
# --------------------------------------------------------------------------
WORDS = ("join hash sort merge index vector query table column duckdb "
         "semantic model prompt batch cache embedding rerank filter plan "
         "optimizer scan fusion retrieval passage answer score").split()


def passages(rng, n, lo, hi):
    out = []
    for _ in range(n):
        words, size = [], int(rng.integers(lo, hi))
        while len(" ".join(words)) < size:
            words.append(str(rng.choice(WORDS)))
        out.append(" ".join(words)[:size])
    return out


def counters():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.topk_sim.ops import block_max_scores
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "topk_sim.block_max_scores": block_max_scores}


def main_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.core import (LocalTorchProvider, ModelResource,
                                  build_metaprompt)
    from repro_torch.params import init_params
    from repro_torch.retrieval import VectorIndex

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    log(phase="weights", arch=cfg.name, params=cfg.num_params(),
        layers=cfg.num_layers, d_model=cfg.d_model,
        seconds=time.perf_counter() - t0)
    provider = LocalTorchProvider("olmo-1b", use_smoke_config=False,
                                  device=dev, params=params)
    engine = provider.engine
    rng = np.random.default_rng(SEED)
    docs = passages(rng, 256, 90, 129)          # embed bucket L = 128
    questions = passages(rng, 8, 30, 60)
    emb_model = ModelResource("olmo-embed", 1, "olmo-1b")
    gen_model = ModelResource("olmo-gen", 1, "olmo-1b", max_output_tokens=16)

    counts = counters()
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # llm_embedding of the corpus, 64 passages per request
    doc_vecs = np.concatenate([provider.embed(emb_model, docs[i:i + 64])
                               for i in range(0, len(docs), 64)])
    index = VectorIndex(doc_vecs, device=dev)
    q_vecs = provider.embed(emb_model, questions)
    scores, ids = index.topk(q_vecs, k=10)
    # RAG answers: each question over its top-3 passages
    answers, new_tokens = [], []
    for qi, question in enumerate(questions):
        mp = build_metaprompt(
            "complete", f"Answer using the passages: {question}",
            [{"passage": docs[j]} for j in ids[qi, :3]])
        before = provider.stats.snapshot()["output_tokens"]
        answers.append(provider.complete(gen_model, mp, 1))
        new_tokens.append(provider.stats.snapshot()["output_tokens"]
                          - before)
    # raw requests, 4 slots busy at once
    raw = [engine.submit([int(t) for t in rng.integers(0, 256, n)],
                         max_new_tokens=16)
           for n in rng.integers(40, 300, 8)]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated()

    check(doc_vecs.shape == (256, cfg.d_model)
          and np.isfinite(doc_vecs).all()
          and np.allclose(np.linalg.norm(doc_vecs, axis=1), 1.0, atol=1e-3),
          "corpus embeddings are finite unit vectors")
    check(ids.shape == (8, 10) and (0 <= ids).all() and (ids < 256).all()
          and np.all(np.diff(scores, axis=1) <= 1e-6),
          "top-10 ids in range, scores descending")
    check(all(n == 16 for n in new_tokens), f"completions: {new_tokens}")
    check(all(len(a) == 1 and a[0].startswith("0: ") for a in answers),
          "completion rows in contract shape")
    check(all(r.finished and len(r.generated) == 16 for r in raw),
          "raw requests generated 16 tokens each")
    stats = provider.stats.snapshot()
    log(phase="main_path", requests=len(docs) // 64 + 1 + len(questions)
        + len(raw), embed_texts=len(docs) + len(questions),
        completions=len(questions), raw_requests=len(raw),
        prompt_tokens=stats["prompt_tokens"]
        + sum(len(r.prompt) for r in raw),
        generated_tokens=stats["output_tokens"]
        + sum(len(r.generated) for r in raw),
        engine_steps=engine.steps, wall_s=wall,
        peak_memory_gb=peak / 1e9, launches=launches)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    return provider, docs, launches


# --------------------------------------------------------------------------
# phase 4: the path through the kernels against the plain versions
# --------------------------------------------------------------------------
def _map(fn, tree):
    """``fn`` applied to every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def compare_decode_rounding(engine, prefix):
    """One full-width decode step from the engine's cache (cloned: the step
    writes in place) against the plain path.  Over a random-weight stack
    one bf16 ulp in one attention output moves the bf16 logits by more
    than LOGITS_TOL (logged as the one-ulp noise floor), so at bf16 the
    step holds each of its decode-attention calls against the plain
    version on the same inputs (TOLS), and the logits are held at
    LOGITS_TOL in the same step in f32 (weights and cache cast to f32, the
    kernel's f32 instance), where rounding stays far below it."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    dev, bf16 = engine.device, torch.bfloat16
    toks = torch.tensor([[101], [7], [230], [64]], dtype=torch.int32,
                        device=dev)
    pos = torch.tensor([1500, 700, 123, 9], dtype=torch.int32, device=dev)
    kernel = L.decode_ops.decode_attention

    def step(fn, cfg, params, cache):
        with mock.patch.object(L.decode_ops, "decode_attention", fn):
            return M.decode_step(cfg, params, toks,
                                 _map(torch.clone, cache), pos)[0]

    calls = []

    def held(q, k, v, p, window=0, scale=None):
        out = kernel(q, k, v, p, window=window, scale=scale)
        ref = decode_attention_ref(q, k, v, p, window=window, scale=scale)
        calls.append((max_err(out, ref), torch.allclose(
            out.float(), ref.float(), atol=TOLS[bf16], rtol=TOLS[bf16])))
        return out
    held.launches = 0        # the wrapper counts under its module-level name

    def one_ulp(q, k, v, p, window=0, scale=None):
        ref = decode_attention_ref(q, k, v, p, window=window, scale=scale)
        if not one_ulp.done:         # first call, first element, one ulp
            ref.view(-1).view(torch.int16)[0] += 1
            one_ulp.done = True
        return ref
    one_ulp.done = False

    args = (engine.cfg, engine.params, engine.cache)
    kern, plain = step(held, *args), step(decode_attention_ref, *args)
    floor = max_err(step(one_ulp, *args), plain)
    f32 = engine.cfg.replace(param_dtype="float32", compute_dtype="float32")
    args32 = (f32, _map(torch.Tensor.float, engine.params),
              _map(torch.Tensor.float, engine.cache))
    kern32 = step(kernel, *args32)
    plain32 = step(decode_attention_ref, *args32)
    del args32
    torch.cuda.empty_cache()
    err32 = max_err(kern32, plain32)
    ok32 = torch.allclose(kern32, plain32, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    log(phase=f"{prefix}decode_step_vs_plain", logits=list(kern.shape),
        pos=pos.tolist(), bf16_calls=len(calls),
        bf16_call_max_abs_err=[e for e, _ in calls],
        bf16_calls_ok=all(ok for _, ok in calls),
        call_atol=TOLS[bf16], call_rtol=TOLS[bf16],
        bf16_logits_max_abs_err=max_err(kern, plain),
        bf16_noise_floor_one_ulp=floor,
        f32_logits_max_abs_err=err32, atol=LOGITS_TOL, rtol=LOGITS_TOL,
        ok=ok32)
    check(torch.isfinite(kern).all().item() and
          torch.isfinite(kern32).all().item(), f"{prefix}decode logits finite")
    check(len(calls) > 0 and all(ok for _, ok in calls),
          f"{prefix}a decode_attention call of the bf16 step differs from "
          f"its plain version: {calls}")
    check(ok32, f"{prefix}f32 decode_step logits differ from the plain path "
          f"by {err32}")


def compare_embed_plain(provider, docs, prefix=""):
    """One 64-text embed batch through the kernels and through every
    full-sequence kernel's plain version (flash attention, the selective
    scan, the RG-LRU recurrence: whichever the model runs)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers as L
    engine = provider.engine
    tokens = [provider._tokenize(t, engine.cfg.vocab_size) for t in docs[:64]]
    e_kern = engine.embed_batch(tokens)
    with mock.patch.object(L.flash_ops, "flash_attention", attention_ref), \
            mock.patch.object(L.ssm_ops, "ssm_scan", ssm_scan_ref), \
            mock.patch.object(L.rglru_ops, "rg_lru", rg_lru_ref):
        e_plain = engine.embed_batch(tokens)
    cos = float(np.min(np.sum(e_kern * e_plain, axis=1)))
    err = float(np.abs(e_kern - e_plain).max())
    log(phase=f"{prefix}embed_vs_plain", texts=len(tokens), min_cosine=cos,
        max_abs_err=err)
    check(cos > 0.999, f"{prefix}embeddings differ from the plain path "
          f"(cos {cos})")


# --------------------------------------------------------------------------
# phase 5: where the device time goes on the main path
# --------------------------------------------------------------------------
# a kernel falls in the first group one of whose markers its name holds
KERNEL_GROUPS = (("flash_attention", ("flash_fwd_",)),
                 ("decode_attention", ("decode_mma_kernel",
                                       "decode_partial_kernel",
                                       "decode_combine_kernel")),
                 ("topk_sim.block_max_scores", ("block_max_kernel",)),
                 ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                             "sm90_")),
                 ("reduction", ("reduce_kernel",)),
                 ("elementwise", ("elementwise_kernel",)),
                 ("copy", ("Memcpy", "Memset", "copy")))


def profile_window(provider):
    """Trace the engine serving 4 requests at once (chunked prefill, then
    decode on all slots) and report the device's busy time by kernel
    group, and its idle share of the window's wall time.  Only device
    activity is traced: host-side op events would multiply the trace, and
    its post-processing, several times over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = provider.engine
    rng = np.random.default_rng(SEED + 3)
    for n in (100, 80, 60, 40):
        engine.submit([int(t) for t in rng.integers(0, 256, n)],
                      max_new_tokens=8)
    steps0 = engine.steps
    torch.cuda.synchronize()
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        rows.append((us, e.count, e.key))
    check(bool(rows), "the profiler recorded no device time")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for us, _, key in rows:
        name = next((g for g, marks in KERNEL_GROUPS
                     if any(m in key for m in marks)), "other")
        groups[name] += us / 1e3
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    steps = engine.steps - steps0
    decode_marks = dict(KERNEL_GROUPS)["decode_attention"]
    decode = {mark: sum(n for _, n, key in rows if mark in key)
              for mark in decode_marks}
    log(phase="profile", engine_steps=steps, wall_s=wall,
        trace_s=time.perf_counter() - t_trace,
        host_ms_per_step=wall * 1e3 / steps, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / (wall * 1e3),
        device_ms_by_group=groups, decode_kernel_calls=decode,
        top_kernels=[{"kernel": key[:80], "calls": n, "ms": us / 1e3}
                     for us, n, key in sorted(rows, reverse=True)[:12]])
    # bf16 decode attention is one launch a call: no merge kernel
    check(decode["decode_mma_kernel"] > 0
          and decode["decode_combine_kernel"] == 0,
          f"bf16 decode attention's kernels in the trace: {decode}")


# --------------------------------------------------------------------------
# phases 6 and 7: falcon-mamba-7b and recurrentgemma-9b at full width
# --------------------------------------------------------------------------
MAMBA = "falcon-mamba-7b"
RGEMMA = "recurrentgemma-9b"


def _layer_counts(cfg) -> dict:
    kinds = [k for pattern, reps in cfg.stages() for k in pattern * reps]
    return {k: kinds.count(k) for k in set(kinds)}


def serve_path(dev, arch, prefix, counts, per_embed, per_decode, seed):
    """Serve ``arch`` at full width through the same entry points as the
    main path: one 64-passage embed request, a question request, a
    device-resident index and top-5, 2 RAG completions, 5 raw requests on
    4 slots.  ``counts`` are the kernel wrappers of this path, set to 0
    just before it and read just after; each must equal its launches per
    embed request (``per_embed``) or per decode step (``per_decode``)
    times the requests or steps of this run.  Then each raw request is
    served again alone in a fresh engine (a reused slot must not carry its
    last occupant's state), and an embed batch and, where decode runs a
    kernel, a decode step go through the kernels against the plain
    versions."""
    from repro_torch.configs import get_config
    from repro_torch.core import (LocalTorchProvider, ModelResource,
                                  build_metaprompt)
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    from repro_torch.retrieval import VectorIndex
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    log(phase=f"{prefix}weights", arch=cfg.name, params=cfg.num_params(),
        layers=cfg.num_layers, layer_kinds=_layer_counts(cfg),
        d_model=cfg.d_model, d_inner=cfg.d_inner,
        ssm_state=cfg.ssm_state, vocab=cfg.vocab_size,
        weight_gb=sum(t.numel() * t.element_size()
                      for t in _tensors(params)) / 1e9,
        seconds=time.perf_counter() - t_phase,
        init_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    provider = LocalTorchProvider(arch, use_smoke_config=False, device=dev,
                                  params=params)
    engine = provider.engine
    rng = np.random.default_rng(seed)
    docs = passages(rng, 64, 90, 129)           # one request, bucket 128
    questions = passages(rng, 4, 30, 60)
    emb_model = ModelResource(f"{prefix}embed", 1, arch)
    gen_model = ModelResource(f"{prefix}gen", 1, arch, max_output_tokens=8)

    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(M, "decode_step", wraps=M.decode_step) as dec:
        doc_vecs = provider.embed(emb_model, docs)
        index = VectorIndex(doc_vecs, device=dev)
        q_vecs = provider.embed(emb_model, questions)
        embed_requests = 2
        scores, ids = index.topk(q_vecs, k=5)
        answers, new_tokens = [], []
        for qi in range(2):
            mp = build_metaprompt(
                "complete", f"Answer using the passages: {questions[qi]}",
                [{"passage": docs[j]} for j in ids[qi, :3]])
            before = provider.stats.snapshot()["output_tokens"]
            answers.append(provider.complete(gen_model, mp, 1))
            new_tokens.append(provider.stats.snapshot()["output_tokens"]
                              - before)
        # 5 raw requests on 4 slots: the fifth takes a freed slot
        prompts = [[int(t) for t in rng.integers(0, 256, n)]
                   for n in rng.integers(40, 120, 5)]
        raw = [engine.submit(p, max_new_tokens=8) for p in prompts]
        engine.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    decode_steps = dec.call_count
    peak = torch.cuda.max_memory_allocated()

    check(doc_vecs.shape == (64, cfg.d_model)
          and np.isfinite(doc_vecs).all()
          and np.allclose(np.linalg.norm(doc_vecs, axis=1), 1.0, atol=1e-3),
          f"{arch} corpus embeddings are finite unit vectors")
    check(ids.shape == (4, 5) and (0 <= ids).all() and (ids < 64).all()
          and np.all(np.diff(scores, axis=1) <= 1e-6),
          f"{arch} top-5 ids in range, scores descending")
    check(new_tokens == [8, 8]
          and all(len(a) == 1 and a[0].startswith("0: ") for a in answers),
          f"{arch} completions: {new_tokens}")
    check(all(r.finished and len(r.generated) == 8 for r in raw),
          f"{arch} raw requests generated 8 tokens each")
    expected = {**{n: k * embed_requests for n, k in per_embed.items()},
                **{n: k * decode_steps for n, k in per_decode.items()}}
    for name, n in launches.items():
        check(n > 0 and n == expected[name],
              f"{arch}: {name} launched {n} times, not {expected[name]}")
    stats = provider.stats.snapshot()
    log(phase=f"{prefix}path", arch=cfg.name, embed_requests=embed_requests,
        embed_texts=len(docs) + len(questions), completions=len(answers),
        raw_requests=len(raw), slots=engine.n_slots,
        raw_slots=[r.slot for r in raw],
        prompt_tokens=stats["prompt_tokens"] + sum(map(len, prompts)),
        generated_tokens=stats["output_tokens"]
        + sum(len(r.generated) for r in raw),
        engine_steps=engine.steps, decode_steps=decode_steps, wall_s=wall,
        peak_memory_gb=peak / 1e9, launches=launches,
        launches_per_embed_request=per_embed,
        launches_per_decode_step=per_decode)

    # each raw request against itself served alone from a fresh state
    t1 = time.perf_counter()
    alone = []
    for p in prompts:
        fresh = ServingEngine(cfg, n_slots=engine.n_slots,
                              max_context=engine.max_context, device=dev,
                              params=params)
        alone.append(fresh.generate(p, max_new_tokens=8))
        del fresh
    same = [r.generated == a for r, a in zip(raw, alone)]
    log(phase=f"{prefix}reused_slots", same_as_alone=same,
        fifth_request_slot=raw[4].slot, seconds=time.perf_counter() - t1)
    check(all(same), f"{arch}: a request in a reused slot differs from its "
          f"run from a fresh state: {same}")

    compare_embed_plain(provider, docs, prefix)
    if per_decode:
        compare_decode_rounding(engine, prefix)
    log(phase=f"{prefix}phase", wall_s=time.perf_counter() - t_phase)
    return launches


def mamba_path(dev):
    """Phase 6: falcon-mamba-7b, whose embed requests run the selective
    scan once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    n = _layer_counts(get_config(MAMBA))
    return serve_path(dev, MAMBA, "mamba_", {"ssm_scan": ssm_scan},
                      {"ssm_scan": n["mamba"]}, {}, SEED + 4)


def rgemma_path(dev):
    """Phase 7: recurrentgemma-9b, whose embed requests run the RG-LRU
    recurrence in each "rec" layer and flash attention in each "local"
    layer, and whose decode steps run decode attention in each "local"
    layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rg_lru.ops import rg_lru
    n = _layer_counts(get_config(RGEMMA))
    return serve_path(
        dev, RGEMMA, "rg_",
        {"rg_lru": rg_lru, "flash_attention": flash_attention,
         "decode_attention": decode_attention},
        {"rg_lru": n["rec"], "flash_attention": n["local"]},
        {"decode_attention": n["local"]}, SEED + 9)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def free_device(what: str):
    gc.collect()
    torch.cuda.empty_cache()
    log(phase=f"{what}_freed",
        allocated_gb=torch.cuda.memory_allocated() / 1e9)


KERNEL_ID_KEYS = ("name", "route", "source", "replaces")
KERNEL_RUN_KEYS = ("max_abs_err", "ok", "ms", "plain_ms", "bound_ms",
                   "bound_by", "library_ms")
DEVICE_KEYS = ("device_ms", "library_device_ms")    # where a row has them


def run_keys(row) -> dict:
    return {k: row[k] for k in KERNEL_RUN_KEYS + DEVICE_KEYS if k in row}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(phase="card", card=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    lib = _build.build()
    log(phase="build", seconds=time.perf_counter() - t0, library=lib.name,
        nvcc_seconds=_build.BUILD_LOG.get("seconds"))
    flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB
    attention_instances(_build)
    flash = check_flash(dev, flush)
    decode, rg_decode = check_decode_rows(dev, flush)
    topk = check_topk(dev, flush)
    ssm = check_ssm(dev, flush)
    # recurrentgemma-9b's shapes: 16 query heads over 1 KV head of 256
    rg_flash = check_flash(dev, flush, KH=1, hd=256, window=2048,
                           seed=SEED + 7)
    rg = check_rg_lru(dev, flush)
    del flush
    torch.cuda.empty_cache()
    for row in (flash, *decode, topk, ssm, rg_flash, *rg_decode, rg):
        check(row["ok"], f"{row['name']} disagrees with its plain version "
              f"({row['shape']})")

    provider, docs, olmo = main_path(dev)
    compare_decode_rounding(provider.engine, "")
    compare_embed_plain(provider, docs)
    profile_window(provider)
    del provider, docs
    free_device("olmo")
    mamba = mamba_path(dev)
    free_device("mamba")
    rgemma = rgemma_path(dev)

    by_path = {"olmo-1b": olmo, MAMBA: mamba, RGEMMA: rgemma}
    kernels = []
    for row, wide in ((flash, rg_flash), (decode[0], rg_decode[0]),
                      (topk, None), (ssm, None), (rg, None)):
        name = row["name"]
        paths = {p: n[name] for p, n in by_path.items() if name in n}
        entry = dict({k: row[k] for k in KERNEL_ID_KEYS}, **run_keys(row),
                     launches=sum(paths.values()), launches_by_path=paths)
        if wide is not None:        # the same kernel at this path's shapes
            entry[RGEMMA] = run_keys(wide)
        kernels.append(entry)
    log(phase="total", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
