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
     of its embed batch, di=4096, f32; the dense models of phases 8-10:
     flash attention of granite-8b's and qwen1.5-32b's 64-text embed batch
     (32 query heads over 8 KV heads of 128; 40 heads of 128) and of
     gemma3-12b's 4 texts of 2,048 tokens (16 query heads over 8 KV heads
     of 256, window 1,024), decode attention at each one's heads over 4
     slots x 2048 positions, gemma3-12b's past its window; whisper-base of
     phase 12: flash attention without the causal mask over 4 clips of
     1,500 frames, 8 heads of 64, against SDPA without a mask, decode
     attention at 8 heads of 64, and its decoder's causal flash attention
     over 4 texts of 128; phi-3-vision-4.2b of phase 13: flash attention
     of a 64-text embed request and of 4 images of 144 patches with 128
     tokens, decode attention, all at 32 heads of 96), with CUDA-event
     times of the
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
  5b. the plan layer (``repro_torch.core``) over phase 3's provider:
     llm_filter, llm_complete and llm_embedding over a 32-row table (8
     rows repeated), llm_reduce over 8 rows and llm_rerank over 16, through
     one SemanticContext with a RequestScheduler (4 workers) and a fresh
     prediction cache, then again on that context, then with no scheduler:
     each call's request counts equal the same call's on MockProvider, the
     second pass sends no request, the serial run returns the same
     results, every request generates its full length, the embeddings
     match provider.embed, and flash and decode attention launch in this
     phase; in the serial run every flash-attention call and one
     decode-attention call in 7 are held against the plain version on the
     same inputs (the phase's own shapes: one live slot of four, positions
     up to ~1,900, a 24-text embed batch), and the embed batch of its
     distinct texts through the kernels against the same through the
     plain versions;
  5c. paper Query 3 as one plan over phase 3's provider: a corpus Table
     of 8,192 passages and 4 questions through ``Pipeline.hybrid_topk``
     (k 8 of 32 candidates) then ``llm_rerank(by="q")``, with 4 scheduler
     workers, an in-memory prediction cache and an ``IndexStore`` in a
     temporary directory: ``check()`` clean, ``collect(verify="strict")``,
     the embed reports and provider calls equal to the same plan's on
     MockProvider, every block-max call and one flash call in 17 and one
     decode call in 7 held against the plain version on the same inputs,
     each question's 32 vector candidates against the plain scan over the
     same index (ids exact but for logged near-ties, scores within 1e-5),
     a second collect that sends nothing, a fresh context that reads the
     index from the store and embeds only the questions, 1,024 appended
     passages (only they embedded; the grown index ranks as one built from
     scratch), the IVF route at full probe against the exact plan and
     ``ann="auto"``'s choice and recall@8 logged; a third collect under
     phase 15's mesh of 4 shards on the card returns the same table,
     sends nothing and scans through the mesh (block-max launched 4 times
     a scan); block-max, flash and decode attention launch in this phase;
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
  8. recurrentgemma-9b freed, granite-8b at full width as phase 6 runs
     falcon-mamba-7b (weights drawn on the card one layer at a time):
     flash attention in each of its 36 layers per embed request, decode
     attention in each per decode step; an embed batch and a decode step
     against the plain versions; each raw request against a fresh engine;
  9. gemma3-12b the same way (48 layers, 40 of them local with a window of
     1,024), with a raw request of 1,500 tokens, whose chunked prefill and
     decode run past the window, and an embed request of 4 texts of
     1,100-1,500 bytes (bucket 2,048), whose flash calls the window cuts,
     held against the plain path too;
  10. qwen1.5-32b the same way (64 layers, 40 heads of 128, qkv bias) on
     the int8 KV cache of 4 slots x 2,048 tokens, through a
     ``ServingEngine`` on that cache inside the provider; the device time
     of its decode steps split into the weight GEMMs, the cache's
     dequantization and the decode kernel; then, the model freed, a decode
     step held against the plain path on its configuration cut to 4
     layers (at 64 the f32 step would not fit beside the weights);
  11. qwen1.5-32b freed, deepseek-moe-16b at full width as phase 8 runs
     granite-8b (28 layers of 16 heads of 128, each with an MoE FFN of 64
     routed experts top-6 and 2 shared; flash attention 28 times per embed
     request, decode attention 28 times per decode step), with a wrapper
     around the MoE layers' routing that sums the dropped assignments by
     group length (none may drop in a decode group) and logs, in the
     embed batch and decode step held against the plain path, the tokens
     whose top-k experts differ between the two runs; then layer 0 at
     full width against an oracle written here, on a decode group of 4
     tokens, a prefill chunk of 32 and an embed row of 128: in f32 within
     1e-4, in bf16 within 2e-2, the same drops, the bf16 call repeated
     bitwise equal; and the device time of 3 decode steps split as in
     phase 10 (the expert GEMMs read every expert's weights a step);
  12. deepseek-moe-16b freed, whisper-base at full width (6 encoder and 6
     decoder layers, d 512, 8 heads of 64), served as the JAX package
     serves it: a 4-slot engine answers 2 text requests on its default
     cache (zero cross-attention keys and values) and refuses an embed
     request without frames (``KeyError``, ROADMAP C.15); then its cache
     is ``encode_for_cache`` of 4 random clips of 1,500 frames (the
     encoder runs flash attention without the causal mask, once a layer)
     and it serves 8 requests of 32 new tokens, two a slot, and the embed
     step runs over 4 (text, clip) pairs; every flash call and one decode
     call in 7 held against the plain version, flash attention counted
     6 times a cache and 12 times an embed step, decode attention 6
     times a decode step; a decode step and a 64-pair embed batch against
     the plain path, prefill and decode in f32 against teacher forcing,
     the decode step's device split, and each request against a fresh
     engine whose slot holds the same clip;
  13. whisper-base freed, phi-3-vision-4.2b at full width (32 layers, d
     3,072, 32 heads of 96: the attention kernels' hd-96 instances), text
     served as the JAX package serves it, as phase 8 runs granite-8b
     (flash attention 32 times an embed request, decode attention 32
     times a decode step); then, on the same weights, 4 random images of
     144 patch embeddings through the model's entry points (the engine
     takes no patches, ROADMAP C.16): ``prefill`` over (image, text) rows
     and 16 greedy decode steps from next_pos = 144 + 64, and the embed
     step over 4 (text, image) pairs, every flash call and one decode
     call in 7 held against the plain version; a 16-pair embed batch
     against the plain path, the decode step's device split, and, the
     model freed, prefill with patches and decode in f32 against teacher
     forcing on the config cut to 4 layers;
  14. the trainer (``repro_torch.launch.train``): olmo-1b at full width
     and depth (bf16 params, remat) trained 6 AdamW steps at global batch
     8 x 512 tokens, each step's loss, rate, grad norm and wall and the
     peak memory logged, the losses and norms finite, and no kernel
     launched (the training route is plain, as the JAX package's); one
     f32 train step of olmo-1b cut to 2 layers on the card against the
     same step on the CPU (loss 1e-5 relative, each gradient leaf 1e-4 of
     its largest magnitude); the resume drill on the cut config (4 steps,
     checkpoints every 2, a run dying at step 3 resumed with ``--resume
     auto``) under ``torch.use_deterministic_algorithms(True)``, resumed
     losses and final checkpoint bitwise the uninterrupted run's; the
     drill's last checkpoint served through ``ServingEngine(cfg,
     checkpoint=...)`` (its params bitwise the trained ones, 4 requests of
     16 new tokens and an embed request, every flash call and one decode
     call in 7 held against the plain version);
  15. the mesh-sharded scan on one card: ``VectorIndex(mesh=)`` over a
     mesh of 4 entries of the card (``launch.mesh.make_mesh``) at
     1,000,000 x 2048 f32 passages, for 8 queries at k 100 and 4 at k 32:
     block_max_scores launched 4 times a call (counted from 0 before each
     call), ids equal to the single-card route's and the plain scan's but
     for logged near-ties within 1e-6, scores within 1e-5, each route's
     device time and the call's wall, the kernel at the shard's shape
     against its plain version; then ``launch/serve.py`` at full olmo-1b
     width on the card (8 requests of 16 new tokens on 4 slots), every
     request finished and decode attention launched 16 times a decode
     step, one call in 7 held against the plain version over the
     launcher's 256-position cache;
  16. the script's wall time, a ``{"kernels": [...]}`` line (each kernel's
     launches summed over the paths, and by path: olmo-1b, plan, query3,
     falcon-mamba-7b, recurrentgemma-9b, granite-8b, gemma3-12b,
     qwen1.5-32b, deepseek-moe-16b, whisper-base, phi-3-vision-4.2b,
     train, sharded, serve; flash and decode attention also with their run
     keys at each model's shapes, block-max at the shard's), then the
     card, then the result line.

Weights are random, drawn from a fixed seed; phase 14 writes its
checkpoints into a temporary directory and removes it.
Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

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
F32_LOGITS_TOL = 1e-4                       # f32 model tolerance of the tests
# whisper's embed step against the plain path: min cosine above 1 - this
# (0.9999984 on an H100 80GB HBM3 at 700 W)
WHISPER_EMBED_COS_GAP = 1e-4


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
def causal_pairs(L: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention over L positions computes,
    each query seeing at most ``window`` keys when ``window`` > 0."""
    if not window or window >= L:
        return L * (L + 1) // 2
    return window * (window + 1) // 2 + (L - window) * window


def check_flash(dev, flush, B=64, L=128, H=16, KH=16, hd=128, window=0,
                causal=True, seed=SEED):
    """Flash attention on an embed batch: by default olmo-1b's (64 texts of
    128 tokens, 16 heads of 128); recurrentgemma-9b's with ``KH=1, hd=256,
    window=2048``; the dense models at their head counts (gemma3-12b's
    with 4 texts of 2048 tokens, where its window of 1024 cuts);
    whisper-base's encoder over 4 clips of 1,500 frames without the causal
    mask (``causal=False``).  SDPA is the yardstick, with an explicit mask
    where the window cuts."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, L, H, hd), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, L, KH, hd), generator=g, device=dev).to(dt)
            for _ in range(2))

    def kern():
        return flash_attention(q, k, v, causal=causal, window=window)

    def plain():
        return attention_ref(q, k, v, causal=causal, window=window)
    out, ref = kern(), plain()
    err = max_err(out, ref)
    # also normalised by the output's scale: over 1,500 keys the outputs
    # are small beside the absolute tolerance
    norm_err = err / ref.float().abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=TOLS[dt],
                        rtol=TOLS[dt]) and norm_err <= TOLS[dt]
    del out, ref
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = {} if KH == H else {"enable_gqa": True}
    cuts = causal and 0 < window < L
    if not causal:
        def lib():
            return sdpa(qt, kt, vt, **gqa)
    elif cuts:
        i = torch.arange(L, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

        def lib():
            return sdpa(qt, kt, vt, attn_mask=mask, **gqa)
    else:
        # a window of at least L masks nothing beyond the causal mask
        def lib():
            return sdpa(qt, kt, vt, is_causal=True, **gqa)
    k_ms, lib_ms = time_pairs_ms(kern, lib, flush)
    med, lib_med = statistics.median(k_ms), statistics.median(lib_ms)
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    pairs = causal_pairs(L, window) if causal else L * L
    flops = 4 * B * H * pairs * hd
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    kind = "causal" if causal else "non-causal"
    shape = (f"q,k,v ({B}, {L}, {H}, {hd}) bf16 {kind}" if KH == H else
             f"q ({B}, {L}, {H}, {hd}), k,v ({B}, {L}, {KH}, {hd}) bf16 "
             f"{kind}")
    if window:
        shape += f", window {window}"
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80",
        shape=shape,
        max_abs_err=err, max_normalised_err=norm_err, atol=TOLS[dt],
        rtol=TOLS[dt], ok=ok, ms=med, ms_min=min(k_ms), plain_ms=time_ms(plain, flush, iters=5),
        library_ms=lib_med, library_ms_min=min(lib_ms),
        library="F.scaled_dot_product_attention"
        + ("(mask" if cuts else "(") + (", enable_gqa)" if gqa else ")"),
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


def check_decode(dev, flush, S=2048, H=16, KH=16, hd=128,
                 positions=(1900, 1024, 300, 37), windows=(0, 512),
                 seed=SEED + 1):
    """Decode attention over 4 slots: olmo-1b's (16 query and 16 KV heads
    of 128, a 2048-slot cache) by default, recurrentgemma-9b's with
    ``KH=1, hd=256`` and positions past its window of 2048, the dense
    models of this slice at their head counts.  The kernel and masked SDPA
    are timed in 50 interleaved pairs (CUDA events around each call) and
    by their device time (the kernels one call launches)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, dt = 4, torch.bfloat16
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


# the dense models of phases 8-10, whisper-base of phase 12 and
# phi-3-vision-4.2b of phase 13 at their served widths: (flash attention of
# an embed request, or of whisper's encoder over 4 clips; decode attention
# over the engine's 4 x 2048 cache)
DENSE_SHAPES = {
    "granite-8b": (dict(H=32, KH=8, hd=128),
                   dict(H=32, KH=8, hd=128, windows=(0,))),
    # a 4-text request of 2,048 tokens, where the window of 1,024 cuts (at
    # 64 texts the plain version's f32 scores alone would take 17 GB);
    # decode positions past the window
    "gemma3-12b": (dict(B=4, L=2048, H=16, KH=8, hd=256, window=1024),
                   dict(H=16, KH=8, hd=256, windows=(1024,),
                        positions=(2000, 1500, 1100, 37))),
    "qwen1.5-32b": (dict(H=40, KH=40, hd=128),
                    dict(H=40, KH=40, hd=128, windows=(0,))),
    # the encoder's self-attention over 1,500 frames, no causal mask
    "whisper-base": (dict(B=4, L=1500, H=8, KH=8, hd=64, causal=False),
                     dict(H=8, KH=8, hd=64, windows=(0,))),
    # 32 heads of 96 (MHA): a 64-text embed request of text alone
    "phi-3-vision-4.2b": (dict(H=32, KH=32, hd=96),
                          dict(H=32, KH=32, hd=96, windows=(0,))),
}
# flash attention of the embed steps whose shapes the rows above miss, by
# path key: phi-3-vision's over 4 images of 144 patches and 128 tokens (272
# positions, no multiple of a tile), whisper-base's causal decoder over 4
# texts of 128
EMBED_FLASH_SHAPES = {
    "phi-3-vision-4.2b_prefix": dict(B=4, L=144 + 128, H=32, KH=32, hd=96),
    "whisper-base_decoder": dict(B=4, L=128, H=8, KH=8, hd=64),
}


def check_dense_rows(dev, flush):
    """Phase 2's flash and decode rows at the shapes of phases 8-10, 12
    and 13: ({arch: (flash row, decode row)}, {path key: flash row} of
    ``EMBED_FLASH_SHAPES``)."""
    dense = {arch: (check_flash(dev, flush, seed=SEED + 10 + i, **fl),
                    check_decode(dev, flush, seed=SEED + 20 + i, **dec)[0])
             for i, (arch, (fl, dec)) in enumerate(DENSE_SHAPES.items())}
    embed = {key: check_flash(dev, flush, seed=SEED + 30 + i, **kw)
             for i, (key, kw) in enumerate(EMBED_FLASH_SHAPES.items())}
    return dense, embed


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


def _f32_layer(tree, r):
    """Repeat ``r`` of a stacked stage tree with its floating leaves cast
    to f32 (copies; int8 cache values stay int8): patched over the model's
    ``_index``, a step casts each layer's weights and cache as it reaches
    that layer, so no f32 copy of the whole stack is ever resident."""
    return _map(lambda t: t[r].float() if t.is_floating_point() else t[r],
                tree)


def compare_decode_rounding(engine, prefix, routes=None, **note):
    """One full-width decode step from the engine's cache (cloned: the step
    writes in place) against the plain path.  Over a random-weight stack
    one bf16 ulp in one attention output moves the bf16 logits by more
    than LOGITS_TOL (logged as the one-ulp noise floor), so at bf16 the
    step holds each of its decode-attention calls against the plain
    version on the same inputs (TOLS), and the logits are held at
    LOGITS_TOL in the same step in f32 (weights and cache cast to f32 a
    layer at a time, the kernel's f32 instance), where rounding stays far
    below it.  ``note`` is logged with the result (a cut of the model).
    With ``routes`` (a ``MoeRoutes`` in place) the tokens whose top-k
    experts differ between the kernel and the plain step are logged, in
    bf16 and in f32, so that a routing flip can be told from a fault."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    dev, bf16 = engine.device, torch.bfloat16
    toks = torch.tensor([[101], [7], [230], [64]], dtype=torch.int32,
                        device=dev)
    pos = torch.tensor([1500, 700, 123, 9], dtype=torch.int32, device=dev)
    kernel = L.decode_ops.decode_attention

    def step(fn, cfg, params, cache, label):
        if routes is not None:
            routes.begin(label)
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
    kern = step(held, *args, "kernel")
    plain = step(decode_attention_ref, *args, "plain")
    floor = max_err(step(one_ulp, *args, "one_ulp"), plain)
    f32 = engine.cfg.replace(param_dtype="float32", compute_dtype="float32")
    # the embedding, final norm and head whole; each layer as it is reached
    params32 = {k: v if k == "stages" else _map(torch.Tensor.float, v)
                for k, v in engine.params.items()}
    with mock.patch.object(M, "_index", _f32_layer):
        kern32 = step(kernel, f32, params32, engine.cache, "kernel32")
        plain32 = step(decode_attention_ref, f32, params32, engine.cache,
                       "plain32")
    del params32
    torch.cuda.empty_cache()
    err32 = max_err(kern32, plain32)
    ok32 = torch.allclose(kern32, plain32, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    if routes is not None:
        note["routing_flips_by_layer"] = {
            "bf16": routes.flips("kernel", "plain"),
            "f32": routes.flips("kernel32", "plain32")}
        routes.end()
    log(phase=f"{prefix}decode_step_vs_plain", **note, logits=list(kern.shape),
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


def compare_embed_plain(provider, docs, prefix="", routes=None):
    """One embed batch (the first 64 texts) through the kernels and through
    every full-sequence kernel's plain version (flash attention, the
    selective scan, the RG-LRU recurrence: whichever the model runs).
    With ``routes`` (a ``MoeRoutes`` in place) the tokens whose top-k
    experts differ between the two runs are logged by layer."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers as L
    engine = provider.engine
    tokens = [provider._tokenize(t, engine.cfg.vocab_size) for t in docs[:64]]
    note = {}
    if routes is not None:
        routes.begin("kernel")
    e_kern = engine.embed_batch(tokens)
    if routes is not None:
        routes.begin("plain")
    with mock.patch.object(L.flash_ops, "flash_attention", attention_ref), \
            mock.patch.object(L.ssm_ops, "ssm_scan", ssm_scan_ref), \
            mock.patch.object(L.rglru_ops, "rg_lru", rg_lru_ref):
        e_plain = engine.embed_batch(tokens)
    if routes is not None:
        note["routing_flips_by_layer"] = routes.flips("kernel", "plain")
        routes.end()
    cos = float(np.min(np.sum(e_kern * e_plain, axis=1)))
    err = float(np.abs(e_kern - e_plain).max())
    log(phase=f"{prefix}embed_vs_plain", texts=len(tokens), min_cosine=cos,
        max_abs_err=err, **note)
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
# phase 5b: the plan layer over the full-width olmo-1b provider
# --------------------------------------------------------------------------
# BaseProvider estimates 0.33 tokens a byte and the provider feeds one token
# a byte, so a 640-token window keeps a request near 1,930 bytes: with at
# most 64 new tokens it fits the engine's 2,048 slots, which drop a longer
# request with no error (ROADMAP.md, queue C)
PLAN_WINDOW = 640
PLAN_OUT = 4
PLAN_PROMPTS = {"filter": "Is this paper about join algorithms?",
                "complete": "Name the paper's main technique.",
                "reduce": "Summarize what these papers have in common.",
                "rerank": "Rank the papers by relevance to vector search."}
PLAN_REPORT = ("n_tuples", "n_unique", "cache_hits", "requests", "retries",
               "nulls", "batch_sizes")


class HeldKernel:
    """A kernel's wrapper that holds one call in ``every`` against the
    plain version on the same inputs, at TOLS of the first input's dtype:
    allclose's test, and the same bound on the error normalised by the
    plain output's largest magnitude (max|diff| / max|ref|), which an
    absolute tolerance misses where the outputs are small.  Every call
    goes through the wrapper, whose count moves as it does on the path;
    the plain version launches no kernel.  Each held call's errors, its
    excess over the tolerance and (for decode attention) its largest
    position stay on the card until ``read``: no call waits for the
    card."""

    def __init__(self, kernel, plain, every=1):
        self.kernel, self.plain, self.every = kernel, plain, every
        self.calls, self.rows, self.shapes = 0, [], set()
        self.tol = None

    # the wrapper counts under its module-level name, which is this object
    # while the patch holds: pass the count through to the wrapper's own
    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, n):
        self.kernel.launches = n

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        self.calls += 1
        if (self.calls - 1) % self.every:
            return out
        ref = self.plain(*args, **kw).float()
        tol = self.tol = TOLS[args[0].dtype]
        diff = (out.float() - ref).abs()
        # decode attention's fourth input: the positions
        top = (args[3].max().float()
               if len(args) > 3 and torch.is_tensor(args[3])
               else diff.new_tensor(-1.0))
        self.rows.append(torch.stack(
            [diff.max(), (diff - tol - tol * ref.abs()).max(), top,
             diff.max() / ref.abs().max().clamp_min(1e-30)]))
        self.shapes.add((tuple(args[0].shape), tuple(args[1].shape)))
        return out

    def read(self) -> dict:
        check(bool(self.rows), "a held kernel was never called")
        rows = torch.stack(self.rows).cpu()
        top = int(rows[:, 2].max())
        return dict(calls=self.calls, held=len(self.rows),
                    max_abs_err=float(rows[:, 0].max()),
                    max_normalised_err=float(rows[:, 3].max()),
                    ok=bool((rows[:, 1] <= 0).all()
                            and (rows[:, 3] <= self.tol).all()),
                    max_position=top if top >= 0 else None,
                    shapes=[list(map(list, s)) for s in sorted(self.shapes)])


def plan_table(rng):
    """32 rows of {title, abstract}; the last 8 repeat earlier rows."""
    rows = [{"title": f"paper {i}", "abstract": a}
            for i, a in enumerate(passages(rng, 24, 90, 129))]
    return rows + [dict(rows[int(i)]) for i in rng.integers(0, 24, 8)]


def plan_pass(core, ctx, rows) -> dict:
    """The phase's calls, once, on ``ctx``: for each its result, the counts
    of its ``ExecutionReport`` (None for reduce and rerank, which write
    none; ``batch_sizes`` sorted, since the scheduler appends them in
    completion order), the provider counters it moved, and its wall."""
    gen, emb = {"model_name": "plan-gen"}, {"model_name": "plan-embed"}

    def prompt(kind):
        return {"prompt": PLAN_PROMPTS[kind]}

    calls = (("filter", lambda: core.llm_filter(ctx, gen, prompt("filter"),
                                                rows)),
             ("complete", lambda: core.llm_complete(
                 ctx, gen, prompt("complete"), rows)),
             ("embedding", lambda: core.llm_embedding(
                 ctx, emb, [r["abstract"] for r in rows])),
             ("reduce", lambda: core.llm_reduce(ctx, gen, prompt("reduce"),
                                                rows[:8])),
             ("rerank", lambda: core.llm_rerank(
                 ctx, gen, prompt("rerank"), rows[:16], window=6, stride=3)))
    out = {}
    for name, call in calls:
        n_reports = len(ctx.reports)
        before = ctx.provider.stats.snapshot()
        t0 = time.perf_counter()
        value = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = ctx.provider.stats.snapshot()
        report = None
        if len(ctx.reports) > n_reports:
            rep = ctx.reports[-1]
            report = {k: getattr(rep, k) for k in PLAN_REPORT}
            report["batch_sizes"] = sorted(report["batch_sizes"])
        out[name] = dict(value=value, report=report, wall_s=wall,
                         **{k: after[k] - before[k] for k in
                            ("calls", "prompt_tokens", "output_tokens")})
    return out


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return a == b


def _plan_log(run: dict) -> dict:
    return {name: {k: v for k, v in r.items() if k != "value"}
            for name, r in run.items()}


def plan_path(provider):
    """The plan layer's semantic functions through one ``SemanticContext``
    with a ``RequestScheduler(max_workers=4)`` and a fresh prediction cache
    over the phase-3 provider: llm_filter, llm_complete and llm_embedding
    over a 32-row table (8 rows repeated), llm_reduce over 8 rows and
    llm_rerank over 16 (window 6, stride 3); then the same calls again on
    that context, and once more with no scheduler and a fresh cache.  The
    counts must equal those of the same calls on ``MockProvider``, the
    second pass must send no request, the serial run must give the same
    results, every request must generate its full length, and the
    embeddings must match ``provider.embed`` called directly.  The serial
    run also holds its flash-attention calls and one decode-attention call
    in 7 against the plain version on the same inputs (``HeldKernel``),
    and the embed batch of the distinct texts is held against the plain
    path."""
    import repro_torch.core as core
    from repro_torch.core import (Catalog, MockProvider, PredictionCache,
                                  RequestScheduler, SemanticContext,
                                  build_metaprompt, estimate_tokens,
                                  serialize_tuple)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L

    rows = plan_table(np.random.default_rng(SEED + 5))
    catalog = Catalog()
    catalog.create_model("plan-gen", arch="olmo-1b",
                         context_window=PLAN_WINDOW,
                         max_output_tokens=PLAN_OUT)
    emb_model = catalog.create_model("plan-embed", arch="olmo-1b")
    # reduce sends one request for its rows and rerank one a window, and
    # neither splits on overflow: the widest of each must fit the window
    widest = sorted(rows[:16], key=lambda r: len(serialize_tuple(r)))[-6:]
    for kind, batch in (("reduce", rows[:8]), ("rerank", widest)):
        need = estimate_tokens(build_metaprompt(
            kind, PLAN_PROMPTS[kind], batch).text) + PLAN_OUT
        check(need <= PLAN_WINDOW,
              f"the {kind} prompt needs {need} of {PLAN_WINDOW} tokens")

    def context(prov, scheduler):
        return SemanticContext(catalog=catalog, provider=prov,
                               cache=PredictionCache(), scheduler=scheduler)

    with RequestScheduler(max_workers=4) as sched:
        on_mock = plan_pass(core, context(MockProvider(), sched), rows)

    counts = {"flash_attention": flash_attention,
              "decode_attention": decode_attention}
    engine = provider.engine
    generate = engine.generate
    requests = []                   # (prompt bytes, new tokens asked, got)

    def recording(prompt, max_new_tokens=32, eos_token=-1):
        toks = generate(prompt, max_new_tokens, eos_token)
        requests.append((len(prompt), max_new_tokens, len(toks)))
        return toks

    for fn in counts.values():
        fn.launches = 0
    steps0 = engine.steps
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(engine, "generate", recording):
        with RequestScheduler(max_workers=4) as sched:
            ctx = context(provider, sched)
            first = plan_pass(core, ctx, rows)
            stats_first = provider.stats.snapshot()
            second = plan_pass(core, ctx, rows)
            stats_second = provider.stats.snapshot()
            sched_stats = {k: getattr(sched.stats, k) for k in
                           ("jobs", "requests", "retries", "coalesced",
                            "max_inflight")}
        held = {"flash_attention": HeldKernel(flash_attention, attention_ref),
                # one call in 7: prime to the 16 layers, so every layer
                # is held, at positions spread over each request
                "decode_attention": HeldKernel(decode_attention,
                                               decode_attention_ref, 7)}
        with mock.patch.object(L.flash_ops, "flash_attention",
                               held["flash_attention"]), \
                mock.patch.object(L.decode_ops, "decode_attention",
                                  held["decode_attention"]):
            serial = plan_pass(core, context(provider, None), rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    held = {name: h.read() for name, h in held.items()}
    log(phase="plan_kernels_vs_plain", atol=TOLS[torch.bfloat16],
        rtol=TOLS[torch.bfloat16], **held)
    for name, h in held.items():
        check(h["ok"],
              f"plan: a {name} call of the serial run differs from its "
              f"plain version: {h}")
    log(phase="plan", rows=len(rows), context_window=PLAN_WINDOW,
        max_output_tokens=PLAN_OUT, wall_s=wall, peak_memory_gb=peak / 1e9,
        launches=launches, engine_steps=engine.steps - steps0,
        generate_calls=len(requests),
        max_request_bytes=max(p + n for p, n, _ in requests),
        scheduler=sched_stats, mock=_plan_log(on_mock),
        first=_plan_log(first), second=_plan_log(second),
        serial=_plan_log(serial))

    for name, r in first.items():
        check(r["report"] == on_mock[name]["report"]
              and r["calls"] == on_mock[name]["calls"],
              f"plan {name}: counts {r['report']}, {r['calls']} calls; on "
              f"MockProvider {on_mock[name]['report']}, "
              f"{on_mock[name]['calls']} calls")
        check(_same(second[name]["value"], r["value"]),
              f"plan {name}: the cached pass returned other results")
        if second[name]["report"] is not None:
            rep = second[name]["report"]
            check(rep["requests"] == 0
                  and rep["cache_hits"] == rep["n_unique"],
                  f"plan {name}: the cached pass reported {rep}")
        check(_same(serial[name]["value"], r["value"])
              and serial[name]["report"] == r["report"]
              and serial[name]["calls"] == r["calls"],
              f"plan {name}: the serial run differs from the scheduled one")
    check(stats_second == stats_first,
          f"the cached pass reached the provider: {stats_first} -> "
          f"{stats_second}")
    # every request generated min(max_output_tokens x rows, 64) tokens
    asked = sorted(
        [min(PLAN_OUT * b, 64) for run in (first, serial)
         for name in ("filter", "complete")
         for b in run[name]["report"]["batch_sizes"]]
        + [PLAN_OUT] * sum(run[name]["calls"] for run in (first, serial)
                           for name in ("reduce", "rerank")))
    check(sorted(n for _, n, _ in requests) == asked
          and all(got == n for _, n, got in requests),
          f"generation lengths {requests}, expected {asked}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the plan path")

    vecs = first["embedding"]["value"]
    check(vecs.shape == (len(rows), engine.cfg.d_model)
          and np.isfinite(vecs).all()
          and np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3),
          "llm_embedding vectors are finite unit vectors")
    texts = [r["abstract"] for r in rows]
    distinct = list(dict.fromkeys(texts))
    direct = np.concatenate([provider.embed(emb_model, distinct[i:i + 16])
                             for i in range(0, len(distinct), 16)])
    ours = vecs[[texts.index(t) for t in distinct]]
    cos = float(np.min(np.sum(ours * direct, axis=1)
                       / np.linalg.norm(ours, axis=1)
                       / np.linalg.norm(direct, axis=1)))
    log(phase="plan_embed_vs_direct", texts=len(distinct), min_cosine=cos)
    check(cos >= 0.999, f"llm_embedding vs provider.embed: cosine {cos}")
    compare_embed_plain(provider, distinct, prefix="plan_")
    return launches


# --------------------------------------------------------------------------
# phase 5c: paper Query 3 as one plan over the full-width olmo-1b provider
# --------------------------------------------------------------------------
Q3_DOCS = 8_192
Q3_APPEND = 1_024
Q3_K, Q3_CANDIDATES = 8, 32
Q3_QUESTIONS = ("Which join algorithms handle cyclic queries?",
                "How does a vector index scan rank passages?",
                "When does a semantic cache save model calls?",
                "What does score fusion add to hybrid retrieval?")
Q3_RERANK = "Rank the passages by how well they answer the question."
Q3_GEN, Q3_EMB = {"model_name": "q3-gen"}, {"model_name": "q3-embed"}
SCORE_TOL = 1e-5                 # cosine scores: the engine's parity tests
SHARDS = 4                       # phase 15's mesh: 4 entries of one card


def q3_corpus(engine_mod, rng, n, start=0):
    """``n`` synthetic research passages {id, title, content, year}, the
    content 60-128 bytes from the fixed vocabulary."""
    ids = list(range(start, start + n))
    return engine_mod.Table({
        "id": ids, "title": [f"passage {i}" for i in ids],
        "content": passages(rng, n, 60, 129),
        "year": [1990 + i % 35 for i in ids]})


def q3_plan(engine_mod, ctx, questions, corpus):
    """Paper Query 3 (``examples/hybrid_search.py``'s plan form): hybrid
    retrieval (embedding scan + BM25 + fusion), then the model's listwise
    rerank of each question's passages."""
    return (engine_mod.Pipeline(ctx, questions, "question")
            .hybrid_topk("score", Q3_EMB, "q", corpus, k=Q3_K,
                         doc_col="content", candidate_k=Q3_CANDIDATES)
            .llm_rerank(Q3_GEN, {"prompt": Q3_RERANK}, ["content"], by="q"))


def q3_counts(ctx, n_reports, before) -> dict:
    """What a run on ``ctx`` sent: its embed reports' counts (sorted, as
    the scheduler completes them in any order) and the provider counters
    it moved (the rerank writes no report)."""
    reports = sorted(
        [{k: (sorted(getattr(r, k)) if k == "batch_sizes"
              else getattr(r, k)) for k in PLAN_REPORT}
         for r in ctx.reports[n_reports:]], key=repr)
    after = ctx.provider.stats.snapshot()
    return dict(reports=reports, **{k: after[k] - before[k] for k in
                                    ("calls", "prompt_tokens",
                                     "output_tokens")})


def q3_run(ctx, engine_mod, questions, corpus, strict=True):
    """One collect of the plan on ``ctx``: (table, counts, pipeline)."""
    n_reports, before = len(ctx.reports), ctx.provider.stats.snapshot()
    pipe = q3_plan(engine_mod, ctx, questions, corpus)
    diags = pipe.check()
    check(diags == [], f"query3: check() reported {[str(d) for d in diags]}")
    table = pipe.collect(verify="strict" if strict else "off")
    return table, q3_counts(ctx, n_reports, before), pipe


def _embedded(counts) -> int:
    return sum(r["n_tuples"] for r in counts["reports"])


def busy(spans) -> dict:
    """Calls, items and the seconds in which at least one call of
    ``spans`` ((start, end, items) each) was running."""
    total, until = 0.0, float("-inf")
    for start, end, _ in sorted(spans):
        total += max(0.0, end - max(start, until))
        until = max(until, end)
    return dict(requests=len(spans), items=sum(n for _, _, n in spans),
                busy_s=total)


def ranks_agree(ids, ref_ids, ref_scores, tol) -> tuple:
    """(agree, near_ties): each query's ranked ids equal the reference's,
    except that ids may trade places within a run of reference scores
    less than 10 x ``tol`` apart (a near-tie, whose order two scans may
    settle either way; counted); a run that reaches the rank limit is not
    compared by id, since either side may cut it elsewhere."""
    ok, ties = True, 0
    for got, ref, s in zip(np.asarray(ids), np.asarray(ref_ids),
                           np.asarray(ref_scores)):
        start = 0
        for r in range(1, len(ref) + 1):
            if r < len(ref) and abs(s[r - 1] - s[r]) < 10 * tol:
                continue
            a, b = set(got[start:r].tolist()), set(ref[start:r].tolist())
            ties += r - start > 1
            if r - start == 1 or r < len(ref):
                ok &= a == b
            start = r
    return bool(ok), ties


def query3_path(provider):
    """Paper Query 3 as one ``Pipeline`` over the phase-3 provider: a
    corpus of 8,192 passages and 4 questions, ``hybrid_topk`` (k 8 of 32
    candidates a retriever) then ``llm_rerank(by="q")``, through a
    ``SemanticContext`` with a ``RequestScheduler(max_workers=4)``, an
    in-memory prediction cache and an ``IndexStore`` in a temporary
    directory.  Fails unless: ``check()`` is clean and ``collect(verify=
    "strict")`` raises nothing; the embed reports and provider calls equal
    the same plan's on ``MockProvider``; every block-max call is held
    against its plain version and a sample of the flash and decode calls
    too; each question's vector candidates equal the plain scan's over
    the same index; a second collect sends nothing; a fresh context reads
    the index from the store and embeds only the questions; 1,024 more
    passages append to it and the grown index ranks as one built from
    scratch; the IVF route at full probe returns the exact ids; and
    block-max, flash and decode attention launch in this phase."""
    import tempfile

    import repro_torch.engine as E
    from repro_torch.core import (Catalog, MockProvider, PredictionCache,
                                  RequestScheduler, SemanticContext,
                                  build_metaprompt, estimate_tokens,
                                  llm_embedding)
    from repro_torch.core.cache import IndexStore
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.topk_sim import ops as topk_ops
    from repro_torch.kernels.topk_sim.ref import block_max_scores_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.retrieval import VectorIndex, cosine_topk, ensure_index
    from repro_torch.retrieval import vector as V
    from repro_torch.retrieval.ivf import default_nlist

    engine = provider.engine
    dev = engine.device
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 6)
    corpus = q3_corpus(E, rng, Q3_DOCS)
    questions = E.Table({"q": list(Q3_QUESTIONS)})
    catalog = Catalog()
    catalog.create_model("q3-gen", arch="olmo-1b",
                         context_window=PLAN_WINDOW,
                         max_output_tokens=PLAN_OUT)
    catalog.create_model("q3-embed", arch="olmo-1b")
    # a question's rerank is one request over its k passages, which does
    # not split on overflow: the widest k must fit the window
    widest = sorted(corpus.column("content"), key=len)[-Q3_K:]
    need = estimate_tokens(build_metaprompt(
        "rerank", Q3_RERANK, [{"content": c} for c in widest]).text) \
        + PLAN_OUT
    check(need <= PLAN_WINDOW,
          f"the rerank prompt needs {need} of {PLAN_WINDOW} tokens")
    store_dir = tempfile.TemporaryDirectory()
    store_path = str(Path(store_dir.name) / "q3.index.json")

    # provider calls by kind (corpus and question embeds, rerank
    # generations) and the IndexStore's file writes and reads: (start,
    # end, items) each; the scheduler's workers overlap provider calls,
    # waiting on the provider's engine lock
    spans = {"embed": [], "complete": [], "store_write": [],
             "store_read": []}

    def timed(kind, fn):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            spans[kind].append((t, time.perf_counter(),
                                len(args[1]) if kind == "embed" else 1))
            return out
        return call

    def context(prov, scheduler, index_path=None):
        return SemanticContext(catalog=catalog, provider=prov,
                               cache=PredictionCache(), scheduler=scheduler,
                               index_path=index_path, device=dev)

    with RequestScheduler(max_workers=4) as sched:
        _, on_mock, _ = q3_run(context(MockProvider(), sched), E,
                               questions, corpus)

    counts = {"topk_sim.block_max_scores": topk_ops.block_max_scores,
              "flash_attention": flash_attention,
              "decode_attention": decode_attention}
    held = {"topk_sim.block_max_scores": HeldKernel(
                topk_ops.block_max_scores, block_max_scores_ref),
            # one call in 17 and one in 7: prime to the 16 layers
            "flash_attention": HeldKernel(flash_attention, attention_ref,
                                          17),
            "decode_attention": HeldKernel(decode_attention,
                                           decode_attention_ref, 7)}
    for fn in counts.values():
        fn.launches = 0
    steps0 = engine.steps
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(topk_ops, "block_max_scores",
                           held["topk_sim.block_max_scores"]), \
            mock.patch.object(L.flash_ops, "flash_attention",
                              held["flash_attention"]), \
            mock.patch.object(L.decode_ops, "decode_attention",
                              held["decode_attention"]), \
            mock.patch.object(provider, "embed",
                              timed("embed", provider.embed)), \
            mock.patch.object(provider, "complete",
                              timed("complete", provider.complete)), \
            mock.patch.object(IndexStore, "put",
                              timed("store_write", IndexStore.put)), \
            mock.patch.object(IndexStore, "append_segment",
                              timed("store_write",
                                    IndexStore.append_segment)), \
            mock.patch.object(IndexStore, "_load",
                              timed("store_read", IndexStore._load)):
        with RequestScheduler(max_workers=4) as sched:
            ctx = context(provider, sched, store_path)
            t1 = time.perf_counter()
            table, first, pipe = q3_run(ctx, E, questions, corpus)
            torch.cuda.synchronize()
            first_wall = time.perf_counter() - t1
            first_spent = {k: busy(spans[k]) for k in ("embed", "complete")}
            t1 = time.perf_counter()
            again, second, _ = q3_run(ctx, E, questions, corpus)
            second_wall = time.perf_counter() - t1
            # a third collect under a mesh of 4 shards on this card: the
            # memoised index places its shards on first use, and the
            # scan runs through them (phase 15)
            mesh = make_mesh((SHARDS,), ("data",), devices=[dev] * SHARDS)
            bm = counts["topk_sim.block_max_scores"]
            bm_before = bm.launches
            t1 = time.perf_counter()
            with mock.patch.object(V, "make_sharded_topk",
                                   wraps=V.make_sharded_topk) as bound, mesh:
                meshed, third, _ = q3_run(ctx, E, questions, corpus)
            third_wall = time.perf_counter() - t1
            mesh_scans, mesh_launches = bound.call_count, \
                bm.launches - bm_before
            explain = pipe.explain()
        # the vector candidates of each question against the plain scan
        texts = [str(c) for c in corpus.column("content")]
        index, source = ensure_index(ctx, Q3_EMB, texts)
        qv = llm_embedding(ctx, Q3_EMB, list(Q3_QUESTIONS))
        vec = (E.Pipeline(ctx, questions, "question")
               .vector_topk("cos", Q3_EMB, "q", corpus, k=Q3_CANDIDATES,
                            doc_col="content").collect())
        s_ref, i_ref = cosine_topk(index.vectors,
                                   torch.from_numpy(qv).to(dev),
                                   Q3_CANDIDATES)
        s_ref, i_ref = s_ref.cpu().numpy(), i_ref.cpu().numpy()
        vec_ids = np.asarray(vec.column("id")).reshape(len(qv), -1)
        vec_s = np.asarray(vec.column("cos")).reshape(len(qv), -1)
        gap = float(np.abs(np.diff(s_ref, axis=1)).min())
        vec_ok, vec_ties = ranks_agree(vec_ids, i_ref, s_ref, SCORE_TOL)
        vec_ok &= bool(np.allclose(np.sort(vec_s, axis=1),
                                   np.sort(s_ref, axis=1),
                                   atol=SCORE_TOL, rtol=0))
        # IVF: full probe returns the exact ids; "auto" picks its probe
        nlist = default_nlist(Q3_DOCS)
        t1 = time.perf_counter()
        index.ivf(nlist)
        ivf_build_s = time.perf_counter() - t1

        def vector_plan(**kw):
            return (E.Pipeline(ctx, questions, "question")
                    .vector_topk("cos", Q3_EMB, "q", corpus, k=Q3_K,
                                 doc_col="content", **kw))

        exact_t = vector_plan().collect()
        exact = exact_t.column("id")
        full_probe = vector_plan(ann="ivf", nlist=nlist,
                                 nprobe=nlist).collect().column("id")
        probe_ok, probe_ties = ranks_agree(
            np.reshape(full_probe, (len(qv), -1)),
            np.reshape(exact, (len(qv), -1)),
            np.reshape(exact_t.column("cos"), (len(qv), -1)), SCORE_TOL)
        auto = vector_plan(ann="auto")
        node = [n for n in auto._plan().nodes if n.op == "vector_topk"][0]
        decision = {k: node.info.get(f"ann_{k}") for k in
                    ("resolved", "nlist", "nprobe", "recall_est")}
        auto_ids = auto.collect().column("id")
        recall = float(np.mean([
            len(set(auto_ids[r:r + Q3_K]) & set(exact[r:r + Q3_K])) / Q3_K
            for r in range(0, len(exact), Q3_K)]))

        # a fresh session on the same store: no corpus embed
        fresh = context(provider, None, store_path)
        _, store_source = ensure_index(fresh, Q3_EMB, texts)
        store_table, from_store, _ = q3_run(fresh, E, questions, corpus)
        # the questions embed alone here, not packed with the corpus tail:
        # another batch, so bf16 may round them otherwise (logged only)
        store_same = [(r["q"], r["id"]) for r in store_table.rows()] == \
            [(r["q"], r["id"]) for r in table.rows()]
        # 1,024 new passages: only they are embedded
        more = q3_corpus(E, rng, Q3_APPEND, start=Q3_DOCS)
        grown_texts = texts + [str(c) for c in more.column("content")]
        n_reports = len(fresh.reports)
        grown, grown_source = ensure_index(fresh, Q3_EMB, grown_texts)
        appended = sum(r.n_tuples for r in fresh.reports[n_reports:])
        rebuilt = VectorIndex(grown.raw, device=dev)
        grown_ids = grown.topk(qv, Q3_CANDIDATES)[1]
        rebuilt_ids = rebuilt.topk(qv, Q3_CANDIDATES)[1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    held = {name: h.read() for name, h in held.items()}
    embeds = sum(r["requests"] for r in first["reports"])
    # the exact scan and the IVF search alone, as a plan's vector
    # retriever calls them (after the launch counts were read)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    topk_ms = []
    for _ in range(20):
        ev[0].record()
        index.topk(qv, Q3_K)
        ev[1].record()
        torch.cuda.synchronize()
        topk_ms.append(ev[0].elapsed_time(ev[1]))
    t1 = time.perf_counter()
    index.topk_ann(qv, Q3_K, nprobe=nlist, nlist=nlist)
    ivf_search_s = time.perf_counter() - t1
    log(phase="query3_kernels_vs_plain", **held)
    log(phase="query3_explain", text=explain)
    log(phase="query3_mesh", mesh=repr(mesh), table_equal=meshed.rows()
        == table.rows(), requests=third["calls"], sharded_scans=mesh_scans,
        block_max_launches=mesh_launches, wall_s=third_wall)
    log(phase="query3", card=card_line(), docs=Q3_DOCS,
        questions=len(Q3_QUESTIONS), k=Q3_K, candidate_k=Q3_CANDIDATES,
        context_window=PLAN_WINDOW,
        rows=len(table), first_wall_s=first_wall,
        second_wall_s=second_wall, embed_requests=embeds,
        embed_texts=_embedded(first),
        provider_time=first_spent,
        store_s={k: [end - start for start, end, _ in spans[k]]
                 for k in ("store_write", "store_read")},
        embed_texts_per_s=first_spent["embed"]["items"]
        / first_spent["embed"]["busy_s"],
        embed_requests_per_s=first_spent["embed"]["requests"]
        / first_spent["embed"]["busy_s"],
        rerank_requests=first["calls"] - embeds, first=first, second=second,
        mock=on_mock, from_store=from_store, store_source=store_source,
        store_run_same_ids=store_same,
        append=dict(source=grown_source, embedded=appended,
                    rows=len(grown)),
        vector_candidates=dict(
            ids_exact=bool(np.array_equal(vec_ids, i_ref)),
            near_ties=vec_ties, min_adjacent_gap=gap, source=source,
            max_score_err=float(np.abs(np.sort(vec_s, axis=1)
                                       - np.sort(s_ref, axis=1)).max())),
        topk_ms=dict(median=statistics.median(topk_ms), min=min(topk_ms),
                     shape=[Q3_DOCS, engine.cfg.d_model, len(qv), Q3_K]),
        ivf=dict(nlist=nlist, build_s=ivf_build_s, search_s=ivf_search_s,
                 full_probe_ids_exact=full_probe == exact,
                 full_probe_near_ties=probe_ties,
                 auto=decision, auto_recall_at_8=recall),
        engine_steps=engine.steps - steps0, launches=launches,
        peak_memory_gb=peak / 1e9, wall_s=wall,
        phase_wall_s=time.perf_counter() - t_phase)
    store_dir.cleanup()

    check(len(table) == len(Q3_QUESTIONS) * Q3_K
          and table.column("q")[::Q3_K] == list(Q3_QUESTIONS),
          f"query3: {len(table)} rows, not {Q3_K} a question")
    check(first["reports"] == on_mock["reports"]
          and first["calls"] == on_mock["calls"],
          f"query3: requests {first}, on MockProvider {on_mock}")
    check(first["output_tokens"] == PLAN_OUT * (first["calls"] - embeds),
          f"query3: the rerank generated {first['output_tokens']} tokens")
    check(second["calls"] == 0 and again.rows() == table.rows(),
          f"query3: the second collect sent {second['calls']} requests")
    check(meshed.rows() == table.rows() and third["calls"] == 0,
          f"query3: the collect under a mesh sent {third['calls']} requests"
          f" or returned another table")
    check(mesh_scans > 0 and mesh_launches == SHARDS * mesh_scans,
          f"query3: under the mesh {mesh_scans} sharded scans launched "
          f"block_max_scores {mesh_launches} times, not {SHARDS} a scan")
    for name, h in held.items():
        check(h["ok"], f"query3: a {name} call differs from its plain "
              f"version: {h}")
    check(vec_ok, f"query3: vector candidates differ from the plain scan "
          f"(smallest adjacent score gap {gap:.3g}, tolerance {SCORE_TOL})")
    check(source == "session", f"query3: the index came from {source}")
    check(store_source == "store" and _embedded(from_store)
          == len(Q3_QUESTIONS) and store_table.rows() == table.rows(),
          f"query3: a fresh session read the index from {store_source} "
          f"and embedded {_embedded(from_store)} texts")
    check(grown_source == "appended" and appended == Q3_APPEND
          and len(grown) == Q3_DOCS + Q3_APPEND
          and np.array_equal(grown_ids, rebuilt_ids),
          f"query3: the append came from {grown_source}, embedded "
          f"{appended} texts")
    check(probe_ok, "query3: IVF at full probe differs from the exact plan")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the Query 3 path")
    return launches


# --------------------------------------------------------------------------
# phases 6 and 7: falcon-mamba-7b and recurrentgemma-9b at full width
# --------------------------------------------------------------------------
MAMBA = "falcon-mamba-7b"
RGEMMA = "recurrentgemma-9b"


def _layer_counts(cfg) -> dict:
    kinds = [k for pattern, reps in cfg.stages() for k in pattern * reps]
    return {k: kinds.count(k) for k in set(kinds)}


def serve_path(dev, arch, prefix, counts, per_embed, per_decode, seed, *,
               kv_quant="none", long_prompt=0, long_texts=0,
               decode_check=True, after_traffic=None, routes=None,
               predicted=None):
    """Serve ``arch`` at full width through the same entry points as the
    main path: one 64-passage embed request, a question request, a
    device-resident index and top-5, 2 RAG completions, 5 raw requests on
    4 slots.  ``counts`` are the kernel wrappers of this path, set to 0
    just before it and read just after; each must equal its launches per
    embed request (``per_embed``) or per decode step (``per_decode``)
    times the requests or steps of this run.  An embed batch and, where
    decode runs a kernel and ``decode_check`` is set, a decode step go
    through the kernels against the plain versions; then the phase's
    engine is freed and each raw request is served again alone in a fresh
    engine (a reused slot must not carry its last occupant's state).

    ``kv_quant="int8"`` serves on the int8 KV cache: neither local
    provider takes a cache format, so the provider's engine is replaced by
    ``ServingEngine(cfg, params=...)`` on that cache, as the parity tests
    replace it.  ``long_prompt`` adds a sixth raw request of that many
    tokens; ``long_texts`` adds an embed request of that many texts of
    1,100-1,500 bytes (bucket 2,048), also held against the plain path.
    ``after_traffic(engine)`` runs after the checks of the traffic, before
    the engine is freed.  ``routes`` (a ``MoeRoutes``) is put in place of
    the MoE layers' routing for the traffic and the comparisons: the
    dropped assignments by group length are logged (a decode group must
    drop none) and the comparisons log routing flips.  ``predicted``
    (``init_peak_memory_gb``, ``cache_gb``, ``peak_memory_gb``,
    ``phase_wall_s``) is logged beside the measured values.  Returns the
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import (LocalTorchProvider, ModelResource,
                                  build_metaprompt)
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    from repro_torch.retrieval import VectorIndex
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(arch).replace(kv_quant=kv_quant)
    def pred(key):
        return ({f"predicted_{key}": predicted[key]}
                if predicted and key in predicted else {})

    def moe_routes():
        return (routes.active() if routes is not None
                else contextlib.nullcontext())
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
        init_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        **pred("init_peak_memory_gb"))
    if kv_quant == "none":
        provider = LocalTorchProvider(arch, use_smoke_config=False,
                                      device=dev, params=params)
    else:
        provider = LocalTorchProvider(arch, device=dev)
        provider.engine = ServingEngine(cfg, device=dev, params=params)
    engine = provider.engine
    cache_gb = sum(t.numel() * t.element_size()
                   for t in _tensors(engine.cache)) / 1e9
    rng = np.random.default_rng(seed)
    docs = passages(rng, 64, 90, 129)           # one request, bucket 128
    questions = passages(rng, 4, 30, 60)
    emb_model = ModelResource(f"{prefix}embed", 1, arch)
    gen_model = ModelResource(f"{prefix}gen", 1, arch, max_output_tokens=8)
    long_rng = np.random.default_rng(seed + 100)
    longs = passages(long_rng, long_texts, 1100, 1501)

    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe_routes(), mock.patch.object(M, "decode_step",
                                         wraps=M.decode_step) as dec:
        doc_vecs = provider.embed(emb_model, docs)
        index = VectorIndex(doc_vecs, device=dev)
        q_vecs = provider.embed(emb_model, questions)
        embed_requests = 2
        if longs:
            long_vecs = provider.embed(emb_model, longs)
            embed_requests += 1
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
        if long_prompt:
            prompts.append([int(t) for t in
                            long_rng.integers(0, 256, long_prompt)])
        raw = [engine.submit(p, max_new_tokens=8) for p in prompts]
        engine.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    decode_steps = dec.call_count
    dec.reset_mock()            # its recorded calls hold the engine's cache
    peak = torch.cuda.max_memory_allocated()
    moe = {} if routes is None else {"moe_drops": routes.drops()}

    check(doc_vecs.shape == (64, cfg.d_model)
          and np.isfinite(doc_vecs).all()
          and np.allclose(np.linalg.norm(doc_vecs, axis=1), 1.0, atol=1e-3),
          f"{arch} corpus embeddings are finite unit vectors")
    if longs:
        check(long_vecs.shape == (len(longs), cfg.d_model)
              and np.isfinite(long_vecs).all(),
              f"{arch} long-text embeddings are finite")
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
    log(phase=f"{prefix}path", arch=cfg.name, kv_quant=kv_quant,
        embed_requests=embed_requests,
        embed_texts=len(docs) + len(questions) + len(longs),
        long_text_bytes=[len(t) for t in longs],
        completions=len(answers), raw_requests=len(raw),
        slots=engine.n_slots, max_context=engine.max_context,
        cache_gb=cache_gb, raw_slots=[r.slot for r in raw],
        raw_prompt_tokens=[len(p) for p in prompts],
        prompt_tokens=stats["prompt_tokens"] + sum(map(len, prompts)),
        generated_tokens=stats["output_tokens"]
        + sum(len(r.generated) for r in raw),
        engine_steps=engine.steps, decode_steps=decode_steps, wall_s=wall,
        peak_memory_gb=peak / 1e9, launches=launches,
        launches_per_embed_request=per_embed,
        launches_per_decode_step=per_decode, **moe,
        **pred("cache_gb"), **pred("peak_memory_gb"))
    for row in moe.get("moe_drops", []):
        check(row["group_tokens"] != engine.n_slots or row["dropped"] == 0,
              f"{arch}: a decode group dropped assignments: {row}")

    with moe_routes():
        compare_embed_plain(provider, docs, prefix, routes)
        if longs:
            compare_embed_plain(provider, longs, f"{prefix}long_", routes)
        if per_decode and decode_check:
            compare_decode_rounding(engine, prefix, routes)
    if after_traffic is not None:
        after_traffic(engine)
    # the phase's engine and its cache go before the fresh engines come
    slots, context = engine.n_slots, engine.max_context
    del provider, engine
    gc.collect()
    torch.cuda.empty_cache()

    # each raw request against itself served alone from a fresh state
    t1 = time.perf_counter()
    alone = []
    torch.cuda.reset_peak_memory_stats()
    for p in prompts:
        fresh = ServingEngine(cfg, n_slots=slots, max_context=context,
                              device=dev, params=params)
        alone.append(fresh.generate(p, max_new_tokens=8))
        del fresh
    same = [r.generated == a for r, a in zip(raw, alone)]
    log(phase=f"{prefix}reused_slots", same_as_alone=same,
        fifth_request_slot=raw[4].slot, seconds=time.perf_counter() - t1,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(all(same), f"{arch}: a request in a reused slot differs from its "
          f"run from a fresh state: {same}")
    log(phase=f"{prefix}phase", wall_s=time.perf_counter() - t_phase,
        **pred("phase_wall_s"))
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


# --------------------------------------------------------------------------
# phases 8-10: the dense models of the JAX package at full width
# --------------------------------------------------------------------------
GRANITE, GEMMA3, QWEN = "granite-8b", "gemma3-12b", "qwen1.5-32b"
GEMMA3_LONG_PROMPT = 1500        # past gemma3-12b's window of 1,024
GEMMA3_LONG_TEXTS = 4            # one embed request at bucket 2,048
QWEN_CUT_LAYERS = 4


def _attention_counts():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention}


def dense_path(dev, arch, prefix, seed, **kw):
    """A dense model through ``serve_path``: flash attention once per layer
    and embed request, decode attention once per layer and decode step."""
    from repro_torch.configs import get_config
    n = get_config(arch).num_layers
    return serve_path(dev, arch, prefix, _attention_counts(),
                      {"flash_attention": n}, {"decode_attention": n}, seed,
                      **kw)


def decode_split(engine, prefix, steps=3):
    """Device time of ``steps`` engine steps with every slot decoding,
    from ``torch.profiler`` (host and device activity): the weight GEMMs
    (kernels by name, as phase 5 groups them; beside the least time of
    reading every weight but the embedding (and an encoder) once a step),
    on the int8
    cache the dequantization of the cache (the kernels launched under a
    ``dequantize_kv`` annotation wrapped around each call), the decode
    kernel, and the rest; with the idle share of the window.  The
    dequantization of one layer's cache is also timed alone with CUDA
    events, times the layers (on the int8 cache).  An encoder-decoder's
    plain cross-attention is annotated the same way and logged beside the
    split (its GEMMs and elementwise kernels are also in the groups)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L
    rng = np.random.default_rng(SEED + 30)
    reqs = [engine.submit([int(t) for t in rng.integers(0, 256, 40)],
                          max_new_tokens=steps + 4)
            for _ in range(engine.n_slots)]
    while any(r.pending_prompt or r.slot < 0 for r in reqs):
        engine.step()
    marks = ("dequantize_kv", "cross_attention")

    def marked(name):
        fn = getattr(L, name)

        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call
    torch.cuda.synchronize()
    with mock.patch.object(L, "dequantize_kv", marked("dequantize_kv")), \
            mock.patch.object(L, "cross_attention",
                              marked("cross_attention")), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run_until_idle()
    check(all(len(r.generated) == steps + 4 for r in reqs),
          "decode_split: the traced requests did not finish")
    events = prof.events()
    kernels = [(e.device_time_total, e.name) for e in events
               if e.device_type == DeviceType.CUDA and e.name not in marks]

    def annotated(name):
        spans = [e.device_time_total for e in events
                 if e.device_type == DeviceType.CPU and e.name == name]
        return sum(spans), len(spans)
    deq_us, n_deq = annotated("dequantize_kv")
    cross_us, n_cross = annotated("cross_attention")
    groups = {"matmul": 0.0, "decode_attention": 0.0}
    for us, name in kernels:
        if "decode_mma_kernel" in name:
            groups["decode_attention"] += us / 1e3
        elif any(m in name for m in dict(KERNEL_GROUPS)["matmul"]):
            groups["matmul"] += us / 1e3
    busy = sum(us for us, _ in kernels) / 1e3
    groups["dequantize_kv"] = deq_us / 1e3
    groups["other"] = busy - sum(groups.values())
    weight_bytes = sum(t.numel() * t.element_size() for name, tree in
                       engine.params.items()
                       if name not in ("embed", "encoder")
                       for t in _tensors(tree))
    row = dict(phase=f"{prefix}decode_split", engine_steps=steps,
               slots=engine.n_slots, wall_ms_per_step=wall * 1e3 / steps,
               device_busy_ms_per_step=busy / steps,
               device_idle_share=1 - busy / (wall * 1e3),
               device_ms_per_step={k: v / steps for k, v in groups.items()},
               weight_read_gb_per_step=weight_bytes / 1e9,
               weight_read_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3)
    if n_cross:
        row.update(cross_attention_calls_per_step=n_cross / steps,
                   cross_attention_ms_per_step=cross_us / 1e3 / steps)
    if engine.cfg.kv_quant == "int8":
        # one layer's cache dequantized alone, as cache_kv does it
        layer = {k: t[0] for k, t in engine.cache[0]["b0"]["attn"].items()}
        flush = torch.empty(32 << 20, dtype=torch.int32,
                            device=engine.device)
        alone_ms = time_ms(lambda: L.cache_kv(engine.cfg, layer), flush)
        row.update(dequantize_calls_per_step=n_deq / steps,
                   dequantize_alone_ms_per_layer=alone_ms,
                   dequantize_alone_ms_per_step=alone_ms
                   * engine.cfg.num_layers,
                   dequantize_bytes_per_layer=sum(
                       t.numel() * t.element_size() for t in layer.values())
                   + 2 * layer["k"].numel() * 2)
    log(**row)
    check(groups["decode_attention"] > 0 and groups["matmul"] > 0,
          f"{prefix}decode_split: the trace holds no decode kernel or GEMM: "
          f"{row}")
    return row


def qwen_cut_check(dev):
    """qwen1.5-32b's decode step held against the plain path on its
    configuration cut to 4 layers (the same widths, the int8 cache, its own
    drawn weights): at 64 layers the f32 step's embedding and head and a
    clone of the cache would not fit beside the weights.  The cache is
    first filled by two requests of 1,600 and 800 tokens, whose chunked
    prefill runs on int8."""
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(QWEN).replace(kv_quant="int8",
                                   num_layers=QWEN_CUT_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    engine = ServingEngine(cfg, device=dev, params=params)
    rng = np.random.default_rng(SEED + 31)
    reqs = [engine.submit([int(t) for t in rng.integers(0, 256, n)],
                          max_new_tokens=4) for n in (1600, 800)]
    engine.run_until_idle()
    check(all(len(r.generated) == 4 for r in reqs),
          "qwen cut: the requests that fill the cache did not finish")
    compare_decode_rounding(
        engine, "qwen_cut_", cut=f"{QWEN_CUT_LAYERS} of 64 layers",
        kv_quant="int8", weight_gb=sum(t.numel() * t.element_size()
                                       for t in _tensors(params)) / 1e9,
        prefill_tokens=[len(r.prompt) for r in reqs])


def granite_path(dev):
    """Phase 8: granite-8b (36 layers, 32 query heads over 8 KV heads of
    128)."""
    return dense_path(dev, GRANITE, "granite_", SEED + 11)


def gemma3_path(dev):
    """Phase 9: gemma3-12b (48 layers, 5 local of window 1,024 to 1 global,
    16 query heads over 8 KV heads of 256), with a request of 1,500
    tokens (chunked prefill and decode past the window) and an embed
    request of 4 texts at bucket 2,048 (the window cuts the flash
    kernel's rows)."""
    return dense_path(dev, GEMMA3, "gemma3_", SEED + 12,
                      long_prompt=GEMMA3_LONG_PROMPT,
                      long_texts=GEMMA3_LONG_TEXTS)


def qwen_path(dev):
    """Phase 10: qwen1.5-32b (64 layers, 40 heads of 128, qkv bias) at full
    width on the int8 KV cache of 4 slots x 2,048 tokens; the decode
    step's device split; then, the model freed, the decode step held on
    the 4-layer cut."""
    launches = dense_path(dev, QWEN, "qwen_", SEED + 13, kv_quant="int8",
                          decode_check=False,
                          after_traffic=lambda e: decode_split(e, "qwen_"))
    free_device("qwen")
    qwen_cut_check(dev)
    return launches


# --------------------------------------------------------------------------
# phase 11: deepseek-moe-16b, the MoE FFN at full width
# --------------------------------------------------------------------------
DEEPSEEK = "deepseek-moe-16b"
# written in PERF.md before the phase's first run on the card
DEEPSEEK_PREDICTED = {"init_peak_memory_gb": 34.6,
                      "peak_memory_gb": [36.0, 37.0],
                      "phase_wall_s": [30.0, 90.0]}
# (name, B, S) of the dispatch check's inputs: a decode step's 4 slots
# (one group of 4 tokens), a prefill chunk of 32, an embed row of 128
MOE_GROUPS = (("decode", 4, 1), ("prefill_chunk", 1, 32),
              ("embed_row", 1, 128))
MOE_F32_TOL = 1e-4


class MoeRoutes:
    """A wrapper around ``moe_route``, the routing and slotting step of
    every MoE layer's ``moe_apply``, put in place by ``active()``.  It
    sums, by group length, the groups routed and the assignments they
    dropped (on the card; read once by ``drops()``), and after
    ``begin(label)`` keeps each call's top-k experts under that label, so
    that two runs of one batch can be compared (``flips``)."""

    def __init__(self):
        from repro_torch.models import layers as L
        self.layers, self.route = L, L.moe_route
        self.groups, self.runs, self.current = {}, {}, None
        self.layer_of = {}      # a layer's router, by address -> its index

    def __call__(self, cfg, router, x):
        r = self.route(cfg, router, x)
        G, S = x.shape[:2]
        layer = self.layer_of.setdefault(router.data_ptr(),
                                         len(self.layer_of))
        n = self.groups.setdefault(S, {}).setdefault(layer, [0, 0, 0])
        n[0] += G
        n[1] += G * S * cfg.top_k
        n[2] = r["dropped"].sum() + n[2]
        if self.current is not None:
            self.current.append(r["eidx"].sort(dim=-1).values)
        return r

    def active(self):
        return mock.patch.object(self.layers, "moe_route", self)

    def begin(self, label: str):
        self.current = self.runs[label] = []

    def end(self):
        self.runs, self.current = {}, None

    def flips(self, a: str, b: str) -> list:
        """Per MoE call of runs ``a`` and ``b``, the tokens whose top-k
        experts differ."""
        return [int((x != y).any(dim=-1).sum())
                for x, y in zip(self.runs[a], self.runs[b])]

    def drops(self) -> list:
        """Groups (layer calls), assignments and dropped assignments by
        group length since the last read, and the dropped share by
        layer."""
        out = []
        for S, by_layer in sorted(self.groups.items()):
            rows = [by_layer[i] for i in sorted(by_layer)]
            dropped = [int(d) for _, _, d in rows]
            assigned = sum(a for _, a, _ in rows)
            out.append({"group_tokens": S, "groups": sum(g for g, _, _ in rows),
                        "assignments": assigned, "dropped": sum(dropped),
                        "dropped_share": sum(dropped) / assigned,
                        "dropped_share_by_layer": [
                            round(d / a, 4) for d, (_, a, _) in
                            zip(dropped, rows)]})
        self.groups = {}
        return out


def moe_oracle(cfg, p, x):
    """The MoE layer from its definition in f32, apart from the port's
    dispatch: in each group of x (G, T, d), the (token, choice) pairs in
    token-major order take a place with their expert while it has fewer
    than C = moe_capacity(T) takers (a running count per expert); a
    token's output is the sum of gate * FFN_e(x) over its kept choices
    (a loop over experts), plus the shared experts' FFN.  Returns
    (y (G, T, d) f32, dropped per group)."""
    def ffn(w, v):
        h = v @ w["w1"].float()
        h = F.silu(h) if cfg.act == "silu" else F.gelu(h, approximate="tanh")
        if cfg.glu:
            h = h * (v @ w["w3"].float())
        return h @ w["w2"].float()

    G, T, d = x.shape
    E, K, C = cfg.num_experts, cfg.top_k, cfg.moe_capacity(T)
    ys, dropped = [], []
    for g in range(G):
        v = x[g].float()
        probs = torch.softmax(v @ p["router"].float(), dim=-1)
        gate, eidx = torch.topk(probs, K, dim=-1)
        gate = (gate / gate.sum(dim=-1, keepdim=True)).reshape(-1)
        choice = eidx.reshape(-1)
        place = F.one_hot(choice, E).cumsum(dim=0).gather(
            1, choice[:, None])[:, 0] - 1
        kept = place < C
        y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        for e in range(E):
            idx = torch.nonzero((choice == e) & kept)[:, 0]
            if idx.numel():
                tok = idx // K
                w = {k: p[k][e] for k in ("w1", "w2", "w3") if k in p}
                y.index_add_(0, tok, gate[idx, None] * ffn(w, v[tok]))
        if cfg.num_shared_experts:
            y = y + ffn(p["shared"], v)
        ys.append(y)
        dropped.append(int((~kept).sum()))
    return torch.stack(ys), dropped


def check_moe_dispatch(engine):
    """Layer 0 of the served model at full width against ``moe_oracle`` on
    random unit-variance inputs at ``MOE_GROUPS``' shapes: ``moe_apply``
    with the layer cast to f32 within MOE_F32_TOL, in bf16 within
    TOLS[bf16]; the dropped assignments equal the oracle's (none in the
    decode group); the bf16 call repeated is bitwise equal."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg, bf16 = engine.cfg, torch.bfloat16
    p = M._index(engine.params["stages"][0]["b0"]["moe"], 0)
    p32 = _map(torch.Tensor.float, p)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=engine.device).manual_seed(SEED + 15)
    rows = []
    for name, B, S in MOE_GROUPS:
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device=engine.device).to(bf16)
        groups = L.moe_groups(x)
        want, want_dropped = moe_oracle(cfg, p32, groups)
        want = want.view(B, S, cfg.d_model)
        y32, _ = L.moe_apply(cfg32, p32, x.float())
        y16, _ = L.moe_apply(cfg, p, x)
        again, _ = L.moe_apply(cfg, p, x)
        rows.append(dict(
            group=name, tokens=B * S, capacity=cfg.moe_capacity(
                groups.shape[1]), assignments=B * S * cfg.top_k,
            dropped=L.moe_route(cfg, p["router"], groups)["dropped"].tolist(),
            oracle_dropped=want_dropped,
            f32_max_abs_err=max_err(y32, want),
            bf16_max_abs_err=max_err(y16, want),
            f32_ok=torch.allclose(y32, want, atol=MOE_F32_TOL,
                                  rtol=MOE_F32_TOL),
            bf16_ok=torch.allclose(y16.float(), want, atol=TOLS[bf16],
                                   rtol=TOLS[bf16]),
            bitwise_repeat=torch.equal(y16.view(torch.int16),
                                       again.view(torch.int16))))
    del p32
    torch.cuda.empty_cache()
    log(phase="deepseek_moe_dispatch", layer=0, f32_tol=MOE_F32_TOL,
        bf16_tol=TOLS[bf16], groups=rows)
    for r in rows:
        check(r["f32_ok"] and r["bf16_ok"] and r["bitwise_repeat"]
              and r["dropped"] == r["oracle_dropped"],
              f"moe dispatch, {r['group']}: {r}")
    check(rows[0]["dropped"] == [0], "the decode group dropped assignments")


def deepseek_path(dev):
    """Phase 11: deepseek-moe-16b (28 layers of 16 heads of 128, each with
    an MoE FFN of 64 routed experts top-6 and 2 shared, expert d_ff 1,408)
    at full width, through phase 8's traffic with the routing wrapper in
    place (drops by group length, routing flips of the comparisons); then
    the dispatch check on layer 0 and the decode step's device split."""
    def after_traffic(engine):
        check_moe_dispatch(engine)
        decode_split(engine, "deepseek_")
    return dense_path(dev, DEEPSEEK, "deepseek_", SEED + 14,
                      routes=MoeRoutes(), predicted=DEEPSEEK_PREDICTED,
                      after_traffic=after_traffic)


# --------------------------------------------------------------------------
# phase 12: whisper-base, the encoder-decoder at full width
# --------------------------------------------------------------------------
WHISPER = "whisper-base"
# written in PERF.md before the phase's first run on the card
WHISPER_PREDICTED = {"init_peak_memory_gb": 0.25,
                     "cache_gb": 0.124,
                     "peak_memory_gb": [1.2, 2.0],
                     "phase_wall_s": [20.0, 60.0]}
WHISPER_CLIPS = 4                # one clip a slot
WHISPER_NEW = 32                 # new tokens a request
WHISPER_DECODE_EVERY = 7         # one decode call in 7 held on the path
WHISPER_EMBED_PAIRS = 64         # (text, clip) pairs of the embed check
WHISPER_EMBED_BUCKET = 128


def whisper_frames(cfg, dev, n, seed):
    """``n`` clips of N(0, 1) frame embeddings (n, encoder_seq, d) in the
    compute dtype, as the JAX package's ``make_batch`` feeds the stubbed
    audio frontend."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, cfg.encoder_seq, cfg.d_model), generator=g,
                       device=dev).to(cfg.compute_torch_dtype)


def bucket_tokens(cfg, texts, dev, bucket):
    """Byte tokens of ``texts`` (the local providers' tokenizer), cut to
    ``bucket`` and padded with -1 to it."""
    from repro_torch.core import LocalTorchProvider
    toks = torch.full((len(texts), bucket), -1, dtype=torch.int32)
    for i, t in enumerate(texts):
        ids = LocalTorchProvider._tokenize(t, cfg.vocab_size)
        ids = ids[:bucket]
        toks[i, :len(ids)] = torch.tensor(ids)
    return toks.to(dev)


def _cross_kv(cache):
    return [t for stage in cache for block in stage.values()
            for t in block["xattn"].values()]


def embed_vs_plain(cfg, params, batches, phase, gap, **note):
    """The embed step over ``batches`` through the kernels and through
    flash attention's plain version, by min cosine above 1 - ``gap``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.serving.steps import make_embed_step
    step = make_embed_step(cfg)
    kern, plain = [], []
    for batch in batches:
        kern.append(step(params, batch))
        with mock.patch.object(L.flash_ops, "flash_attention", attention_ref):
            plain.append(step(params, batch))
    kern, plain = torch.cat(kern), torch.cat(plain)
    cos = float((kern * plain).sum(dim=-1).min())
    log(phase=phase, **note, min_cosine=cos, min_cosine_bound=1 - gap,
        max_abs_err=max_err(kern, plain))
    check(torch.isfinite(kern).all().item() and cos > 1 - gap,
          f"{phase}: embeddings differ from the plain path (cos {cos})")


def whisper_embed_vs_plain(cfg, params, dev):
    """The embed step over 64 (text, clip) pairs through the kernels and
    through flash attention's plain version (encoder and decoder), 16
    pairs a call (the plain version's scores of 16 clips take 1.2 GB), by
    min cosine."""
    rng = np.random.default_rng(SEED + 43)
    texts = passages(rng, WHISPER_EMBED_PAIRS, 90, 129)
    frames = whisper_frames(cfg, dev, WHISPER_EMBED_PAIRS, SEED + 44)
    toks = bucket_tokens(cfg, texts, dev, WHISPER_EMBED_BUCKET)
    embed_vs_plain(cfg, params,
                   [{"tokens": toks[i:i + 16], "frames": frames[i:i + 16]}
                    for i in range(0, WHISPER_EMBED_PAIRS, 16)],
                   "whisper_embed_vs_plain", WHISPER_EMBED_COS_GAP,
                   pairs=WHISPER_EMBED_PAIRS, bucket=WHISPER_EMBED_BUCKET)


def teacher_forcing(cfg, params, inputs, phase, **note):
    """In f32: ``prefill`` over ``inputs`` (2 rows of frames or patches)
    and 13 tokens, then 3 decode steps, against ``forward_train``'s
    teacher-forced logits over the same inputs and 16 tokens (the JAX
    package's own test of every config, ``tests/test_models.py``), at
    F32_LOGITS_TOL.  ``next_pos`` must be the prefix's length plus 13."""
    from repro_torch.models import model as M
    dev = next(iter(inputs.values())).device
    g = torch.Generator(device=dev).manual_seed(SEED + 45)
    toks = torch.randint(0, 256, (2, 16), generator=g, device=dev,
                         dtype=torch.int32)
    full, _ = M.forward_train(cfg, params, {"tokens": toks, **inputs})
    P = full.shape[1] - 16               # a vision prefix's positions
    lg, cache, pos = M.prefill(cfg, params, {"tokens": toks[:, :13],
                                             **inputs}, P + 24)
    errs = [max_err(lg[:, -1], full[:, P + 12])]
    for i in range(3):
        lg, cache = M.decode_step(cfg, params, toks[:, 13 + i:14 + i], cache,
                                  pos + i)
        errs.append(max_err(lg[:, 0], full[:, P + 13 + i]))
    log(phase=phase, **note, next_pos=pos, max_abs_err=errs,
        atol=F32_LOGITS_TOL, logit_scale=float(full.abs().max()))
    check(pos == P + 13, f"{phase}: prefill returned next_pos {pos}")
    check(torch.isfinite(full).all().item() and max(errs) < F32_LOGITS_TOL,
          f"{phase}: f32 prefill/decode differ from teacher forcing: {errs}")


def whisper_teacher_forcing(cfg, params, frames):
    """At full width in f32 (the weights cast), over 2 clips."""
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    teacher_forcing(cfg32, _map(torch.Tensor.float, params),
                    {"frames": frames[:2].float()},
                    "whisper_f32_prefill_decode_vs_teacher_forcing")
    torch.cuda.empty_cache()


def whisper_path(dev):
    """Phase 12: whisper-base (6 encoder and 6 decoder layers, d 512, 8
    heads of 64, LayerNorm, GELU MLP, V 51,865 tied) at full width, served
    as the JAX package serves it.  A ``ServingEngine`` of 4 slots x 2,048
    first serves 2 raw text requests on its default cache (cross-attention
    over zero keys and values); its ``embed_batch``, whose requests carry
    no frames, raises ``KeyError: 'frames'`` (ROADMAP C.15).  Then the
    cache is replaced by ``encode_for_cache`` of 4 clips (the encoder:
    flash attention without the causal mask, once a layer) and 8 requests
    of 32 new tokens run on the 4 slots (4 prompts of 4 tokens, then 4 of
    40-100, whose chunked prefill runs over the cross cache in reused
    slots), and the embed step runs once over 4 (text, clip) pairs (flash
    attention in each encoder and decoder layer).  Every flash call and
    one decode call in 7 of that path are held against the plain version;
    then a decode step, a 64-pair embed batch and, in f32, prefill and
    decode against teacher forcing; the decode step's device split; and
    each request against its run in a fresh engine whose first slot holds
    the same clip."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.steps import make_embed_step

    cfg = get_config(WHISPER)
    slots, context = WHISPER_CLIPS, 2048
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    log(phase="whisper_weights", arch=cfg.name, params=cfg.num_params(),
        encoder_layers=cfg.num_encoder_layers, layers=cfg.num_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size,
        encoder_seq=cfg.encoder_seq,
        weight_gb=sum(t.numel() * t.element_size()
                      for t in _tensors(params)) / 1e9,
        seconds=time.perf_counter() - t_phase,
        init_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        predicted_init_peak_memory_gb=WHISPER_PREDICTED[
            "init_peak_memory_gb"])
    frames = whisper_frames(cfg, dev, WHISPER_CLIPS, SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    text_prompts = [[int(t) for t in rng.integers(0, 256, n)]
                    for n in rng.integers(40, 101, 2)]
    clip_prompts = [[int(t) for t in rng.integers(0, 256, n)]
                    for n in [4] * slots + list(rng.integers(40, 101, slots))]
    embed_texts = passages(rng, WHISPER_CLIPS, 90, 129)
    engine = ServingEngine(cfg, n_slots=slots, max_context=context,
                           device=dev, params=params)
    cache_gb = sum(t.numel() * t.element_size()
                   for t in _tensors(engine.cache)) / 1e9
    embed_step = make_embed_step(cfg)
    counts = _attention_counts()
    flash = HeldKernel(counts["flash_attention"], attention_ref)
    decode = HeldKernel(counts["decode_attention"], decode_attention_ref,
                        every=WHISPER_DECODE_EVERY)

    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(L.flash_ops, "flash_attention", flash), \
            mock.patch.object(L.decode_ops, "decode_attention", decode), \
            mock.patch.object(M, "decode_step", wraps=M.decode_step) as dec:
        # text on the default cache, as the JAX engine serves it
        text = [engine.submit(p, max_new_tokens=WHISPER_NEW)
                for p in text_prompts]
        engine.run_until_idle()
        zero_cross = not any(t.any().item() for t in _cross_kv(engine.cache))
        embed_error = None
        try:
            engine.embed_batch([[1, 2, 3]])
        except KeyError as e:
            embed_error = e.args[0]
        # audio: the 4 clips' cross-attention cache, then 8 requests
        enc_cache = M.encode_for_cache(cfg, params, frames, slots, context)
        engine.cache = enc_cache
        reqs = [engine.submit(p, max_new_tokens=WHISPER_NEW)
                for p in clip_prompts]
        engine.run_until_idle()
        emb = embed_step(params, {"tokens": bucket_tokens(
            cfg, embed_texts, dev, WHISPER_EMBED_BUCKET),
                                  "frames": frames})
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    decode_steps = dec.call_count
    dec.reset_mock()            # its recorded calls hold the engine's cache
    peak = torch.cuda.max_memory_allocated()
    held = {"flash_attention": flash.read(), "decode_attention": decode.read()}

    check(zero_cross, "whisper: the default cache's cross K/V are not zero")
    check(embed_error == "frames", f"whisper: embed_batch without frames "
          f"raised {embed_error!r}, not KeyError('frames')")
    check(all(r.finished and len(r.generated) == WHISPER_NEW
              for r in text + reqs),
          f"whisper requests generated {WHISPER_NEW} tokens each")
    slots_used = [r.slot for r in reqs]
    check(slots_used == list(range(slots)) * 2,
          f"whisper: each slot serves two clip requests: {slots_used}")
    check(emb.shape == (WHISPER_CLIPS, cfg.d_model)
          and torch.isfinite(emb).all().item()
          and torch.allclose(emb.norm(dim=-1), torch.ones_like(emb[:, 0]),
                             atol=1e-3),
          "whisper embeddings are finite unit vectors")
    per_embed = cfg.num_encoder_layers + cfg.num_layers
    expected = {"flash_attention": cfg.num_encoder_layers + per_embed,
                "decode_attention": cfg.num_layers * decode_steps}
    log(phase="whisper_path", arch=cfg.name, slots=slots,
        max_context=context, cache_gb=cache_gb,
        predicted_cache_gb=WHISPER_PREDICTED["cache_gb"],
        text_requests=len(text), clip_requests=len(reqs),
        prompt_tokens=[len(p) for p in text_prompts + clip_prompts],
        clip_slots=slots_used, zero_cross_on_default_cache=zero_cross,
        embed_batch_without_frames_raises=f"KeyError({embed_error!r})",
        embed_pairs=WHISPER_CLIPS, engine_steps=engine.steps,
        decode_steps=decode_steps, wall_s=wall, peak_memory_gb=peak / 1e9,
        predicted_peak_memory_gb=WHISPER_PREDICTED["peak_memory_gb"],
        launches=launches, expected_launches=expected,
        launches_per_encode=cfg.num_encoder_layers,
        launches_per_embed_step=per_embed,
        launches_per_decode_step=cfg.num_layers)
    log(phase="whisper_kernels_vs_plain", atol=TOLS[torch.bfloat16],
        decode_every=WHISPER_DECODE_EVERY, **held)
    for name, n in launches.items():
        check(n > 0 and n == expected[name],
              f"whisper: {name} launched {n} times, not {expected[name]}")
    for name, row in held.items():
        check(row["ok"], f"whisper: a held {name} call differs from its "
              f"plain version: {row}")
    check(held["flash_attention"]["held"] == launches["flash_attention"],
          "whisper: not every flash call was held")

    compare_decode_rounding(engine, "whisper_")
    decode_split(engine, "whisper_")
    whisper_embed_vs_plain(cfg, params, dev)
    whisper_teacher_forcing(cfg, params, frames)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # each request against its run alone in a fresh engine whose first
    # slot holds the same clip's cross K/V (the same tensors, rolled)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    same = []
    for r, p in zip(reqs, clip_prompts):
        fresh = ServingEngine(cfg, n_slots=slots, max_context=context,
                              device=dev, params=params)
        for t, src in zip(_cross_kv(fresh.cache), _cross_kv(enc_cache)):
            t.copy_(torch.roll(src, -r.slot, dims=1))
        same.append(fresh.generate(p, max_new_tokens=WHISPER_NEW)
                    == r.generated)
        del fresh
    log(phase="whisper_reused_slots", same_as_alone=same,
        seconds=time.perf_counter() - t1,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(all(same), f"whisper: a request differs from its run in a fresh "
          f"engine holding the same clip: {same}")
    log(phase="whisper_phase", wall_s=time.perf_counter() - t_phase,
        predicted_phase_wall_s=WHISPER_PREDICTED["phase_wall_s"])
    return launches


# --------------------------------------------------------------------------
# phase 13: phi-3-vision-4.2b, the vision patch prefix at full width
# --------------------------------------------------------------------------
PHI3V = "phi-3-vision-4.2b"
# written in PERF.md before the phase's first run on the card
PHI3V_PREDICTED = {"init_peak_memory_gb": 8.1,
                   "cache_gb": 3.22,
                   "peak_memory_gb": [11.0, 13.0],
                   "phase_wall_s": [20.0, 40.0]}
PHI3V_IMAGES = 4                 # (image, text) requests of the image path
PHI3V_TEXT = 64                  # prompt tokens after each image
PHI3V_NEW = 16                   # greedy decode steps after the prefill
PHI3V_DECODE_EVERY = 7           # one decode call in 7 held on the path
PHI3V_EMBED_BUCKET = 128
PHI3V_EMBED_PAIRS = 16           # (text, image) pairs of the embed check
# the embed check's bound: min cosine above 1 - this, as phase 4's
PHI3V_EMBED_COS_GAP = 1e-3
PHI3V_CUT_LAYERS = 4             # the f32 teacher-forcing check's depth


def phi3v_patches(cfg, dev, n, seed):
    """``n`` random "images": ``num_prefix_tokens`` patch embeddings each,
    N(0, 1) at the token embeddings' scale (d^-0.5), in the compute dtype
    (the image tower is a stub in the JAX package too)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((n, cfg.num_prefix_tokens, cfg.d_model),
                        generator=g, device=dev) * cfg.d_model ** -0.5
            ).to(cfg.compute_torch_dtype)


def phi3v_images(engine) -> dict:
    """Requests over images, through the model's entry points (the engine
    and the provider take no patches, as the JAX package's take none:
    ROADMAP C.16): ``prefill`` over 4 (image, 64-token text) rows, greedy
    ``decode_step`` from next_pos = 144 + 64 for 16 steps, and the embed
    step over 4 (text, image) pairs.  Every flash call and one decode call
    in 7 held against the plain version; flash counted once a layer for
    the prefill and for the embed step, decode once a layer a step.  The
    images must move the logits (the prefix is read).  Returns the
    launches."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving.steps import make_embed_step
    cfg, params, dev = engine.cfg, engine.params, engine.device
    P, B = cfg.num_prefix_tokens, PHI3V_IMAGES
    rng = np.random.default_rng(SEED + 50)
    patches = phi3v_patches(cfg, dev, B, SEED + 51)
    prompts = bucket_tokens(cfg, passages(rng, B, PHI3V_TEXT, 129), dev,
                             PHI3V_TEXT)
    embed_tokens = bucket_tokens(cfg, passages(rng, B, 90, 129), dev,
                                  PHI3V_EMBED_BUCKET)
    step = make_embed_step(cfg)
    counts = _attention_counts()
    flash = HeldKernel(counts["flash_attention"], attention_ref)
    decode = HeldKernel(counts["decode_attention"], decode_attention_ref,
                        every=PHI3V_DECODE_EVERY)

    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(L.flash_ops, "flash_attention", flash), \
            mock.patch.object(L.decode_ops, "decode_attention", decode):
        logits, cache, pos = M.prefill(
            cfg, params, {"tokens": prompts, "patches": patches},
            P + PHI3V_TEXT + PHI3V_NEW)
        first = logits[:, -1]
        tok = first.argmax(dim=-1, keepdim=True).to(torch.int32)
        generated, finite = [tok], [torch.isfinite(first).all()]
        for i in range(PHI3V_NEW):
            lg, cache = M.decode_step(
                cfg, params, tok, cache,
                torch.full((B,), pos + i, dtype=torch.int32, device=dev))
            tok = lg[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
            generated.append(tok)
            finite.append(torch.isfinite(lg).all())
        emb = step(params, {"tokens": embed_tokens, "patches": patches})
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    held = {"flash_attention": flash.read(), "decode_attention": decode.read()}
    del cache
    # the same text without its image: the prefix must change the logits
    text_only, _, text_pos = M.prefill(cfg, params, {"tokens": prompts},
                                       PHI3V_TEXT)
    image_shift = max_err(first, text_only[:, -1])
    del text_only
    generated = torch.cat(generated, dim=1).cpu()

    expected = {"flash_attention": 2 * cfg.num_layers,
                "decode_attention": PHI3V_NEW * cfg.num_layers}
    log(phase="phi3v_images", card=card_line(), images=B,
        patches_per_image=P, prompt_tokens=PHI3V_TEXT, next_pos=pos,
        decode_steps=PHI3V_NEW, generated=generated.tolist(),
        embed_pairs=B, embed_bucket=PHI3V_EMBED_BUCKET, wall_s=wall,
        peak_memory_gb=peak / 1e9, launches=launches,
        expected_launches=expected,
        image_vs_text_only_logits_max_abs_diff=image_shift)
    log(phase="phi3v_kernels_vs_plain", atol=TOLS[torch.bfloat16],
        decode_every=PHI3V_DECODE_EVERY, **held)
    check(pos == P + PHI3V_TEXT and text_pos == PHI3V_TEXT,
          f"phi3v: prefill returned next_pos {pos} and {text_pos}")
    check(all(bool(f) for f in finite)
          and bool(((generated >= 0) & (generated < cfg.vocab_size)).all()),
          "phi3v: image-prefix logits finite, tokens in the vocabulary")
    check(emb.shape == (B, cfg.d_model) and torch.isfinite(emb).all().item()
          and torch.allclose(emb.norm(dim=-1), torch.ones_like(emb[:, 0]),
                             atol=1e-3),
          "phi3v: image-text embeddings are finite unit vectors")
    check(image_shift > 0, "phi3v: the image prefix does not change the "
          "logits")
    for name, n in launches.items():
        check(n == expected[name],
              f"phi3v images: {name} launched {n} times, not "
              f"{expected[name]}")
    for name, row in held.items():
        check(row["ok"], f"phi3v: a held {name} call differs from its "
              f"plain version: {row}")
    check(held["flash_attention"]["held"] == launches["flash_attention"],
          "phi3v: not every flash call was held")
    return launches


def phi3v_embed_vs_plain(engine):
    """The embed step over 16 (text, image) pairs through the flash kernel
    and through its plain version, by min cosine."""
    cfg, dev = engine.cfg, engine.device
    rng = np.random.default_rng(SEED + 53)
    texts = passages(rng, PHI3V_EMBED_PAIRS, 90, 129)
    embed_vs_plain(cfg, engine.params, [{
        "tokens": bucket_tokens(cfg, texts, dev, PHI3V_EMBED_BUCKET),
        "patches": phi3v_patches(cfg, dev, PHI3V_EMBED_PAIRS, SEED + 54)}],
        "phi3v_image_embed_vs_plain", PHI3V_EMBED_COS_GAP,
        pairs=PHI3V_EMBED_PAIRS, bucket=PHI3V_EMBED_BUCKET)


def phi3v_teacher_forcing(dev):
    """On the configuration cut to 4 layers at full width, in f32 (its own
    weights, drawn in f32), over 2 images: the f32 instances of both
    kernels at hd 96 run it."""
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    cfg = get_config(PHI3V).replace(num_layers=PHI3V_CUT_LAYERS,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    teacher_forcing(cfg, params,
                    {"patches": phi3v_patches(cfg, dev, 2, SEED + 55)},
                    "phi3v_f32_prefill_decode_vs_teacher_forcing",
                    cut=f"{PHI3V_CUT_LAYERS} of 32 layers")


def phi3v_path(dev):
    """Phase 13: phi-3-vision-4.2b (32 layers, d 3,072, 32 heads of 96,
    SwiGLU d_ff 8,192, V 32,064 untied) at full width.  Text as the JAX
    package serves it, through ``serve_path`` (flash 32 times an embed
    request, decode 32 times a decode step; the decode step against the
    plain path); then, on the same weights, requests over images through
    the model's entry points (``phi3v_images``), an embed batch of (text,
    image) pairs against the plain path and the decode step's device
    split; the engine freed, prefill and decode with patches against
    teacher forcing in f32 on the config cut to 4 layers."""
    images = {}

    def after_traffic(engine):
        images.update(phi3v_images(engine))
        phi3v_embed_vs_plain(engine)
        decode_split(engine, "phi3v_")
    text = dense_path(dev, PHI3V, "phi3v_", SEED + 15,
                      predicted=PHI3V_PREDICTED, after_traffic=after_traffic)
    free_device("phi3v")
    phi3v_teacher_forcing(dev)
    return {name: n + images.get(name, 0) for name, n in text.items()}


# --------------------------------------------------------------------------
# phase 14: the trainer, olmo-1b at full width, and its checkpoint served
# --------------------------------------------------------------------------
TRAIN = "olmo-1b"
# written in PERF.md before the phase's first run on the card
TRAIN_PREDICTED = {"peak_memory_gb": [22.0, 25.0],
                   "step_s": [0.2, 0.4],
                   "first_step_s": [0.5, 5.0],
                   "step0_loss": [10.9, 11.6],
                   "phase_wall_s": [35.0, 75.0]}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 512
TRAIN_CUT_LAYERS = 2             # the f32 check, the drill and the serving
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 128
DRILL_STEPS, DRILL_EVERY, DRILL_DIE = 4, 2, 3
DRILL_BATCH, DRILL_SEQ = 2, 128
TRAIN_SERVE_NEW = 16
TRAIN_DECODE_EVERY = 7           # one decode call in 7 held on the path
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4     # tests/test_torch_training


def _kernel_counts():
    from repro_torch.kernels.rg_lru.ops import rg_lru
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    return {**counters(), "ssm_scan": ssm_scan, "rg_lru": rg_lru}


def _flat_leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _flat_leaves(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in _flat_leaves(v, f"{path}/{i}").items()}
    return {path: tree}


def _train_args(dev, *extra) -> list:
    return ["--arch", TRAIN, "--device", str(dev), "--log-every", "1",
            *map(str, extra)]


def train_full(dev) -> dict:
    """(a) olmo-1b at full width and depth (bf16 params, remat on) for 6
    AdamW steps through ``launch/train.py: run`` at global batch 8 and
    sequence 512: each step's loss, rate, grad norm and wall, the peak
    memory, and every kernel's launches, which must all be 0 (the
    training route is plain, as the JAX package's)."""
    from repro_torch.launch.train import run
    counts = _kernel_counts()
    rows = []

    def on_step(step, params, metrics, seconds):
        rows.append({"step": step, "loss": float(metrics["loss"]),
                     "lr": float(metrics["lr"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "wall_s": seconds})
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepSplit() as split:
        losses = run(_train_args(dev, "--steps", TRAIN_STEPS,
                                 "--global-batch", TRAIN_BATCH,
                                 "--seq-len", TRAIN_SEQ), on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for row, part in zip(rows, split.rows()):
        row.update(part)
    launches = {name: fn.launches for name, fn in counts.items()}
    cfg = _train_cfg()
    log(phase="train_olmo", card=card_line(), arch=TRAIN,
        params=cfg.num_params(), layers=cfg.num_layers, steps=TRAIN_STEPS,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, remat=cfg.remat,
        param_dtype=cfg.param_dtype, rows=rows, wall_s=wall,
        step_s_median=statistics.median(r["wall_s"] for r in rows[1:]),
        **{f"{k}_median": statistics.median(r[k] for r in rows[1:])
           for k in ("forward_ms", "backward_ms", "adamw_ms", "step_ms")},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        ln_vocab=float(np.log(cfg.vocab_size)), launches=launches,
        **{f"predicted_{k}": TRAIN_PREDICTED[k] for k in
           ("peak_memory_gb", "step_s", "first_step_s", "step0_loss")})
    check(all("step_ms" in r for r in rows),
          f"train split: a step was not timed {rows}")
    check(len(losses) == TRAIN_STEPS == len(rows)
          and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                  for r in rows), f"train: non-finite losses or norms {rows}")
    check(all(n == 0 for n in launches.values()),
          f"train: the train steps launched kernels {launches}")
    return launches


class StepSplit:
    """Times the parts of every train step that ``run`` takes, on the
    stream, with CUDA events: the forward (``M.loss_fn``), the backward
    (the rest of ``value_and_grad``) and the AdamW update
    (``adamw_update``).  For the time of a ``with`` it wraps the three
    functions where ``train_step`` looks them up; the step's code is
    unchanged.  ``rows()`` synchronizes and gives each step's ms."""
    PARTS = ("loss_fn", "value_and_grad", "adamw_update")

    def __enter__(self):
        from repro_torch.models import model as M
        from repro_torch.training import train_step as TS
        self.events = {name: [] for name in self.PARTS}
        self._saved = [(M, "loss_fn"), (TS, "value_and_grad"),
                       (TS, "adamw_update")]
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name in self._saved]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def timed(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.events[name].append(ev)
            return out
        return timed

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def rows(self) -> list:
        torch.cuda.synchronize()
        ms = {name: [a.elapsed_time(b) for a, b in evs]
              for name, evs in self.events.items()}
        check(len(set(map(len, ms.values()))) == 1,
              f"train split: unmatched parts {ms}")
        return [{"forward_ms": f, "backward_ms": vg - f, "adamw_ms": u,
                 "step_ms": a_end.elapsed_time(b_end) + vg}
                for f, vg, u, (_, a_end), (_, b_end) in zip(
                    ms["loss_fn"], ms["value_and_grad"], ms["adamw_update"],
                    self.events["value_and_grad"],
                    self.events["adamw_update"])]


def _train_cfg(**kw):
    from repro_torch.configs import get_config
    return get_config(TRAIN).replace(**kw)


def train_cut_vs_cpu(dev):
    """(b) one f32 train step of olmo-1b cut to 2 layers at full width on
    the card against the same step on the CPU: the same weights (drawn on
    the CPU, copied over), the same 2 x 128 batch.  The loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest magnitude;
    then AdamW on both (the grad norm within 1e-5, the rate equal)."""
    from repro_torch.params import init_params
    from repro_torch.training import HParams, adamw_init, make_train_step
    from repro_torch.training.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.training.train_step import value_and_grad
    cfg = _train_cfg(num_layers=TRAIN_CUT_LAYERS, param_dtype="float32",
                     compute_dtype="float32")
    t0 = time.perf_counter()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    params = _map(lambda t: t.to(dev), cpu_params)
    b = SyntheticTokenPipeline(DataConfig(
        cfg.vocab_size, TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH, SEED)).batch_at(0)
    cpu_b = {k: torch.from_numpy(v) for k, v in b.items()}
    card_b = {k: v.to(dev) for k, v in cpu_b.items()}
    t1 = time.perf_counter()
    (l_card, _), g_card = value_and_grad(cfg, params, card_b)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    (l_cpu, _), g_cpu = value_and_grad(cfg, cpu_params, cpu_b)
    t3 = time.perf_counter()
    loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    gc, gp = _flat_leaves(g_card), _flat_leaves(g_cpu)
    worst = max(((gc[p].cpu() - g).abs().max()
                 / g.abs().max().clamp_min(1e-30)).item()
                for p, g in gp.items())
    del g_card, g_cpu, gc, gp
    hp = HParams(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, hp)
    _, _, m_card = step(params, adamw_init(params), card_b)
    _, _, m_cpu = step(cpu_params, adamw_init(cpu_params), cpu_b)
    gn_rel = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) \
        / float(m_cpu["grad_norm"])
    log(phase="train_cut_f32_vs_cpu", layers=TRAIN_CUT_LAYERS,
        params=cfg.num_params(), batch=TRAIN_CHECK_BATCH,
        seq_len=TRAIN_CHECK_SEQ, loss_card=float(l_card),
        loss_cpu=float(l_cpu), loss_rel_err=loss_rel,
        max_grad_err_over_leaf_max=worst, grad_norm_rel_err=gn_rel,
        lr_card=float(m_card["lr"]), lr_cpu=float(m_cpu["lr"]),
        setup_s=t1 - t0, card_s=t2 - t1, cpu_s=t3 - t2,
        loss_rtol=TRAIN_LOSS_RTOL, grad_tol=TRAIN_GRAD_TOL)
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"train: the card's f32 loss differs from the CPU's by {loss_rel}")
    check(worst <= TRAIN_GRAD_TOL,
          f"train: a card gradient differs from the CPU's by {worst} of its "
          "largest magnitude")
    check(gn_rel <= TRAIN_LOSS_RTOL
          and float(m_card["lr"]) == float(m_cpu["lr"]),
          f"train: AdamW's grad norm {gn_rel} or rate differ")


def train_drill(dev, root: Path):
    """(c) the fault-tolerance drill on the cut config (bf16): 4 steps
    uninterrupted, checkpoints every 2; the same run dying at step 3, then
    resumed with ``--resume auto`` from step 2.  Under
    ``torch.use_deterministic_algorithms(True)`` the resumed losses must
    equal the uninterrupted run's bitwise, and so must the final
    checkpoints.  Returns the resumed run's final params and the
    checkpoint directory."""
    from repro_torch.launch.train import run
    from repro_torch.training.checkpoint import CheckpointManager
    args = _train_args(dev, "--layers", TRAIN_CUT_LAYERS, "--steps",
                       DRILL_STEPS, "--global-batch", DRILL_BATCH,
                       "--seq-len", DRILL_SEQ, "--ckpt-every", DRILL_EVERY)
    last = {}
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        full = run(args + ["--ckpt-dir", str(root / "a")])
        died = None
        try:
            run(args + ["--ckpt-dir", str(root / "b"), "--die-at-step",
                        str(DRILL_DIE)])
        except SystemExit as e:
            died = e.code
        resumed = run(args + ["--ckpt-dir", str(root / "b"), "--resume",
                              "auto"],
                      on_step=lambda s, p, m, w: last.update(params=p))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    wall = time.perf_counter() - t0
    a = _flat_leaves(CheckpointManager(str(root / "a")).restore_latest())
    b = _flat_leaves(CheckpointManager(str(root / "b")).restore_latest())
    same_ckpt = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    ckpt_gb = sum(p.stat().st_size for p in (root / "b").glob("*.npz")) \
        / 1e9 / len(list((root / "b").glob("*.npz")))
    del a, b
    log(phase="train_drill", layers=TRAIN_CUT_LAYERS, steps=DRILL_STEPS,
        ckpt_every=DRILL_EVERY, died_at=DRILL_DIE, exit_code=died,
        losses_full=full, losses_resumed=resumed,
        bitwise_losses=full[-len(resumed):] == resumed,
        bitwise_final_checkpoint=same_ckpt, checkpoint_gb=ckpt_gb,
        deterministic_algorithms=True, wall_s=wall)
    check(died == 42 and len(resumed) == DRILL_STEPS - DRILL_EVERY,
          f"train drill: exit {died}, {len(resumed)} resumed steps")
    check(full[-len(resumed):] == resumed and same_ckpt,
          f"train drill: resumed losses {resumed} or checkpoint differ "
          f"from the uninterrupted run's {full}")
    return last["params"], root / "b"


def train_serve(dev, trained, ckpt_dir: Path) -> dict:
    """(d) the drill's last checkpoint served through
    ``ServingEngine(cfg, checkpoint=dir)``: its params equal the trained
    ones bitwise; 4 requests of 16 new tokens and one embed request, every
    flash call and one decode call in 7 held against the plain version;
    flash counted once a layer for the embed request, decode once a layer
    a decode step.  Returns the launches."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    cfg = _train_cfg(num_layers=TRAIN_CUT_LAYERS)
    engine = ServingEngine(cfg, checkpoint=str(ckpt_dir), device=dev)
    served, want = _flat_leaves(engine.params), _flat_leaves(trained)
    same = set(served) == set(want) and all(
        served[k].dtype == want[k].dtype and torch.equal(served[k], want[k])
        for k in want)
    rng = np.random.default_rng(SEED + 60)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in rng.integers(40, 120, 4)]
    texts = passages(rng, 8, 90, 129)
    counts = _attention_counts()
    flash = HeldKernel(counts["flash_attention"], attention_ref)
    decode = HeldKernel(counts["decode_attention"], decode_attention_ref,
                        every=TRAIN_DECODE_EVERY)
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(L.flash_ops, "flash_attention", flash), \
            mock.patch.object(L.decode_ops, "decode_attention", decode), \
            mock.patch.object(M, "decode_step", wraps=M.decode_step) as dec:
        reqs = [engine.submit(p, max_new_tokens=TRAIN_SERVE_NEW)
                for p in prompts]
        engine.run_until_idle()
        emb = engine.embed_batch([list(t.encode()) for t in texts])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_steps = dec.call_count
    launches = {name: fn.launches for name, fn in counts.items()}
    held = {"flash_attention": flash.read(), "decode_attention": decode.read()}
    expected = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * decode_steps}
    log(phase="train_serve", checkpoint_params_equal_trained=same,
        requests=len(reqs), new_tokens=[len(r.generated) for r in reqs],
        embed_texts=len(texts), decode_steps=decode_steps, wall_s=wall,
        launches=launches, expected_launches=expected)
    log(phase="train_serve_kernels_vs_plain", atol=TOLS[torch.bfloat16],
        decode_every=TRAIN_DECODE_EVERY, **held)
    check(same, "train: the served checkpoint's params differ from the "
          "trained ones")
    check(all(r.finished and len(r.generated) == TRAIN_SERVE_NEW
              for r in reqs), "train: a served request did not finish")
    check(emb.shape == (len(texts), cfg.d_model) and np.isfinite(emb).all()
          and np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3),
          "train: the served embeddings are not finite unit vectors")
    for name, n in launches.items():
        check(n == expected[name], f"train serve: {name} launched {n} "
              f"times, not {expected[name]}")
    for name, row in held.items():
        check(row["ok"], f"train: a held {name} call differs from its plain "
              f"version: {row}")
    check(held["flash_attention"]["held"] == launches["flash_attention"],
          "train: not every flash call was held")
    return launches


def train_path(dev):
    """Phase 14: the trainer (``launch/train.py``) at full olmo-1b width,
    the cut config's f32 step against the CPU, the resume drill and the
    drill's checkpoint served.  Returns the launches of the phase (the
    train steps' are all 0; the serving's flash and decode)."""
    import tempfile
    t0 = time.perf_counter()
    train_full(dev)
    free_device("train_olmo")
    train_cut_vs_cpu(dev)
    free_device("train_cut")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        trained, ckpt_dir = train_drill(dev, Path(tmp))
        launches = train_serve(dev, trained, ckpt_dir)
        del trained
    log(phase="train_phase", wall_s=time.perf_counter() - t0,
        predicted_phase_wall_s=TRAIN_PREDICTED["phase_wall_s"])
    return launches


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


# --------------------------------------------------------------------------
# phase 15: the mesh-sharded scan on one card, and the serving launcher
# --------------------------------------------------------------------------
SHARDED_ROWS, SHARDED_DIM = 1_000_000, 2048
SHARDED_CASES = ((8, 100), (4, Q3_CANDIDATES))      # (queries, k)
SHARDED_CALLS = 20               # timed calls a case
NEAR_TIE = 1e-6                  # ids may trade places within this gap
# written in PERF.md before the phase's first run on the card
SHARDED_PREDICTED = {"shard_kernel_ms": [0.7, 0.9],
                     "sharded_route_ms": [3.5, 7.0],
                     "single_route_ms": [10.0, 14.0],
                     "phase_wall_s": [30, 60]}
SERVE_ARGS = ["--full", "--arch", "olmo-1b", "--requests", "8",
              "--slots", "4", "--prompt-len", "48", "--max-new", "16",
              "--max-context", "256"]


def event_ms(fn, calls=SHARDED_CALLS, warmup=2, device=None) -> list:
    """Device times in ms of ``calls`` calls of ``fn`` on ``device``'s
    current stream (the current device's where None), by CUDA events, L2
    warm (a call reads 8 GB)."""
    with torch.cuda.device(device):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(calls):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def spread(times) -> dict:
    return dict(median=statistics.median(times), min=min(times),
                max=max(times))


def sharded_scan(dev, flush):
    """Phase 15a: ``VectorIndex(mesh=)`` over a mesh of 4 entries of this
    card at 1,000,000 x 2048 f32, for 8 queries at k 100 and 4 at k 32
    (Query 3's ``candidate_k``): block_max_scores launched 4 times a
    call, each counted from 0 just before the call; ids against the
    single-card route (``topk_sim`` over the whole normalised corpus, as
    ``VectorIndex.topk`` runs it) and the plain scan (``cosine_topk``),
    exact but for logged near-ties within 1e-6, scores within 1e-5; the
    kernel at the shard's shape against its plain version.  Returns
    (the kernel's row at the shard shape, launches of the phase)."""
    from repro_torch.kernels.topk_sim import ops as topk_ops
    from repro_torch.kernels.topk_sim.ref import block_max_scores_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.retrieval import VectorIndex, cosine_topk
    from repro_torch.retrieval import distributed as D

    N, Dm = SHARDED_ROWS, SHARDED_DIM
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    raw = torch.randn((N, Dm), generator=g, device=dev).cpu().numpy()
    mesh = make_mesh((SHARDS,), ("data",), devices=[dev] * SHARDS)
    torch.cuda.reset_peak_memory_stats()
    index = VectorIndex(raw, mesh=mesh)
    del raw
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    shards = index._placed(mesh)
    placed_peak = torch.cuda.max_memory_allocated()
    # the single-card route's corpus, as VectorIndex(device=dev) holds it
    whole = torch.from_numpy(index.host_vectors).to(dev)
    bm = topk_ops.block_max_scores
    launches, cases = 0, []
    for Q, k in SHARDED_CASES:
        q = torch.randn((Q, Dm), generator=g, device=dev)
        q_host = q.cpu().numpy()
        bm.launches = 0
        t1 = time.perf_counter()
        s, i = index.topk(q_host, k)
        call_s = time.perf_counter() - t1
        n = bm.launches
        launches += n
        s1, i1 = (x.cpu().numpy() for x in topk_ops.topk_sim(whole, q, k))
        s0, i0 = (x.cpu().numpy() for x in cosine_topk(whole, q, k))
        single_ok, single_ties = ranks_agree(i, i1, s1, NEAR_TIE / 10)
        plain_ok, plain_ties = ranks_agree(i, i0, s0, NEAR_TIE / 10)
        fn = D.make_sharded_topk(mesh, k)
        route = event_ms(lambda: fn(shards, q))
        single = event_ms(lambda: topk_ops.topk_sim(whole, q, k))
        walls = []
        for _ in range(SHARDED_CALLS):
            t1 = time.perf_counter()
            index.topk(q_host, k)
            walls.append((time.perf_counter() - t1) * 1e3)
        cases.append(dict(
            queries=Q, k=k, launches=n, first_call_s=call_s,
            ids_equal_single=bool(np.array_equal(i, i1)),
            ids_equal_plain=bool(np.array_equal(i, i0)),
            near_ties_single=single_ties, near_ties_plain=plain_ties,
            min_adjacent_gap=float(np.abs(np.diff(s1, axis=1)).min()),
            max_score_err_single=float(np.abs(s - s1).max()),
            max_score_err_plain=float(np.abs(s - s0).max()),
            route_ms=spread(route), single_route_ms=spread(single),
            call_wall_ms=spread(walls), ok=single_ok and plain_ok and bool(
                np.abs(s - s1).max() <= SCORE_TOL
                and np.abs(s - s0).max() <= SCORE_TOL)))
    del whole
    # the kernel at the shard's shape
    shard = shards[0]
    qn = torch.randn((8, Dm), generator=g, device=dev)
    qn = qn / qn.norm(dim=-1, keepdim=True)
    out = bm(shard, qn)
    ref = block_max_scores_ref(shard, qn)
    rows = shard.shape[0]
    b_ms, b_by = bound_ms((rows * Dm + 8 * Dm + 8 * out.shape[1]) * 4,
                          2 * 8 * rows * Dm, torch.float32)
    row = dict(
        name="topk_sim.block_max_scores", shape=f"shard ({rows}, {Dm}) f32 "
        f"of {SHARDS} on one card, queries (8, {Dm}), block_n 64",
        max_abs_err=max_err(out, ref), ok=torch.allclose(
            out, ref, atol=TOLS[torch.float32], rtol=TOLS[torch.float32]),
        ms=time_ms(lambda: bm(shard, qn), flush),
        plain_ms=time_ms(lambda: block_max_scores_ref(shard, qn), flush,
                         iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(phase="sharded_scan", card=card_line(), rows=N, dim=Dm,
        mesh=repr(mesh), shard_rows=[t.shape[0] for t in shards],
        shard_devices=[str(t.device) for t in shards],
        index_holds_whole_corpus_tensor=index.vectors is not None,
        build_s=build_s, placed_peak_gb=placed_peak / 1e9, cases=cases,
        kernel=row, predicted=SHARDED_PREDICTED)
    check(index.vectors is None and sum(t.shape[0] for t in shards) == N
          and all(t.shape[0] == N // SHARDS for t in shards),
          "sharded: the shards do not split the corpus evenly")
    for case in cases:
        check(case["launches"] == SHARDS,
              f"sharded: block_max_scores launched {case['launches']} "
              f"times in a call, not {SHARDS}")
        check(case["ok"], f"sharded: the sharded route differs from the "
              f"single-card route or the plain scan: {case}")
    check(row["ok"], f"sharded: block_max_scores at the shard shape "
          f"differs from its plain version ({row['max_abs_err']})")
    return row, {"topk_sim.block_max_scores": launches}


def serve_launch():
    """Phase 15b: ``launch/serve.py`` as a user runs it, at full olmo-1b
    width on the card (no ``--device``): every request finishes with its
    tokens; decode attention launches in each of the 16 layers a decode
    step, one call in 7 held against the plain version on the same inputs
    (``HeldKernel``; a cache of 256 positions, ``--max-context``, which no
    other phase decodes over).  The launcher's routes run no full-sequence
    forward (chunked prefill is plain, as in the JAX package), so flash
    attention does not launch there; its count is logged."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models import layers as L

    layers = get_config("olmo-1b").num_layers
    counts = {"flash_attention": flash_ops.flash_attention,
              "decode_attention": decode_ops.decode_attention}
    for fn in counts.values():
        fn.launches = 0
    # one call in 7: prime to the 16 layers, so every layer is held
    held = HeldKernel(decode_ops.decode_attention, decode_attention_ref, 7)
    t0 = time.perf_counter()
    with mock.patch.object(L.decode_ops, "decode_attention", held):
        out = serve.run(SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counts.items()}
    held = held.read()
    n_req = int(SERVE_ARGS[SERVE_ARGS.index("--requests") + 1])
    new = int(SERVE_ARGS[SERVE_ARGS.index("--max-new") + 1])
    log(phase="serve_kernels_vs_plain", atol=TOLS[torch.bfloat16],
        rtol=TOLS[torch.bfloat16], decode_attention=held)
    log(phase="serve_launcher", argv=SERVE_ARGS, **out, wall_s=wall,
        launches=launches)
    check(held["ok"], f"serve: a decode_attention call differs from its "
          f"plain version: {held}")
    check(held["calls"] == launches["decode_attention"],
          f"serve: {held['calls']} decode calls went through the held "
          f"wrapper, {launches['decode_attention']} launched")
    check(out["done"] == out["requests"] == n_req
          and out["tokens"] == n_req * new,
          f"serve: {out['done']} of {n_req} requests finished, "
          f"{out['tokens']} tokens")
    check(launches["decode_attention"] > 0
          and launches["decode_attention"] % layers == 0,
          f"serve: decode attention launched {launches['decode_attention']}"
          f" times, not {layers} a decode step")
    return {"decode_attention": launches["decode_attention"]}


def sharded_path(dev):
    """Phase 15: the sharded scan (15a) and the serving launcher (15b)."""
    t0 = time.perf_counter()
    flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB
    row, launches = sharded_scan(dev, flush)
    del flush
    free_device("sharded")
    served = serve_launch()
    log(phase="sharded_phase", wall_s=time.perf_counter() - t0,
        predicted_phase_wall_s=SHARDED_PREDICTED["phase_wall_s"])
    return row, launches, served


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
    # phase 14's drill runs under torch.use_deterministic_algorithms, which
    # requires this cuBLAS workspace setting (32 MiB, read when cuBLAS
    # first runs)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    dense, embed_flash = check_dense_rows(dev, flush)
    del flush
    torch.cuda.empty_cache()
    for row in (flash, *decode, topk, ssm, rg_flash, *rg_decode, rg,
                *(r for rows in dense.values() for r in rows),
                *embed_flash.values()):
        check(row["ok"], f"{row['name']} disagrees with its plain version "
              f"({row['shape']})")

    provider, docs, olmo = main_path(dev)
    compare_decode_rounding(provider.engine, "")
    compare_embed_plain(provider, docs)
    profile_window(provider)
    plan = plan_path(provider)
    query3 = query3_path(provider)
    del provider, docs
    free_device("olmo")
    mamba = mamba_path(dev)
    free_device("mamba")
    rgemma = rgemma_path(dev)
    free_device("rgemma")
    granite = granite_path(dev)
    free_device("granite")
    gemma3 = gemma3_path(dev)
    free_device("gemma3")
    qwen = qwen_path(dev)
    free_device("qwen_cut")
    deepseek = deepseek_path(dev)
    free_device("deepseek")
    whisper = whisper_path(dev)
    free_device("whisper")
    phi3v = phi3v_path(dev)
    free_device("phi3v_cut")
    train = train_path(dev)
    free_device("train")
    shard_row, sharded, served = sharded_path(dev)

    by_path = {"olmo-1b": olmo, "plan": plan, "query3": query3,
               MAMBA: mamba, RGEMMA: rgemma, GRANITE: granite,
               GEMMA3: gemma3, QWEN: qwen, DEEPSEEK: deepseek,
               WHISPER: whisper, PHI3V: phi3v, "train": train,
               "sharded": sharded, "serve": served}
    # the same kernel at other paths' shapes, by path
    wider = {"flash_attention": {RGEMMA: rg_flash, **{
                 arch: rows[0] for arch, rows in dense.items()},
                 **embed_flash},
             "decode_attention": {RGEMMA: rg_decode[0], **{
                 arch: rows[1] for arch, rows in dense.items()}},
             "topk_sim.block_max_scores": {"sharded": shard_row}}
    kernels = []
    for row in (flash, decode[0], topk, ssm, rg):
        name = row["name"]
        paths = {p: n[name] for p, n in by_path.items() if name in n}
        entry = dict({k: row[k] for k in KERNEL_ID_KEYS}, **run_keys(row),
                     launches=sum(paths.values()), launches_by_path=paths)
        for path, wide in wider.get(name, {}).items():
            entry[path] = dict(run_keys(wide), shape=wide["shape"])
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
