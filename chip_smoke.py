"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught and hidden):
  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` (one nvcc call, one shared library);
  2. each kernel against its plain PyTorch version at the main path's
     shapes (olmo-1b: flash attention on a 64-text embed batch of 128
     tokens, decode attention over 4 slots x 2048 positions, the block-max
     scan over 100,000 x 2048 f32 passages; falcon-mamba-7b: the selective
     scan of a 64-text embed batch of 128 tokens, di=8192, N=16), with
     CUDA-event times of the kernel, the plain version and, where one
     exists, one PyTorch library call computing the same function; bounds
     from the card's peak rates;
  3. the main path at full olmo-1b width through the user's entry points
     (LocalTorchProvider.embed, VectorIndex.topk, LocalTorchProvider.complete,
     ServingEngine.submit/run_until_idle), with every kernel's launch count
     read from this run alone;
  4. one full-width decode step and one embed batch through the kernels
     against the same through the plain versions;
  5. a traced window of the engine serving 4 requests at once: device
     time by kernel group and the device's idle share;
  6. olmo-1b freed, the falcon-mamba-7b path at full width through the
     same entry points (one 64-passage embed request, a device-resident
     index, top-k, 2 RAG completions, 5 raw requests on 4 slots), the
     selective scan's launches read from this run alone; each raw request
     against the same request served alone from a fresh state (a reused
     slot must not carry its last occupant's state); one embed batch
     through the kernel against the same through the plain scan;
  7. a ``{"kernels": [...]}`` line, then the card, then the result line.

Weights are random, drawn from a fixed seed (no checkpoint is needed).
Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import gc
import json
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


def ids_match(ids, ref_ids, ref_scores, tie_tol=1e-6) -> bool:
    """Equal top-k ids, except at ranks whose plain scores tie a
    neighbouring rank's within ``tie_tol``."""
    ids, ref_ids = ids.cpu().numpy(), ref_ids.cpu().numpy()
    s = ref_scores.double().cpu().numpy()
    for qi, ri in zip(*np.nonzero(ids != ref_ids)):
        near = [abs(s[qi, ri] - s[qi, j]) for j in (ri - 1, ri + 1)
                if 0 <= j < s.shape[1]]
        if not near or min(near) > tie_tol:
            return False
    return True


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions at main-path shapes
# --------------------------------------------------------------------------
def check_flash(dev, flush):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, L, H, hd, dt = 64, 128, 16, 128, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((B, L, H, hd), generator=g, device=dev).to(dt)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), atol=TOLS[dt],
                        rtol=TOLS[dt])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * B * H * (L * (L + 1) // 2) * hd
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80",
        shape=f"q,k,v ({B}, {L}, {H}, {hd}) bf16 causal",
        max_abs_err=err, atol=TOLS[dt], rtol=TOLS[dt], ok=ok,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), flush),
        plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=True), flush,
                         iters=5),
        library_ms=lib, library="F.scaled_dot_product_attention",
        bound_ms=b_ms, bound_by=b_by)
    log(**row)
    return row


def check_decode(dev, flush):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, S, H, KH, hd, dt = 4, 2048, 16, 16, 128, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(dt)
    kc, vc = (torch.randn((B, S, KH, hd), generator=g, device=dev).to(dt)
              for _ in range(2))
    pos = torch.tensor([1900, 1024, 300, 37], dtype=torch.int32, device=dev)
    rows = []
    for window in (0, 512):
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
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        mask = valid[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), flush)
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
            ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush, iters=5),
            library_ms=lib, library="F.scaled_dot_product_attention(mask)",
            bound_ms=b_ms, bound_by=b_by,
            full_cache_bound_ms=(2 * kc.numel() * 2) / HBM_BYTES_PER_S * 1e3)
        log(**row)
        rows.append(row)
    return rows


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
    ids_ok = ids_match(i, i_ref, s_ref)
    n_blocks = out.shape[1]
    nbytes = (N * D + Q * D + Q * n_blocks) * 4
    b_ms, b_by = bound_ms(nbytes, 2 * Q * N * D, torch.float32)
    row = dict(
        name="topk_sim.block_max_scores", route="cuda",
        source="src/repro_torch/csrc/topk_sim.cu",
        replaces="src/repro/kernels/topk_sim/kernel.py:64",
        shape=f"corpus ({N}, {D}) f32, queries ({Q}, {D}), block_n {bn}; "
              f"top-{k} ids vs plain: {'exact' if ids_ok else 'DIFFER'}",
        max_abs_err=err, atol=TOLS[torch.float32], rtol=TOLS[torch.float32],
        ok=ok and ids_ok,
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
def compare_plain(provider, docs):
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    engine = provider.engine
    dev = engine.device
    toks = torch.tensor([[101], [7], [230], [64]], dtype=torch.int32,
                        device=dev)
    pos = torch.tensor([1500, 700, 123, 9], dtype=torch.int32, device=dev)

    def step():
        cache = [{k: {"attn": {n: t.clone() for n, t in v["attn"].items()}}
                  for k, v in stage.items()} for stage in engine.cache]
        return M.decode_step(engine.cfg, engine.params, toks, cache, pos)[0]
    kern = step()
    with mock.patch.object(L.decode_ops, "decode_attention",
                           decode_attention_ref):
        plain = step()
    err = max_err(kern, plain)
    ok = torch.allclose(kern, plain, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    log(phase="decode_step_vs_plain", logits=list(kern.shape),
        max_abs_err=err, atol=LOGITS_TOL, rtol=LOGITS_TOL, ok=ok,
        pos=pos.tolist())
    check(torch.isfinite(kern).all().item(), "decode logits finite")
    check(ok, f"decode_step logits differ from the plain path by {err}")

    tokens = [provider._tokenize(t, engine.cfg.vocab_size) for t in docs[:64]]
    e_kern = engine.embed_batch(tokens)
    with mock.patch.object(L.flash_ops, "flash_attention", attention_ref):
        e_plain = engine.embed_batch(tokens)
    cos = float(np.min(np.sum(e_kern * e_plain, axis=1)))
    err = float(np.abs(e_kern - e_plain).max())
    log(phase="embed_vs_plain", texts=len(tokens), min_cosine=cos,
        max_abs_err=err)
    check(cos > 0.999, f"embeddings differ from the plain path (cos {cos})")


# --------------------------------------------------------------------------
# phase 5: where the device time goes on the main path
# --------------------------------------------------------------------------
# a kernel falls in the first group one of whose markers its name holds
KERNEL_GROUPS = (("flash_attention", ("flash_fwd_",)),
                 ("decode_attention", ("decode_partial_kernel",
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
    log(phase="profile", engine_steps=steps, wall_s=wall,
        trace_s=time.perf_counter() - t_trace,
        host_ms_per_step=wall * 1e3 / steps, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / (wall * 1e3),
        device_ms_by_group=groups,
        top_kernels=[{"kernel": key[:80], "calls": n, "ms": us / 1e3}
                     for us, n, key in sorted(rows, reverse=True)[:12]])


# --------------------------------------------------------------------------
# phase 6: the falcon-mamba-7b path at full width
# --------------------------------------------------------------------------
MAMBA = "falcon-mamba-7b"


def mamba_path(dev):
    """Serve falcon-mamba-7b through the same entry points; its embed
    requests run the selective-scan kernel once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.core import (LocalTorchProvider, ModelResource,
                                  build_metaprompt)
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.params import init_params
    from repro_torch.retrieval import VectorIndex
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(MAMBA)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    log(phase="mamba_weights", arch=cfg.name, params=cfg.num_params(),
        layers=cfg.num_layers, d_model=cfg.d_model, d_inner=cfg.d_inner,
        ssm_state=cfg.ssm_state, vocab=cfg.vocab_size,
        weight_gb=sum(t.numel() * t.element_size()
                      for t in _tensors(params)) / 1e9,
        seconds=time.perf_counter() - t_phase,
        init_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    provider = LocalTorchProvider(MAMBA, use_smoke_config=False, device=dev,
                                  params=params)
    engine = provider.engine
    rng = np.random.default_rng(SEED + 4)
    docs = passages(rng, 64, 90, 129)           # one request, bucket 128
    questions = passages(rng, 4, 30, 60)
    emb_model = ModelResource("mamba-embed", 1, MAMBA)
    gen_model = ModelResource("mamba-gen", 1, MAMBA, max_output_tokens=8)

    ssm_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
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
    launches = ssm_scan.launches
    peak = torch.cuda.max_memory_allocated()

    check(doc_vecs.shape == (64, cfg.d_model)
          and np.isfinite(doc_vecs).all()
          and np.allclose(np.linalg.norm(doc_vecs, axis=1), 1.0, atol=1e-3),
          "falcon-mamba corpus embeddings are finite unit vectors")
    check(ids.shape == (4, 5) and (0 <= ids).all() and (ids < 64).all()
          and np.all(np.diff(scores, axis=1) <= 1e-6),
          "falcon-mamba top-5 ids in range, scores descending")
    check(new_tokens == [8, 8]
          and all(len(a) == 1 and a[0].startswith("0: ") for a in answers),
          f"falcon-mamba completions: {new_tokens}")
    check(all(r.finished and len(r.generated) == 8 for r in raw),
          "falcon-mamba raw requests generated 8 tokens each")
    check(launches == cfg.num_layers * embed_requests,
          f"ssm_scan launched {launches} times, not {cfg.num_layers} per "
          f"embed request")
    stats = provider.stats.snapshot()
    log(phase="mamba_path", arch=cfg.name, embed_requests=embed_requests,
        embed_texts=len(docs) + len(questions), completions=len(answers),
        raw_requests=len(raw), slots=engine.n_slots,
        raw_slots=[r.slot for r in raw],
        prompt_tokens=stats["prompt_tokens"] + sum(map(len, prompts)),
        generated_tokens=stats["output_tokens"]
        + sum(len(r.generated) for r in raw),
        engine_steps=engine.steps, wall_s=wall, peak_memory_gb=peak / 1e9,
        launches={"ssm_scan": launches})

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
    log(phase="mamba_reused_slots", same_as_alone=same,
        fifth_request_slot=raw[4].slot, seconds=time.perf_counter() - t1)
    check(all(same), f"a request in a reused slot differs from its run "
          f"from a fresh state: {same}")

    compare_embed_plain_scan(provider, docs)
    log(phase="mamba_phase", wall_s=time.perf_counter() - t_phase)
    return launches


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def compare_embed_plain_scan(provider, docs):
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers as L
    engine = provider.engine
    tokens = [provider._tokenize(t, engine.cfg.vocab_size) for t in docs]
    e_kern = engine.embed_batch(tokens)
    with mock.patch.object(L.ssm_ops, "ssm_scan", ssm_scan_ref):
        e_plain = engine.embed_batch(tokens)
    cos = float(np.min(np.sum(e_kern * e_plain, axis=1)))
    err = float(np.abs(e_kern - e_plain).max())
    log(phase="mamba_embed_vs_plain", texts=len(tokens), min_cosine=cos,
        max_abs_err=err)
    check(cos > 0.999, f"falcon-mamba embeddings differ from the plain scan "
          f"(cos {cos})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    flash = check_flash(dev, flush)
    decode = check_decode(dev, flush)
    topk = check_topk(dev, flush)
    ssm = check_ssm(dev, flush)
    del flush
    torch.cuda.empty_cache()
    for row in (flash, *decode, topk, ssm):
        check(row["ok"], f"{row['name']} disagrees with its plain version")

    provider, docs, launches = main_path(dev)
    compare_plain(provider, docs)
    profile_window(provider)
    del provider, docs
    gc.collect()
    torch.cuda.empty_cache()
    log(phase="olmo_freed",
        allocated_gb=torch.cuda.memory_allocated() / 1e9)
    launches["ssm_scan"] = mamba_path(dev)

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ok", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict({k: row[k] for k in keys}, launches=launches[row["name"]])
               for row in (flash, decode[0], topk, ssm)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
