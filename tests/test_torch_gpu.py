"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips when no CUDA device is
present (decided in the ``cuda`` fixture, never at import).  This file
imports no JAX, so it also runs on a machine that has only PyTorch:
``python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances are the kernel tolerances of ``tests/test_kernels.py``: 2e-5
in f32 and 2e-2 in bf16 (one bf16 rounding of the output), five times
those for the selective scan and the RG-LRU recurrence (their tests
there), top-k ids exact: ties rank by id ascending, as the reference's
retrieval operators order them.  The last case drives the retrieval
layer's full-ranking branch (a plan's masked ``corpus_filter``) at the
Query 3 phase's corpus shape.  The MoE FFN, which has no kernel, is
held on the card against the CPU and against itself (two bf16 calls
bitwise equal).  The encoder-decoder (whisper-base) runs flash attention
without the causal mask over 1,500 frames and decode attention at hd 64;
its smoke config's cross-attention cache and decode step are held on the
card against the CPU.  phi-3-vision's head dim of 96 has its own instances
of both attention kernels (the decode kernel's P V split over 3 warps of
32 dims); a prefill over patches and tokens and a decode step of its smoke
config widened to hd 96 are held on the card against the CPU.  On a
machine with two cards or more, each wrapper launches on its tensors'
card while another is current, and the mesh-sharded scan runs over every
card at 100,000 x 2048 against the single-card route (these skip below
two cards, decided in the ``cards`` fixture).  On four cards, one f32
train step of granite-smoke and of mixtral-smoke over a (2, 2) process
mesh (NCCL, ``tests/torch_sharding_cases.py``) is held to the same step
on one card (skips below four cards, decided in the ``four_cards``
fixture); so is the cut mixtral-8x7b's sharded prefill and decode steps
over a (1, 4) mesh (``tests/torch_sharded_serving_cases.py``).  The
decode kernel's range form (per-row valid ranges, the log-sum-exp) is
held against its plain version, and shards of a cache merged against the
unsharded call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rg_lru import ops as rglru_ops
from repro_torch.kernels.rg_lru.ref import rg_lru_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.topk_sim import ops as topk_ops
from repro_torch.kernels.topk_sim.ref import (block_max_scores_ref,
                                              topk_sim_ref)
import repro_torch.core as core
import repro_torch.engine as engine
import repro_torch.retrieval as retrieval

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def _close(out, ref, dtype):
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def assert_topk_ids_match(ids, ref_ids):
    """ids equal ref_ids at every rank: both rank (score desc, id asc)."""
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ref_ids))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,KH,hd,causal,window",
    [(2, 64, 4, 2, 32, True, 0),
     (1, 96, 8, 8, 16, True, 0),
     (2, 48, 4, 1, 16, True, 16),        # MQA + sliding window
     (1, 80, 6, 2, 64, False, 0),        # bidirectional
     (1, 33, 4, 2, 16, True, 0),         # ragged edge
     (64, 128, 16, 16, 128, True, 0),    # olmo-1b embed batch
     (2, 64, 16, 1, 256, True, 0),       # hd 256, 16 heads over 1 KV head
     (2, 100, 16, 1, 256, True, 48),     # ... ragged, sliding window
     (64, 128, 16, 1, 256, True, 2048),  # recurrentgemma-9b embed batch
     (2, 70, 8, 4, 64, True, 0),         # G 2 query heads folded into rows
     (2, 70, 8, 2, 64, True, 0),         # G 4
     (2, 70, 8, 1, 64, True, 0),         # G 8
     (2, 70, 8, 4, 128, True, 0),
     (2, 70, 8, 2, 128, True, 0),
     (2, 70, 8, 1, 128, True, 0),
     (2, 77, 16, 1, 256, True, 0),       # G 16, a ragged folded tile
     (1, 1024, 4, 4, 128, True, 0),      # the K/V ring wraps 16 times
     (2, 96, 4, 2, 256, False, 0),       # hd 256, bidirectional
     (2, 200, 8, 2, 64, True, 8),        # a window smaller than a tile
     (4, 2048, 16, 8, 256, True, 1024),  # gemma3-12b: G 2, the window cuts
     (64, 128, 32, 8, 128, True, 0),     # granite-8b embed batch: G 4
     (64, 128, 40, 40, 128, True, 0),    # qwen1.5-32b embed batch: 40 heads
     (4, 1500, 8, 8, 64, False, 0),      # whisper-base encoder: 4 clips
     (2, 272, 8, 8, 96, True, 0),        # hd 96: a prefix of 144 + 128
     (1, 80, 4, 4, 96, False, 0),        # hd 96, bidirectional
     (2, 70, 8, 2, 96, True, 0),         # hd 96, G 4
     (2, 100, 4, 2, 96, True, 24),       # hd 96, sliding window
     (4, 272, 32, 32, 96, True, 0)])     # phi-3-vision: 4 images + text
def test_flash_attention_kernel(cuda, B, S, H, KH, hd, causal, window,
                                dtype):
    rng = np.random.default_rng(0)
    q = _t(rng, (B, S, H, hd), dtype, cuda)
    k = _t(rng, (B, S, KH, hd), dtype, cuda)
    v = _t(rng, (B, S, KH, hd), dtype, cuda)
    before = flash_ops.flash_attention.launches
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    _close(out, attention_ref(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,window",
                         [(3, 100, 8, 4, 32, 0),
                          (2, 64, 4, 4, 16, 16),
                          (1, 257, 8, 2, 64, 0),
                          (4, 2048, 16, 16, 128, 0),     # olmo-1b decode
                          (4, 2048, 16, 16, 128, 512)])
def test_decode_attention_kernel(cuda, B, S, H, KH, hd, window, dtype):
    rng = np.random.default_rng(1)
    q = _t(rng, (B, 1, H, hd), dtype, cuda)
    kc = _t(rng, (B, S, KH, hd), dtype, cuda)
    vc = _t(rng, (B, S, KH, hd), dtype, cuda)
    pos = torch.from_numpy(rng.integers(0, S, B).astype(np.int32)).to(cuda)
    before = decode_ops.decode_attention.launches
    out = decode_ops.decode_attention(q, kc, vc, pos, window=window)
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + 1
    _close(out, decode_attention_ref(q, kc, vc, pos, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,window,pos",
                         [(2, 300, 64, [299, 10]),
                          (4, 4096, 2048, [4000, 2500, 1000, 37])])
def test_decode_attention_kernel_mqa_hd256(cuda, B, S, window, pos, dtype):
    """recurrentgemma-9b's local layers: 16 query heads over one KV head
    of 256, positions past the window."""
    rng = np.random.default_rng(5)
    q = _t(rng, (B, 1, 16, 256), dtype, cuda)
    kc = _t(rng, (B, S, 1, 256), dtype, cuda)
    vc = _t(rng, (B, S, 1, 256), dtype, cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = decode_ops.decode_attention.launches
    out = decode_ops.decode_attention(q, kc, vc, pos, window=window)
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + 1
    _close(out, decode_attention_ref(q, kc, vc, pos, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "H,KH,hd,window,pos",
    [(16, 8, 256, 1024, [2000, 1500, 1100, 37]),   # gemma3-12b, G 2
     (32, 8, 128, 0, [1900, 1024, 300, 37]),       # granite-8b, G 4
     (40, 40, 128, 0, [1900, 1024, 300, 37]),      # qwen1.5-32b, 40 heads
     (8, 8, 64, 0, [1900, 1024, 300, 37]),         # whisper-base, hd 64
     (32, 32, 96, 0, [1900, 1024, 300, 37])])      # phi-3-vision, hd 96
def test_decode_attention_kernel_dense_widths(cuda, H, KH, hd, window, pos,
                                              dtype):
    """The dense models', whisper-base's and phi-3-vision's served decode
    shapes: 4 slots
    x 2048 positions, gemma3-12b's positions past its window of 1024."""
    rng = np.random.default_rng(7)
    q = _t(rng, (4, 1, H, hd), dtype, cuda)
    kc = _t(rng, (4, 2048, KH, hd), dtype, cuda)
    vc = _t(rng, (4, 2048, KH, hd), dtype, cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = decode_ops.decode_attention.launches
    out = decode_ops.decode_attention(q, kc, vc, pos, window=window)
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + 1
    _close(out, decode_attention_ref(q, kc, vc, pos, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,KH,G", [(128, 2, 4), (64, 4, 1), (256, 1, 16)])
def test_decode_attention_range_kernel(cuda, hd, KH, G, dtype):
    """The kernel's range form against its plain version: per-row [lo, hi]
    with a full row, an empty range (hi < lo), a range past the cache's
    end (clipped), a short one and one of one key; the output at the
    kernel tolerance and the log-sum-exp within 1e-4, -inf and o = 0 on
    the empty row."""
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_range_ref)
    rng = np.random.default_rng(11)
    B, S, H = 5, 700, KH * G
    q = _t(rng, (B, 1, H, hd), dtype, cuda)
    kc = _t(rng, (B, S, KH, hd), dtype, cuda)
    vc = _t(rng, (B, S, KH, hd), dtype, cuda)
    lo = torch.tensor([0, 100, 300, 50, 699], dtype=torch.int32, device=cuda)
    hi = torch.tensor([699, 99, 900, 60, 699], dtype=torch.int32,
                      device=cuda)
    before = decode_ops.decode_attention.launches
    out, lse = decode_ops.decode_attention_range(q, kc, vc, lo, hi)
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + 1
    ref, ref_lse = decode_attention_range_ref(q, kc, vc, lo, hi)
    _close(out, ref, dtype)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    assert torch.isinf(lse[1]).all() and (out[1] == 0).all()
    fin = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_shards_merge_to_the_whole(cuda, dtype):
    """A 4 x 4,096-slot cache cut into 4 sequence shards: each shard's
    range call (its rows' windows cut to the shard, some empty, one window
    across two shards) merged by ``sharding.merge_shards`` equals the
    unsharded call at the kernel tolerance, and the merged lse the plain
    version's over the whole range within 1e-4."""
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_range_ref, valid_range)
    from repro_torch.models.sharding import merge_shards
    rng = np.random.default_rng(12)
    B, S, H, KH, hd, window, n = 4, 4096, 32, 8, 128, 512, 4
    q = _t(rng, (B, 1, H, hd), dtype, cuda)
    kc = _t(rng, (B, S, KH, hd), dtype, cuda)
    vc = _t(rng, (B, S, KH, hd), dtype, cuda)
    pos = torch.tensor([1500, 1100, 2900, 4000], dtype=torch.int32,
                       device=cuda)
    Ls = S // n
    outs = [decode_ops.decode_attention_range(
        q, kc[:, i * Ls:(i + 1) * Ls].contiguous(),
        vc[:, i * Ls:(i + 1) * Ls].contiguous(),
        *valid_range(pos - i * Ls, B, window, cuda), window=window)
        for i in range(n)]
    merged, lse = merge_shards([o for o, _ in outs], [l for _, l in outs])
    whole = decode_ops.decode_attention(q, kc, vc, pos, window=window)
    _close(merged, whole, dtype)
    _, ref_lse = decode_attention_range_ref(
        q, kc, vc, *valid_range(pos, B, window, cuda))
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    # row 0's window [989, 1500] spans shards 0 and 1; shards 2, 3 empty
    assert [bool(torch.isfinite(l[0]).all()) for _, l in outs] == [
        True, True, False, False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_step_on_the_card(cuda, dtype):
    """One decode step of qwen1.5-32b's smoke config on the int8 KV cache,
    on the card: the cache filled by chunked prefill (per-row lengths),
    the step through the decode kernel, which reads the dequantized cache,
    against the same step through its plain version.  Logits within 1e-4
    in f32 and 6e-2 in bf16 (the model tolerances); the kernel launches
    once a layer."""
    from unittest import mock

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    cfg = get_smoke_config("qwen1.5-32b").replace(
        kv_quant="int8", param_dtype=dtype, compute_dtype=dtype)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    cache = M.init_cache(cfg, 4, 256, cuda)
    assert cache[0]["b0"]["attn"]["k"].dtype == torch.int8
    g = torch.Generator(device=cuda).manual_seed(1)
    for c0 in range(0, 96, 32):
        toks = torch.randint(0, 256, (4, 32), generator=g, device=cuda)
        M.prefill_chunk(cfg, params, toks, cache, c0)
    toks = torch.randint(0, 256, (4, 1), generator=g, device=cuda)
    pos = torch.tensor([96, 80, 33, 5], dtype=torch.int32, device=cuda)

    def step():
        clone = [{b: {k: {n: t.clone() for n, t in c.items()}
                      for k, c in blk.items()} for b, blk in st.items()}
                 for st in cache]
        return M.decode_step(cfg, params, toks, clone, pos)[0]
    before = decode_ops.decode_attention.launches
    out = step()
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + cfg.num_layers
    with mock.patch.object(L.decode_ops, "decode_attention",
                           decode_attention_ref):
        ref = step()
    tol = {"float32": 1e-4, "bfloat16": 6e-2}[dtype]
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", decode_ops.GROUPS)
@pytest.mark.parametrize(
    "B,S,hd,window,pos",
    [(1, 200, 64, 0, [0]),                        # a position of 0
     (3, 130, 64, 0, [129, 130, 1000]),           # at and past S - 1
     (2, 300, 128, 100, [250, 299]),              # a window cutting a tile
     (2, 1000, 32, 0, [999, 640]),                # S not a multiple of 64
     (2, 77, 16, 0, [76, 5]),                     # hd 16, one ragged tile
     (1, 4097, 128, 0, [4096]),                   # B 1, one long row
     (4, 3000, 64, 0, [2999, 1, 64, 1500]),       # B 4, very uneven rows
     (4, 5000, 256, 2048, [4999, 2047, 2048, 0]),  # windowed and uneven
     (2, 700, 96, 0, [699, 130]),                  # hd 96: 3 P V warps
     (3, 500, 96, 128, [499, 64, 0])])             # hd 96, windowed
def test_decode_attention_kernel_edges(cuda, B, S, hd, window, pos, G,
                                       dtype):
    """The split rule's edges: rows of one key, rows cut by the cache end
    or the window, chunks that end inside a tile, every G in GROUPS (the
    bf16 kernel's MMA rows past G are padding)."""
    rng = np.random.default_rng(8)
    KH = 2
    q = _t(rng, (B, 1, G * KH, hd), dtype, cuda)
    kc = _t(rng, (B, S, KH, hd), dtype, cuda)
    vc = _t(rng, (B, S, KH, hd), dtype, cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = decode_ops.decode_attention.launches
    out = decode_ops.decode_attention(q, kc, vc, pos, window=window)
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + 1
    _close(out, decode_attention_ref(q, kc, vc, pos, window=window), dtype)


@pytest.mark.parametrize("B,S,H,KH,hd,window,pos",
                         [(4, 2048, 16, 16, 128, 0, [1900, 1024, 300, 37]),
                          (4, 4096, 16, 1, 256, 2048,
                           [4000, 2500, 2100, 37])])
def test_decode_attention_repeated_calls_identical(cuda, B, S, H, KH, hd,
                                                   window, pos):
    """Three bf16 calls on the same inputs give the same bits: the last
    block of each row merges the partials in a fixed order and sets the
    row's counter back to 0 for the next call."""
    rng = np.random.default_rng(9)
    q = _t(rng, (B, 1, H, hd), torch.bfloat16, cuda)
    kc = _t(rng, (B, S, KH, hd), torch.bfloat16, cuda)
    vc = _t(rng, (B, S, KH, hd), torch.bfloat16, cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    outs = [decode_ops.decode_attention(q, kc, vc, pos, window=window)
            for _ in range(3)]
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(decode_ops._COUNTERS[q.device, stream].abs().sum()) == 0
    _close(outs[0], decode_attention_ref(q, kc, vc, pos, window=window),
           torch.bfloat16)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_decode_attention_two_streams(cuda):
    """bf16 calls issued on two streams at once, with different lengths,
    each match the plain version: every stream has row counters of its
    own, so one stream's blocks never count toward another's merge."""
    rng = np.random.default_rng(10)
    B, S, H, KH, hd = 4, 2048, 16, 16, 128
    q = _t(rng, (B, 1, H, hd), torch.bfloat16, cuda)
    kc = _t(rng, (B, S, KH, hd), torch.bfloat16, cuda)
    vc = _t(rng, (B, S, KH, hd), torch.bfloat16, cuda)
    positions = [torch.tensor(p, dtype=torch.int32, device=cuda)
                 for p in ([1900, 1024, 300, 37], [2047, 64, 1500, 700])]
    streams = [torch.cuda.Stream(cuda) for _ in positions]
    outs = [[] for _ in positions]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(20):
        for s, pos, out in zip(streams, positions, outs):
            with torch.cuda.stream(s):
                out.append(decode_ops.decode_attention(q, kc, vc, pos))
    torch.cuda.synchronize()
    for s, pos, out in zip(streams, positions, outs):
        assert int(decode_ops._COUNTERS[q.device, s.cuda_stream].abs()
                   .sum()) == 0
        ref = decode_attention_ref(q, kc, vc, pos)
        for o in out:
            _close(o, ref, torch.bfloat16)


@pytest.mark.parametrize("N,D,Q,k,bn", [(1000, 32, 5, 10, 64),
                                        (513, 16, 3, 7, 128),
                                        (64, 8, 1, 64, 16),
                                        (5, 8, 2, 9, 64),
                                        (1, 4, 2, 3, 64),
                                        (1000, 30, 9, 10, 64),   # D % 4 != 0
                                        (100_000, 2048, 8, 100, 64)])
def test_topk_sim_kernel(cuda, N, D, Q, k, bn):
    rng = np.random.default_rng(2)
    c = _t(rng, (N, D), torch.float32, cuda)
    q = _t(rng, (Q, D), torch.float32, cuda)
    bm = topk_ops.block_max_scores(c, q, block_n=bn)
    torch.testing.assert_close(bm, block_max_scores_ref(c, q, block_n=bn),
                               atol=1e-5, rtol=1e-5)
    before = topk_ops.block_max_scores.launches
    s, i = topk_ops.topk_sim(c, q, k, block_n=bn)
    torch.cuda.synchronize()
    assert topk_ops.block_max_scores.launches == before + 1
    s_ref, i_ref = topk_sim_ref(c, q, min(k, N))
    assert s.shape == (Q, min(k, N))
    torch.testing.assert_close(s, s_ref, atol=1e-5, rtol=1e-5)
    assert_topk_ids_match(i.cpu(), i_ref.cpu())


def test_topk_sim_kernel_duplicated_corpus(cuda):
    """100,000 rows drawn from 1,000 distinct vectors (D 2048, k 100):
    whole groups of rows tie, and the kernel's route ranks them by id as
    the plain version does."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1000, 2048)).astype(np.float32)
    c = torch.from_numpy(base[rng.integers(0, 1000, 100_000)]).to(cuda)
    q = _t(rng, (8, 2048), torch.float32, cuda)
    before = topk_ops.block_max_scores.launches
    s, i = topk_ops.topk_sim(c, q, 100)
    torch.cuda.synchronize()
    assert topk_ops.block_max_scores.launches == before + 1
    s_ref, i_ref = topk_sim_ref(c, q, 100)
    torch.testing.assert_close(s, s_ref, atol=1e-5, rtol=1e-5)
    assert_topk_ids_match(i.cpu(), i_ref.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_attention_instance_fits(cuda, hd, dtype):
    """Every instance is resident on the card with the shared memory its
    launcher asks for; the bf16 ones keep no local memory (no spills)."""
    info = flash_ops.instance_info(hd, dtype)
    assert info["blocks_per_sm"] >= 1 and info["shared_bytes"] > 0
    assert 0 < info["registers"] <= 255
    if dtype == torch.bfloat16:
        assert info["local_bytes"] == 0, info
    with pytest.raises(ValueError, match="no instance"):
        flash_ops.instance_info(hd + 8, dtype)
    with pytest.raises(ValueError, match="no instance"):
        flash_ops.instance_info(hd, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", decode_ops.HEAD_DIMS)
def test_decode_attention_instance_fits(cuda, hd, dtype):
    """Every instance is resident on the card with the shared memory its
    launcher asks for at most; the bf16 ones (one per head dim, for every
    G) keep no local memory (no spills)."""
    info = decode_ops.instance_info(hd, dtype)
    assert info["blocks_per_sm"] >= 1
    assert 0 < info["registers"] <= 255
    if dtype == torch.bfloat16:
        assert info["local_bytes"] == 0, info
        assert info["shared_bytes"] > 0
    with pytest.raises(ValueError, match="no instance"):
        decode_ops.instance_info(hd + 8, dtype)
    with pytest.raises(ValueError, match="no instance"):
        decode_ops.instance_info(hd, torch.float16)


def test_kernels_reject_bad_input(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda)         # head dim 24
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q.half(), q.half(), q.half())
    c = torch.zeros((16, 8), device=cuda)
    with pytest.raises(ValueError):
        topk_ops.block_max_scores(c, torch.zeros((2, 4), device=cuda))


def _ssm_inputs(rng, B, S, di, N, dtype, device):
    """``tests/test_kernels.py``'s selective-scan inputs."""
    x = _t(rng, (B, S, di), dtype, device)
    dt = torch.from_numpy(np.abs(rng.standard_normal((B, S, di))).astype(
        np.float32) * 0.1).to(device=device, dtype=dtype)
    Bm = _t(rng, (B, S, N), dtype, device)
    Cm = _t(rng, (B, S, N), dtype, device)
    A_log = torch.from_numpy(np.log(np.abs(rng.standard_normal((di, N)))
                                    + 0.5).astype(np.float32)).to(device)
    D = _t(rng, (di,), torch.float32, device)
    return x, dt, Bm, Cm, A_log, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,N",
                         [(2, 80, 48, 8),
                          (1, 128, 64, 16),
                          (2, 33, 24, 4),
                          (3, 37, 200, 16),       # ragged di and S
                          (2, 21, 130, 5),        # state of 5
                          (4, 256, 8192, 16)])    # falcon-mamba-7b width
def test_ssm_scan_kernel(cuda, B, S, di, N, dtype):
    args = _ssm_inputs(np.random.default_rng(3), B, S, di, N, dtype, cuda)
    before = ssm_ops.ssm_scan.launches
    out = ssm_ops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, S, di)
    ref = ssm_scan_ref(*args)
    tol = 5 * TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_ssm_scan_rejects_bad_input(cuda):
    x, dt, Bm, Cm, A_log, D = _ssm_inputs(np.random.default_rng(4), 2, 16,
                                          64, 16, torch.bfloat16, cuda)
    with pytest.raises(TypeError):                  # dt not in x's dtype
        ssm_ops.ssm_scan(x, dt.float(), Bm, Cm, A_log, D)
    with pytest.raises(TypeError):                  # A_log not f32
        ssm_ops.ssm_scan(x, dt, Bm, Cm, A_log.bfloat16(), D)
    wide = torch.zeros((2, 16, 32), dtype=x.dtype, device=cuda)
    with pytest.raises(ValueError):                 # state above 16
        ssm_ops.ssm_scan(x, dt, wide, wide,
                         torch.zeros((64, 32), device=cuda), D)
    with pytest.raises(ValueError):                 # A_log of another width
        ssm_ops.ssm_scan(x, dt, Bm, Cm, A_log[:32], D)
    with pytest.raises(ValueError):                 # not contiguous
        ssm_ops.ssm_scan(x.transpose(0, 1), dt, Bm, Cm, A_log, D)
    with pytest.raises(ValueError):                 # a CPU tensor among them
        ssm_ops.ssm_scan(x, dt, Bm, Cm, A_log, D.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di", [(2, 80, 48), (1, 200, 32),
                                    (4, 256, 4096)])   # recurrentgemma width
def test_rg_lru_kernel(cuda, B, S, di, dtype):
    """``tests/test_kernels.py``'s rg_lru inputs: a in [0.5, 0.999)."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, S, di)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    b = _t(rng, (B, S, di), dtype, cuda)
    before = rglru_ops.rg_lru.launches
    out = rglru_ops.rg_lru(a, b)
    torch.cuda.synchronize()
    assert rglru_ops.rg_lru.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, S, di)
    tol = 5 * TOLS[dtype]
    torch.testing.assert_close(out.float(), rg_lru_ref(a, b).float(),
                               atol=tol, rtol=tol)


def test_rg_lru_rejects_bad_input(cuda):
    a = torch.zeros((2, 16, 64), device=cuda)
    with pytest.raises(TypeError):                  # b not in a's dtype
        rglru_ops.rg_lru(a, a.bfloat16())
    with pytest.raises(ValueError):                 # shapes differ
        rglru_ops.rg_lru(a, a[:, :8])
    with pytest.raises(ValueError):                 # not contiguous
        rglru_ops.rg_lru(a.transpose(0, 1), a.transpose(0, 1))
    with pytest.raises(ValueError):                 # a CPU tensor
        rglru_ops.rg_lru(a, a.cpu())


# ---------------------------------------------------------------------------
# the MoE FFN (plain tensor operations, no kernel of its own)
# ---------------------------------------------------------------------------
def _moe_layer(cfg, device):
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    gen = torch.Generator(device=device).manual_seed(0)
    return M._index(L.init_moe(cfg, gen, (1,), device), 0)


@pytest.mark.parametrize("B,S", [(2, 32), (4, 1), (1, 128)])
def test_moe_apply_on_the_card_matches_the_cpu(cuda, B, S):
    """f32, deepseek-moe-16b's routing (64 experts top-6, 2 shared) at a
    narrow width: the card's output within 2e-5 of the CPU's on the same
    inputs, the router loss within 1e-5, the same drops per group (none in
    the decode group of 4)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    cfg = get_smoke_config("deepseek-moe-16b").replace(
        num_experts=64, top_k=6, param_dtype="float32",
        compute_dtype="float32")
    p = _moe_layer(cfg, cuda)
    x = _t(np.random.default_rng(B * S), (B, S, cfg.d_model), torch.float32,
           cuda)
    y, aux = L.moe_apply(cfg, p, x)
    p_cpu = {k: (v.cpu() if torch.is_tensor(v)
                 else {n: t.cpu() for n, t in v.items()})
             for k, v in p.items()}
    y_cpu, aux_cpu = L.moe_apply(cfg, p_cpu, x.cpu())
    _close(y.cpu(), y_cpu, torch.float32)
    assert abs(float(aux) - float(aux_cpu)) < 1e-5
    drops = L.moe_route(cfg, p["router"], L.moe_groups(x))["dropped"]
    assert drops.tolist() == L.moe_route(
        cfg, p_cpu["router"], L.moe_groups(x.cpu()))["dropped"].tolist()
    if S == 1:
        assert int(drops.sum()) == 0


@pytest.mark.parametrize("B,S", [(64, 128), (1, 32), (4, 1)])
def test_moe_apply_bf16_repeats_bitwise(cuda, B, S):
    """One layer of deepseek-moe-16b at full width (d 2,048, 64 experts of
    1,408, top-6, 2 shared) in bf16, at the embed batch's, a prefill
    chunk's and a decode step's groups: two calls on the same inputs are
    bitwise equal (the combine gathers, it does not scatter-add)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("deepseek-moe-16b")
    p = _moe_layer(cfg, cuda)
    x = _t(np.random.default_rng(1), (B, S, cfg.d_model), torch.bfloat16,
           cuda)
    y1, aux1 = L.moe_apply(cfg, p, x)
    y2, aux2 = L.moe_apply(cfg, p, x)
    assert y1.dtype == torch.bfloat16 and torch.isfinite(y1).all()
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(aux1, aux2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_step_on_the_card(cuda, dtype):
    """One decode step of deepseek-moe-16b's smoke config on the card,
    the cache filled by chunked prefill (per-row lengths): decode
    attention launches once a layer; in f32 the logits are within 1e-4 of
    the same step through the plain decode attention; in bf16 the step
    repeated on the same cache is bitwise equal."""
    from unittest import mock

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    cfg = get_smoke_config("deepseek-moe-16b").replace(
        param_dtype=dtype, compute_dtype=dtype)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    cache = M.init_cache(cfg, 4, 256, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for c0 in range(0, 96, 32):
        toks = torch.randint(0, 256, (4, 32), generator=g, device=cuda)
        M.prefill_chunk(cfg, params, toks, cache, c0)
    toks = torch.randint(0, 256, (4, 1), generator=g, device=cuda)
    pos = torch.tensor([96, 80, 33, 5], dtype=torch.int32, device=cuda)

    def step():
        clone = [{b: {k: {n: t.clone() for n, t in c.items()}
                      for k, c in blk.items()} for b, blk in st.items()}
                 for st in cache]
        return M.decode_step(cfg, params, toks, clone, pos)[0]
    before = decode_ops.decode_attention.launches
    out = step()
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + cfg.num_layers
    assert torch.isfinite(out).all()
    if dtype == "float32":
        with mock.patch.object(L.decode_ops, "decode_attention",
                               decode_attention_ref):
            ref = step()
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    else:
        assert torch.equal(out, step())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_cache_and_decode_step_on_the_card(cuda, dtype):
    """whisper-base's smoke config on the card against the same on the
    CPU (the weights drawn once on the CPU): ``encode_for_cache`` of 4
    clips, whose encoder launches the flash kernel once a layer without
    the causal mask, every cache leaf; then chunked prefill and one decode
    step over that cache, which launches decode attention once a decoder
    layer.  Within 1e-4 in f32 and 6e-2 in bf16 (the model tolerances)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    cfg = get_smoke_config("whisper-base").replace(
        param_dtype=dtype, compute_dtype=dtype)
    tol = 1e-4 if dtype == "float32" else 6e-2
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    frames = _t(rng, (4, cfg.encoder_seq, cfg.d_model), cfg.compute_torch_dtype,
                "cpu")
    toks = torch.from_numpy(rng.integers(0, 256, (4, 16)).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, 256, (4, 1)).astype(np.int32))
    pos = torch.tensor([16, 16, 16, 16], dtype=torch.int32)

    def run(device):
        p = _to(params, device)
        cache = M.encode_for_cache(cfg, p, frames.to(device), 4, 64)
        enc = [t.clone() for st in cache for t in
               (st["b0"]["xattn"]["k"], st["b0"]["xattn"]["v"])]
        M.prefill_chunk(cfg, p, toks.to(device), cache, 0)
        logits, _ = M.decode_step(cfg, p, tok.to(device), cache,
                                  pos.to(device))
        return enc, logits
    flash0 = flash_ops.flash_attention.launches
    dec0 = decode_ops.decode_attention.launches
    enc, logits = run(cuda)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == flash0 +         cfg.num_encoder_layers
    assert decode_ops.decode_attention.launches == dec0 + cfg.num_layers
    enc_cpu, logits_cpu = run("cpu")
    for a, b in zip(enc, enc_cpu):
        assert a.abs().max() > 0
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=tol,
                                   rtol=tol)
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits.cpu(), logits_cpu, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_prefill_and_decode_step_on_the_card(cuda, dtype):
    """phi-3-vision's smoke config widened to two heads of 96 (the full
    config's head dim) on the card against the same on the CPU (weights
    drawn once on the CPU): ``prefill`` over 4 images of 4 patches and 20
    tokens, whose flash calls run the hd-96 instance once a layer, then
    one decode step at next_pos = 24, which launches decode attention once
    a layer.  Within 1e-4 in f32 and 6e-2 in bf16 (the model
    tolerances)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    cfg = get_smoke_config("phi-3-vision-4.2b").replace(
        d_model=192, num_heads=2, num_kv_heads=2, head_dim=96,
        param_dtype=dtype, compute_dtype=dtype)
    tol = 1e-4 if dtype == "float32" else 6e-2
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    patches = _t(rng, (4, cfg.num_prefix_tokens, cfg.d_model),
                 cfg.compute_torch_dtype, "cpu") * cfg.d_model ** -0.5
    toks = torch.from_numpy(rng.integers(0, 256, (4, 20)).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, 256, (4, 1)).astype(np.int32))

    def run(device):
        p = _to(params, device)
        logits, cache, pos = M.prefill(
            cfg, p, {"tokens": toks.to(device),
                     "patches": patches.to(device)}, 64)
        step, _ = M.decode_step(cfg, p, tok.to(device), cache,
                                torch.full((4,), pos, dtype=torch.int32,
                                           device=device))
        return logits, step, pos
    flash0 = flash_ops.flash_attention.launches
    dec0 = decode_ops.decode_attention.launches
    logits, step, pos = run(cuda)
    torch.cuda.synchronize()
    assert pos == cfg.num_prefix_tokens + 20
    assert flash_ops.flash_attention.launches == flash0 + cfg.num_layers
    assert decode_ops.decode_attention.launches == dec0 + cfg.num_layers
    logits_cpu, step_cpu, _ = run("cpu")
    for a, b in ((logits, logits_cpu), (step, step_cpu)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the retrieval layer: the full-ranking branch at the Query 3 phase's shape
# ---------------------------------------------------------------------------
def test_full_ranking_branch_on_the_card(cuda):
    """The masked, unpruned ``corpus_filter`` plan ranks the whole corpus
    (``VectorIndex.topk`` with k = N) and masks it: at 16,384 x 2048 its
    ids equal the plain scan's (``cosine_topk``) over the same index, its
    scores within 1e-5.  Prints the peak device memory of the collect."""
    n, dim, k = 16_384, 2048, 8
    emb = {"model": "e", "embedding_dim": dim, "context_window": 1 << 20}
    corpus = engine.Table({"id": list(range(n)),
                           "content": [f"passage {i} on topic {i % 97}"
                                       for i in range(n)]})
    qs = engine.Table({"q": ["topic 3", "topic 41", "passage 77", "ann"]})
    keep = lambda r: r["id"] % 3 != 0
    ctx = core.SemanticContext(provider=core.MockProvider())
    pipe = engine.Pipeline(ctx, qs, "q").vector_topk(
        "s", emb, "q", corpus, k=k, doc_col="content", corpus_filter=keep,
        corpus_filter_cols=["id"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = topk_ops.block_max_scores.launches
    t = pipe.collect(optimize=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert topk_ops.block_max_scores.launches == before + 1
    index = next(iter(ctx._index_registry.values()))
    assert len(index) == n and index.device.type == "cuda"
    qv = core.llm_embedding(ctx, emb, qs.column("q"))
    s, i = retrieval.cosine_topk(index.vectors,
                                 torch.from_numpy(qv).to(cuda), n)
    expect, scores = [], []
    for r in range(len(qv)):
        ids = [int(x) for x in i[r].tolist() if x % 3 != 0][:k]
        expect += ids
        scores += [float(s[r, int((i[r] == x).nonzero())]) for x in ids]
    assert t.column("id") == expect
    np.testing.assert_allclose(t.column("s"), scores, atol=1e-5, rtol=0)
    print(f"full-ranking branch {n} x {dim}, Q {len(qv)}: peak "
          f"{peak / 2**20:.1f} MiB allocated on "
          f"{torch.cuda.get_device_name(0)}")


# --------------------------------------------------------------------------
# autograd: the kernels refuse it; the training route runs no kernel
# --------------------------------------------------------------------------
def _kernel_calls(rng, device):
    """(name, wrapper, plain version, inputs) of the five kernels at small
    shapes, f32."""
    f32 = torch.float32
    q = _t(rng, (1, 32, 2, 16), f32, device)
    kv = _t(rng, (1, 32, 2, 16), f32, device)
    x, dt, Bm, Cm, A_log, D = _ssm_inputs(rng, 1, 16, 32, 4, f32, device)
    a = torch.rand((1, 16, 32), device=device)
    corpus = _t(rng, (256, 32), f32, device)
    pos = torch.tensor([20], dtype=torch.int32, device=device)
    return [
        ("flash_attention", flash_ops.flash_attention, attention_ref,
         (q, kv, kv.clone())),
        ("decode_attention", decode_ops.decode_attention,
         decode_attention_ref, (q[:, :1], kv, kv.clone(), pos)),
        ("ssm_scan", ssm_ops.ssm_scan, ssm_scan_ref, (x, dt, Bm, Cm, A_log,
                                                      D)),
        ("rg_lru", rglru_ops.rg_lru, rg_lru_ref, (a, a.clone())),
        ("block_max_scores", topk_ops.block_max_scores,
         block_max_scores_ref, (corpus, corpus[:8].clone())),
    ]


@pytest.mark.parametrize("which", range(5))
def test_kernel_wrappers_refuse_grad(cuda, which):
    """On the card a wrapper raises, naming its kernel, where an input
    requires grad and grad mode is on; under ``no_grad`` the same call
    runs the kernel and matches the plain version."""
    rng = np.random.default_rng(40 + which)
    name, fn, ref, args = _kernel_calls(rng, cuda)[which]
    live = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name}.*no backward"):
        fn(live, *args[1:])
    before = fn.launches
    with torch.no_grad():
        out = fn(live, *args[1:])
    assert fn.launches == before + 1 and not out.requires_grad
    tol = 5 * TOLS[torch.float32] if name in ("ssm_scan", "rg_lru") \
        else TOLS[torch.float32]
    torch.testing.assert_close(out, ref(*args), atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# several cards: each wrapper launches on its tensors' card; the sharded scan
# --------------------------------------------------------------------------
@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("which", range(5))
def test_kernel_wrappers_launch_on_their_tensors_card(cards, which):
    """With cuda:0 current, each wrapper called on tensors on cuda:1
    launches there (its count moves, its output lies there) and matches
    the plain version; cuda:0 stays current."""
    rng = np.random.default_rng(60 + which)
    name, fn, ref, args = _kernel_calls(rng, cards[1])[which]
    before = fn.launches
    with torch.cuda.device(cards[0]), torch.no_grad():
        out = fn(*args)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(cards[1])
    assert fn.launches == before + 1 and out.device == cards[1]
    tol = 5 * TOLS[torch.float32] if name in ("ssm_scan", "rg_lru") \
        else TOLS[torch.float32]
    torch.testing.assert_close(out, ref(*args), atol=tol, rtol=tol)


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_bf16_attention_on_another_card(cards, kernel):
    """The bf16 attention instances raise their shared-memory limit on the
    launching device: on cuda:1 with cuda:0 current too."""
    rng = np.random.default_rng(70)
    bf16 = torch.bfloat16
    with torch.cuda.device(cards[0]), torch.no_grad():
        if kernel == "flash_attention":
            q = _t(rng, (2, 128, 4, 128), bf16, cards[1])
            k, v = (_t(rng, (2, 128, 4, 128), bf16, cards[1])
                    for _ in range(2))
            out = flash_ops.flash_attention(q, k, v)
            ref = attention_ref(q, k, v)
        else:
            q = _t(rng, (2, 1, 4, 128), bf16, cards[1])
            k, v = (_t(rng, (2, 256, 4, 128), bf16, cards[1])
                    for _ in range(2))
            pos = torch.tensor([200, 17], dtype=torch.int32,
                               device=cards[1])
            out = decode_ops.decode_attention(q, k, v, pos)
            ref = decode_attention_ref(q, k, v, pos)
    torch.cuda.synchronize(cards[1])
    assert out.device == cards[1]
    _close(out, ref, bf16)


def _ranks_agree(ids, ref_ids, ref_scores, gap=1e-6):
    """Equal ids at every rank, except that ids may trade places within a
    run of reference scores less than ``gap`` apart (a near-tie; a run
    that reaches the rank limit is compared up to it only by score)."""
    for got, ref, s in zip(ids, ref_ids, ref_scores):
        start = 0
        for r in range(1, len(ref) + 1):
            if r < len(ref) and s[r - 1] - s[r] < gap:
                continue
            if r < len(ref) or r - start == 1:
                assert set(got[start:r]) == set(ref[start:r])
            start = r


def test_sharded_route_over_the_cards(cards):
    """``VectorIndex(mesh=)`` over every visible card at 100,000 x 2048:
    one shard a card, block_max_scores launched once a card per call, ids
    equal to the single-card route's (near-ties within 1e-6 aside),
    scores within 1e-5."""
    from repro_torch.launch.mesh import make_mesh
    n = len(cards)
    mesh = make_mesh((n,), ("data",))
    g = torch.Generator(device=cards[0]).manual_seed(11)
    host = torch.randn((100_000, 2048), generator=g,
                       device=cards[0]).cpu().numpy()
    index = retrieval.VectorIndex(host, mesh=mesh)
    single = retrieval.VectorIndex(host, device=cards[0])
    assert [t.device for t in index._placed(mesh)] == cards
    assert index.vectors is None
    rng = np.random.default_rng(12)
    for Q, k in ((8, 100), (4, 32)):
        q = rng.standard_normal((Q, 2048)).astype(np.float32)
        before = topk_ops.block_max_scores.launches
        s, i = index.topk(q, k)
        assert topk_ops.block_max_scores.launches == before + n
        s1, i1 = single.topk(q, k)
        np.testing.assert_allclose(s, s1, atol=1e-5, rtol=0)
        _ranks_agree(i, i1, s1)


@pytest.fixture
def four_cards(cuda):
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip("needs 4 CUDA devices")
    return [torch.device("cuda", i) for i in range(4)]


def test_sharded_train_step_over_four_cards(four_cards, tmp_path):
    """granite-smoke (KV heads over "model") and mixtral-smoke, two f32
    train steps on mesh (2, 2) of four processes under NCCL against the
    same steps on one card: both losses to 1e-5 relative; the first
    step's gradients and AdamW's moments after it to 1e-4 of each leaf's
    largest magnitude."""
    import json
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_sharding_cases as C
    out = tmp_path / "cards.json"
    C.cards_main(out)
    res = json.loads(out.read_text())
    for arch, r in res.items():
        for key in ("loss", "loss2"):
            got, want = r[key]
            assert abs(got - want) <= 1e-5 * abs(want), (arch, key, r)
        for key in ("grads_err", "m_err", "v_err"):
            assert r[key] <= 1e-4, (arch, key, r)
        assert r["device"] == "cuda:0", (arch, r)


def test_sharded_serving_over_four_cards(four_cards, tmp_path):
    """mixtral-8x7b at full width cut to 2 layers in f32: the prefill of 4
    prompts of 300 tokens into a 1,024-slot cache and 4 greedy decode
    steps on mesh (1, 4) of four processes under NCCL (the cache's
    sequence over the cards, the decode kernel on each card's shard,
    merged) against the same steps on one card: every step's logits
    within 1e-4, the tokens equal, the decode kernel launched once a layer
    a step on every card."""
    import json
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_sharded_serving_cases as C
    out = tmp_path / "serve_cards.json"
    C.cards_main(out)
    res = json.loads(out.read_text())
    assert max(res["logits_err"]) <= 1e-4, res
    assert all(res["tokens_equal"]), res
    assert res["decode_launches"] == [[2] * 4] * 4, res


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _leaves(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in _leaves(v, f"{path}/{i}").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ["olmo-1b", "falcon-mamba-7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One f32 train step of the smoke config on the card against the same
    step on the CPU (the same drawn weights, the same batch): the loss to
    1e-5 relative, each gradient leaf to 1e-4 of its largest magnitude.
    The card's step launches no kernel (the plain route)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.params import init_params
    from repro_torch.training import HParams, adamw_init, make_train_step
    from repro_torch.training.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.training.train_step import value_and_grad
    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    batch = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 32, 2)
                                   ).batch_at(0)
    cpu_b = {k: torch.from_numpy(v) for k, v in batch.items()}
    card_b = {k: v.to(cuda) for k, v in cpu_b.items()}
    wrappers = (flash_ops.flash_attention, decode_ops.decode_attention,
                ssm_ops.ssm_scan, rglru_ops.rg_lru,
                topk_ops.block_max_scores)
    before = [w.launches for w in wrappers]
    (l_card, _), g_card = value_and_grad(cfg, on_card, card_b)
    (l_cpu, _), g_cpu = value_and_grad(cfg, params, cpu_b)
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=0)
    gc, gp = _leaves(g_card), _leaves(g_cpu)
    assert set(gc) == set(gp)
    for path, want in gp.items():
        bound = 1e-4 * want.abs().max().item()
        assert (gc[path].cpu() - want).abs().max().item() <= bound, path
    step = make_train_step(cfg, HParams(lr=1e-3, warmup_steps=1,
                                        total_steps=4))
    new, _, m = step(on_card, adamw_init(on_card), card_b)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert all(torch.isfinite(t).all() for t in _leaves(new).values())
    assert [w.launches for w in wrappers] == before
