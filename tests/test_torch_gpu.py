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
Query 3 phase's corpus shape.
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
     (2, 200, 8, 2, 64, True, 8)])       # a window smaller than a tile
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
     (4, 5000, 256, 2048, [4999, 2047, 2048, 0])])  # windowed and uneven
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
