"""The port's plain kernel versions against the JAX package's Pallas kernels.

The same numpy inputs (``np.random.default_rng``) go through the JAX
kernel (``ops.*``, Pallas in interpret mode on the CPU) and through the
port's wrapper on CPU tensors, which runs the plain PyTorch version.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in
bf16, top-k ids exact.  The CUDA kernels themselves are held against the
same plain versions in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

# the JAX package and the port are compared where both are installed; on
# a machine with only one of them this module is skipped
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the suite runs in parallel workers: one intra-op thread per worker keeps
# these small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

import jax.numpy as jnp
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.topk_sim.kernel import block_max_scores as jax_block_max
from repro.kernels.topk_sim.ops import topk_sim as jax_topk_sim
from repro.retrieval.vector import cosine_topk as jax_cosine_topk
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.topk_sim import ops as topk_ops
from repro_torch.kernels.topk_sim.ref import (block_max_scores_ref,
                                              topk_sim_ref)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(x, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(out_t, out_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KH,hd,causal,window,bq,bk",
    [
        (2, 64, 4, 2, 32, True, 0, 16, 16),
        (1, 96, 8, 8, 16, True, 0, 32, 16),
        (2, 48, 4, 1, 16, True, 16, 16, 16),     # MQA + sliding window
        (1, 80, 6, 2, 64, False, 0, 16, 32),     # bidirectional (encoder)
        (1, 33, 4, 2, 16, True, 0, 16, 16),      # ragged -> padding path
    ])
def test_flash_attention_plain_matches_jax_kernel(B, S, H, KH, hd, causal,
                                                  window, bq, bk, dtype):
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.standard_normal((B, S, H, hd), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, S, KH, hd), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((B, S, KH, hd), np.float32), dtype)
    ref = jax_flash(qj, kj, vj, causal=causal, window=window, block_q=bq,
                    block_k=bk, interpret=True)
    before = flash_ops.flash_attention.launches
    out = flash_ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert flash_ops.flash_attention.launches == before   # CPU: plain path
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, DTYPES[dtype][2])
    _close(attention_ref(qt, kt, vt, causal=causal, window=window), ref,
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,hd,window,bs",
                         [(3, 100, 8, 4, 32, 0, 32),
                          (2, 64, 4, 4, 16, 16, 16),
                          (1, 257, 8, 2, 64, 0, 64),
                          (2, 300, 16, 1, 256, 64, 64),   # recurrentgemma-9b
                          (3, 150, 16, 2, 64, 0, 64)])    # G 8
def test_decode_attention_plain_matches_jax_kernel(B, S, H, KH, hd, window,
                                                   bs, dtype):
    rng = np.random.default_rng(1)
    qj, qt = _both(rng.standard_normal((B, 1, H, hd), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, S, KH, hd), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((B, S, KH, hd), np.float32), dtype)
    pos = rng.integers(0, S, B).astype(np.int32)
    ref = jax_decode(qj, kj, vj, jnp.asarray(pos), window=window,
                     block_s=bs, interpret=True)
    before = decode_ops.decode_attention.launches
    out = decode_ops.decode_attention(qt, kt, vt, torch.from_numpy(pos),
                                      window=window)
    assert decode_ops.decode_attention.launches == before
    _close(out, ref, DTYPES[dtype][2])
    _close(decode_attention_ref(qt, kt, vt, torch.from_numpy(pos),
                                window=window), ref, DTYPES[dtype][2])


@pytest.mark.parametrize("rows,n_max,G", [(64, 2048, 1),    # olmo-1b
                                           (4, 2048, 16),    # recurrentgemma
                                           (8, 32768, 8),
                                           (1, 64, 1),
                                           (1, 100, 16),
                                           (4096, 4096, 1)])  # > 2 waves
def test_decode_chunk_keys(rows, n_max, G):
    """The bf16 kernel's keys per block: whole 64-key tiles, and a grid
    (rows x blocks for the longest row) within GRID_WAVES waves of
    resident blocks unless one chunk already holds the longest row."""
    grid_blocks = decode_ops.GRID_WAVES * 1 * 132   # 1 block per SM, 132 SMs
    chunk = decode_ops.chunk_keys(grid_blocks, rows, n_max, G)
    assert chunk >= decode_ops.TILE_KEYS
    assert chunk % decode_ops.TILE_KEYS == 0
    blocks = rows * -(-n_max // chunk)
    assert blocks <= grid_blocks or chunk >= n_max


@pytest.mark.parametrize("N,D,Q,k,bn", [(1000, 32, 5, 10, 64),
                                        (513, 16, 3, 7, 128),
                                        (64, 8, 1, 64, 16),
                                        (5, 8, 2, 9, 64),       # k > N
                                        (1, 4, 2, 3, 64)])      # 1-doc
def test_topk_sim_matches_jax_kernel(N, D, Q, k, bn):
    rng = np.random.default_rng(2)
    c = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    s_j, i_j = jax_topk_sim(jnp.asarray(c), jnp.asarray(q), k, block_n=bn,
                            interpret=True)
    before = topk_ops.block_max_scores.launches
    s, i = topk_ops.topk_sim(torch.from_numpy(c), torch.from_numpy(q), k,
                             block_n=bn)
    assert topk_ops.block_max_scores.launches == before
    assert s.shape == (Q, min(k, N)) and i.dtype == torch.int32
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    s_r, i_r = topk_sim_ref(torch.from_numpy(c), torch.from_numpy(q),
                            min(k, N))
    np.testing.assert_allclose(s_r.numpy(), np.asarray(s_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(i_r.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("k", [10, 100])
def test_topk_sim_ties_in_canonical_order(k):
    """A corpus of 4,000 rows drawn from 50 distinct vectors: the block
    choice and the final cut keep tied docs in id order, so the ids are
    the JAX jnp scan's (score desc, id asc) exactly."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((50, 64)).astype(np.float32)
    c = base[rng.integers(0, 50, 4000)]
    q = rng.standard_normal((8, 64)).astype(np.float32)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    s_j, i_j = jax_cosine_topk(jnp.asarray(cn), jnp.asarray(q), k)
    for fn in (topk_ops.topk_sim, topk_sim_ref):
        s, i = fn(torch.from_numpy(c), torch.from_numpy(q), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("N,D,Q,bn", [(1000, 32, 5, 64), (513, 16, 3, 128),
                                      (7, 8, 9, 8)])
def test_block_max_plain_matches_jax_kernel(N, D, Q, bn):
    rng = np.random.default_rng(3)
    c = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    ref = np.asarray(jax_block_max(jnp.asarray(c), jnp.asarray(q),
                                   block_n=bn, interpret=True))
    out = topk_ops.block_max_scores(torch.from_numpy(c), torch.from_numpy(q),
                                    block_n=bn)
    n_blocks = -(-N // bn)
    assert out.shape == (Q, n_blocks)
    # the TPU kernel pads to whole grid steps; its extra blocks are -inf
    assert np.all(np.isneginf(ref[:, n_blocks:]))
    np.testing.assert_allclose(out.numpy(), ref[:, :n_blocks], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_array_equal(
        block_max_scores_ref(torch.from_numpy(c), torch.from_numpy(q),
                             block_n=bn).numpy(), out.numpy())


def test_topk_sim_empty_corpus_and_queries():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    s, i = topk_ops.topk_sim(torch.zeros((0, 8)), q, 5)
    s_j, i_j = jax_topk_sim(jnp.zeros((0, 8)), jnp.asarray(q.numpy()), 5)
    assert s.shape == s_j.shape == (3, 0) and i.shape == i_j.shape == (3, 0)
    c = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    s, i = topk_ops.topk_sim(c, torch.zeros((0, 8)), 2)
    s_j, i_j = jax_topk_sim(jnp.asarray(c.numpy()), jnp.zeros((0, 8)), 2)
    assert s.shape == s_j.shape == (0, 2) and i.shape == i_j.shape == (0, 2)


@pytest.mark.parametrize("wrapper", ["flash", "decode", "block_max"])
def test_wrappers_raise_off_cpu_without_kernel(wrapper):
    """A tensor that is not on the CPU never takes the plain path: it goes
    to the kernel, which takes only CUDA tensors (here: raises)."""
    x = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "flash":
            flash_ops.flash_attention(x, x, x)
        elif wrapper == "decode":
            decode_ops.decode_attention(x[:, :1], x, x, 0)
        else:
            topk_ops.block_max_scores(x[0, :, 0], x[0, :, 0])
