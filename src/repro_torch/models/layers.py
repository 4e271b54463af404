"""Layer primitives of the dense decoder, the Mamba-1 block, the RG-LRU
block and the encoder-decoder (port of ``repro/models/layers.py``).

Plain functions on tensors with the JAX package's parameter layout
(``wq`` is (d, H, hd), ``wo`` is (H, hd, d), ``in_proj`` is (d, 2 di),
...), so weights carried over by ``repro_torch.params.from_jax`` run
unchanged.  Full-sequence attention goes through
``kernels.flash_attention``, decode attention through
``kernels.decode_attention``, the full-sequence selective scan of a
Mamba layer through ``kernels.ssm_scan`` and the full-sequence recurrence
of an RG-LRU layer through ``kernels.rg_lru``: the CUDA kernels for
tensors on the GPU, their plain versions for tensors on the CPU.  The
chunked attention of chunked prefill and the stateful linear scan of
Mamba and RG-LRU prefill and decode have no kernel in the JAX package
either and stay plain PyTorch here.

bf16 rounds where the JAX package rounds: norms and rope in f32 and cast
back, projections as bf16 products, the scans in f32.  The int8 KV cache
(``kv_quant="int8"``) quantizes keys and values per (token, head) and
dequantizes the cache before attention reads it, as the JAX package does.
The MoE FFN (``moe_apply``) dispatches as the JAX package does, group by
group with capacity drops, in plain tensor operations (the JAX package
has no kernel for it either).  The encoder-decoder's encoder runs its
self-attention through ``kernels.flash_attention`` without the causal
mask; the decoder's cross-attention over the encoder's keys and values
(``cross_attention``) is the plain chunked attention, as the JAX package
computes it outside any Pallas kernel.

Each full-sequence function takes a ``route``: "kernels" (serving, the
embed step) as above, or "plain", the training route, which mirrors the
JAX package's ``use_pallas=False`` branches: attention by
``cfg.attn_impl`` (``chunked_attention``, or ``blocked_attention``, which
visits only the block pairs the mask can reach), the Mamba scan by
``cfg.ssm_fuse`` (``linear_scan``, or ``fused_selective_scan``, whose
discretised tensors exist one chunk at a time), the RG-LRU by
``linear_scan``.  The kernels have no backward (nor have the Pallas
kernels), so a loss goes through the plain route.

Sharding is injected through a ``policy`` (see ``sharding.py``), at the
JAX package's call sites and under its names: ``policy(x, name)``
constrains an activation to its named layout.  The default
``NULL_POLICY`` makes every constraint a no-op, so the same code runs on
one device.  Under a ``sharding.MeshPolicy`` the tensors are ``DTensor``s
and the few ops DTensor cannot run as they are (rope's angles, the plain
attention, the causal conv, the scans, the MoE dispatch) run on the local
shards through ``sharding``'s ``*_on_shards``; the plain tensors of one
device never take those branches.  On the serving paths the cache's
sequence is sharded: decode and chunked prefill write it shard-locally
and attend over each shard, merged by log-sum-exp
(``sharding.decode_on_shards``, ``sharding.attend_on_sequence``).
"""

from __future__ import annotations

import math
import numbers

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rg_lru import ops as rglru_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops

from . import sharding
from .config import ModelConfig

F32 = torch.float32
NEG = -1e30
ROUTES = ("kernels", "plain")


# --------------------------------------------------------------------------
# sharding policy indirection
# --------------------------------------------------------------------------
class NullPolicy:
    """No-op activation-sharding policy (single-device tests)."""

    dp_size = 1     # data-parallel world size (MoE decode grouping hint)

    def __call__(self, x, name: str):
        return x


NULL_POLICY = NullPolicy()


def positions_vector(pos, B: int, device) -> torch.Tensor:
    """A scalar or per-row position as an int32 (B,) tensor on ``device``
    (no copy when it already is one)."""
    return torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int32, device=device), (B,))


# --------------------------------------------------------------------------
# normalisation
# --------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, d: int, lead=(), device=None):
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((*lead, d), dtype=F32, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((*lead, d), dtype=F32, device=device),
                "bias": torch.zeros((*lead, d), dtype=F32, device=device)}
    return {}  # nonparam_ln (OLMo)


def norm_apply(cfg: ModelConfig, p, x):
    dt = x.dtype
    x = x.to(F32)
    if cfg.norm == "rmsnorm":
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6)
        x = x * p["scale"]
    else:
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + 1e-5)
        if p:
            x = x * p["scale"] + p["bias"]
    return x.to(dt)


def rms_head_norm(scale, x):
    """Per-head RMS norm (qk-norm); x: (..., hd)."""
    dt = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6)
    return (x * scale).to(dt)


# --------------------------------------------------------------------------
# rotary / sinusoidal positions
# --------------------------------------------------------------------------
def rope_apply(x, positions, theta: float):
    """x: (B, S, H, hd), positions: (B, S) or (S,) int."""
    if isinstance(x, DTensor):
        return sharding.rope_on_shards(
            lambda xl, pl: rope_apply(xl, pl, theta), x, positions)
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(F32) * freqs               # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos(seq: int, d: int, offset=0, dtype=torch.bfloat16,
                 device=None):
    """(seq, d) sinusoidal positions: sines then cosines of f32 angles,
    cast to ``dtype`` (the encoder's input positions)."""
    pos = torch.arange(seq, dtype=F32, device=device) + offset
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=F32, device=device)
                      * (math.log(10_000.0) / max(half - 1, 1)))
    ang = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------
# plain attention (chunked prefill; the CPU oracle of the decode kernel)
# --------------------------------------------------------------------------
def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset=0, kv_valid_len=None, block_k: int = 512,
                      scale: float | None = None, k_offset: int = 0,
                      return_lse: bool = False):
    """Online-softmax attention over KV blocks of ``block_k``.

    q: (B, Sq, H, hd);  k, v: (B, Sk, KH, hd) with H % KH == 0.
    ``q_offset``: absolute position of q[0], scalar or per row (B,).
    ``k_offset``: absolute position of k[0] (a sequence shard's start).
    ``window`` > 0: sliding-window mask  q_pos - k_pos < window.
    ``kv_valid_len``: mask out k positions >= this (counted from k[0]).
    Returns (B, Sq, H, hd) in q.dtype, and with ``return_lse`` also the
    log-sum-exp (B, Sq, H) f32 of each query's scaled scores, -inf for a
    query with no visible key.  The last block is not padded: a row with
    at least one visible key gets the JAX package's result.
    """
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    bk = min(block_k, Sk)
    q_off = positions_vector(q_offset, B, q.device)
    q_pos = q_off[:, None] + torch.arange(Sq, device=q.device)[None, :]
    valid_limit = Sk if kv_valid_len is None else kv_valid_len
    qg = (q.to(F32) * scale).reshape(B, Sq, KH, G, hd)

    m = torch.full((B, KH, G, Sq), NEG, dtype=F32, device=q.device)
    l = torch.zeros((B, KH, G, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, KH, G, Sq, hd), dtype=F32, device=q.device)
    for start in range(0, Sk, bk):
        kblk = k[:, start:start + bk].to(F32)
        vblk = v[:, start:start + bk].to(F32)
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, kblk)
        k_pos = start + torch.arange(kblk.shape[1], device=q.device)
        mask = (k_pos[None, None, :] < valid_limit).expand(B, Sq, -1)
        if k_offset:
            k_pos = k_pos + k_offset
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
        if window:
            mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
        s = s + torch.where(mask[:, None, None], 0.0, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkh->bkgqh", p,
                                                   vblk)
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]                # (B,KH,G,Sq,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    if not return_lse:
        return out
    # a query with no visible key kept m at NEG (its masked scores summed
    # as ones): no mass
    lse = torch.where(m > NEG / 2, m + torch.log(l),
                      torch.full((), float("-inf"), device=q.device))
    return out, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def blocked_attention(q, k, v, *, causal: bool, window: int = 0,
                      block_q: int = 512, block_k: int = 512,
                      scale: float | None = None):
    """Static block-pair attention: only the (q-block, kv-block) pairs the
    causal/window mask can reach, as the JAX package enumerates them
    (``block_q`` x ``block_k`` tiles, the pair skipped when its whole kv
    block lies after the q block's last row, or its last key before the
    window of the q block's first row), each q block's pairs in kv order
    under one online softmax.  Where the JAX package scans the flattened
    pair list and writes each q block at its last pair, the port loops
    over q blocks and their kv blocks; the last blocks are not padded
    (as in ``chunked_attention``).  Training and prefill shapes only (no
    q offset).  q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd) -> (B, Sq, H, hd)
    in q.dtype."""
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    outs = []
    for q_lo in range(0, Sq, bq):
        qt = (q[:, q_lo:q_lo + bq].to(F32) * scale).reshape(B, -1, KH, G,
                                                            hd)
        n = qt.shape[1]
        q_pos = q_lo + torch.arange(n, device=q.device)
        m = torch.full((B, KH, G, n), NEG, dtype=F32, device=q.device)
        l = torch.zeros((B, KH, G, n), dtype=F32, device=q.device)
        acc = torch.zeros((B, KH, G, n, hd), dtype=F32, device=q.device)
        for k_lo in range(0, Sk, bk):
            if causal and k_lo > q_lo + bq - 1:
                continue
            if window and q_lo - (k_lo + bk - 1) >= window:
                continue
            kt = k[:, k_lo:k_lo + bk].to(F32)
            vt = v[:, k_lo:k_lo + bk].to(F32)
            s = torch.einsum("bqkgh,btkh->bkgqt", qt, kt)
            k_pos = k_lo + torch.arange(kt.shape[1], device=q.device)
            mask = torch.ones((n, kt.shape[1]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
            s = s + torch.where(mask, 0.0, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkh->bkgqh",
                                                       p, vt)
            m = m_new
        outs.append(acc / l.clamp_min(1e-37)[..., None])
    out = torch.cat(outs, dim=3)                               # (B,KH,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: float | None = None):
    """Single-step attention over a cache, the layer-level plain form.

    q: (B, 1, H, hd); caches: (B, Smax, KH, hd); pos: scalar or (B,) —
    the current token's absolute position (its K/V already written)."""
    B, _, H, hd = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    qg = (q.to(F32) * scale).reshape(B, KH, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(F32))
    pos_b = positions_vector(pos, B, q.device)
    k_pos = torch.arange(Smax, device=q.device)
    mask = k_pos[None, :] <= pos_b[:, None]
    if window:
        mask = mask & (pos_b[:, None] - k_pos[None, :] < window)
    s = s + torch.where(mask[:, None, None], 0.0, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p / l.clamp_min(1e-37),
                       v_cache.to(F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# attention block (proj + rope + residual-ready output)
# --------------------------------------------------------------------------
def normal_init(shape, std, dtype, generator, device):
    """N(0, 1) scaled by ``std``, drawn in f32 and cast to ``dtype``.  A
    tensor of more than two axes is stacked over layers (its leading axis)
    and is drawn one layer at a time into the result, so the f32 temporary
    is one layer's, not the stack's; a matrix (the embedding, the head) is
    drawn whole."""
    if len(shape) <= 2:
        x = torch.randn(shape, generator=generator, dtype=F32, device=device)
        return x.mul_(std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=generator, dtype=F32,
                             device=device).mul_(std)
    return out


def init_attention(cfg: ModelConfig, generator, lead=(), device=None,
                   cross: bool = False):
    """Attention weights (stacked over ``lead``) drawn like the JAX init:
    N(0, 1) scaled by fan-in^-0.5, cast to ``param_dtype``.  A decoder's
    cross-attention (``cross``) has no qkv bias."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KH = cfg.padded_num_heads, cfg.padded_num_kv_heads
    dt = cfg.param_torch_dtype
    sd = d ** -0.5
    p = {
        "wq": normal_init((*lead, d, H, hd), sd, dt, generator, device),
        "wk": normal_init((*lead, d, KH, hd), sd, dt, generator, device),
        "wv": normal_init((*lead, d, KH, hd), sd, dt, generator, device),
        "wo": normal_init((*lead, H, hd, d), (H * hd) ** -0.5, dt, generator,
                      device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((*lead, H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((*lead, KH, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((*lead, KH, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=F32, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=F32, device=device)
    return p


def _project(x, w):
    """x: (B, S, d) @ w: (d, N, hd) -> (B, S, N, hd)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).view(*x.shape[:-1], n, hd)


def attn_qkv(cfg: ModelConfig, p, x, positions, kind: str,
             policy=NULL_POLICY, rope: bool = True):
    """Project to q, k, v (+bias, qk-norm, rope)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if rope:
        theta = cfg.rope_theta if kind in ("attn", "global") else cfg.theta_local
        q = rope_apply(q, positions, theta)
        k = rope_apply(k, positions, theta)
    q = policy(q, "act_q")
    k = policy(k, "act_kv")
    v = policy(v, "act_kv")
    return q, k, v


def attn_out(p, o, policy=NULL_POLICY):
    H, hd, d = p["wo"].shape
    y = o.reshape(*o.shape[:2], H * hd) @ p["wo"].reshape(H * hd, d)
    return policy(y, "act")


def _attend(fn, q, k, v):
    """``fn(q, k, v)``, on the local shards where q is a ``DTensor``."""
    if isinstance(q, DTensor):
        return sharding.attention_on_shards(fn, q, k, v)
    return fn(q, k, v)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind in ("local", "swa") else 0


def self_attention_train(cfg: ModelConfig, p, x, kind: str, positions,
                         policy=NULL_POLICY, causal: bool = True,
                         route: str = "kernels"):
    q, k, v = attn_qkv(cfg, p, x, positions, kind, policy)
    window = _window(cfg, kind)
    if route == "kernels":
        o = _attend(lambda q, k, v: flash_ops.flash_attention(
            q, k, v, causal=causal, window=window), q, k, v)
    elif cfg.attn_impl == "blocked":
        o = _attend(lambda q, k, v: blocked_attention(
            q, k, v, causal=causal, window=window, block_q=cfg.attn_block_k,
            block_k=cfg.attn_block_k), q, k, v)
    else:
        o = _attend(lambda q, k, v: chunked_attention(
            q, k, v, causal=causal, window=window,
            block_k=cfg.attn_block_k), q, k, v)
    o = policy(o, "act_q")
    return attn_out(p, o, policy), (k, v)


def quantize_kv(x):
    """Symmetric int8 per-(token, head) quantization:
    x (B, S, KH, hd) -> (int8 values, f32 scales (B, S, KH, 1))."""
    xf = x.to(F32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                            1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype):
    """``(q in f32 * scale)`` rounded to ``dtype``, in one elementwise
    pass (the product is formed in f32 and rounded as it is stored)."""
    return torch.mul(q, scale, out=torch.empty(q.shape, dtype=dtype,
                                               device=q.device))


def cache_entries(cfg: ModelConfig, k, v):
    """What the cache stores for new keys and values: themselves, or on
    the int8 cache (``kv_quant="int8"``) their int8 values and f32
    scales."""
    if cfg.kv_quant != "int8":
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def cache_kv(cfg: ModelConfig, cache):
    """The keys and values that attention reads from a layer's cache: the
    cache itself, or the int8 cache dequantized to the compute dtype (the
    whole cache, as the JAX package does before its decode kernel)."""
    if cfg.kv_quant != "int8":
        return cache["k"], cache["v"]
    dt = cfg.compute_torch_dtype
    return (dequantize_kv(cache["k"], cache["k_scale"], dt),
            dequantize_kv(cache["v"], cache["v_scale"], dt))


def self_attention_decode(cfg: ModelConfig, p, x, kind: str, cache, pos,
                          policy=NULL_POLICY):
    """x: (B, 1, d). cache: {"k","v"}: (B, Smax, KH, hd), with
    {"k_scale","v_scale"}: (B, Smax, KH, 1) on the int8 cache.  Returns
    (y, cache).

    The new K/V are written in place at ``cache[b, pos[b]]`` (on the int8
    cache quantized, values and scales); every other position is left as
    it was.  (The JAX package rebuilds the whole cache with a masked
    ``where``, which keeps its write local to a sequence-sharded cache.)
    On the int8 cache the decode kernel reads the cache dequantized to the
    compute dtype.

    Under a mesh the cache leaves are ``DTensor``s with the sequence
    sharded (``sharding.cache_specs``): the token's K/V go to the rank
    whose shard holds ``pos[b]``, written in place there and nowhere else
    (``sharding.cache_write_on_shards``), and each rank runs the decode
    kernel with every query head over its shard's part of the row's range
    (its log-sum-exp beside), the shards merged over the sequence's mesh
    axes (``sharding.decode_on_shards``): the cross-card flash-decode the
    JAX package's layout stands for.  No cache leaf is gathered or copied.
    """
    B = x.shape[0]
    pos_b = positions_vector(pos, B, x.device)
    q, k, v = attn_qkv(cfg, p, x, pos_b[:, None], kind, policy)
    rows = torch.arange(B, device=x.device)
    at = pos_b.long()
    for name, t in cache_entries(cfg, k, v).items():
        if isinstance(cache[name], DTensor):
            sharding.cache_write_on_shards(cache[name], t, pos_b[:, None])
        else:
            cache[name][rows, at] = t[:, 0].to(cache[name].dtype)
        cache[name] = policy(cache[name], "kv_cache")
    k_use, v_use = cache_kv(cfg, cache)
    q = policy(q, "act_q_decode")
    window = _window(cfg, kind)
    if isinstance(k_use, DTensor):
        o = sharding.decode_on_shards(decode_ops.decode_attention_range, q,
                                      k_use, v_use, pos_b, window)
    else:
        o = decode_ops.decode_attention(q, k_use, v_use, pos_b,
                                        window=window)
    return attn_out(p, o, policy), cache


def self_attention_extend(cfg: ModelConfig, p, x, kind: str, cache, off,
                          policy=NULL_POLICY):
    """Chunked prefill: a chunk of C prompt tokens against an existing
    cache.  x: (B, C, d); off: int, or (B,) — tokens already cached per
    row.  The chunk's K/V are written in place at ``[off, off + C)``
    (positions past the cache are dropped, as in the JAX package, whose
    gather-select rewrites the whole cache instead).  Under a mesh each
    rank writes the chunk's positions its sequence shard holds, in place
    (a chunk may cross a shard's edge; ``sharding.cache_write_on_shards``),
    and the chunk's queries, every head, attend over each shard with the
    plain chunked attention and its log-sum-exp, the shards merged
    (``sharding.attend_on_sequence``); no cache leaf is gathered or copied.

    On the int8 cache the chunk's K/V are quantized as the decode step
    quantizes them, values and scales written, and the chunk attends over
    the dequantized cache, its own keys included: what the decode step
    computes when it is fed the same tokens one at a time.  (The JAX
    package's chunked prefill has no int8 path: it casts the chunk to
    int8 and drops the scales; ``ROADMAP.md``, queue C.)"""
    B, C, _ = x.shape
    off_b = positions_vector(off, B, x.device)
    positions = off_b[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = attn_qkv(cfg, p, x, positions, kind, policy)
    Smax = cache["k"].shape[1]
    entries = cache_entries(cfg, k, v)
    window = _window(cfg, kind)
    if isinstance(cache["k"], DTensor):
        for name, t in entries.items():
            sharding.cache_write_on_shards(cache[name], t, positions)
    elif isinstance(off, numbers.Integral):
        n = max(0, min(C, Smax - int(off)))
        for name, t in entries.items():
            cache[name][:, off:off + n] = t[:, :n].to(cache[name].dtype)
    else:
        at = positions.long()
        keep = at < Smax
        rows = torch.arange(B, device=x.device)[:, None].expand(B, C)
        for name, t in entries.items():
            cache[name][rows[keep], at[keep]] = t[keep].to(cache[name].dtype)
    cache["k"] = policy(cache["k"], "kv_cache")
    cache["v"] = policy(cache["v"], "kv_cache")
    k_all, v_all = cache_kv(cfg, cache)
    q = policy(q, "act_q")
    if isinstance(k_all, DTensor):
        o = sharding.attend_on_sequence(
            lambda ql, kl, vl, q0, k0: chunked_attention(
                ql, kl, vl, causal=True, window=window, q_offset=q0,
                k_offset=k0, block_k=cfg.attn_block_k, return_lse=True),
            q, k_all, v_all, off_b)
    else:
        o = chunked_attention(q, k_all, v_all, causal=True, window=window,
                              q_offset=off_b, block_k=cfg.attn_block_k)
    o = policy(o, "act_q")
    return attn_out(p, o, policy), cache


def cross_attention(cfg: ModelConfig, p, x, enc_k, enc_v,
                    policy=NULL_POLICY):
    """Decoder cross-attention over the encoder's keys and values (B, Se,
    KH, hd), no rope: the plain chunked attention without a mask."""
    q = _project(x, p["wq"])
    q = policy(q, "act_q")
    o = _attend(lambda q, k, v: chunked_attention(
        q, k, v, causal=False, block_k=cfg.attn_block_k), q, enc_k, enc_v)
    o = policy(o, "act_q")
    return attn_out(p, o, policy)


def encode_cross_kv(cfg: ModelConfig, p, enc_out, policy=NULL_POLICY):
    """The cross-attention keys and values of the encoder's output."""
    k, v = _project(enc_out, p["wk"]), _project(enc_out, p["wv"])
    return policy(k, "act_kv"), policy(v, "act_kv")


# --------------------------------------------------------------------------
# dense FFN
# --------------------------------------------------------------------------
def init_ffn(cfg: ModelConfig, generator, lead=(), device=None):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_torch_dtype
    p = {"w1": normal_init((*lead, d, f), d ** -0.5, dt, generator, device),
         "w2": normal_init((*lead, f, d), f ** -0.5, dt, generator, device)}
    if cfg.glu:
        p["w3"] = normal_init((*lead, d, f), d ** -0.5, dt, generator, device)
    return p


def _act(cfg: ModelConfig, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def ffn_apply(cfg: ModelConfig, p, x, policy=NULL_POLICY):
    h = _act(cfg, x @ p["w1"])
    if cfg.glu:
        h = h * (x @ p["w3"])
    h = policy(h, "act_ff")
    y = h @ p["w2"]
    return policy(y, "act")


# --------------------------------------------------------------------------
# Mixture-of-Experts FFN (top-k, shared experts, capacity-dropped dispatch)
# --------------------------------------------------------------------------
def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared experts as one dense FFN of their summed width."""
    return cfg.replace(d_ff=cfg.moe_d_ff * cfg.num_shared_experts)


def init_moe(cfg: ModelConfig, generator, lead=(), device=None):
    """MoE weights (stacked over ``lead``) at the JAX init's shapes, scales
    and dtypes: the router in f32 whatever ``param_dtype`` is, the experts'
    (E, d, f) and (E, f, d) products and the shared FFN in
    ``param_dtype``."""
    d, E, fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = cfg.param_torch_dtype
    p = {
        "router": normal_init((*lead, d, E), d ** -0.5, F32, generator,
                              device),
        "w1": normal_init((*lead, E, d, fe), d ** -0.5, dt, generator,
                          device),
        "w2": normal_init((*lead, E, fe, d), fe ** -0.5, dt, generator,
                          device),
    }
    if cfg.glu:
        p["w3"] = normal_init((*lead, E, d, fe), d ** -0.5, dt, generator,
                              device)
    if cfg.num_shared_experts:
        p["shared"] = init_ffn(_shared_cfg(cfg), generator, lead, device)
    return p


def moe_groups(x, dp_size: int = 1):
    """x: (B, S, d) as dispatch groups (G, T, d).  A batch row is a group;
    a decode batch (S == 1, B > 1) is regrouped into ``min(B, dp_size)``
    groups (``policy.dp_size``: one group of B tokens under
    ``NULL_POLICY``, one per data shard under a mesh)."""
    B, S, d = x.shape
    if S == 1 and B > 1:
        G = min(B, max(dp_size, 1))
        return x.reshape(G, B // G, d)
    return x


def moe_route(cfg: ModelConfig, router, x):
    """Top-k routing and capacity slotting of the groups x: (G, S, d).

    The router runs in f32; the top-k gates are renormalised.  The (token,
    choice) assignments of a group, flattened token-major, are stably
    sorted by expert: each expert's first ``C = moe_capacity(S)`` takers
    get its slots ``e * C + rank`` and the rest are dropped (slot
    ``E * C``).  Returns a dict of
      probs (G, S, E) f32, eidx (G, S, K), counts (G, E) takers per expert,
      table (G, E*C) the token in each slot (S, a zero row, where empty),
      wtab (G, E*C) f32 the gate of each slot's assignment (0 where empty),
      slot (G, S, K) each assignment's slot (E*C where dropped),
      dropped (G,) the assignments each group dropped."""
    G, S, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = cfg.moe_capacity(S)
    probs = torch.softmax(x.to(F32) @ router, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    ef = eidx.reshape(G, S * K)
    order = torch.argsort(ef, dim=-1, stable=True)
    sorted_e = ef.gather(-1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, ef, torch.ones_like(ef))
    starts = counts.cumsum(dim=-1) - counts
    ranks = torch.arange(S * K, device=x.device) - starts.gather(-1,
                                                                 sorted_e)
    keep = ranks < C
    dest = torch.where(keep, sorted_e * C + ranks, E * C)
    src_tok = order // K
    wts = gate.reshape(G, S * K).gather(-1, order)
    # the sentinel column E*C takes every dropped assignment and is cut off
    table = torch.full((G, E * C + 1), S, dtype=torch.int64,
                       device=x.device).scatter_(1, dest, src_tok)[:, :E * C]
    wtab = torch.zeros((G, E * C + 1), dtype=F32,
                       device=x.device).scatter_(1, dest, wts)[:, :E * C]
    slot = torch.empty_like(dest).scatter_(1, order, dest).view(G, S, K)
    return {"probs": probs, "eidx": eidx, "counts": counts, "table": table,
            "wtab": wtab, "slot": slot, "dropped": (~keep).sum(dim=-1)}


def _moe_experts(cfg: ModelConfig, x, r, w1, w2, w3, policy=NULL_POLICY):
    """The routed experts' outputs per token: x (G, S, d) the groups, r
    the routing (``table``, ``wtab``, ``slot``); (G, S, d) in x's dtype."""
    G, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = cfg.moe_capacity(S)
    # row g*(S+1) + t of the padded flat batch is token t of group g
    x_pad = torch.cat([x, x.new_zeros((G, 1, d))], dim=1).view(-1, d)
    rows = r["table"] + torch.arange(G, device=x.device)[:, None] * (S + 1)
    xe = x_pad[rows.view(G, E, C).transpose(0, 1).reshape(E, G * C)]
    xe = policy(xe, "moe_gathered")
    h = _act(cfg, torch.bmm(xe, w1))
    if cfg.glu:
        h = h * torch.bmm(xe, w3)
    h = policy(h, "moe_hidden")
    out = torch.bmm(h, w2)                                  # (E, G*C, d)
    w = r["wtab"].view(G, E, C).transpose(0, 1).reshape(E, G * C, 1)
    out = out * w.to(out.dtype)

    # assignment slot e*C + c of group g is row e*G*C + g*C + c of ``out``
    slot = r["slot"]
    flat = ((slot // C) * (G * C) + torch.arange(G, device=x.device)[
        :, None, None] * C + slot % C)
    flat = torch.where(slot < E * C, flat, E * G * C)
    flat = flat.sort(dim=-1).values        # slot order: expert by expert
    out = torch.cat([out.view(E * G * C, d), out.new_zeros((1, d))])
    parts = out[flat]                                       # (G, S, K, d)
    y = parts[:, :, 0]
    for k in range(1, K):
        y = y + parts[:, :, k]
    return y


def moe_apply(cfg: ModelConfig, p, x, policy=NULL_POLICY):
    """Group-local capacity dispatch (``moe_groups``, ``moe_route``).
    x: (B, S, d).  Returns (y, aux): y (B, S, d) in x's dtype and the
    Switch-style load-balance loss (f32 scalar) of the undropped counts.

    Each expert's slots gather their tokens' rows into one (E, G*C, d)
    tensor, whose products ``act(x @ w1) * (x @ w3) @ w2`` are batched
    over E; each slot's output is scaled by its gate cast to x's dtype.
    The JAX package then scatter-adds the slots into the tokens in slot
    order; here each token gathers the outputs of its K slots (a dropped
    assignment reads a zero row) and adds them in that same order, one
    addition at a time in x's dtype: no floating-point atomics, so two
    runs on the card are bitwise equal.  The shared experts' FFN is added
    last.  Under a mesh the routing and the experts run on the local
    shards (``sharding.moe_on_shards``): the groups of the local data
    shard, the experts' local d_ff."""
    orig_shape = x.shape
    E, K = cfg.num_experts, cfg.top_k
    weights = [p["w1"], p["w2"], p["w3"] if cfg.glu else None]
    if isinstance(x, DTensor):
        # the local rows are one data shard's groups: dp_size 1 locally
        y, r = sharding.moe_on_shards(
            lambda xl, rl: moe_route(cfg, rl, moe_groups(xl)),
            lambda xl, rl, ws: _moe_experts(
                cfg, moe_groups(xl), rl, ws[0], ws[1],
                ws[2] if cfg.glu else None).reshape(xl.shape),
            x, p["router"], [w for w in weights if w is not None])
        G, S_, _ = r["probs"].shape
    else:
        x = moe_groups(x, policy.dp_size)
        G, S_, d = x.shape
        r = moe_route(cfg, p["router"], x)
        y = _moe_experts(cfg, x, r, *weights, policy)
    y = y.reshape(orig_shape)
    x = x.reshape(orig_shape)
    y = policy(y, "act")
    if cfg.num_shared_experts:
        y = y + ffn_apply(_shared_cfg(cfg), p["shared"], x, policy)

    frac = r["counts"].to(F32).sum(dim=0) / (G * S_ * K)
    imp = r["probs"].mean(dim=(0, 1))
    return y, E * torch.sum(frac * imp)


# --------------------------------------------------------------------------
# linear recurrence scan  h_t = a_t * h_{t-1} + b_t   (chunked)
# --------------------------------------------------------------------------
def _doubling_scan(a, b):
    """Inclusive scan of the affine maps (a_t, b_t) along axis 1 in
    log2(L) doubling steps.  Returns (A, Bv) with h_t = Bv_t + A_t * h_in
    for a state h_in entering the chunk."""
    L = a.shape[1]
    k = 1
    while k < L:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def linear_scan(a, b, h0=None, *, chunk: int = 256):
    """Scan along axis 1.  a, b: (B, S, ...); h0: (B, ...) or None (zero).
    Returns (h_all (B, S, ...), h_last (B, ...)).  Chunks of ``chunk``
    steps run one after another, each as a doubling scan (the JAX
    package runs an associative scan inside each chunk)."""
    if isinstance(a, DTensor):
        return sharding.scan_on_shards(
            lambda a, b, h0: linear_scan(a, b, h0, chunk=chunk), a, b, h0)
    S = a.shape[1]
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    outs = []
    for start in range(0, S, chunk):
        A, Bv = _doubling_scan(a[:, start:start + chunk],
                               b[:, start:start + chunk])
        hc = Bv + A * h[:, None]
        h = hc[:, -1]
        outs.append(hc)
    return torch.cat(outs, dim=1), h


# --------------------------------------------------------------------------
# causal depthwise conv (width 4)
# --------------------------------------------------------------------------
def causal_conv(x, w, b, state=None):
    """x: (B, S, C); w: (cw, C); state: (B, cw-1, C) prior context or None.

    Returns (y, new_state) where new_state is the trailing cw-1 inputs."""
    if isinstance(x, DTensor) and state is None:
        y = sharding.conv_on_shards(lambda xl, wl, bl: causal_conv(xl, wl, bl)[0],
                             x, w, b)
        return y, None
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    new_state = xp[:, -(cw - 1):] if cw > 1 else state
    return y, new_state


# --------------------------------------------------------------------------
# Mamba-1 selective SSM block
# --------------------------------------------------------------------------
def init_mamba(cfg: ModelConfig, generator, lead=(), device=None):
    """Mamba weights (stacked over ``lead``) at the JAX init's shapes and
    dtypes: projections and the conv in ``param_dtype``, ``dt_bias``,
    ``A_log`` and ``D`` in f32 with the JAX init's constant values."""
    d, di, s, r, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.conv_width)
    dt = cfg.param_torch_dtype
    a_log = torch.log(torch.arange(1, s + 1, dtype=F32, device=device))
    return {
        "in_proj": normal_init((*lead, d, 2 * di), d ** -0.5, dt, generator,
                               device),
        "conv_w": normal_init((*lead, cw, di), cw ** -0.5, dt, generator,
                              device),
        "conv_b": torch.zeros((*lead, di), dtype=dt, device=device),
        "x_proj": normal_init((*lead, di, r + 2 * s), di ** -0.5, dt,
                              generator, device),
        "dt_proj": normal_init((*lead, r, di), r ** -0.5, dt, generator,
                               device),
        "dt_bias": torch.full((*lead, di), -2.0, dtype=F32, device=device),
        "A_log": a_log.expand(*lead, di, s).contiguous(),
        "D": torch.ones((*lead, di), dtype=F32, device=device),
        "out_proj": normal_init((*lead, di, d), di ** -0.5, dt, generator,
                                device),
    }


def fused_selective_scan(cfg: ModelConfig, x_c, dt, Bm, Cm, A_log, D,
                         h0=None):
    """Chunked selective scan with the discretisation and the C projection
    inside each chunk's body, which is checkpointed: the (B, chunk, di,
    state) tensors exist one chunk at a time, in the forward and again in
    the backward, never as a full-sequence residual (the JAX package's
    ``jax.checkpoint``-ed chunk body; its associative scan within a chunk
    is the doubling scan here).  x_c, dt (f32), Bm, Cm: (B, S, ...); h0:
    (B, di, state) f32 or None.  Returns (y (B, S, di) f32, h_last)."""
    if isinstance(x_c, DTensor):
        return sharding.fused_scan_on_shards(
            lambda *t: fused_selective_scan(cfg, *t), x_c, dt, Bm, Cm, A_log,
            D, h0)
    B, S, di = x_c.shape
    A = -torch.exp(A_log.to(F32))

    def chunk_body(h_in, xq, dtq, Bq, Cq):
        dtf = dtq.to(F32)
        a = torch.exp(dtf[..., None] * A)                       # (B,ck,di,s)
        bu = (dtf * xq.to(F32))[..., None] * Bq.to(F32)[:, :, None, :]
        Ac, Buc = _doubling_scan(a, bu)
        hc = Buc + Ac * h_in[:, None]
        return hc[:, -1], (hc * Cq.to(F32)[:, :, None, :]).sum(dim=-1)

    h = (torch.zeros((B, di, Bm.shape[-1]), dtype=F32, device=x_c.device)
         if h0 is None else h0)
    ys = []
    for start in range(0, S, cfg.scan_chunk):
        part = [t[:, start:start + cfg.scan_chunk] for t in (x_c, dt, Bm, Cm)]
        h, y = torch.utils.checkpoint.checkpoint(chunk_body, h, *part,
                                                 use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1) + D.to(F32) * x_c.to(F32), h


def _mamba_core(cfg: ModelConfig, p, x_c, policy=NULL_POLICY, h0=None,
                return_state=False, route: str = "kernels"):
    """x_c: (B, S, di) post-conv activations -> (y, h_last).

    On the kernels route without a state in or out (the full-sequence
    forward) the scan is ``ssm_ops.ssm_scan`` with dt cast to x_c's dtype,
    as the JAX package's kernel path casts it; otherwise it is the plain
    scan, ``fused_selective_scan`` where ``cfg.ssm_fuse`` is "chunk", else
    ``linear_scan``, as in the JAX package."""
    r, s = cfg.dt_rank, cfg.ssm_state
    proj = x_c @ p["x_proj"]
    dt_raw, Bm, Cm = proj.split([r, s, s], dim=-1)
    dt = F.softplus((dt_raw @ p["dt_proj"]).to(F32) + p["dt_bias"])
    if route == "kernels" and h0 is None and not return_state:
        y = ssm_ops.ssm_scan(x_c, dt.to(x_c.dtype), Bm.contiguous(),
                             Cm.contiguous(), p["A_log"], p["D"])
        return y, None
    if cfg.ssm_fuse == "chunk":
        y, h_last = fused_selective_scan(cfg, x_c, dt, Bm, Cm, p["A_log"],
                                         p["D"], h0=h0)
        return y.to(x_c.dtype), (h_last if return_state else None)
    A = -torch.exp(p["A_log"])                                  # (di, s)
    a = torch.exp(dt[..., None] * A)                            # (B,S,di,s)
    bu = (dt * x_c.to(F32))[..., None] * Bm.to(F32)[:, :, None, :]
    h_all, h_last = linear_scan(a, bu, h0, chunk=cfg.scan_chunk)
    y = (h_all * Cm.to(F32)[:, :, None, :]).sum(dim=-1)          # (B,S,di)
    y = y + p["D"] * x_c.to(F32)
    return y.to(x_c.dtype), (h_last if return_state else None)


def mamba_apply_train(cfg: ModelConfig, p, x, policy=NULL_POLICY,
                      route: str = "kernels"):
    xz = x @ p["in_proj"]
    xz = policy(xz, "act_inner2")
    x_in, z = xz.chunk(2, dim=-1)
    x_c, _ = causal_conv(x_in, p["conv_w"], p["conv_b"])
    x_c = F.silu(x_c)
    y, _ = _mamba_core(cfg, p, x_c, policy, route=route)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    return policy(out, "act")


def mamba_apply_decode(cfg: ModelConfig, p, x, cache, policy=NULL_POLICY):
    """x: (B, C, d), any C; cache: {"conv": (B, cw-1, di), "ssm": (B, di,
    s)}.  Returns (y, cache): the cache given, its state written in place
    (the engine hands in views of its slot rows)."""
    xz = x @ p["in_proj"]
    xz = policy(xz, "act_inner2")
    x_in, z = xz.chunk(2, dim=-1)
    x_c, conv_state = causal_conv(x_in, p["conv_w"], p["conv_b"],
                                  state=cache["conv"])
    x_c = F.silu(x_c)
    y, h_last = _mamba_core(cfg, p, x_c, policy, h0=cache["ssm"],
                            return_state=True)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    cache["conv"].copy_(policy(conv_state, "ssm_conv"))
    cache["ssm"].copy_(policy(h_last, "ssm_state"))
    return policy(out, "act"), cache


def init_mamba_cache(cfg: ModelConfig, B: int, dtype, lead=(), device=None):
    return {"conv": torch.zeros((*lead, B, cfg.conv_width - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((*lead, B, cfg.d_inner, cfg.ssm_state),
                               dtype=F32, device=device)}


# --------------------------------------------------------------------------
# RG-LRU block (Griffin / RecurrentGemma recurrent block)
# --------------------------------------------------------------------------
def init_rglru(cfg: ModelConfig, generator, lead=(), device=None):
    """RG-LRU weights (stacked over ``lead``) at the JAX init's shapes and
    dtypes: projections, the conv and the block-diagonal gates in
    ``param_dtype``; the gate biases and ``lam`` in f32 with the JAX init's
    constants (zero biases, lam = 2, a base decay of sigmoid(2))."""
    d, di, cw, nb = cfg.d_model, cfg.d_inner, cfg.conv_width, cfg.rglru_blocks
    bs = di // nb
    dt = cfg.param_torch_dtype
    return {
        "w_x": normal_init((*lead, d, di), d ** -0.5, dt, generator, device),
        "w_gate": normal_init((*lead, d, di), d ** -0.5, dt, generator,
                              device),
        "conv_w": normal_init((*lead, cw, di), cw ** -0.5, dt, generator,
                              device),
        "conv_b": torch.zeros((*lead, di), dtype=dt, device=device),
        "rg_a": normal_init((*lead, nb, bs, bs), bs ** -0.5, dt, generator,
                            device),
        "rg_a_b": torch.zeros((*lead, di), dtype=F32, device=device),
        "rg_x": normal_init((*lead, nb, bs, bs), bs ** -0.5, dt, generator,
                            device),
        "rg_x_b": torch.zeros((*lead, di), dtype=F32, device=device),
        "lam": torch.full((*lead, di), 2.0, dtype=F32, device=device),
        "out_proj": normal_init((*lead, di, d), di ** -0.5, dt, generator,
                                device),
    }


def _blockdiag(x, w, nb: int):
    """x: (B, S, di) times the block-diagonal (nb, di/nb, di/nb) w."""
    B, S, di = x.shape
    xb = x.reshape(B, S, nb, di // nb)
    return torch.einsum("bsnq,nqp->bsnp", xb, w).reshape(B, S, di)


_RG_C = 8.0


def _rglru_core(cfg: ModelConfig, p, x_c, h0=None, return_state=False,
                route: str = "kernels"):
    """x_c: (B, S, di) post-conv activations -> (h f32, h_last).

    The gates are computed in f32.  On the kernels route without a state
    in or out (the full-sequence forward) the recurrence is
    ``rglru_ops.rg_lru``, where the JAX package calls its Pallas kernel;
    otherwise it is the plain ``linear_scan``."""
    nb = cfg.rglru_blocks
    r = torch.sigmoid(_blockdiag(x_c, p["rg_a"], nb).to(F32) + p["rg_a_b"])
    i = torch.sigmoid(_blockdiag(x_c, p["rg_x"], nb).to(F32) + p["rg_x_b"])
    log_a = -_RG_C * r * F.softplus(p["lam"])                  # <= 0
    a = torch.exp(log_a)
    gated = i * x_c.to(F32)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * gated
    if route == "kernels" and h0 is None and not return_state:
        return rglru_ops.rg_lru(a, b), None
    h_all, h_last = linear_scan(a, b, h0, chunk=cfg.scan_chunk)
    return h_all, (h_last if return_state else None)


def _gelu(x):
    # the gate branch is jax.nn.gelu's default (tanh approximation),
    # whatever cfg.act is
    return F.gelu(x, approximate="tanh")


def rglru_apply_train(cfg: ModelConfig, p, x, policy=NULL_POLICY,
                      route: str = "kernels"):
    xb = x @ p["w_x"]
    g = _gelu(x @ p["w_gate"])
    xb = policy(xb, "act_inner")
    g = policy(g, "act_inner")
    x_c, _ = causal_conv(xb, p["conv_w"], p["conv_b"])
    h, _ = _rglru_core(cfg, p, x_c, route=route)
    y = (h * g.to(F32)).to(x.dtype)
    out = y @ p["out_proj"]
    return policy(out, "act")


def rglru_apply_decode(cfg: ModelConfig, p, x, cache, policy=NULL_POLICY):
    """x: (B, C, d), any C; cache: {"conv": (B, cw-1, di), "h": (B, di)
    f32}.  Returns (y, cache): the cache given, its state written in
    place (the engine hands in views of its slot rows)."""
    xb = x @ p["w_x"]
    g = _gelu(x @ p["w_gate"])
    xb = policy(xb, "act_inner")
    x_c, conv_state = causal_conv(xb, p["conv_w"], p["conv_b"],
                                  state=cache["conv"])
    h, h_last = _rglru_core(cfg, p, x_c, h0=cache["h"], return_state=True)
    y = (h * g.to(F32)).to(x.dtype)
    out = y @ p["out_proj"]
    cache["conv"].copy_(policy(conv_state, "ssm_conv"))
    cache["h"].copy_(policy(h_last, "ssm_state"))
    return policy(out, "act"), cache


def init_rglru_cache(cfg: ModelConfig, B: int, dtype, lead=(), device=None):
    return {"conv": torch.zeros((*lead, B, cfg.conv_width - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "h": torch.zeros((*lead, B, cfg.d_inner), dtype=F32,
                             device=device)}
