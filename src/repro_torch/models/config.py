"""Model configuration for the PyTorch port (counterpart of
``repro/models/config.py``).

The same frozen dataclass and field names as the JAX package, for the
fields the dense decoder, the MoE FFN, the Mamba-1 block, the RG-LRU
block, the encoder-decoder (whisper), the vision patch prefix, the int8
KV cache and the training loss read.  The training route's fields keep
the JAX package's meanings and defaults: ``router_aux_weight`` (the MoE
router loss's weight in ``loss_fn``), ``attn_impl`` ("masked":
``chunked_attention``; "blocked": ``blocked_attention``), ``ssm_fuse``
("none": ``linear_scan``; "chunk": ``fused_selective_scan``, wherever
the Mamba scan is plain, as in the JAX package), ``remat``
and ``remat_policy`` (activation checkpointing per layer, "full" or
"dots": matmul outputs saved).  They select among plain functions on
the route that ``loss_fn`` takes (``models/model.py``); serving runs the
kernels whatever they say.  Fields that only the TPU lowering reads
(``use_pallas``, ``unroll_*``, the cost-probe ``stages_override`` and
``enc_stages_override``) are dropped: the port picks its kernels by the
route and the device a tensor lives on, not by a flag.  The sharding
fields are kept with the JAX package's meanings: ``shard_multiple``
pads the query heads (and an MHA config's KV heads) and the vocabulary
up to a multiple of it (``padded_num_heads``, ``padded_num_kv_heads``,
``padded_vocab``), and the weights are drawn at the padded shapes; 1,
the default, pads nothing.  ``moe_gathered_spec`` ("replicated" or
"auto") is the reference's switch for whether its policy places the MoE
dispatch tensors ("moe_gathered", "moe_hidden"); it has no effect on the
port's mesh path, where the dispatch runs on the local shards
(``sharding.moe_on_shards``) and no policy hook reaches those tensors,
so "replicated" and "auto" run alike.  So are ``max_seq``, which no code of
the JAX package reads, and ``train_accum_steps``, which only its dry run
reads (the trainer takes ``HParams.accum_steps``).

The shape cells (``ShapeCell``, ``SHAPES``, ``LONG_CONTEXT_OK``,
``cell_is_supported``) are the JAX package's, line for line; the sharded
serving tool takes its cache length from ``SHAPES["decode_32k"]``.

The audio frontend is the ``frames`` input (B, encoder_seq, d_model) of
an encoder-decoder: the JAX package stubs the conv stem the same way.
The vision frontend is the ``patches`` input (B, P, d_model), P =
``num_prefix_tokens`` in the configs, put in front of the token
embeddings: the JAX package stubs the CLIP image tower the same way.

Layer-kind strings used in ``pattern``:
  "attn"   full (global) causal self-attention
  "local"  sliding-window causal self-attention (window = ``window_size``)
  "swa"    alias of "local"
  "rec"    RG-LRU recurrence block (Griffin; d_inner, rglru_blocks)
  "mamba"  Mamba-1 selective-SSM block (no separate FFN; d_ff == 0)
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch

ATTN_KINDS = ("attn", "local", "swa", "global")
PORTED_KINDS = ATTN_KINDS + ("mamba", "rec")
KV_QUANTS = ("none", "int8")
FRONTENDS = ("", "audio", "vision")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    pattern: Tuple[str, ...] = ("attn",)
    window_size: int = 0             # for "local"/"swa" layers
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # 0 -> same as rope_theta
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparam_ln
    glu: bool = True                 # gated (SwiGLU/GeGLU) FFN; False -> plain MLP
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d) embedding multiplier
    # ---- MoE ----
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-routed-expert hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ---- SSM (Mamba-1) / RG-LRU ----
    d_inner: int = 0
    ssm_state: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    scan_chunk: int = 256            # chunk of the stateful linear scan
    rglru_blocks: int = 16           # block-diagonal gate blocks
    ssm_fuse: str = "none"           # none | chunk (the plain Mamba scan)
    # ---- encoder-decoder / frontends ----
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # whisper: 1500 frames
    frontend: str = ""               # "" | "audio" | "vision"
    num_prefix_tokens: int = 0       # vlm: image patch tokens prepended to text
    # ---- KV cache ----
    kv_quant: str = "none"           # none | int8 (quantized KV cache)
    # ---- numerics ----
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_block_k: int = 512          # KV block of the plain chunked attention
    attn_impl: str = "masked"        # masked | blocked (plain attention)
    remat: bool = True               # activation checkpointing per layer
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    # ---- sharding ----
    moe_gathered_spec: str = "replicated"   # replicated | auto; no effect
                                            #   on the port's mesh path
    shard_multiple: int = 1          # pad heads and vocab to a multiple; 1: none

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_num_heads(self) -> int:
        """Q heads padded up so head-sharding divides the model axis."""
        m = self.shard_multiple
        if m <= 1 or self.num_heads < m:
            return self.num_heads
        return _round_up(self.num_heads, m)

    @property
    def padded_num_kv_heads(self) -> int:
        """MHA (H == KV) pads both so the 1:1 grouping survives padding;
        GQA keeps its true KV head count (replicated if not divisible)."""
        if self.num_heads == self.num_kv_heads:
            return self.padded_num_heads
        return self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        """The embedding's and the head's row count: the vocabulary
        rounded up to ``shard_multiple``; the padded rows are drawn like
        the others and masked out of the loss and of greedy decoding."""
        m = self.shard_multiple
        return _round_up(self.vocab_size, m) if m > 1 else self.vocab_size

    @property
    def theta_local(self) -> float:
        return self.rope_theta_local or self.rope_theta

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """(pattern, repeats) segments covering num_layers exactly."""
        p = self.pattern
        reps, rem = divmod(self.num_layers, len(p))
        out = []
        if reps:
            out.append((p, reps))
        if rem:
            out.append((p[:rem], 1))
        return tuple(out)

    def encoder_stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        if not self.is_encoder_decoder:
            return ()
        return ((("attn",), self.num_encoder_layers),)

    def moe_capacity(self, tokens_per_group: int) -> int:
        """Per-expert slot capacity for a dispatch group of given size."""
        ideal = tokens_per_group * self.top_k / self.num_experts
        c = int(math.ceil(ideal * self.capacity_factor))
        return max(1, min(_round_up(c, 4), tokens_per_group * self.top_k))

    def num_params(self) -> int:
        """Analytic parameter count (the JAX package's formula for the
        layer kinds the port runs; norm scales are not counted)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d
        if not self.tie_embeddings:
            n += d * self.vocab_size
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        ffn_mult = 3 if self.glu else 2
        ffn = ffn_mult * d * self.d_ff
        if self.num_experts:
            moe = d * self.num_experts \
                + self.num_experts * ffn_mult * d * self.moe_d_ff \
                + (self.num_shared_experts * ffn_mult * d * self.moe_d_ff
                   if self.num_shared_experts else 0)
            per_kind = {k: attn + moe for k in ATTN_KINDS}
        else:
            per_kind = {k: attn + ffn for k in ATTN_KINDS}
        if self.d_inner:
            di, s = self.d_inner, self.ssm_state
            per_kind["mamba"] = (d * 2 * di + self.conv_width * di
                                 + di * (self.dt_rank + 2 * s)
                                 + self.dt_rank * di + di * s + di + di * d)
            bs = di // self.rglru_blocks
            per_kind["rec"] = (2 * d * di + self.conv_width * di
                               + 2 * self.rglru_blocks * bs * bs + di
                               + di * d + ffn)
        for pattern, reps in self.stages():
            for kind in pattern:
                n += per_kind[kind] * reps
        if self.is_encoder_decoder:
            enc_attn = 4 * d * d
            n += self.num_encoder_layers * (enc_attn + ffn)
            n += self.num_layers * enc_attn          # decoder cross-attention
        return n

    def active_params(self) -> int:
        """Params touched per token (MoE: only routed top-k)."""
        if not self.num_experts:
            return self.num_params()
        d = self.d_model
        ffn_mult = 3 if self.glu else 2
        dead = (self.num_experts - self.top_k) * ffn_mult * d * self.moe_d_ff
        n_moe_layers = sum(
            reps * sum(1 for k in pat if k in ATTN_KINDS)
            for pat, reps in self.stages())
        return self.num_params() - dead * n_moe_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str                         # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs for which long_500k is runnable (sub-quadratic / windowed); the
# rest SKIP that cell per DESIGN.md §4.
LONG_CONTEXT_OK = {
    "falcon-mamba-7b", "recurrentgemma-9b", "mixtral-8x7b", "gemma3-12b",
}


def cell_is_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True


def check_supported(cfg: ModelConfig):
    """Raise for what the port does not run yet (ROADMAP.md, queue A)."""
    missing = []
    if cfg.frontend not in FRONTENDS:
        missing.append(f"{cfg.frontend} frontend")
    if cfg.kv_quant not in KV_QUANTS:
        missing.append(f"kv_quant={cfg.kv_quant!r}")
    for kind in cfg.pattern:
        if kind not in PORTED_KINDS:
            missing.append(f"layer kind {kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not yet ported to PyTorch "
            "(see ROADMAP.md, queue A)")
