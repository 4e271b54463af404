"""Serving step functions: greedy sampling and the embed step (port of
``repro/serving/steps.py``)."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def _sample(cfg: ModelConfig, logits):
    """logits: (B, 1, V) f32 -> greedy tokens (B, 1) int32.  (Temperature
    sampling of the JAX package is not ported yet.)"""
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab,
                            device=logits.device) < cfg.vocab_size
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits.argmax(dim=-1).to(torch.int32)


def make_embed_step(cfg: ModelConfig):
    """Mean-pooled final hidden state as the text embedding
    (llm_embedding).  Token -1 pads and is left out of the mean.  An
    encoder-decoder runs its encoder over ``batch["frames"]`` first, as
    the JAX package does; a batch of tokens alone raises ``KeyError:
    'frames'`` there and here (``ROADMAP.md``, C.15).  With the vision
    frontend and ``batch["patches"]`` (B, P, d), the stack runs over the
    patches and the tokens and the first P rows are dropped before the
    mean, as in the JAX package; without patches it embeds the tokens
    alone (C.16).  The step runs the kernels, under ``torch.no_grad()``."""

    @torch.no_grad()
    def embed_step(params, batch):
        # run the decoder stack in train (full-sequence) mode, no logits
        enc_out = M._encoder_output(cfg, params, batch)
        x, positions = M._assemble_input(cfg, params, batch)
        x, _, _ = M._run_stages(cfg, params["stages"], list(cfg.stages()),
                                x, mode="train", positions=positions,
                                enc_out=enc_out)
        x = L.norm_apply(cfg, params.get("final_norm", {}), x)
        mask = (batch["tokens"] >= 0).to(F32)
        if cfg.frontend == "vision" and "patches" in batch:
            x = x[:, batch["patches"].shape[1]:]
        emb = (x.to(F32) * mask[..., None]).sum(dim=1) / \
            mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        return emb / torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True).clamp_min(1e-9)
    return embed_step
