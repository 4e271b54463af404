"""Serving step functions: prefill / decode with greedy and temperature
sampling, and the embed step (port of ``repro/serving/steps.py``).

These are the units the JAX package's dry run lowers for the inference
shape cells; the continuous-batching engine (``engine.py``) drives the
model's entry points itself, greedily.  Each step takes a ``policy``
(``layers.NULL_POLICY``, or a ``sharding.MeshPolicy`` over a
``ProcessMesh``), as the JAX package's ``build_cell`` wires them: the
params placed by ``sharding.param_specs``, the cache by
``sharding.cache_specs`` (``model.init_cache(..., mesh=)``, or the
prefill step's own).  They compute under ``torch.no_grad()``.

Under a mesh the logits are sharded over the vocabulary ("model");
``_sample`` gathers them whole on every rank (B x V f32) before it takes
any argmax, so the next tokens are a plain tensor that every rank holds
alike.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def gumbel_noise(shape, generator: torch.Generator, device):
    """Standard Gumbel noise of ``shape`` (f32) from ``generator``: the
    noise of ``_sample``'s categorical draw, in one place so a test can
    hand it the JAX package's."""
    u = torch.rand(shape, generator=generator, dtype=F32, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(F32).tiny)))


def _sample(cfg: ModelConfig, logits, rng=None, temperature=0.0):
    """logits: (B, 1, V) f32 -> tokens (B, 1) int32.  Greedy when ``rng``
    is None; otherwise a categorical draw at ``temperature`` (the argmax
    of ``logits / max(T, 1e-4)`` plus Gumbel noise from the
    ``torch.Generator`` ``rng``), greedy where ``temperature <= 0``.  The
    padded vocabulary (``shard_multiple`` > 1) is masked out first."""
    logits = sharding.full(logits)
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab,
                            device=logits.device) < cfg.vocab_size
        logits = logits.masked_fill(~mask, float("-inf"))
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if rng is None:
        return greedy
    temperature = torch.as_tensor(temperature, dtype=F32,
                                  device=logits.device)
    noisy = (logits / temperature.clamp_min(1e-4)
             + gumbel_noise(logits.shape, rng, logits.device)).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, noisy.to(torch.int32))


def make_prefill_step(cfg: ModelConfig, cache_len: int,
                      policy=L.NULL_POLICY):
    """``prefill_step(params, batch)`` -> {"logits", "next_token" (greedy),
    "cache", "pos"}."""
    cfg = cfg.replace(remat=False)      # no backward pass in serving

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache, pos = M.prefill(cfg, params, batch, cache_len, policy)
        return {"logits": logits, "next_token": _sample(cfg, logits),
                "cache": cache, "pos": pos}
    return prefill_step


def make_decode_step(cfg: ModelConfig, policy=L.NULL_POLICY):
    """``decode_step(params, tokens, cache, pos, rng=None,
    temperature=0.0)`` -> {"logits", "next_token", "cache"}; the cache is
    the one given, written in place."""
    cfg = cfg.replace(remat=False)      # no backward pass in serving

    @torch.no_grad()
    def decode_step(params, tokens, cache, pos, rng=None, temperature=0.0):
        logits, cache = M.decode_step(cfg, params, tokens, cache, pos,
                                      policy)
        return {"logits": logits,
                "next_token": _sample(cfg, logits, rng, temperature),
                "cache": cache}
    return decode_step


def make_embed_step(cfg: ModelConfig, policy=L.NULL_POLICY):
    """Mean-pooled final hidden state as the text embedding
    (llm_embedding).  Token -1 pads and is left out of the mean.  An
    encoder-decoder runs its encoder over ``batch["frames"]`` first, as
    the JAX package does; a batch of tokens alone raises ``KeyError:
    'frames'`` there and here (``ROADMAP.md``, C.15).  With the vision
    frontend and ``batch["patches"]`` (B, P, d), the stack runs over the
    patches and the tokens and the first P rows are dropped before the
    mean, as in the JAX package; without patches it embeds the tokens
    alone (C.16).  The step runs the kernels, under ``torch.no_grad()``;
    under a mesh the embeddings come back whole on every rank."""
    cfg = cfg.replace(remat=False)      # no backward pass in serving

    @torch.no_grad()
    def embed_step(params, batch):
        # run the decoder stack in train (full-sequence) mode, no logits
        enc_out = M._encoder_output(cfg, params, batch, policy=policy)
        x, positions = M._assemble_input(cfg, params, batch, policy)
        x, _, _ = M._run_stages(cfg, params["stages"], list(cfg.stages()),
                                x, mode="train", positions=positions,
                                policy=policy, enc_out=enc_out)
        x = sharding.full(L.norm_apply(cfg, params.get("final_norm", {}), x))
        mask = (sharding.full(batch["tokens"]) >= 0).to(F32)
        if cfg.frontend == "vision" and "patches" in batch:
            x = x[:, batch["patches"].shape[1]:]
        emb = (x.to(F32) * mask[..., None]).sum(dim=1) / \
            mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        return emb / torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True).clamp_min(1e-9)
    return embed_step
