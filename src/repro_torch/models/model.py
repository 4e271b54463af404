"""Stack assembly for the dense and MoE decoders, the Mamba-1 stack, the
Griffin hybrid (RG-LRU and local attention), the encoder-decoder
(whisper) and the vision patch prefix (phi-3-vision): train forward,
prefill, chunked prefill, decode and the encoder's cross-attention cache
(port of ``repro/models/model.py``).

Parameters keep the JAX package's pytree: ``{"embed", "final_norm",
"stages": [{"b0": {...}, ...}, ...]}`` with each stage's weights stacked
along a leading ``repeats`` axis (see ``ModelConfig.stages``).  Where the
JAX package scans over that axis, the port loops over it.  Caches keep
the same stage structure: (repeats, B, S, KH, hd) keys and values of an
attention layer (int8, beside f32 (repeats, B, S, KH, 1) ``k_scale`` and
``v_scale``, when ``kv_quant="int8"``), (repeats, B, cw-1, di) conv and (repeats, B, di, N) ssm
state of a Mamba layer, (repeats, B, cw-1, di) conv and (repeats, B, di)
f32 ``h`` of an RG-LRU layer.  Decode and chunked prefill write them in
place and return them.  An encoder-decoder's decoder layer also holds the
encoder's cross-attention keys and values, (repeats, B, encoder_seq, KH,
hd) ``xattn`` ``k`` and ``v`` in the compute dtype (also on the int8
cache, as in the JAX package): zero in a fresh cache, written by
``prefill`` and ``encode_for_cache``, and read in place by decode and
chunked prefill.  ``reset_recurrent_rows`` leaves them, so a slot keeps
its clip across requests, as the JAX engine's slots do.

Batch dict convention: ``tokens`` (B, S) int token ids (-1 pads);
``frames`` (B, encoder_seq, d_model) the audio frontend's stub embeddings
(an encoder-decoder's encoder input, as in the JAX package); ``patches``
(B, P, d_model) the vision frontend's stub patch embeddings, prepended to
the tokens' by ``forward_train``, ``prefill`` (whose ``next_pos`` is then
P + S) and the embed step where the config's frontend is "vision", as in
the JAX package.  ``prefill_chunk`` and ``decode_step`` take tokens only.
Parameters are drawn by ``repro_torch.params.init_params``.

Full-sequence entry points take a ``route`` (``layers.ROUTES``):
"kernels", the CUDA kernels on the card (serving, the embed step,
``forward_train`` by default), or "plain", the training route of
``loss_fn``, which mirrors the JAX package's ``use_pallas=False``
branches (``layers.py``).  On the plain route in train mode,
``cfg.remat`` checkpoints each repeat of a stage
(``torch.utils.checkpoint``), as ``jax.checkpoint`` wraps the JAX
package's scan body; ``remat_policy="dots"`` saves the outputs of the
weight products (``aten.mm``: matmuls with no batch dimension, as
``dots_with_no_batch_dims_saveable`` saves) and recomputes the rest.
The serving entry points (``prefill``, ``prefill_chunk``,
``encode_for_cache``, ``decode_step``) compute under ``torch.no_grad()``.

Every entry point takes a ``policy`` (``layers.NULL_POLICY`` by default,
``sharding.MeshPolicy`` over a mesh), threaded to the layers and applied
at the JAX package's call sites.  Under a mesh the params and the batch
are ``DTensor``s; ``loss_fn`` and ``forward_train`` on the plain route
run there (``training/train_step.py``), and so do ``prefill``,
``prefill_chunk`` and ``decode_step`` of the attention-only decoders on
the compute-dtype cache, whose leaves are ``DTensor``s placed by
``sharding.cache_specs`` (``init_cache(..., mesh=)``); the other caches
raise there (``sharding.refuse_serving``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from torch.distributed.tensor import DTensor

from . import layers as L
from . import sharding
from .config import ATTN_KINDS, ModelConfig, check_supported

F32 = torch.float32


def _index(tree, r: int):
    """Repeat ``r`` of a stacked stage tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# --------------------------------------------------------------------------
# single-layer application (shared by train / prefill / decode / extend)
# --------------------------------------------------------------------------
def apply_layer(cfg: ModelConfig, kind: str, p, x, *, mode: str, positions,
                pos=None, cache=None, policy=L.NULL_POLICY, enc_out=None,
                causal=True, cache_len=0, route: str = "kernels"):
    """Returns (x, new_cache, aux): aux is the MoE layer's router loss,
    None for a layer without one.  A layer with ``xattn`` (an
    encoder-decoder's decoder) attends over the encoder after its
    self-attention residual: over ``enc_out``'s keys and values in train
    and prefill mode, over the cache's ``xattn`` in decode and extend."""
    if kind == "mamba":
        x, new_cache = _apply_mamba(cfg, p, x, mode=mode, cache=cache,
                                    policy=policy, route=route)
        return policy(x, "act"), new_cache, None
    if kind == "rec":
        x, new_cache = _apply_rec(cfg, p, x, mode=mode, cache=cache,
                                  policy=policy, route=route)
        return policy(x, "act"), new_cache, None
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not yet ported "
                                  "to PyTorch (see ROADMAP.md, queue A)")
    new_cache = {}
    h = L.norm_apply(cfg, p.get("ln1", {}), x)
    if mode == "decode":
        y, new_attn = L.self_attention_decode(cfg, p["attn"], h, kind,
                                              cache["attn"], pos, policy)
    elif mode == "extend":
        y, new_attn = L.self_attention_extend(cfg, p["attn"], h, kind,
                                              cache["attn"], pos, policy)
    else:
        y, (k, v) = L.self_attention_train(cfg, p["attn"], h, kind,
                                           positions, policy, causal=causal,
                                           route=route)
        if mode == "prefill":
            new_attn = {name: _prefill_cache(t, cache_len, policy)
                        for name, t in L.cache_entries(cfg, k, v).items()}
    x = x + y
    if "xattn" in p:
        hx = L.norm_apply(cfg, p.get("ln_x", {}), x)
        if mode in ("decode", "extend"):
            ek, ev = cache["xattn"]["k"], cache["xattn"]["v"]
        else:
            ek, ev = L.encode_cross_kv(cfg, p["xattn"], enc_out, policy)
        x = x + L.cross_attention(cfg, p["xattn"], hx, ek, ev, policy)
        if mode == "prefill":
            new_cache["xattn"] = {"k": ek, "v": ev}
    h2 = L.norm_apply(cfg, p.get("ln2", {}), x)
    aux = None
    if "moe" in p:
        # the null policy is moe_apply's default and stays out of the call,
        # which wrappers of moe_apply's three-argument form then take
        extra = () if policy is L.NULL_POLICY else (policy,)
        y2, aux = L.moe_apply(cfg, p["moe"], h2, *extra)
    else:
        y2 = L.ffn_apply(cfg, p["ffn"], h2, policy)
    x = x + y2
    if mode in ("prefill", "decode", "extend"):
        new_cache["attn"] = new_attn
    return policy(x, "act"), new_cache, aux


def _prefill_cache(t, cache_len: int, policy):
    """A prompt's keys or values (B, S, KH, hd) padded to the cache's
    ``cache_len`` positions; under a mesh placed by the policy's
    "kv_cache" spec, the sequence sharded, each rank keeping the prompt
    positions of its shard (``sharding.cache_from_prefill``)."""
    if isinstance(t, DTensor):
        return sharding.cache_from_prefill(t, policy.mesh,
                                           policy.specs["kv_cache"],
                                           cache_len)
    return policy(F.pad(t, (0, 0, 0, 0, 0, cache_len - t.shape[1])),
                  "kv_cache")


def _apply_mamba(cfg: ModelConfig, p, x, *, mode: str, cache, policy, route):
    """A Mamba layer: norm, the block, a residual, no FFN.  Its decode
    path takes any number of tokens (the conv and the scan carry a
    state), so prefill is decode from a zero state and extend is decode."""
    h = L.norm_apply(cfg, p.get("ln1", {}), x)
    if mode == "train":
        return x + L.mamba_apply_train(cfg, p["mamba"], h, policy,
                                       route), {}
    c = (cache["mamba"] if mode in ("decode", "extend")
         else L.init_mamba_cache(cfg, x.shape[0], cfg.compute_torch_dtype,
                                 device=x.device))
    y, c = L.mamba_apply_decode(cfg, p["mamba"], h, c, policy)
    return x + y, {"mamba": c}


def _apply_rec(cfg: ModelConfig, p, x, *, mode: str, cache, policy, route):
    """An RG-LRU layer: norm, the block, a residual, then norm, the FFN, a
    residual.  As for Mamba, prefill is decode from a zero state and
    extend is decode."""
    h = L.norm_apply(cfg, p.get("ln1", {}), x)
    new_cache = {}
    if mode == "train":
        y = L.rglru_apply_train(cfg, p["rec"], h, policy, route)
    else:
        c = (cache["rec"] if mode in ("decode", "extend")
             else L.init_rglru_cache(cfg, x.shape[0],
                                     cfg.compute_torch_dtype,
                                     device=x.device))
        y, new_cache["rec"] = L.rglru_apply_decode(cfg, p["rec"], h, c,
                                                   policy)
    x = x + y
    h2 = L.norm_apply(cfg, p.get("ln2", {}), x)
    return x + L.ffn_apply(cfg, p["ffn"], h2, policy), new_cache


# --------------------------------------------------------------------------
# stage execution (a loop over stacked repeats)
# --------------------------------------------------------------------------
def _matmuls_saved():
    """``remat_policy="dots"``: keep the weight products' outputs (mm:
    the matmuls with no batch dimension) and recompute everything else."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _run_stages(cfg: ModelConfig, stages_params, pattern_list, x, *, mode,
                positions, pos=None, caches=None, policy=L.NULL_POLICY,
                enc_out=None, causal=True, cache_len=0,
                route: str = "kernels"):
    """pattern_list: list of (pattern, repeats) matching stages_params.
    Returns (x, caches, aux): in decode/extend the given caches (written
    in place), in prefill new ones, in train None per stage; aux is the
    sum of the layers' MoE router losses in layer order (None without MoE
    layers).  ``route`` is "kernels" or "plain" (``layers.ROUTES``); in
    train mode on the plain route ``cfg.remat`` checkpoints each repeat."""
    if route not in L.ROUTES:
        raise ValueError(f"route {route!r} not in {L.ROUTES}")
    remat = cfg.remat and mode == "train" and route == "plain"
    new_caches = []
    total_aux = None
    for si, ((pattern, repeats), sp) in enumerate(
            zip(pattern_list, stages_params)):
        stage_cache = None if caches is None else caches[si]
        rep_caches = []
        for r in range(repeats):
            lp = _index(sp, r)
            lc = None if stage_cache is None else _index(stage_cache, r)

            def body(x, lp=lp, lc=lc, pattern=pattern):
                ncs, auxes = {}, []
                for j, kind in enumerate(pattern):
                    x, ncs[f"b{j}"], aux = apply_layer(
                        cfg, kind, lp[f"b{j}"], x, mode=mode,
                        positions=positions, pos=pos,
                        cache=None if lc is None else lc[f"b{j}"],
                        policy=policy, enc_out=enc_out, causal=causal,
                        cache_len=cache_len, route=route)
                    if aux is not None:
                        auxes.append(aux)
                return x, ncs, auxes

            if remat:
                x, ncs, auxes = torch.utils.checkpoint.checkpoint(
                    body, x, use_reentrant=False,
                    **({"context_fn": _matmuls_saved}
                       if cfg.remat_policy == "dots" else {}))
            else:
                x, ncs, auxes = body(x)
            for aux in auxes:
                total_aux = aux if total_aux is None else total_aux + aux
            rep_caches.append(ncs)
        if mode == "prefill":
            new_caches.append(_stack(rep_caches))
        else:
            new_caches.append(stage_cache)
    return x, new_caches, total_aux


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------
def _embed_tokens(cfg: ModelConfig, params, tokens, policy=L.NULL_POLICY):
    # token -1 (embed padding) takes row V-1 as jnp.take does; the pooling
    # mask of the embed step drops it
    table = params["embed"]
    tokens = tokens.remainder(table.shape[0])
    if isinstance(table, DTensor):
        x = sharding.embed_on_shards(table, tokens)
    else:
        x = table[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return policy(x.to(cfg.compute_torch_dtype), "act")


def _logits(cfg: ModelConfig, params, x, policy=L.NULL_POLICY):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return policy(logits.to(F32), "logits")


def _assemble_input(cfg: ModelConfig, params, batch, policy=L.NULL_POLICY):
    """Token embeddings, after the vision prefix where the batch has one:
    ``patches`` (B, P, d), cast to the compute dtype, in front of the
    tokens, as the JAX package does.  Positions run over the whole
    sequence, so the text starts at position P and the prefix is under the
    causal mask like any token.  Returns (x, positions)."""
    check_supported(cfg)
    x = _embed_tokens(cfg, params, batch["tokens"], policy)
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        x = policy(x, "act")
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def _run_encoder(cfg: ModelConfig, params, frames, route="kernels",
                 policy=L.NULL_POLICY):
    """The encoder over ``frames`` (B, encoder_seq, d): sinusoidal
    positions added in the compute dtype, its stages in train mode
    without the causal mask (flash attention on the kernels route, rope as
    in every attention layer), its final norm."""
    x = frames.to(cfg.compute_torch_dtype)
    x = x + _replicated_like(x, L.sinusoid_pos(x.shape[1], cfg.d_model,
                                               dtype=x.dtype,
                                               device=x.device))
    x = policy(x, "act")
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    enc = params["encoder"]
    x, _, _ = _run_stages(cfg, enc["stages"], list(cfg.encoder_stages()), x,
                          mode="train", positions=positions, policy=policy,
                          causal=False, route=route)
    return L.norm_apply(cfg, enc.get("final_norm", {}), x)


def _replicated_like(x, t):
    """``t``, a plain tensor held alike on every rank, as a replicated
    ``DTensor`` where ``x`` is one."""
    if isinstance(x, DTensor):
        return DTensor.from_local(t, x.device_mesh,
                                  [sharding.Replicate()] * x.device_mesh.ndim,
                                  run_check=False)
    return t


def _encoder_output(cfg: ModelConfig, params, batch, route="kernels",
                    policy=L.NULL_POLICY):
    """An encoder-decoder's encoder output over ``batch["frames"]`` (a
    ``KeyError`` without them, as in the JAX package), else None."""
    if not cfg.is_encoder_decoder:
        return None
    return _run_encoder(cfg, params, batch["frames"], route, policy)


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------
def forward_train(cfg: ModelConfig, params, batch, route: str = "kernels",
                  policy=L.NULL_POLICY):
    """Full-sequence teacher-forced forward. Returns (logits, aux); aux is
    the MoE layers' summed router loss, as the JAX package's, 0 for a
    stack without MoE layers.  ``route``: "kernels" or "plain" (the
    training route, which autograd can differentiate)."""
    enc_out = _encoder_output(cfg, params, batch, route, policy)
    x, positions = _assemble_input(cfg, params, batch, policy)
    x, _, aux = _run_stages(cfg, params["stages"], list(cfg.stages()), x,
                            mode="train", positions=positions, policy=policy,
                            enc_out=enc_out, route=route)
    x = L.norm_apply(cfg, params.get("final_norm", {}), x)
    if aux is None:
        aux = _replicated_like(x, torch.zeros((), dtype=F32,
                                              device=x.device))
    return _logits(cfg, params, x, policy), aux


def loss_fn(cfg: ModelConfig, params, batch, policy=L.NULL_POLICY):
    """Next-token cross-entropy over ``batch["labels"]`` (-1 ignored) plus
    ``router_aux_weight`` times the MoE router loss, as the JAX package's
    ``loss_fn``: a vision batch's prefix rows are dropped from the logits
    first, and the padded vocabulary (``shard_multiple`` > 1) is masked.
    Returns (total, {"loss", "aux_loss", "tokens"}).  The forward takes
    the plain route, the one autograd can differentiate.  Under a mesh the
    logits are gathered over the vocabulary (``sharding.unshard``) before
    the log-sum-exp."""
    logits, aux = forward_train(cfg, params, batch, route="plain",
                                policy=policy)
    labels = batch["labels"]
    if isinstance(logits, DTensor):
        logits = sharding.unshard(logits, 2)
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    if cfg.padded_vocab != cfg.vocab_size:
        mask_v = torch.arange(cfg.padded_vocab,
                              device=logits.device) < cfg.vocab_size
        logits = logits.masked_fill(~_replicated_like(logits, mask_v),
                                    float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    nll = ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)
    total = nll + cfg.router_aux_weight * aux
    return total, {"loss": nll, "aux_loss": aux, "tokens": mask.sum()}


def init_cache(cfg: ModelConfig, B: int, cache_len: int, device=None,
               mesh=None):
    """Zero cache matching the stage structure.  Over ``mesh`` (a
    ``ProcessMesh``) each leaf is a ``DTensor`` placed by
    ``sharding.cache_specs``, of which each rank makes only its shard."""
    check_supported(cfg)
    if mesh is not None:
        sharding.refuse_serving(cfg)
        return sharding.map_specs(
            lambda t, spec: sharding.zeros(t.shape, t.dtype, mesh, spec,
                                           device),
            init_cache(cfg, B, cache_len, "meta"),
            sharding.cache_specs(cfg, mesh, B))
    dt = cfg.compute_torch_dtype
    hd, KH = cfg.resolved_head_dim, cfg.padded_num_kv_heads

    def layer_cache(kind, repeats):
        if kind == "mamba":
            return {"mamba": L.init_mamba_cache(cfg, B, dt, (repeats,),
                                                device)}
        if kind == "rec":
            return {"rec": L.init_rglru_cache(cfg, B, dt, (repeats,),
                                              device)}
        shape = (repeats, B, cache_len, KH, hd)
        if cfg.kv_quant == "int8":
            scale = (*shape[:-1], 1)
            c = {"attn": {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, dtype=F32, device=device),
                "v_scale": torch.zeros(scale, dtype=F32, device=device)}}
        else:
            c = {"attn": {"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)}}
        if cfg.is_encoder_decoder:
            xs = (repeats, B, cfg.encoder_seq, KH, hd)
            c["xattn"] = {"k": torch.zeros(xs, dtype=dt, device=device),
                          "v": torch.zeros(xs, dtype=dt, device=device)}
        return c
    return [{f"b{j}": layer_cache(kind, repeats)
             for j, kind in enumerate(pattern)}
            for pattern, repeats in cfg.stages()]


def reset_recurrent_rows(cfg: ModelConfig, cache, row: int):
    """Zero one batch row of every recurrent cache leaf (the conv and ssm
    state of a Mamba layer, the conv and h state of an RG-LRU layer);
    attention caches are masked by position and stay, and so do an
    encoder-decoder's cross-attention keys and values (the slot's clip)."""
    for stage in cache:
        for block in stage.values():
            for kind in ("mamba", "rec"):
                for t in block.get(kind, {}).values():
                    t[:, row].zero_()


def _check_mesh(cfg: ModelConfig, policy):
    if isinstance(policy, sharding.MeshPolicy):
        sharding.refuse_serving(cfg)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, cache_len: int,
            policy=L.NULL_POLICY):
    """Process the prompt; returns (last-token logits, cache, next_pos).
    Under a mesh the cache's leaves are placed by ``sharding.cache_specs``
    (the sequence sharded)."""
    _check_mesh(cfg, policy)
    enc_out = _encoder_output(cfg, params, batch, policy=policy)
    x, positions = _assemble_input(cfg, params, batch, policy)
    x, caches, _ = _run_stages(cfg, params["stages"], list(cfg.stages()),
                               x, mode="prefill", positions=positions,
                               policy=policy, enc_out=enc_out,
                               cache_len=cache_len)
    x = L.norm_apply(cfg, params.get("final_norm", {}), x)
    logits = _logits(cfg, params, x[:, -1:], policy)
    return logits, caches, x.shape[1]


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, params, tokens, cache, off,
                  policy=L.NULL_POLICY):
    """Chunked prefill: extend the cache with C prompt tokens.  tokens:
    (B, C) int; off: int or (B,) tokens already cached.  Returns (logits
    (B, C, V), cache) — the cache given, written in place."""
    check_supported(cfg)
    _check_mesh(cfg, policy)
    x = _embed_tokens(cfg, params, tokens, policy)
    x, caches, _ = _run_stages(cfg, params["stages"], list(cfg.stages()),
                               x, mode="extend", positions=None, pos=off,
                               caches=cache, policy=policy)
    x = L.norm_apply(cfg, params.get("final_norm", {}), x)
    return _logits(cfg, params, x, policy), caches


@torch.no_grad()
def encode_for_cache(cfg: ModelConfig, params, frames, B: int,
                     cache_len: int, policy=L.NULL_POLICY):
    """Enc-dec: run the encoder over ``frames`` (B, encoder_seq, d) and
    return a fresh cache (on the frames' device) whose decoder layers hold
    the encoder's cross-attention keys and values, the self-attention
    cache zero (pos=0)."""
    cache = init_cache(cfg, B, cache_len, frames.device)
    enc_out = _run_encoder(cfg, params, frames, policy=policy)
    for (pattern, repeats), sp, sc in zip(cfg.stages(), params["stages"],
                                          cache):
        for r in range(repeats):
            for j, kind in enumerate(pattern):
                if kind in ATTN_KINDS:
                    ek, ev = L.encode_cross_kv(
                        cfg, _index(sp[f"b{j}"]["xattn"], r), enc_out,
                        policy)
                    sc[f"b{j}"]["xattn"]["k"][r] = ek
                    sc[f"b{j}"]["xattn"]["v"][r] = ev
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, tokens, cache, pos,
                policy=L.NULL_POLICY):
    """One decode step.  tokens: (B, 1) int; pos: int or (B,) position of
    this token.  Returns (logits (B, 1, V), cache) — the cache given,
    written in place."""
    check_supported(cfg)
    _check_mesh(cfg, policy)
    x = _embed_tokens(cfg, params, tokens, policy)
    pos = L.positions_vector(pos, x.shape[0], x.device)
    x, caches, _ = _run_stages(cfg, params["stages"], list(cfg.stages()),
                               x, mode="decode", positions=None, pos=pos,
                               caches=cache, policy=policy)
    x = L.norm_apply(cfg, params.get("final_norm", {}), x)
    return _logits(cfg, params, x, policy), caches
