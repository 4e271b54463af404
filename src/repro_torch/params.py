"""Model weights for the port: a seeded draw, weights carried over from
the JAX package, and the reader of its ``.npz`` checkpoints.

The port keeps the JAX package's parameter pytree (nested dicts, stacked
per stage, see ``models/model.py``) with ``torch.Tensor`` leaves.
``jax.random`` and ``torch`` draw different numbers from one seed, so the
parity tests carry the JAX weights across with ``from_jax``; ``init_params``
is the port's own draw at the same shapes and scales, for runs without
JAX.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported


def _init_layer(cfg: ModelConfig, kind: str, generator, reps: int, device,
                cross: bool = False):
    """One layer's weights, stacked over ``reps`` repeats (the JAX
    package's ``_init_layer`` keys); an attention layer of an
    encoder-decoder's decoder (``cross``) adds ``ln_x`` and ``xattn``."""
    d = cfg.d_model
    p = {"ln1": L.init_norm(cfg, d, (reps,), device)}
    if kind == "mamba":
        p["mamba"] = L.init_mamba(cfg, generator, (reps,), device)
        return p
    if kind == "rec":
        p["rec"] = L.init_rglru(cfg, generator, (reps,), device)
    else:
        p["attn"] = L.init_attention(cfg, generator, (reps,), device)
        if cross:
            p["ln_x"] = L.init_norm(cfg, d, (reps,), device)
            p["xattn"] = L.init_attention(cfg, generator, (reps,), device,
                                          cross=True)
    p["ln2"] = L.init_norm(cfg, d, (reps,), device)
    if kind != "rec" and cfg.num_experts:
        p["moe"] = L.init_moe(cfg, generator, (reps,), device)
    else:
        p["ffn"] = L.init_ffn(cfg, generator, (reps,), device)
    return p


def _init_stages(cfg: ModelConfig, stages, generator, device, cross: bool):
    return [{f"b{j}": _init_layer(cfg, kind, generator, reps, device, cross)
             for j, kind in enumerate(pattern)}
            for pattern, reps in stages]


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Weights at the JAX init's shapes and scales (N(0, 1) times
    fan-in^-0.5, cast to ``param_dtype``; the JAX init's constants where
    it has them), drawn from ``generator``, which must live on
    ``device``.  An encoder-decoder adds ``{"encoder": {"stages",
    "final_norm"}}`` and cross-attention in each decoder layer."""
    check_supported(cfg)
    Vp, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": L.normal_init((Vp, d), d ** -0.5, cfg.param_torch_dtype,
                           generator, device),
        "final_norm": L.init_norm(cfg, d, device=device),
        "stages": _init_stages(cfg, cfg.stages(), generator, device,
                               cross=cfg.is_encoder_decoder),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal_init((d, Vp), d ** -0.5,
                                      cfg.param_torch_dtype, generator,
                                      device)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "stages": _init_stages(cfg, cfg.encoder_stages(), generator,
                                   device, cross=False),
            "final_norm": L.init_norm(cfg, d, device=device),
        }
    return params


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # bf16 crosses as its bit pattern (numpy has no bfloat16 of its own)
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def from_jax(tree, device="cpu"):
    """The port's parameters from a JAX parameter pytree whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, params)``): the same nested
    structure and stacked per-stage layout, with tensor leaves."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax(v, device) for v in tree]
    return _tensor(tree, device)


# --------------------------------------------------------------------------
# CheckpointManager .npz format (repro/training/checkpoint.py)
# --------------------------------------------------------------------------
def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def normalize(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [normalize(node[str(i)]) for i in range(len(keys))]
        return {k: normalize(v) for k, v in node.items()}

    return normalize(root)


def load_checkpoint(path, device="cpu", place=None):
    """Read one ``step_*.npz`` checkpoint with numpy alone: flattened key
    paths, bf16 stored as a uint16 view and named in ``__dtypes__``.  bf16
    becomes ``torch.bfloat16`` by reinterpreting the bits.  Returns the
    saved tree (params, optimizer state, ...) with tensor leaves on
    ``device``, or ``place(key, host tensor)`` of each, read one at a
    time."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        dtypes = {}
        if "__dtypes__" in z.files:
            dtypes = json.loads(z["__dtypes__"].tobytes().decode())
        for key in z.files:
            if key == "__dtypes__":
                continue
            arr = z[key]                  # a fresh array: no copy needed
            if dtypes.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out[key] = t.to(device) if place is None else place(key, t)
            del arr, t
    return _unflatten(out)
