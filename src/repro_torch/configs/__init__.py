"""Architecture config registry: ``get_config(arch)`` / ``list_archs()``.

Every architecture of the JAX package is ported: olmo-1b,
falcon-mamba-7b, recurrentgemma-9b, granite-8b, gemma3-12b, qwen1.5-32b,
deepseek-moe-16b, mixtral-8x7b, whisper-base and phi-3-vision-4.2b.
``NOT_YET_PORTED`` names the JAX package's architectures that the port
does not serve yet (none now); looking one up raises a ``KeyError`` that
says so, an unknown name a ``KeyError`` that lists the ported ones.
"""

from __future__ import annotations

import importlib

_ARCHS = {
    "olmo-1b": "olmo_1b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-8b": "granite_8b",
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-32b": "qwen15_32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-base": "whisper_base",
    "phi-3-vision-4.2b": "phi3_vision",
}

# architectures of the JAX package that the port does not serve yet
NOT_YET_PORTED: tuple = ()


def list_archs():
    return list(_ARCHS)


def _mod(arch: str):
    if arch not in _ARCHS:
        if arch in NOT_YET_PORTED:
            raise KeyError(f"arch {arch!r} is not yet ported to PyTorch "
                           f"(see ROADMAP.md); ported: {list(_ARCHS)}")
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")


def get_config(arch: str, *, shard_multiple: int = 1):
    cfg = _mod(arch).CONFIG
    return cfg.replace(shard_multiple=shard_multiple) if shard_multiple > 1 \
        else cfg


def get_smoke_config(arch: str):
    return _mod(arch).SMOKE
