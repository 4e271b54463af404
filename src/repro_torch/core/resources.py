"""The MODEL resource (the part of ``repro/core/resources.py`` that the
provider reads): a versioned, immutable description of a served model."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelResource:
    name: str
    version: int
    arch: str                       # a ported arch (see repro_torch.configs)
    provider: str = "local-torch"
    context_window: int = 4096
    max_output_tokens: int = 256
    temperature: float = 0.0
    embedding_dim: int = 0          # 0 -> arch d_model
    max_concurrency: int = 4        # in-flight request cap
    scope: str = "local"
    created_at: float = 0.0
    deleted: bool = False

    @property
    def ref(self) -> str:
        return f"{self.name}@{self.version}"
