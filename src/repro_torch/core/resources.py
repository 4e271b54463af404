"""MODEL and PROMPT as first-class, versioned schema objects (paper §2.1).

Mirrors FlockMTL's DDL:

    CREATE GLOBAL MODEL('model-relevance-check', 'gpt-4o-mini', 'openai')
    CREATE PROMPT('joins-prompt', 'is related to join algos given abstract')

becomes

    catalog.create_model("model-relevance-check", arch="olmo-1b",
                         scope="global", context_window=4096)
    catalog.create_prompt("joins-prompt",
                          "is related to join algos given abstract")

Resources are versioned: updating creates a new version, previous versions
stay addressable (``name@2``); the latest is used by default.  GLOBAL
resources live in a machine-level catalog shared across databases, LOCAL
ones in the current database's catalog — resolution order LOCAL, then
GLOBAL (as in FlockMTL).

A copy of ``repro/core/resources.py``.  Deliberate difference:
``ModelResource.provider`` defaults to ``"local-torch"`` (the reference's
is ``"local-jax"``), so a persisted catalog differs in that one field.
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional


@dataclass(frozen=True)
class ModelResource:
    name: str
    version: int
    arch: str                       # a ported arch (or "mock")
    provider: str = "local-torch"   # local-torch | mock
    context_window: int = 4096
    max_output_tokens: int = 256
    temperature: float = 0.0
    embedding_dim: int = 0          # 0 -> arch d_model
    max_concurrency: int = 4        # scheduler: in-flight request cap
    scope: str = "local"
    created_at: float = 0.0
    deleted: bool = False

    @property
    def ref(self) -> str:
        return f"{self.name}@{self.version}"


@dataclass(frozen=True)
class PromptResource:
    name: str
    version: int
    text: str
    scope: str = "local"
    created_at: float = 0.0
    deleted: bool = False

    @property
    def ref(self) -> str:
        return f"{self.name}@{self.version}"


_REF_RE = re.compile(r"^(.*?)(?:@(\d+))?$")


class _Registry:
    def __init__(self):
        self._versions: dict[str, list] = {}

    def create(self, res):
        self._versions.setdefault(res.name, []).append(res)

    def next_version(self, name: str) -> int:
        return len(self._versions.get(name, [])) + 1

    def get(self, ref: str):
        m = _REF_RE.match(ref)
        name, ver = m.group(1), m.group(2)
        if name not in self._versions:
            return None
        versions = self._versions[name]
        if ver is None:
            live = [r for r in versions if not r.deleted]
            return live[-1] if live else None
        i = int(ver) - 1
        return versions[i] if 0 <= i < len(versions) else None

    def delete(self, name: str):
        if name in self._versions:
            self._versions[name] = [
                type(r)(**{**asdict(r), "deleted": True})
                for r in self._versions[name]]

    def all(self):
        return {n: list(v) for n, v in self._versions.items()}


class Catalog:
    """LOCAL (per-database) + GLOBAL (per-machine) resource catalogs."""

    _global_models = _Registry()
    _global_prompts = _Registry()
    _global_lock = threading.Lock()

    def __init__(self, path: Optional[str] = None):
        self._models = _Registry()
        self._prompts = _Registry()
        self._lock = threading.Lock()
        self._path = Path(path) if path else None
        if self._path and self._path.exists():
            self._load()

    # ----- DDL ------------------------------------------------------------
    def create_model(self, name: str, arch: str, *, scope: str = "local",
                     **kw) -> ModelResource:
        reg = self._global_models if scope == "global" else self._models
        lock = self._global_lock if scope == "global" else self._lock
        with lock:
            res = ModelResource(name=name, version=reg.next_version(name),
                                arch=arch, scope=scope,
                                # wall-clock catalog timestamp
                                # flocklint: ignore[FLKL101]
                                created_at=time.time(), **kw)
            reg.create(res)
        self._persist()
        return res

    def create_prompt(self, name: str, text: str, *,
                      scope: str = "local") -> PromptResource:
        reg = self._global_prompts if scope == "global" else self._prompts
        lock = self._global_lock if scope == "global" else self._lock
        with lock:
            res = PromptResource(name=name, version=reg.next_version(name),
                                 text=text, scope=scope,
                                 # wall-clock catalog timestamp
                                 # flocklint: ignore[FLKL101]
                                 created_at=time.time())
            reg.create(res)
        self._persist()
        return res

    def update_model(self, name: str, **changes) -> ModelResource:
        cur = self.get_model(name)
        if cur is None:
            raise KeyError(f"no MODEL named {name!r}")
        kw = {**asdict(cur), **changes}
        for drop in ("version", "created_at", "deleted"):
            kw.pop(drop, None)
        scope = kw.pop("scope", cur.scope)
        return self.create_model(kw.pop("name"), kw.pop("arch"),
                                 scope=scope, **kw)

    def update_prompt(self, name: str, text: str) -> PromptResource:
        cur = self.get_prompt(name)
        if cur is None:
            raise KeyError(f"no PROMPT named {name!r}")
        return self.create_prompt(name, text, scope=cur.scope)

    def delete_model(self, name: str):
        self._models.delete(name)
        with self._global_lock:
            self._global_models.delete(name)
        self._persist()

    def delete_prompt(self, name: str):
        self._prompts.delete(name)
        with self._global_lock:
            self._global_prompts.delete(name)
        self._persist()

    # ----- resolution (LOCAL shadows GLOBAL, like FlockMTL) ----------------
    def get_model(self, ref: str) -> Optional[ModelResource]:
        return self._models.get(ref) or self._global_models.get(ref)

    def get_prompt(self, ref: str) -> Optional[PromptResource]:
        return self._prompts.get(ref) or self._global_prompts.get(ref)

    # ----- persistence ------------------------------------------------------
    def _persist(self):
        if not self._path:
            return
        data = {
            "models": {n: [asdict(r) for r in v]
                       for n, v in self._models.all().items()},
            "prompts": {n: [asdict(r) for r in v]
                        for n, v in self._prompts.all().items()},
        }
        # full-name staging (path.name + ".tmp"): .with_suffix would
        # collide for multi-dot paths — see cache._tmp_path
        from .cache import _tmp_path
        tmp = _tmp_path(self._path)
        tmp.write_text(json.dumps(data, indent=1))
        tmp.replace(self._path)

    def _load(self):
        data = json.loads(self._path.read_text())
        for versions in data.get("models", {}).values():
            for r in versions:
                self._models.create(ModelResource(**r))
        for versions in data.get("prompts", {}).values():
            for r in versions:
                self._prompts.create(PromptResource(**r))


# convenience: reset GLOBAL state (tests)
def reset_global_catalog():
    Catalog._global_models = _Registry()
    Catalog._global_prompts = _Registry()
