"""Model providers: the execution backends behind MODEL resources.

FlockMTL calls OpenAI/Azure/Ollama over HTTP; the port's providers are:

  * MockProvider     — deterministic, dependency-free; unit tests and the
                       interactive demo.  Supports pluggable "behaviours" so
                       semantic functions return sensible values.
  * LocalTorchProvider — a ported architecture (byte-level tokenizer)
                         served through ``repro_torch.serving`` on the GPU;
                         random weights unless a checkpoint or parameters
                         are given, so
                         outputs are structurally real (true prefill and
                         decode) but not semantically meaningful.

Providers enforce the context window: requests above it raise
ContextOverflowError, which drives the adaptive batcher's 10% backoff.

A copy of ``repro/core/provider.py``: ``BaseProvider`` and
``MockProvider`` are bit-identical in hashing and row shapes.  Deliberate
difference: ``LocalTorchProvider`` stands where the reference has
``LocalJaxProvider``, and takes ``device`` and ``params`` beside
``checkpoint``.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from .batching import ContextOverflowError
from .metaprompt import MetaPrompt
from .resources import ModelResource

TOKENS_PER_CHAR = 0.33


def estimate_tokens(text: str) -> int:
    return int(len(text) * TOKENS_PER_CHAR) + 1


@dataclass
class ProviderStats:
    """Aggregate provider counters.  The scheduler executes requests from
    a thread pool, so every mutation goes through ``add`` (one lock per
    provider); bare ``+=`` on the fields from worker threads would drop
    updates under concurrency."""
    calls: int = 0
    prompt_tokens: int = 0
    output_tokens: int = 0
    latency_s: float = 0.0

    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, calls: int = 0, prompt_tokens: int = 0,
            output_tokens: int = 0, latency_s: float = 0.0):
        with self._lock:
            self.calls += calls
            self.prompt_tokens += prompt_tokens
            self.output_tokens += output_tokens
            self.latency_s += latency_s

    def snapshot(self) -> dict:
        with self._lock:
            return {"calls": self.calls,
                    "prompt_tokens": self.prompt_tokens,
                    "output_tokens": self.output_tokens,
                    "latency_s": self.latency_s}


class BaseProvider:
    def __init__(self):
        self.stats = ProviderStats()

    # ---- protocol --------------------------------------------------------
    def complete(self, model: ModelResource, mp: MetaPrompt,
                 n_rows: int) -> List[str]:
        """Run one batched chat-completion; returns per-row raw lines
        (map functions) or a single-element list (reduce functions)."""
        raise NotImplementedError

    def embed(self, model: ModelResource,
              texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    # ---- shared checks -----------------------------------------------------
    def _check_context(self, model: ModelResource, mp: MetaPrompt,
                       n_rows: int):
        need = estimate_tokens(mp.text) + model.max_output_tokens * max(
            n_rows, 1)
        if need > model.context_window:
            raise ContextOverflowError(
                f"{need} tokens > context window {model.context_window}")


class MockProvider(BaseProvider):
    """Deterministic provider: hash-seeded answers, optional behaviours.

    behaviour: fn(function_kind, prompt_text, rows) -> list[str] | None.
    When it returns None the default hash-based answer is used.
    """

    def __init__(self, behaviour: Optional[Callable] = None,
                 latency_per_call_s: float = 0.0,
                 latency_per_token_s: float = 0.0):
        super().__init__()
        self.behaviour = behaviour
        self.latency_per_call_s = latency_per_call_s
        self.latency_per_token_s = latency_per_token_s

    _ID_RE = re.compile(r'\s*(?:id="\d+"|"id":\s*\d+,?|^\|\s*\d+\s)')

    @classmethod
    def _h(cls, text: str) -> int:
        # hash CONTENT only (strip the per-batch row id) so the same tuple
        # gets the same answer regardless of its position in a batch —
        # keeps dedup/cache semantics testable
        return int.from_bytes(
            hashlib.sha256(cls._ID_RE.sub("", text).encode()).digest()[:8],
            "big")

    _MULTI_TASK_RE = re.compile(
        r"\bt(\d+) \[(filter|complete|complete_json)\]")

    def _default_rows(self, mp: MetaPrompt, rows: List[str]) -> List[str]:
        fn = mp.function
        out = []
        if fn == "multi":
            # fused pass: answer every sub-task declared in the prefix with
            # the same content-hash scheme the single-task kinds use
            tasks = self._MULTI_TASK_RE.findall(mp.prefix)
            for i, r in enumerate(rows):
                obj = {}
                for tag, kind in tasks:
                    h = self._h(r + mp.prefix + tag)
                    if kind == "filter":
                        obj[f"t{tag}"] = h % 2 == 0
                    elif kind == "complete_json":
                        obj[f"t{tag}"] = {"value": f"v{h % 10_000}"}
                    else:
                        obj[f"t{tag}"] = f"text-{h % 10_000}"
                out.append(f"{i}: {json.dumps(obj)}")
            return out
        if fn in ("reduce", "reduce_json"):
            h = self._h(mp.text)
            return [json.dumps({"summary": f"agg-{h % 10_000}"})
                    if fn == "reduce_json" else f"summary-{h % 10_000}"]
        if fn == "rerank":
            idx = list(range(len(rows)))
            idx.sort(key=lambda i: self._h(rows[i] + mp.prefix))
            return [",".join(map(str, idx))]
        for i, r in enumerate(rows):
            h = self._h(r + mp.prefix)
            if fn == "filter":
                out.append(f"{i}: {'true' if h % 2 == 0 else 'false'}")
            elif fn == "complete_json":
                out.append(f'{i}: {{"value": "v{h % 10_000}"}}')
            else:
                out.append(f"{i}: text-{h % 10_000}")
        return out

    def complete(self, model, mp, n_rows):
        self._check_context(model, mp, n_rows)
        rows = [ln for ln in mp.suffix.splitlines()
                if ln and not ln.startswith("#")][:n_rows]
        rows += [""] * (n_rows - len(rows))
        t0 = time.monotonic()
        out = None
        if self.behaviour is not None:
            out = self.behaviour(mp.function, mp.prefix, rows)
        if out is None:
            out = self._default_rows(mp, rows)
        # simulated service latency: per-call overhead + per-token decode
        sim = self.latency_per_call_s + self.latency_per_token_s * (
            estimate_tokens(mp.text) + model.max_output_tokens * n_rows)
        if sim:
            time.sleep(min(sim, 1.0))
        self.stats.add(calls=1, prompt_tokens=estimate_tokens(mp.text),
                       output_tokens=sum(estimate_tokens(o) for o in out),
                       latency_s=time.monotonic() - t0)
        return out

    def embed(self, model, texts):
        t0 = time.monotonic()
        dim = model.embedding_dim or 64
        out = np.zeros((len(texts), dim), np.float32)
        for i, t in enumerate(texts):
            rng = np.random.default_rng(self._h(t) % (2 ** 32))
            v = rng.standard_normal(dim)
            out[i] = v / np.linalg.norm(v)
        # same simulated service latency regime as complete(): embeds
        # are provider round-trips too (retrieval overlap benchmarks
        # depend on the embed wave costing real wall-clock)
        sim = self.latency_per_call_s + self.latency_per_token_s * sum(
            estimate_tokens(t) for t in texts)
        if sim:
            time.sleep(min(sim, 1.0))
        self.stats.add(calls=1, latency_s=time.monotonic() - t0)
        return out


class LocalTorchProvider(BaseProvider):
    """Serve a ported architecture with the ``repro_torch.serving`` engine.

    Byte-level tokenizer (token id == byte value; ids < 256) keeps the
    provider independent of any external vocabulary.  Generation is
    greedy.  ``device=None`` serves on the GPU and raises without one;
    the weights come from ``checkpoint`` (a ``CheckpointManager``
    directory, as for ``LocalJaxProvider``) or ``params``
    (``repro_torch.params``), else they are drawn from a fixed seed.  An encoder-decoder (whisper-base) completes
    text against its engine's zero cross-attention cache and cannot embed
    (``KeyError: 'frames'``), as ``LocalJaxProvider`` (ROADMAP.md, C.15);
    audio is served through ``engine.cache`` (``serving/engine.py``).  A
    vision model (phi-3-vision-4.2b) completes and embeds text only, as
    ``LocalJaxProvider`` does (ROADMAP.md, C.16); an image reaches the
    model only through its entry points (``serving/engine.py``).
    """

    def __init__(self, arch: str = "olmo-1b", *, use_smoke_config=True,
                 checkpoint: Optional[str] = None, max_context: int = 2048,
                 device=None, params=None):
        super().__init__()
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.serving.engine import ServingEngine
        cfg = (get_smoke_config(arch) if use_smoke_config
               else get_config(arch))
        self.engine = ServingEngine(cfg, checkpoint=checkpoint,
                                    max_context=max_context, device=device,
                                    params=params)
        # the serving engine mutates shared decode state (slots, pos, KV
        # cache); scheduler worker threads must take turns.  Concurrency
        # for this provider comes from the engine's own continuous
        # batching, not from overlapped calls.
        self._engine_lock = threading.Lock()

    @staticmethod
    def _tokenize(text: str, vocab: int) -> list[int]:
        return [b % vocab for b in text.encode()]

    @staticmethod
    def _detokenize(toks) -> str:
        return bytes(int(t) % 256 for t in toks).decode("latin1")

    def complete(self, model, mp, n_rows):
        self._check_context(model, mp, n_rows)
        t0 = time.monotonic()
        vocab = self.engine.cfg.vocab_size
        prompt = self._tokenize(mp.text, vocab)
        max_new = min(model.max_output_tokens * max(n_rows, 1), 64)
        with self._engine_lock:
            toks = self.engine.generate(prompt, max_new_tokens=max_new)
        text = self._detokenize(toks)
        self.stats.add(calls=1, prompt_tokens=len(prompt),
                       output_tokens=len(toks),
                       latency_s=time.monotonic() - t0)
        # random weights produce uninterpretable bytes; wrap them in the
        # contract shape so downstream parsing stays exercised end-to-end
        return [f"{i}: {text[:32]!r}" for i in range(n_rows)] \
            if mp.function in ("complete", "complete_json", "filter",
                               "multi") \
            else [text[:64]]

    def embed(self, model, texts):
        vocab = self.engine.cfg.vocab_size
        with self._engine_lock:
            out = self.engine.embed_batch(
                [self._tokenize(t, vocab) for t in texts])
        self.stats.add(calls=1)
        return out
