"""Model providers of the port: the execution backend behind a MODEL
resource (port of ``repro/core/provider.py``).

  * LocalTorchProvider — a ported architecture (byte-level tokenizer)
                         served through ``repro_torch.serving`` on the GPU;
                         random weights unless parameters are given, so
                         outputs are structurally real (true prefill and
                         decode) but not semantically meaningful.

Providers enforce the context window: requests above it raise
ContextOverflowError, which drives the adaptive batcher's 10% backoff.
``MockProvider`` and the plan layer that drives providers are the next
slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from .batching import ContextOverflowError
from .metaprompt import MetaPrompt
from .resources import ModelResource

TOKENS_PER_CHAR = 0.33


def estimate_tokens(text: str) -> int:
    return int(len(text) * TOKENS_PER_CHAR) + 1


@dataclass
class ProviderStats:
    """Aggregate provider counters.  Every mutation goes through ``add``
    (one lock per provider) so concurrent callers never drop updates."""
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


class LocalTorchProvider(BaseProvider):
    """Serve a ported architecture with the ``repro_torch.serving`` engine.

    Byte-level tokenizer (token id == byte value; ids < 256) keeps the
    provider independent of any external vocabulary.  Generation is
    greedy.  ``device=None`` serves on the GPU and raises without one;
    ``params`` (``repro_torch.params``) give the weights, else they are
    drawn from a fixed seed.
    """

    def __init__(self, arch: str = "olmo-1b", *, use_smoke_config=True,
                 max_context: int = 2048, device=None, params=None):
        super().__init__()
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.serving.engine import ServingEngine
        cfg = (get_smoke_config(arch) if use_smoke_config
               else get_config(arch))
        self.engine = ServingEngine(cfg, max_context=max_context,
                                    device=device, params=params)
        # the serving engine mutates shared decode state (slots, pos, KV
        # cache); concurrent callers take turns.  Concurrency for this
        # provider comes from the engine's own continuous batching.
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
