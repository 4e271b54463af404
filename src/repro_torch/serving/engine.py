"""Continuous-batching serving engine (the runtime behind
LocalTorchProvider); port of ``repro/serving/engine.py``.

Design (vLLM-style):
  * a fixed number of decode SLOTS; each slot owns one row of the batched
    cache (B = n_slots);
  * prompts enter through CHUNKED PREFILL (prefill_chunk, Sarathi-style):
    whole chunks of ``chunk`` tokens, the remainder token by token through
    the decode step;
  * every engine step decodes all active slots at their own positions
    (per-row ``pos`` vector, copied to the device once per step);
  * finished requests free their slot; waiting requests are admitted FCFS.

Unlike the JAX engine, which runs a prefill chunk over every slot and then
keeps only the working slot's rows of the returned cache, a chunk here runs
on the working slot's row alone and writes its cache rows in place; the
other slots' rows are never touched.

A slot's recurrent state (the ``conv`` and ``ssm`` leaves of a Mamba
layer's cache, the ``conv`` and ``h`` leaves of an RG-LRU layer's) is
zeroed when a request is admitted to it: the previous
occupant's state, and whatever idle decode steps added to it, would
otherwise carry into the new request.  A KV cache needs no reset: its
stale rows lie past the new request's positions and are masked.  (The
JAX engine does not reset it; ROADMAP.md, queue C.)

An encoder-decoder (whisper-base) is served as the JAX engine serves it.
The cache starts with zero cross-attention keys and values, so a text
request's cross-attention adds nothing, and ``embed_batch``, whose
requests carry no frames, raises ``KeyError: 'frames'`` (ROADMAP.md,
C.15).  To serve requests over audio, put ``models.model.encode_for_cache(
cfg, params, frames, n_slots, max_context)`` in ``engine.cache`` before
submitting: slot i then holds clip i for every request admitted to it
(admission resets only recurrent rows).  The engine takes no frames of
its own, as the JAX engine takes none.

A vision model (phi-3-vision-4.2b) is served as text, as the JAX engine
serves it: requests and ``embed_batch`` carry tokens alone, so generation
and embeddings run over the text without an image prefix (ROADMAP.md,
C.16).  A request over an image goes through the model's entry points:
``models.model.prefill`` over ``{"tokens", "patches"}``, then
``decode_step`` from its ``next_pos`` (P + S), or the embed step
(``serving.steps.make_embed_step``) over such a batch.  The engine takes
no patches, as the JAX engine takes none.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.params import init_params
from repro_torch.serving.steps import make_embed_step


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_token: int = -1              # -1: never stop early
    generated: List[int] = field(default_factory=list)
    # wall-clock arrival timestamp  # flocklint: ignore[FLKL101]
    submitted_at: float = field(default_factory=time.time)
    finished: bool = False
    slot: int = -1
    pos: int = 0                     # tokens of this request already cached
    pending_prompt: int = 0          # prompt tokens not yet prefilled


class ServingEngine:
    """``device=None`` serves on the GPU (and raises without one).
    ``checkpoint`` is a ``CheckpointManager`` directory, written by either
    package: the latest checkpoint's ``["params"]`` are restored onto the
    engine's device, as the JAX engine restores them (a non-parametric
    norm's empty subtree is not in the file, and the model reads it as
    empty).  Else ``params`` are the port's parameters
    (``repro_torch.params``: carried over from JAX, or drawn); without
    either, weights are drawn from ``seed``.  The model's serving entry
    points and the embed step compute under ``torch.no_grad()``: serving
    needs no gradient, and the kernels have no backward."""

    def __init__(self, cfg: ModelConfig, *, n_slots: int = 4,
                 max_context: int = 2048, chunk: int = 32,
                 checkpoint: Optional[str] = None, seed: int = 0,
                 device=None, params=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_context = max_context
        self.chunk = chunk
        if checkpoint:
            from repro_torch.training.checkpoint import CheckpointManager
            state = CheckpointManager(checkpoint).restore_latest(
                self.device)
            if state is None:
                raise FileNotFoundError(f"no checkpoint in {checkpoint}")
            self.params = state["params"]
        elif params is not None:
            self.params = params
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = init_params(cfg, gen, self.device)
        self.cache = M.init_cache(cfg, n_slots, max_context, self.device)
        self._rid = itertools.count()
        self.waiting: List[Request] = []
        self.active: List[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)
        self.cur_tok = np.zeros(n_slots, np.int32)
        self.steps = 0
        self._embed = make_embed_step(cfg)

    # ------------------------------------------------------------------ API
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_token: int = -1) -> Request:
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_token=eos_token)
        req.pending_prompt = len(req.prompt)
        self.waiting.append(req)
        return req

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 32,
                 eos_token: int = -1) -> List[int]:
        req = self.submit(prompt, max_new_tokens, eos_token)
        while not req.finished:
            self.step()
        return req.generated

    def run_until_idle(self, max_steps: int = 100_000):
        while (self.waiting or any(self.active)) and max_steps:
            self.step()
            max_steps -= 1

    # ----------------------------------------------------------------- step
    def _admit(self):
        for slot in range(self.n_slots):
            if self.active[slot] is None and self.waiting:
                req = self.waiting.pop(0)
                if len(req.prompt) + req.max_new_tokens > self.max_context:
                    req.finished = True      # reject: cannot fit
                    continue
                req.slot = slot
                req.pos = 0
                M.reset_recurrent_rows(self.cfg, self.cache, slot)
                self.active[slot] = req

    def _slot_cache(self, slot: int):
        """The cache rows of one slot, as views that share its memory."""
        def rows(tree):
            if isinstance(tree, dict):
                return {k: rows(v) for k, v in tree.items()}
            return tree[:, slot:slot + 1]
        return [rows(stage) for stage in self.cache]

    def _prefill_work(self):
        """Advance chunked prefill for one slot still consuming its prompt."""
        for slot, req in enumerate(self.active):
            # keep >=1 prompt token for the decode path so the first
            # generated token comes from real last-token logits
            if req is None or req.pending_prompt <= self.chunk:
                continue
            start = len(req.prompt) - req.pending_prompt
            toks = torch.tensor([req.prompt[start:start + self.chunk]],
                                dtype=torch.int32, device=self.device)
            M.prefill_chunk(self.cfg, self.params, toks,
                            self._slot_cache(slot), int(self.pos[slot]))
            req.pos += self.chunk
            self.pos[slot] += self.chunk
            req.pending_prompt -= self.chunk
            return True      # one chunk per engine step keeps latency fair
        return False

    def step(self):
        self._admit()
        self.steps += 1
        if self._prefill_work():
            return
        # build the decode batch: remaining prompt tokens are fed one at a
        # time (teacher forcing); slots past their prompt sample greedily
        any_active = False
        toks = np.zeros((self.n_slots, 1), np.int32)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            any_active = True
            if req.pending_prompt > 0:
                idx = len(req.prompt) - req.pending_prompt
                toks[slot, 0] = req.prompt[idx]
            else:
                toks[slot, 0] = self.cur_tok[slot]
        if not any_active:
            return
        pos_vec = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = M.decode_step(
            self.cfg, self.params, torch.from_numpy(toks).to(self.device),
            self.cache, pos_vec)
        nxt = _mask_vocab(self.cfg, logits[:, 0]).argmax(dim=-1).to(
            torch.int32).cpu().numpy()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[slot] += 1
            req.pos += 1
            if req.pending_prompt > 0:
                req.pending_prompt -= 1
                if req.pending_prompt == 0:
                    self.cur_tok[slot] = nxt[slot]
                    req.generated.append(int(nxt[slot]))
            else:
                self.cur_tok[slot] = nxt[slot]
                req.generated.append(int(nxt[slot]))
            done = (len(req.generated) >= req.max_new_tokens
                    or (req.eos_token >= 0 and req.generated
                        and req.generated[-1] == req.eos_token)
                    or req.pos >= self.max_context - 1)
            if done and req.pending_prompt == 0:
                req.finished = True
                self.active[slot] = None
                self.pos[slot] = 0
                self.cur_tok[slot] = 0

    # ---------------------------------------------------------------- embed
    def embed(self, tokens: Sequence[int]) -> np.ndarray:
        """Mean-pooled hidden state (llm_embedding backend)."""
        return self.embed_batch([tokens])[0]

    def embed_batch(self, token_lists) -> np.ndarray:
        """One padded forward for N texts, padded with token -1 to a
        power-of-two length of at least 32."""
        longest = max((len(t) for t in token_lists), default=1)
        L = 1 << max(5, (max(longest, 1) - 1).bit_length())
        toks = np.full((len(token_lists), L), -1, np.int32)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        emb = self._embed(self.params,
                          {"tokens": torch.from_numpy(toks).to(self.device)})
        return emb.cpu().numpy()


def _mask_vocab(cfg, logits):
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab,
                            device=logits.device) < cfg.vocab_size
        return logits.masked_fill(~mask, float("-inf"))
    return logits
