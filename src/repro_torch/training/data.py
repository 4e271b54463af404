"""Deterministic, resumable synthetic data pipeline.

Token streams are generated from a counter-based RNG keyed on
(seed, step, host), so:
  * RESUMABLE: after restart the pipeline regenerates exactly the batch for
    any step — no iterator state to checkpoint beyond the step counter;
  * ELASTIC: per-host shards are a pure function of (step, host_index,
    n_hosts); changing the host count re-partitions the same global stream;
  * STRAGGLER-AWARE: ``StragglerWatchdog`` tracks per-step wall time and
    flags hosts whose step time exceeds ``threshold``x the running median
    (on real fleets this feeds the scheduler's replacement logic; here it
    feeds metrics and the fault-tolerance test).

Documents are sampled from a mixture of Zipfian token draws and repeated
phrase templates so batches have realistic repetition for the dedup/cache
benchmarks (and non-trivial loss curves for the training example).

Port of ``repro/training/data.py``: the same numpy code, so a batch is
bitwise the JAX package's for the same (config, step, host).  Batches
are numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    pad_id: int = -1


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def batch_at(self, step: int) -> dict:
        """Global-deterministic batch for ``step`` (this host's shard)."""
        cfg = self.cfg
        rows = []
        base = self.host_index * self.local_batch
        for r in range(self.local_batch):
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 65_537 + base + r)
            # zipf-distributed ids clipped to vocab, plus a motif: repeat a
            # short random phrase so sequences are learnably compressible
            toks = rng.zipf(cfg.zipf_a, cfg.seq_len + 1)
            toks = np.minimum(toks - 1, cfg.vocab_size - 1)
            phrase = rng.integers(0, cfg.vocab_size,
                                  rng.integers(4, 12))
            pos = rng.integers(0, max(cfg.seq_len - len(phrase), 1),
                               max(cfg.seq_len // (4 * len(phrase)), 1))
            for p in pos:
                toks[p:p + len(phrase)] = phrase[:len(toks[p:p + len(phrase)])]
            rows.append(toks)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.flagged_steps: list[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record step time; returns True if this step straggled."""
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        self.times = self.times[-self.window:]
        self._step += 1
        med = float(np.median(self.times))
        straggled = len(self.times) >= 8 and dt > self.threshold * med
        if straggled:
            self.flagged_steps.append(self._step)
        return straggled

    @property
    def median_s(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0
