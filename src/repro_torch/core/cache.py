"""Prediction cache: reuse LLM outputs within and across queries (paper §2.3).

Exact-match cache keyed on (model@version, prompt@version or inline text,
function kind, serialization, decode params, serialized input tuple).
LRU in memory with optional JSON-lines persistence so reuse survives
process restarts ("across queries").

A copy of ``repro/core/cache.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, Optional

logger = logging.getLogger(__name__)


def cache_key(model_ref: str, prompt_key: str, function: str,
              serialization: str, payload: str, params: str = "") -> str:
    h = hashlib.sha256()
    for part in (model_ref, prompt_key, function, serialization, payload,
                 params):
        h.update(part.encode())
        h.update(b"\x1f")
    return h.hexdigest()


# once the JSONL holds this many superseded lines, put() compacts in place
_COMPACT_MIN_LINES = 4096


def _tmp_path(path: Path) -> Path:
    """Atomic-replace staging name: the FULL filename + ``.tmp``.

    ``path.with_suffix(".tmp")`` strips only the last suffix, so
    multi-dot sidecar paths get mangled (``cache.jsonl.selectivity``
    -> ``cache.jsonl.tmp``) and sidecars sharing a prefix would stage
    through the SAME temp file and corrupt each other's atomic
    replace.  Appending to the full name keeps staging files unique
    per destination."""
    return path.with_name(path.name + ".tmp")


class PredictionCache:
    def __init__(self, capacity: int = 100_000,
                 persist_path: Optional[str] = None):
        self.capacity = capacity
        self._data: OrderedDict[str, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._persisted_lines = 0
        self._persist_path = Path(persist_path) if persist_path else None
        if self._persist_path and self._persist_path.exists():
            self._load()

    def get(self, key: str):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return True, self._data[key]
            self.misses += 1
            return False, None

    def peek(self, key: str):
        """Lookup without touching LRU order or hit/miss counters (the
        scheduler's single-flight re-check uses this so its second look
        does not distort the session's cache statistics)."""
        with self._lock:
            if key in self._data:
                return True, self._data[key]
            return False, None

    @property
    def persist_path(self) -> Optional[Path]:
        return self._persist_path

    def put(self, key: str, value):
        with self._lock:
            noop = key in self._data and self._data[key] == value
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
            if noop:
                return       # re-put of an identical entry: no disk append
            self._persisted_lines += 1
            do_compact = (self._persist_path is not None
                          and self._persisted_lines
                          > max(_COMPACT_MIN_LINES, 2 * len(self._data)))
            if self._persist_path:
                with self._persist_path.open("a") as f:
                    f.write(json.dumps({"k": key, "v": value}) + "\n")
        if do_compact:
            self.compact()

    def compact(self):
        """Rewrite the persistence file from the live LRU contents,
        dropping superseded/evicted lines accumulated by appends."""
        if not self._persist_path:
            return
        with self._lock:
            tmp = _tmp_path(self._persist_path)
            with tmp.open("w") as f:
                for k, v in self._data.items():
                    f.write(json.dumps({"k": k, "v": v}) + "\n")
            tmp.replace(self._persist_path)
            self._persisted_lines = len(self._data)

    def _load(self):
        lines = self._persist_path.read_text().splitlines()
        for line in lines:
            try:
                rec = json.loads(line)
                self._data[rec["k"]] = rec["v"]
            except (json.JSONDecodeError, KeyError) as exc:
                logger.debug("cache line skipped (%s): %.80s", exc, line)
                continue
        self._persisted_lines = len(lines)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    @property
    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._data)}

    def clear(self):
        with self._lock:
            self._data.clear()
            self.hits = self.misses = 0


# bounded observation window for selectivity statistics: once a prompt's
# recorded total exceeds this many tuples the counters are rescaled down,
# so recent observations carry at least 1/WINDOW of the weight and a
# shifted data distribution re-learns within ~one window instead of
# fighting an unbounded historical average (speculative waste budgets
# and filter ordering depend on the estimate tracking the CURRENT data)
SELECTIVITY_WINDOW = 1024


def bound_observations(passed: int, total: int,
                       window: int = SELECTIVITY_WINDOW
                       ) -> tuple[int, int]:
    """Rescale an aggregate (passed, total) pair so ``total`` never
    exceeds ``window`` — exponential forgetting with bounded weight."""
    if total <= window:
        return passed, total
    scale = window / total
    return min(window, int(round(passed * scale))), window


class SelectivityStore:
    """JSON sidecar persisting per-prompt ``llm_filter`` pass rates.

    Lives alongside the prediction cache (default path: the cache's
    JSONL path + ``.selectivity.json``) so cost-ordered filter chains
    have real statistics on first sight of a recurring prompt across
    sessions.  Entries are keyed by the prompt's cache identity
    (``name@version`` for catalog prompts, ``inline:<text>`` otherwise),
    so a prompt or model re-version naturally orphans old entries;
    ``prune_stale`` additionally drops versioned keys that a catalog
    resolves to a *newer* ref, keeping the sidecar from growing with
    dead versions."""

    def __init__(self, path: str):
        self.path = Path(path)
        self._lock = threading.Lock()

    def load(self) -> dict[str, list]:
        if not self.path.exists():
            return {}
        try:
            data = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError) as exc:
            logger.debug("sidecar %s unreadable: %s", self.path, exc)
            return {}
        out: dict[str, list] = {}
        for pid, obs in data.get("stats", {}).items():
            if (isinstance(obs, list) and len(obs) == 2
                    and all(isinstance(x, int) and x >= 0 for x in obs)
                    and obs[0] <= obs[1]):
                # sidecars written before windowing may carry unbounded
                # totals; bound them on load so drift detection applies
                out[pid] = list(bound_observations(obs[0], obs[1]))
        return out

    def save(self, stats: dict[str, list]):
        with self._lock:
            tmp = _tmp_path(self.path)
            tmp.write_text(json.dumps({"stats": stats}, indent=1))
            tmp.replace(self.path)

    @staticmethod
    def prune_stale(stats: dict[str, list], catalog) -> dict[str, list]:
        """Drop entries whose ``name@version`` key is superseded by a
        newer prompt version in ``catalog`` (re-versioned prompts start
        from fresh statistics)."""
        out = {}
        for pid, obs in stats.items():
            name, sep, _ = pid.rpartition("@")
            if sep and not pid.startswith("inline:"):
                live = catalog.get_prompt(name)
                if live is not None and live.ref != pid:
                    continue
            out[pid] = obs
        return out


# per-model latency observations kept in the calibration sidecar: enough
# for stable percentiles without the file growing with every request
CALIBRATION_WINDOW = 256

# request/retry counters are bounded the same way as selectivity: beyond
# this many admissions the counters rescale, so a model whose overflow
# behaviour changed (bigger window, fixed serialization) re-learns its
# headroom instead of dragging historical retries forever
CALIBRATION_COUNT_WINDOW = 4096

# calibration-aware batch sizing: floor and activation threshold for the
# planning headroom derived from observed overflow-retry rates
HEADROOM_MIN = 0.5          # never plan below half the context budget
HEADROOM_MIN_OBS = 8        # admissions needed before trusting the rate


def headroom_factor(requests: int, retries: int) -> float:
    """Per-model batch-planning headroom from observed overflow retries.

    A retry means an admitted batch exceeded the provider's real budget
    — the planner's token estimates undercount by roughly the overflow
    fraction (serialization framing, id wrappers), so shaving the
    planned budget by the observed retry rate removes most splits up
    front.  Returns 1.0 (full budget) until enough admissions exist to
    trust the rate, floored at ``HEADROOM_MIN``."""
    total = requests + retries
    if total < HEADROOM_MIN_OBS or retries <= 0:
        return 1.0
    return max(HEADROOM_MIN, 1.0 - retries / total)


def corpus_fingerprint(texts) -> str:
    """Order-sensitive content fingerprint of a retrieval corpus.

    Keys the ``IndexStore`` (with the embedding model's ref) so a
    rebuilt index is reused exactly when the corpus texts AND their
    order are unchanged — candidate doc ids index into the corpus, so
    order is part of the identity.  Each text is length-prefixed so no
    choice of text content can make two different corpora collide
    (separator bytes inside a text cannot fake a document boundary)."""
    h = hashlib.sha256()
    for t in texts:
        payload = str(t).encode()
        h.update(str(len(payload)).encode())
        h.update(b":")
        h.update(payload)
    return h.hexdigest()


# persisted vector indexes are whole embedding matrices; keep only the
# most recent corpora so the sidecar stays bounded
INDEX_STORE_CAPACITY = 8


class IndexStore:
    """JSON sidecar memoising built vector indexes, keyed by
    ``(embedding model ref, corpus fingerprint)``.

    The expensive part of paper Query 3 is embedding the corpus; a
    repeated RAG query over an unchanged corpus should pay ZERO embed
    requests, not a prediction-cache scan over every document.  This
    sidecar persists the raw embedding matrix next to the prediction
    cache (default path: the cache's JSONL path + ``.index.json``) with
    the same discipline as the other sidecars: full-filename ``.tmp``
    atomic replace, corrupt-file recovery (a bad sidecar loads as empty
    and the index is rebuilt, never a crash), and ``prune_stale`` drops
    entries whose model ``name@version`` a catalog resolves to a newer
    ref.  Bounded to ``INDEX_STORE_CAPACITY`` corpora, oldest first.

    Indexes are stored as SEGMENTS so a corpus append persists only the
    delta: ``append_segment`` records the grown corpus as the base
    entry's segment chain plus one new segment holding just the new
    rows.  Entries written before segmentation (``{"vectors": ...}``)
    still load; the first append converts them in place.  Eviction and
    pruning garbage-collect segments no surviving entry references, so
    capacity accounting covers segment payloads too (no orphaned
    sidecar data)."""

    def __init__(self, path: str, capacity: int = INDEX_STORE_CAPACITY):
        self.path = Path(path)
        self.capacity = capacity
        self._lock = threading.Lock()
        # file writes serialize on their own lock so get()/has() (the
        # optimizer's index_cached probe, other retrieval nodes) never
        # block behind a multi-megabyte sidecar rewrite
        self._io_lock = threading.Lock()
        self._version = 0               # bumped per mutation, under _lock
        self._written = 0               # last version flushed to disk
        self._data: OrderedDict[str, dict] = OrderedDict()
        self._segments: dict[str, list] = {}
        self._load()

    @staticmethod
    def _key(model_ref: str, fingerprint: str) -> str:
        return f"{model_ref}|{fingerprint}"

    @staticmethod
    def _valid_matrix(vecs) -> bool:
        if not isinstance(vecs, list) or not vecs:
            return False
        width = {len(v) if isinstance(v, list) else -1 for v in vecs}
        if len(width) != 1 or -1 in width:
            return False
        return all(isinstance(x, (int, float)) and x == x
                   for v in vecs for x in v)

    def _valid(self, rec, segments=None) -> bool:
        if not isinstance(rec, dict):
            return False
        if "segments" in rec:
            segs = rec["segments"]
            pool = self._segments if segments is None else segments
            return (isinstance(segs, list) and segs
                    and all(isinstance(s, str) and s in pool for s in segs))
        return self._valid_matrix(rec.get("vectors"))

    @staticmethod
    def _rows(rec) -> int:
        if "segments" in rec:
            return int(rec.get("n", 0))
        return len(rec["vectors"])

    def _gc_segments(self):
        """Drop segments no live entry references (call under _lock).
        Evicting an entry frees its segment payloads unless a longer
        chain still shares them."""
        live = {s for rec in self._data.values()
                for s in rec.get("segments", ())}
        self._segments = {k: v for k, v in self._segments.items()
                          if k in live}

    def _evict(self):
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
        self._gc_segments()

    def _load(self):
        if not self.path.exists():
            return
        try:
            data = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError) as exc:
            logger.debug("sidecar %s unreadable: %s", self.path, exc)
            return
        if not isinstance(data, dict):
            return
        segments = {k: v for k, v in data.get("segments", {}).items()
                    if self._valid_matrix(v)}
        for key, rec in data.get("indexes", {}).items():
            if self._valid(rec, segments):
                self._data[key] = rec
        self._segments = segments
        self._evict()

    def get(self, model_ref: str, fingerprint: str):
        """The stored embedding matrix as float32, or None."""
        import numpy as np
        with self._lock:
            rec = self._data.get(self._key(model_ref, fingerprint))
            if rec is None:
                return None
            if "segments" in rec:
                return np.concatenate(
                    [np.asarray(self._segments[s], np.float32)
                     for s in rec["segments"]], axis=0)
            return np.asarray(rec["vectors"], np.float32)

    def entries(self, model_ref: str) -> list:
        """(fingerprint, n_rows) for every stored corpus of this model,
        the prefix-append candidates ``ensure_index`` matches against."""
        prefix = f"{model_ref}|"
        with self._lock:
            return [(k[len(prefix):], self._rows(rec))
                    for k, rec in self._data.items()
                    if k.startswith(prefix)]

    def _snapshot(self) -> tuple[dict, int]:
        """Bump the version and capture a snapshot (call under _lock)."""
        self._version += 1
        return ({"indexes": dict(self._data),
                 "segments": dict(self._segments)}, self._version)

    def _write_snapshot(self, snapshot: dict, version: int):
        """Persist one mutation's snapshot.  The version guard makes a
        late writer with a stale snapshot a no-op, so concurrent puts
        cannot roll the file back to a state missing a newer entry."""
        payload = json.dumps(snapshot)
        with self._io_lock:
            if version <= self._written:
                return
            tmp = _tmp_path(self.path)
            tmp.write_text(payload)
            tmp.replace(self.path)
            self._written = version

    @staticmethod
    def _matrix(vectors):
        import numpy as np
        v = np.asarray(vectors, np.float32)
        if v.ndim != 2 or not v.size:
            return None
        # float32 -> python float -> float32 roundtrips exactly, so a
        # reloaded index reproduces the in-session one bit-for-bit
        return [[float(x) for x in row] for row in v]

    def put(self, model_ref: str, fingerprint: str, vectors):
        mat = self._matrix(vectors)
        if mat is None:
            return
        key = self._key(model_ref, fingerprint)
        with self._lock:
            self._data[key] = {"vectors": mat}
            self._data.move_to_end(key)
            self._evict()
            snapshot, version = self._snapshot()
        self._write_snapshot(snapshot, version)

    def _as_segments(self, key: str, rec: dict) -> dict:
        """Convert a legacy whole-matrix entry to a one-segment chain
        (call under _lock)."""
        if "segments" in rec:
            return rec
        seg = f"{key}#0"
        self._segments[seg] = rec["vectors"]
        new = {"segments": [seg], "n": len(rec["vectors"])}
        self._data[key] = new
        return new

    def append_segment(self, model_ref: str, base_fingerprint: str,
                       fingerprint: str, delta_vectors):
        """Persist a grown corpus as ``base``'s segment chain plus one
        new segment holding only ``delta_vectors``.  Falls back to
        nothing (caller should ``put`` the full matrix) when the base
        entry is absent.  Returns True when the append was recorded."""
        mat = self._matrix(delta_vectors)
        if mat is None:
            return False
        base_key = self._key(model_ref, base_fingerprint)
        key = self._key(model_ref, fingerprint)
        with self._lock:
            base = self._data.get(base_key)
            if base is None:
                return False
            base = self._as_segments(base_key, base)
            seg = f"{key}#{len(base['segments'])}"
            self._segments[seg] = mat
            self._data[key] = {"segments": base["segments"] + [seg],
                               "n": self._rows(base) + len(mat)}
            self._data.move_to_end(key)
            self._evict()
            snapshot, version = self._snapshot()
        self._write_snapshot(snapshot, version)
        return True

    def keys(self) -> list:
        with self._lock:
            return list(self._data)

    def segment_keys(self) -> list:
        with self._lock:
            return list(self._segments)

    def has(self, model_ref: str, fingerprint: str) -> bool:
        with self._lock:
            return self._key(model_ref, fingerprint) in self._data

    @staticmethod
    def prune_stale(keys, catalog) -> list:
        """Which of ``keys`` (``ref|fingerprint`` strings) survive: keys
        whose model ``name@version`` is superseded by a newer catalog
        version are stale (a re-versioned embedding model produces
        different vectors)."""
        out = []
        for key in keys:
            ref = key.split("|", 1)[0]
            name, sep, _ = ref.rpartition("@")
            if sep:
                live = catalog.get_model(name)
                if live is not None and live.ref != ref:
                    continue
            out.append(key)
        return out

    def prune(self, catalog):
        """Drop stale entries in place (called at session start)."""
        with self._lock:
            live = set(self.prune_stale(list(self._data), catalog))
            stale = [k for k in self._data if k not in live]
            for k in stale:
                del self._data[k]
            self._gc_segments()
            if not (stale and self.path.exists()):
                return
            snapshot, version = self._snapshot()
        self._write_snapshot(snapshot, version)


class CalibrationStore:
    """JSON sidecar persisting per-model execution statistics aggregated
    from ``ExecutionReport``s: request/retry counts, tuples served (mean
    batch size), and a bounded window of recent per-request latencies.

    This is what turns the optimizer's flat serialization-sample cost
    model into a *calibrated* one: ``explain()``'s ``waves``
    critical-path estimate multiplies by the model's observed latency
    percentiles instead of guessing, and the speculative-dispatch
    decision compares serial vs speculative wall-clock from the same
    statistics.  Lives alongside the prediction cache (default path:
    the cache's JSONL path + ``.calibration.json``), keyed by the
    model's ``name@version`` ref so a model re-version orphans old
    entries; ``prune_stale`` drops refs a catalog resolves to a newer
    version.  A corrupt or unreadable sidecar loads as empty — the cost
    model degrades to uncalibrated, never crashes."""

    def __init__(self, path: str):
        self.path = Path(path)
        self._lock = threading.Lock()

    @staticmethod
    def _valid(rec) -> bool:
        if not isinstance(rec, dict):
            return False
        for k in ("requests", "retries", "tuples"):
            v = rec.get(k)
            if not isinstance(v, int) or v < 0:
                return False
        return isinstance(rec.get("latency_s"), list)

    def load(self) -> dict[str, dict]:
        if not self.path.exists():
            return {}
        try:
            data = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError) as exc:
            logger.debug("sidecar %s unreadable: %s", self.path, exc)
            return {}
        if not isinstance(data, dict):
            return {}
        out: dict[str, dict] = {}
        for ref, rec in data.get("models", {}).items():
            if not self._valid(rec):
                continue
            # self-heal: sidecars written before the monotonic-clock fix
            # may carry negative latencies (wall-clock stepped backwards
            # mid-request) — drop the bad samples, keep the record
            lat = [float(x) for x in rec["latency_s"]
                   if isinstance(x, (int, float)) and not isinstance(x, bool)
                   and math.isfinite(x) and x >= 0]
            out[ref] = {"requests": rec["requests"],
                        "retries": rec["retries"],
                        "tuples": rec["tuples"],
                        "latency_s": lat[-CALIBRATION_WINDOW:]}
        return out

    def save(self, stats: dict[str, dict]):
        with self._lock:
            tmp = _tmp_path(self.path)
            tmp.write_text(json.dumps({"models": stats}, indent=1))
            tmp.replace(self.path)

    @staticmethod
    def prune_stale(stats: dict[str, dict], catalog) -> dict[str, dict]:
        """Drop entries whose ``name@version`` ref is superseded by a
        newer model version in ``catalog`` (a re-versioned model may
        have a new arch/window — its latency profile starts fresh)."""
        out = {}
        for ref, rec in stats.items():
            name, sep, _ = ref.rpartition("@")
            if sep:
                live = catalog.get_model(name)
                if live is not None and live.ref != ref:
                    continue
            out[ref] = rec
        return out
