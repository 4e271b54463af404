"""Fault-tolerant checkpointing: atomic, keep-N, resumable (port of
``repro/training/checkpoint.py``).

  * ATOMIC: write to ``step_XXXX.tmp.npz`` then ``rename`` — a failure
    mid-save never corrupts the latest checkpoint;
  * KEEP-N: bounded disk, oldest checkpoints garbage-collected;
  * RESUME: ``restore_latest`` scans the directory, so ``--resume auto``
    after a crash continues from the newest complete checkpoint
    (bitwise-identical continuation is asserted in the drill).

Format: the JAX package's — one ``.npz`` per checkpoint with flattened
key paths (``params/stages/0/b0/attn/wq``), bf16 stored as its ``uint16``
bit pattern and named in a ``__dtypes__`` JSON entry, plus a JSON
manifest (step, time, caller's metadata).  A file written by either
package restores in the other.  Restoring needs numpy alone (no
``ml_dtypes``): ``repro_torch.params.load_checkpoint`` reads the file and
returns tensors on the device asked for.  Empty subtrees (the ``{}`` of a
non-parametric norm) hold no array and are not in the file, in either
package.

Differences from the JAX package: ``save`` takes tensors (or numpy
arrays) and copies them to the host before it returns, also with
``async_save``, so the caller may update its state in place at once;
``restore`` and ``restore_latest`` take the ``device`` of the tensors they
return.

A state of ``DTensor``s (the trainer over a mesh) saves full tensors from
rank 0: every rank calls ``save``, each leaf is gathered in turn
(``full_tensor``, a collective) and rank 0 writes it into the archive at
once, so no rank holds more than one full leaf; the other ranks wait
for the file (a barrier).  ``restore(step, device, place=)`` reads the
archive one leaf at a time and hands each to ``place(key, tensor)``
(``sharding.placer``: onto a mesh by its spec), so a state larger than a
host's memory restores onto any mesh.
"""

from __future__ import annotations

import json
import re
import threading
import time
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.params import load_checkpoint


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _host(leaf):
    """(numpy copy of ``leaf``, whether it is bf16); a bf16 tensor becomes
    its uint16 bit pattern, since numpy has no bfloat16 of its own."""
    if not torch.is_tensor(leaf):
        return np.array(leaf), False
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, state: dict, metadata: Optional[dict] = None):
        """state: nested dicts/lists of tensors or arrays (params, opt,
        ...), copied to the host before this returns.  A state holding
        ``DTensor``s is saved by every rank together (see the module's
        docstring)."""
        flat = _flatten(state)
        if any(isinstance(v, DTensor) for v in flat.values()):
            self._save_sharded(step, flat, metadata or {})
            return
        host = {k: _host(v) for k, v in flat.items()}
        if self.async_save:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(step, host, metadata or {}))
            self._pending.start()
        else:
            self._write(step, host, metadata or {})

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _save_sharded(self, step: int, flat: dict, metadata: dict):
        writer = dist.get_rank() == 0
        tmp = self.dir / f"step_{step:010d}.tmp.npz"
        dtypes = {}
        zf = (zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                              allowZip64=True) if writer else None)
        try:
            for key, leaf in flat.items():
                if isinstance(leaf, DTensor):
                    leaf = leaf.full_tensor()    # every rank: the gather
                if writer:
                    arr, bf16 = _host(leaf)
                    if bf16:
                        dtypes[key] = "bfloat16"
                    _write_member(zf, key, arr)
                    del arr
                del leaf
            if writer:
                _write_member(zf, "__dtypes__", np.frombuffer(
                    json.dumps(dtypes).encode(), np.uint8))
        finally:
            if zf is not None:
                zf.close()
        if writer:
            self._publish(step, tmp, metadata)
        dist.barrier()

    def _publish(self, step: int, tmp: Path, metadata: dict):
        final = self.dir / f"step_{step:010d}.npz"
        # wall-clock manifest timestamp  # flocklint: ignore[FLKL101]
        manifest = {"step": step, "time": time.time(), **metadata}
        (self.dir / f"step_{step:010d}.json").write_text(
            json.dumps(manifest))
        tmp.replace(final)                      # atomic publish
        self._gc()

    def _write(self, step: int, host: dict, metadata: dict):
        dtypes = {k: "bfloat16" for k, (_, bf16) in host.items() if bf16}
        enc = {k: a for k, (a, _) in host.items()}
        tmp = self.dir / f"step_{step:010d}.tmp.npz"
        np.savez(tmp, __dtypes__=np.frombuffer(
            json.dumps(dtypes).encode(), np.uint8), **enc)
        self._publish(step, tmp, metadata)

    def _gc(self):
        ckpts = self.list_steps()
        for step in ckpts[:-self.keep] if self.keep else []:
            for suffix in (".npz", ".json"):
                p = self.dir / f"step_{step:010d}{suffix}"
                if p.exists():
                    p.unlink()

    # ---- restore -------------------------------------------------------------
    def list_steps(self):
        steps = []
        for p in self.dir.glob("step_*.npz"):
            m = re.fullmatch(r"step_(\d+)\.npz", p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def restore(self, step: int, device="cpu", place=None) -> dict:
        return load_checkpoint(self.dir / f"step_{step:010d}.npz", device,
                               place)

    def restore_latest(self, device="cpu", place=None) -> Optional[dict]:
        steps = self.list_steps()
        return self.restore(steps[-1], device, place) if steps else None

    def latest_step(self) -> int:
        steps = self.list_steps()
        return steps[-1] if steps else -1

    def metadata(self, step: int) -> dict:
        p = self.dir / f"step_{step:010d}.json"
        return json.loads(p.read_text()) if p.exists() else {}


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray):
    """One ``.npy`` member of an ``.npz`` archive, as ``np.savez`` writes
    it."""
    with zf.open(key + ".npy", mode="w", force_zip64=True) as f:
        np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
