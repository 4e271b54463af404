"""Device meshes of the port (counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` is single-controller, as ``jax.sharding.Mesh`` is: one Python
process drives every device of it.  It holds an ndarray of
``torch.device``s with one axis per name; ``with mesh:`` makes it the
thread's current mesh, as JAX's ``with mesh:`` sets the thread-local
``thread_resources``, and ``current_mesh()`` reads it
(``retrieval.active_mesh`` routes the exact scan by it).  Work on a mesh
runs as launches on each device from this one process, and results move
between devices by copies (``retrieval/distributed.py``); no process
group is opened.

Differences from the JAX package: ``make_mesh`` takes ``devices``
(default: every visible CUDA device in order; it raises when there are
too few and never falls back to the CPU), and a device may appear more
than once, which JAX forbids: the CPU tests build meshes of eight
entries of ``cpu``, and ``chip_smoke.py`` one of four entries of one card.
``make_production_mesh`` and the TPU roofline constants have one caller
in the JAX package, ``launch/dryrun.py``; they come with the port's
sharding and dry-run (``ROADMAP.md`` A.12), and any peak the port states
there is the H100's.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

_LOCAL = threading.local()


def _stack() -> list:
    if not hasattr(_LOCAL, "meshes"):
        _LOCAL.meshes = []
    return _LOCAL.meshes


class Mesh:
    """``devices``: an ndarray (or nested sequence) of devices with one
    axis per name in ``axis_names``.  ``shape`` maps each axis name to its
    size and ``size`` counts the entries, as on ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"Mesh: devices of shape {self.devices.shape} "
                             f"for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def __enter__(self) -> "Mesh":
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def current_mesh() -> Optional[Mesh]:
    """The innermost ``with mesh:`` of this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``: the first ``prod(shape)`` of
    ``devices`` (default: the visible CUDA devices in order) in row-major
    order.  Raises when there are fewer."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} for axes {axes}")
    n = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise RuntimeError(f"make_mesh: a mesh of shape {shape} needs {n} "
                           f"devices, {len(devices)} given or visible")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axes)
