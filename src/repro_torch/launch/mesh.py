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
dry-run (``ROADMAP.md`` 12c), and any peak the port states there is the
H100's.

The sharded model (``models/sharding.py``) runs on another kind of mesh,
a ``ProcessMesh``: one process per device under ``torch.distributed``
(NCCL on the cards; gloo only where the caller asks for the CPU), each
holding its shards as ``DTensor``s over a
``torch.distributed.device_mesh.DeviceMesh`` with named axes.  A train
step needs autograd through every collective, which the single
controller's copies do not give, and one Python thread per device
issues its launches.  ``ProcessMesh`` exposes the same ``shape`` mapping
and ``axis_names`` as ``Mesh``, so ``sharding.py`` reads one interface.
The single-controller ``Mesh`` stays for the corpus scan
(``retrieval/distributed.py``); ``ROADMAP.md`` lists the two meshes as a
later simplification.  ``run_processes`` starts the processes of a
``ProcessMesh`` on this host (``tcp://127.0.0.1`` and a free port), and
``make_process_mesh`` raises, never falls back, when there is no process
group, no CUDA device for a card mesh, or fewer ranks than the shape.
"""

from __future__ import annotations

import math
import os
import socket
import sys
import threading
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

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


# --------------------------------------------------------------------------
# one process per device (the sharded model)
# --------------------------------------------------------------------------
class ProcessMesh:
    """A ``DeviceMesh`` over the ranks of the process group, with named
    axes: ``shape`` maps each axis name to its size and ``axis_names``
    lists them, as on ``Mesh``; ``device`` is this rank's device."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, device={self.device})"


def make_process_mesh(shape, axes, device=None) -> ProcessMesh:
    """A ``ProcessMesh`` of ``shape`` over ``axes`` on the initialised
    process group, ranks in row-major order.  ``device`` None means this
    rank's CUDA device (``torch.cuda.current_device()``, NCCL); "cpu"
    takes the CPU (gloo).  Raises when the group is not initialised, its
    size is not the shape's, or its backend is not the device's."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_process_mesh: shape {shape} for axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh: no process group; start the "
                           "processes with run_processes")
    n, world = math.prod(shape), dist.get_world_size()
    if world != n:
        raise RuntimeError(f"make_process_mesh: a mesh of shape {shape} "
                           f"needs {n} ranks, the group has {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_process_mesh: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    want = "gloo" if device.type == "cpu" else "nccl"
    if dist.get_backend() != want:
        raise RuntimeError(f"make_process_mesh: a {device.type} mesh needs "
                           f"the {want} backend, the group has "
                           f"{dist.get_backend()}")
    dm = DeviceMesh(device.type, torch.arange(n).reshape(shape),
                    mesh_dim_names=axes)
    return ProcessMesh(dm, device)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process(rank: int, world: int, port: int, device=None):
    """Join the process group as ``rank`` of ``world`` at
    ``tcp://127.0.0.1:port``: NCCL on CUDA device ``rank`` (``device``
    None), gloo on the CPU (``device="cpu"``).  Returns the device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_process: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        dev, backend = torch.device(device), "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, **kw)
    return dev


def _process_main(rank, fn, world, port, device, args):
    dev = init_process(rank, world, port, device)
    try:
        fn(rank, dev, *args)
    except BaseException:
        # the other ranks may be waiting in a collective for this one, and
        # tearing the group down (NCCL) would wait with them: report and
        # leave at once, so that run_processes stops the rest
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def run_processes(fn, world: int, device=None, args=()):
    """Run ``fn(rank, device, *args)`` in ``world`` processes on this host,
    each joined to one process group (``init_process``), and wait for all;
    raises if any fails.  The processes are spawned (a fresh interpreter
    each).  A process whose ``fn`` raises prints the traceback and exits at
    once, without tearing down its group, and the others are then
    stopped: ranks left waiting in a collective for it cannot hang the
    run."""
    import torch.multiprocessing as mp
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(_process_main, args=(fn, world, free_port(), device, args),
             nprocs=world, join=True)
