"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, at first use, into
``build/repro_torch_kernels/`` at the root of the checkout.  The library's
file name holds a digest of the sources and flags, so an edited source is
rebuilt and an unchanged tree loads what it built before.  ``BUILD_LOG``
keeps what ``nvcc -Xptxas -v`` reported for each source (registers,
spills) when this process built the library.

Nothing here runs at import time: the CPU tests import every module, and
a host may have neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# {"seconds": compile and link wall time, "log": {source: nvcc output}} of
# a build made by this process; empty when the library was already built
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the repro_torch kernels")


def so_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels.{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built already; its path."""
    path = so_path()
    if path.exists():
        return path
    nvcc = _nvcc()
    objs = BUILD_DIR / f"{path.name}.{os.getpid()}.objs"
    objs.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.name}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    try:
        procs = {src: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
             str(objs / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sorted(CSRC.glob("*.cu"))}
        logs = {src.name: proc.communicate()[0]
                for src, proc in procs.items()}
        failed = [src.name for src, proc in procs.items() if proc.returncode]
        if failed:
            raise RuntimeError("kernel build failed (nvcc):\n" + "\n".join(
                f"{name}:\n{logs[name]}" for name in failed))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(objs / f"{src.stem}.o") for src in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOG.update(seconds=time.monotonic() - t0, log=logs)
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed (nvcc exit "
                               f"{link.returncode}):\n{link.stdout}")
        os.replace(tmp, path)   # atomic publish
    finally:
        shutil.rmtree(objs, ignore_errors=True)
        tmp.unlink(missing_ok=True)
    return path


def load(signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The kernel library, built on first use, with ``signatures`` (C
    function -> ``argtypes``) declared; every entry point returns a
    ``cudaError_t`` as int."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
        for fn, argtypes in signatures.items():
            getattr(_LIB, fn).argtypes = list(argtypes)
            getattr(_LIB, fn).restype = ctypes.c_int
    return _LIB


def check_launch(lib: ctypes.CDLL, rc: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(lib: ctypes.CDLL, entry: str, what: str, device: torch.device,
           stream: int, *args):
    """Call the C entry point ``entry`` with ``args`` and ``stream`` (the
    wrapper's ``stream_ptr(device)``), with ``device`` current on this
    thread for the call, and raise on a CUDA error.  An entry point sets
    its kernel's shared memory and launches it on the thread's current
    device, which need not hold the tensors (a mesh shard on cuda:1 while
    cuda:0 is current): without the guard that launch would run in the
    wrong context or fail with "invalid resource handle".  Where the
    device is already current, as on every launch of a one-card path,
    the call takes no guard."""
    if device.index is None or device.index == torch.cuda.current_device():
        rc = getattr(lib, entry)(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = getattr(lib, entry)(*args, stream)
    check_launch(lib, rc, what)


def refuse_grad(name: str, *tensors):
    """Raise where autograd would need a gradient through a kernel: the
    kernels have no backward, and a tensor a kernel wrote has no
    ``grad_fn``, so the graph would stop there without a word.  Serving
    calls them under ``torch.no_grad()`` or on tensors that need no
    gradient; the training route runs the plain versions instead
    (``route="plain"`` in ``models/model.py``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if torch.is_tensor(t)):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and an input requires "
            "grad; call it under torch.no_grad() or take the plain route "
            "(route='plain')")


def require_cuda(name: str, t: torch.Tensor, dtypes, ndim: int):
    """Validate a kernel argument: a contiguous CUDA tensor of one of
    ``dtypes`` with ``ndim`` dimensions, 16-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer must be 16-byte aligned")
