"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. On first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``kernels/_build/`` (listed in ``.gitignore``) and loaded with ``ctypes``. The
library's file name carries a hash of its source, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the kernels' C interfaces (csrc/int8_rows.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# What ptxas reported for each library built in this process (registers,
# shared memory, spills), for the build log of chip_smoke.py.
BUILD_LOG: Dict[str, str] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: named by a hash of the
    source, the shared headers ``csrc/*.cuh`` and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Raises on a failed build."""
    names = list(names)
    pending = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        pending.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, proc in pending:
        stdout, stderr = proc.communicate()
        BUILD_LOG[name] = (stdout + stderr).strip()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path, = build([name])
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib


def c_function(library: str, name: str, argtypes):
    """Entry point ``name`` of ``csrc/<library>.cu`` with its argument types
    set. Every entry point returns ``cudaGetLastError()`` after its launch."""
    fn = getattr(load(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def on_card(tables: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor]) -> bool:
    """Whether a call launches its kernel: True when ``inputs`` lie on one
    CUDA device, whose ``tables`` are then on that device or in pinned host
    memory; False when everything lies on the CPU. Raises otherwise."""
    devices = {t.device for t in inputs}
    if len(devices) != 1:
        raise ValueError(f"inputs must share one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        if any(t.device.type != "cpu" for t in tables):
            raise ValueError("a table on the card needs its inputs on the card")
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tables:
        if t.device != dev and not (t.device.type == "cpu" and t.is_pinned()):
            raise ValueError(f"with inputs on {dev} a table must be on {dev} or in "
                             f"pinned host memory, not on {t.device} unpinned")
    return True


def refuse_autograd(name: str, *tensors):
    """Raise when autograd would record a call: the forward kernels have no
    backward kernel (nor do the reference's), and a kernel's output would
    leave the graph silently. The check is the same on the CPU, where the
    call takes the plain version, as on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel: call it under torch.no_grad() (inference), "
            f"or train through the plain mixers (StackCtx(use_kernel=False))")


def check_contiguous(name: str, *tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def stream(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current CUDA stream, for a C entry point."""
    return torch.cuda.current_stream(dev).cuda_stream


def launched(wrapper, err: int):
    """Raise if a launch failed, else count it on ``wrapper.launches``."""
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
