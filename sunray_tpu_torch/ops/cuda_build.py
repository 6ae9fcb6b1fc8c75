"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

All sources under `sunray_tpu_torch/csrc/` compile into one shared library
with a plain C interface, at first use, into `build/sunray_tpu_torch/` at
the repository root (ignored by git). The file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded. Nothing here runs at import time: the CPU tests import every
module on a host that has no nvcc and no card.

Flags: sm_90a (Hopper), -O3, and no --use_fast_math: flush-to-zero and
approximate exp/division would move the Moller-Trumbore edge predicate
and the a-trous weights. --fmad=false keeps each multiply and add rounded
on its own, as PyTorch's elementwise kernels round them; a kernel fuses a
multiply-add only where it calls fmaf() itself, in the places where the
plain version calls ops/fp.fma. So every kernel can be held to its plain
PyTorch version bit for bit, or at the tolerance of libm's exp.

`launches` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "sunray_tpu_torch"
SOURCES = ("trace.cu", "gather.cu", "atrous.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

launches: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build, launch or accept its arguments."""


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or add it to PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsunray_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if needed. Returns (library path, nvcc's
    output: the -Xptxas=-v register and spill report, empty when the
    library was already built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(
            f"nvcc exited {proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _declare(lib):
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.sunray_trace_closest.argtypes = [p, p, p, f, p, f, p, p, p, i, i,
                                         p, p, p, p, p, p]
    lib.sunray_trace_occluded.argtypes = [p, p, p, f, p, f, p, p, p, p, i, i,
                                          p, p]
    lib.sunray_gather_rows.argtypes = [p, p, i, i, i64, i64, p, p]
    lib.sunray_atrous_pass.argtypes = [p, p, p, p, p, i, i, i, p, p]
    for fn in (lib.sunray_trace_closest, lib.sunray_trace_occluded,
               lib.sunray_gather_rows, lib.sunray_atrous_pass):
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            _lib = _declare(ctypes.CDLL(str(path)))
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if the C entry point reported a CUDA error for `name`."""
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err} at launch")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors) -> torch.device:
    """Every tensor on one CUDA device and contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise KernelError(
                f"{name}: tensors must share one CUDA device, got "
                f"{[str(x.device) for x in tensors]}"
            )
        if not t.is_contiguous():
            raise KernelError(f"{name}: inputs must be contiguous")
    return dev


def require_dtype(name: str, t, dtype) -> None:
    if t.dtype != dtype:
        raise KernelError(f"{name}: expected {dtype}, got {t.dtype}")
