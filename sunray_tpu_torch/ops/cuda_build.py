"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

All sources under `sunray_tpu_torch/csrc/` compile into one shared library
with a plain C interface, at first use, into `build/sunray_tpu_torch/` at
the repository root (ignored by git): one nvcc per source, all started
together, then one link. The file name carries a hash of the
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
SOURCES = ("trace.cu", "gather.cu", "atrous.cu", "restir.cu", "binned.cu",
           "taa.cu", "history.cu", "boundary.cu", "bvh.cu", "overlay.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(CSRC_DIR / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(SOURCES, objs)]
    report = []
    failed = []
    for s, proc in zip(SOURCES, procs):
        text = proc.communicate()[0]
        report.append(text)
        if proc.returncode != 0:
            failed.append(f"{s}: nvcc exited {proc.returncode}:\n{text}")
    if failed:
        raise KernelError("\n".join(failed))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise KernelError(f"link exited {link.returncode}:\n"
                          f"{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return out, "".join(report)


def _signatures():
    """Argument types of every C entry point, by name. Each returns an int:
    a CUDA error code, 0 for none."""
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    binned = [p, p, p, i, i, p, p, p, p, p, p, p, i]
    pairs = [p, p, p, i, i, p, p, p, p, p, i, p, p, i, i]
    bvh = [p, p, i, p, p, i, i, p, p, p, i, i, i]
    rays = [p, p, p, p, p, i64, p, p, p, p, p, p, p, p]
    return {
        "sunray_trace_closest": [p, p, p, f, p, f, p, p, p, i, i,
                                 p, p, p, p, p, p],
        "sunray_trace_occluded": [p, p, p, f, p, f, p, p, p, p, i, i, p, p],
        "sunray_gather_rows": [p, p, i, i, i64, i64, p, p],
        "sunray_gather_rows_bwd": [p, p, i, i, i64, i64, i, i, i64, i64, i,
                                   p, p, p],
        "sunray_gather_bwd_launch_shape": [ctypes.POINTER(i)],
        "sunray_gather_runs_scratch": [i64, i, i, i64, ctypes.POINTER(i64)],
        "sunray_gather_runs_sort": [p, i64, i, i, p, p, p, p],
        "sunray_gather_rows_bwd_runs": [p, i64, i64, i64, i64, i64, p, i, i,
                                        i, p, i64, p, p, p],
        "sunray_gather_runs_launch_shape": [ctypes.POINTER(i)],
        "sunray_atrous_pass": [p, p, p, p, p, i, i, i, p, p],
        "sunray_ris_audition": [p, i, p, p, p, p, p, p, p, p, p, i, i,
                                p, p, p, p, p, p, p, p],
        "sunray_di_temporal": ([p, i, p] + [p] * 6 + [p] * 7
                               + [i64, p, p] + [p] * 7 + [i, f, f]
                               + [p] * 7 + [p]),
        "sunray_di_spatial": ([p, i, p] + [p] * 5 + [p] * 4 + [p] * 6
                              + [i, i, ctypes.POINTER(i), i, f, f, f]
                              + [p] * 9 + [p]),
        "sunray_gi_spatial": ([p] + [p] * 5 + [p] * 7 + [i, p]
                              + [p] * 4 + [i, f] + [p] * 6 + [p]),
        "sunray_ris_audition_bf16": [p, i, p, p, p, p, p, p, p, p, p, i, i,
                                     p, p, p, p, p, p, p, p],
        "sunray_di_temporal_bf16": ([p, i, p] + [p] * 6 + [p] * 7
                                    + [i64, p, p] + [p] * 7 + [i, f, f]
                                    + [p] * 7 + [p]),
        "sunray_di_spatial_bf16": ([p, i, p] + [p] * 5 + [p] * 4 + [p] * 6
                                   + [p, i, i, ctypes.POINTER(i), i, f, f, f]
                                   + [p] * 9 + [p]),
        "sunray_di_spatial_window": ([p, i, p] + [p] * 5 + [p] * 4 + [p] * 6
                                     + [i, i, i, i, i, ctypes.POINTER(i), i,
                                        f, f, f] + [p] * 9 + [p]),
        "sunray_di_spatial_window_bf16": ([p, i, p] + [p] * 5 + [p] * 4
                                          + [p] * 6 + [p, i, i, i, i, i,
                                                       ctypes.POINTER(i), i,
                                                       f, f, f]
                                          + [p] * 9 + [p]),
        "sunray_atrous_pass_window": [p, p, p, p, p, i, i, i, i, i, p, p],
        "sunray_gi_spatial_bf16": ([p] + [p] * 5 + [p] * 7 + [i, p]
                                   + [p] * 4 + [p] * 3 + [i, f] + [p] * 6
                                   + [p]),
        "sunray_binned_closest": binned + [p, p, p, p, p],
        "sunray_binned_occluded": binned + [p, p],
        "sunray_cluster_scan": [p, p, p, p, i, p, i, p, p, p],
        "sunray_pair_closest": pairs + [p, p, p, p, p],
        "sunray_pair_occluded": pairs + [p, p],
        "sunray_trace_occluded_woop": [p, p, p, f, p, f, p, p, p, i, i, p, p],
        "sunray_inv_det": [p, p, i64, p],
        "sunray_taa_clamp_blend": [p, p, p, i, i, f, p, p],
        "sunray_taa_clamp_blend_window": [p, p, p, i, i, f, p, p],
        "sunray_history_gather": [p, p, p, i, p, i64, i64, p],
        "sunray_boundary_candidates": [p, p, p, i, p, i, i64, i, p, p, p, p,
                                       p],
        "sunray_bvh_walk": bvh + rays,
        "sunray_bvh_walk_alpha": bvh + [p] * 10 + [i] * 4 + rays,
        "sunray_woop_launch_shape": [ctypes.POINTER(i)],
        "sunray_occluded_launch_shape": [ctypes.POINTER(i)],
        "sunray_closest_launch_shape": [ctypes.POINTER(i)],
        "sunray_ris_launch_shape": [ctypes.POINTER(i)],
        "sunray_atrous_tile_shape": [ctypes.POINTER(i)],
        "sunray_boundary_launch_shape": [ctypes.POINTER(i)],
        "sunray_bvh_launch_shape": [ctypes.POINTER(i)],
        "sunray_paint_meshes": [p, p, i, i, p, p, p, p, p, p, p, i, p],
        "sunray_overlay_launch_shape": [ctypes.POINTER(i)],
    }


def declare(lib, names=None):
    """Set the argument and result types of the C entry points `names` (all
    of them by default) on a loaded library; returns the library. A
    library built from one source declares that source's entry points."""
    table = _signatures()
    for name in table if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes = table[name]
        fn.restype = ctypes.c_int
    return lib


def launch_shape(lib, name: str, n: int) -> tuple[int, ...]:
    """The n ints that the library's shape query `name` reports (its
    kernel's compile-time launch shape)."""
    out = (ctypes.c_int * n)()
    check_launch(name, getattr(lib, name)(out))
    return tuple(out)


def _check_launch_shapes(lib) -> None:
    """The host's copies of the kernels' launch shapes, which the CPU models
    of the kernels and chip_smoke.py's counts read, must be the library's."""
    from sunray_tpu_torch.ops import (cuda_boundary, cuda_bvh, cuda_gather,
                                      cuda_image, cuda_overlay, cuda_restir,
                                      cuda_trace)

    for name, want in (
            ("sunray_woop_launch_shape",
             (cuda_trace.WOOP_RAYS, cuda_trace.WOOP_THREADS)),
            ("sunray_occluded_launch_shape",
             (cuda_trace.OCC_RAYS, cuda_trace.OCC_THREADS,
              cuda_trace.OCC_WIDE_MIN)),
            ("sunray_closest_launch_shape",
             (cuda_trace.CLOSEST_RAYS, cuda_trace.CLOSEST_THREADS,
              cuda_trace.CLOSEST_WIDE_MIN)),
            ("sunray_ris_launch_shape", (cuda_restir.RIS_SMEM_LIGHTS,)),
            ("sunray_atrous_tile_shape",
             (*cuda_image.ATROUS_TILE, cuda_image.ATROUS_HALO)),
            ("sunray_boundary_launch_shape", cuda_boundary.LAUNCH_SHAPE),
            ("sunray_gather_bwd_launch_shape", cuda_gather.BWD_LAUNCH_SHAPE),
            ("sunray_gather_runs_launch_shape", cuda_gather.RUN_SHAPE),
            ("sunray_bvh_launch_shape", cuda_bvh.LAUNCH_SHAPE),
            ("sunray_overlay_launch_shape",
             (*cuda_overlay.TILE, cuda_overlay.CHUNK))):
        got = launch_shape(lib, name, len(want))
        if got != want:
            raise KernelError(f"{name}: the library launches {got}, the host "
                              f"code models {want}")


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = declare(ctypes.CDLL(str(path)))
            _check_launch_shapes(lib)
            _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if the C entry point reported a CUDA error for `name`."""
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err} at launch")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def on_cpu(*tensors) -> bool:
    """True when every tensor argument lies on the CPU (non-tensors, e.g.
    scalar bounds or None, are ignored): the wrappers' test for taking the
    plain version."""
    return all(t.device.type == "cpu" for t in tensors if torch.is_tensor(t))


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
