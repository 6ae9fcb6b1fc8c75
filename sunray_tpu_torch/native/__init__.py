"""Native (C++) runtime components of the port, bound through ctypes.

- build_sah_bvh: the binned-SAH BVH builder (sah_builder.cpp, the port's
  own copy of the JAX package's), the quality / SLOW_BUILD path of the
  AsState heuristic; the device LBVH (ops/bvh.build_bvh) is the
  FAST_BUILD path.
- jpeg_lib: the baseline JPEG encoder (jpeg_encoder.cpp) behind
  utils/jpeg.write_jpeg; entropy coding is serial, so it runs on the host.

Each source is compiled with g++ at first use into build/sunray_tpu_torch/
at the repository root (ignored by git), into a temporary file that is
then renamed, under a name that carries a hash of the source, the flags
and the host's -march=native target, so that a build directory copied to
another machine is rebuilt there rather than loaded with another CPU's
instructions. A failed build raises NativeBuildError: the port does not
switch to the LBVH on its own, since that would change what a SLOW_BUILD
measures, and it has no other JPEG encoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "sah_builder.cpp"
JPEG_SOURCE = SOURCE.parent / "jpeg_encoder.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "sunray_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_libs = {}
_target = None


class NativeBuildError(RuntimeError):
    """g++ failed to build or load the native library."""


def _host_target() -> bytes:
    """What -march=native means on this host: g++'s resolved target
    options (architecture and every ISA extension it switches on)."""
    global _target
    if _target is None:
        proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, timeout=60)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ -Q --help=target exited "
                                   f"{proc.returncode}:\n"
                                   f"{proc.stderr.decode(errors='replace')}")
        _target = proc.stdout
    return _target


def library_path(source: Path = SOURCE, stem: str = "libsunray_native") -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(source.read_bytes())
    h.update(_host_target())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _load(source: Path, stem: str, declare):
    """The library built from `source` (g++ on first call), its entry
    points typed by declare(lib)."""
    with _lock:
        if source in _libs:
            return _libs[source]
        path = library_path(source, stem)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            try:
                proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp),
                                       str(source)],
                                      capture_output=True, text=True,
                                      timeout=300)
            except OSError as e:
                raise NativeBuildError(f"g++ could not run: {e}") from None
            if proc.returncode != 0:
                raise NativeBuildError(f"g++ exited {proc.returncode}:\n"
                                       f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        declare(lib)
        _libs[source] = lib
        return lib


def _declare_sah(lib):
    f, i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.sunray_build_sah_bvh.restype = ctypes.c_int
    lib.sunray_build_sah_bvh.argtypes = [f, f, f, ctypes.c_int, ctypes.c_int,
                                         i, i, i, i, f, f, i]


def _declare_jpeg(lib):
    p = ctypes.c_void_p
    lib.sunray_jpeg_encode.restype = ctypes.c_long
    lib.sunray_jpeg_encode.argtypes = [p, ctypes.c_int, ctypes.c_int, p, p, p,
                                       p, p, ctypes.c_long]


def get_lib():
    """The loaded SAH builder library, built on first call."""
    return _load(SOURCE, "libsunray_native", _declare_sah)


def jpeg_lib():
    """The loaded JPEG encoder library, built on first call."""
    return _load(JPEG_SOURCE, "libsunray_jpeg", _declare_jpeg)


def build_sah_bvh(v0, v1, v2, leaf_size: int = 4, device="cpu"):
    """Host binned-SAH build over triangles v0, v1, v2 ((T, 3) float32
    numpy arrays) -> ops.bvh.Bvh with its tensors on `device`."""
    from sunray_tpu_torch.ops.bvh import Bvh

    lib = get_lib()
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    t = v0.shape[0]
    nl_max = max(t, 1)
    child_l = np.zeros(nl_max, np.int32)
    child_r = np.zeros(nl_max, np.int32)
    range_first = np.zeros(nl_max, np.int32)
    range_last = np.zeros(nl_max, np.int32)
    node_min = np.zeros((2 * nl_max, 3), np.float32)
    node_max = np.zeros((2 * nl_max, 3), np.float32)
    leaf_tri = np.full((nl_max, leaf_size), -1, np.int32)

    def fptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def iptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    nl = lib.sunray_build_sah_bvh(
        fptr(v0), fptr(v1), fptr(v2), t, leaf_size,
        iptr(child_l), iptr(child_r), iptr(range_first), iptr(range_last),
        fptr(node_min), fptr(node_max), iptr(leaf_tri))
    if nl <= 0:
        raise NativeBuildError(f"sunray_build_sah_bvh returned {nl} for {t} "
                               "triangles")
    ni = nl - 1

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Bvh(child_l=dev(child_l[:ni]), child_r=dev(child_r[:ni]),
               node_min=dev(node_min[:ni + nl]), node_max=dev(node_max[:ni + nl]),
               leaf_tri=dev(leaf_tri[:nl]), range_first=dev(range_first[:ni]),
               range_last=dev(range_last[:ni]), num_leaves=int(nl))
