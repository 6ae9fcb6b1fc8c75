"""Native (C++) runtime components of the port, bound through ctypes.

build_sah_bvh: the binned-SAH BVH builder (sah_builder.cpp, the port's
own copy of the JAX package's), the quality / SLOW_BUILD path of the
AsState heuristic; the device LBVH (ops/bvh.build_bvh) is the FAST_BUILD
path. It is compiled with g++ at first use into build/sunray_tpu_torch/
at the repository root (ignored by git), under a name that carries a
hash of the source, the flags and the host's -march=native target, so
that a build directory copied to another machine is rebuilt there
rather than loaded with another CPU's instructions. A failed build raises NativeBuildError:
the port does not switch to the LBVH on its own, since that would change
what a SLOW_BUILD measures.
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
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "sunray_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
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


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_target())
    return BUILD_DIR / f"libsunray_native_{h.hexdigest()[:16]}.so"


def get_lib():
    """The loaded native library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise NativeBuildError(f"g++ exited {proc.returncode}:\n"
                                       f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        f, i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        lib.sunray_build_sah_bvh.restype = ctypes.c_int
        lib.sunray_build_sah_bvh.argtypes = [f, f, f, ctypes.c_int, ctypes.c_int,
                                             i, i, i, i, f, f, i]
        _lib = lib
        return _lib


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
