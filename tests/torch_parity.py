"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to the JAX function and
to its counterpart in sunray_tpu_torch as numpy arrays.

Importing this module pins PyTorch to one intra-op and one inter-op thread.
The suite runs in several worker processes on one host (pytest-xdist), and
each worker's default pool of one thread per core, spinning while it
waits, slowed the binned tracer's plain walks by 10-100x there. The
results do not depend on the thread count.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
torch.set_num_interop_threads(1)

GOLDEN_KW = dict(width=96, height=64, bounces=4, virtual_bounces=3,
                 ris_candidates=8, di_spatial_samples=3, gi_spatial_samples=2,
                 denoise_passes=2, lighting="nee")          # test_golden.py:36-40
CAMERA = dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
WINNER_AGREE = 0.995                             # test_restir_math.py:209


def to_numpy(obj):
    """numpy copy of a JAX array or of a (flax) dataclass of them, as the
    nested dicts that sunray_tpu_torch.convert takes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return None if obj is None else np.asarray(obj)


def t(x):
    """numpy/JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def n(x):
    return x.detach().cpu().numpy()


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10.0 * np.log10(1.0 / mse)


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernel tests run only where CUDA is present
    (python -m pytest -m gpu tests/test_torch_*.py on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


def tie_cluster_set(cs):
    """The ClusterSet cs (sunray_tpu_torch.ops.binned_trace) with the second
    cluster of each supercluster replaced by a copy of the first under ids
    shifted past every triangle id: every hit in a first cluster has an
    exact tie (the same t, u and v) in the second."""
    from sunray_tpu_torch.ops import binned_trace
    from sunray_tpu_torch.ops.cuda_binned import ID_ROW, SC_K

    c, _, k = cs.tri_pack.shape
    first = torch.arange(0, c - 1, SC_K, device=cs.tri_pack.device)
    ids = cs.tri_ids.reshape(c, k).clone()
    pack, lo, hi = cs.tri_pack.clone(), cs.aabb_lo.clone(), cs.aabb_hi.clone()
    ids[first + 1] = torch.where(ids[first] >= 0,
                                 ids[first] + int(cs.tri_ids.max()) + 1, -1)
    pack[first + 1] = pack[first]
    pack[first + 1, ID_ROW] = ids[first + 1]
    lo[first + 1], hi[first + 1] = lo[first], hi[first]
    return binned_trace.cluster_set(ids.reshape(-1), pack, lo, hi)


def check_reservoir(ps, pres, js, jres, idx="light_idx",
                    pos_keys=("light_pos",), w_key="W", m_rtol=0.0):
    """A port reservoir (seed ps, fields pres) against a JAX one (js, jres)
    by the take-flip scheme of tests/test_restir_math.py:199-216: seeds
    bit-equal, M exact (or within m_rtol), the winner equal on more than
    WINNER_AGREE of lanes, w_sum within rtol 5e-4, positions within 1e-5
    and W within 3e-4 on the lanes whose winner agrees. Returns the
    winner agreement."""
    np.testing.assert_array_equal(n(ps).astype(np.uint32), np.asarray(js))
    if m_rtol:
        np.testing.assert_allclose(n(pres["M"]), np.asarray(jres["M"]),
                                   rtol=m_rtol)
    else:
        np.testing.assert_array_equal(n(pres["M"]), np.asarray(jres["M"]))
    same = n(pres[idx]) == np.asarray(jres[idx])
    assert same.mean() > WINNER_AGREE, f"winner agreement {same.mean()}"
    np.testing.assert_allclose(n(pres["w_sum"]), np.asarray(jres["w_sum"]),
                               rtol=5e-4, atol=1e-6)
    for key in pos_keys:
        np.testing.assert_allclose(n(pres[key])[same],
                                   np.asarray(jres[key])[same],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    if w_key:
        np.testing.assert_allclose(n(pres[w_key])[same],
                                   np.asarray(jres[w_key])[same],
                                   rtol=3e-4, atol=1e-5, err_msg=w_key)
    return same.mean()


class JaxNativeUnavailable(RuntimeError):
    """The JAX package's native SAH library could not be built or loaded."""


REPO = Path(__file__).resolve().parent.parent
JAX_NATIVE_DIR = REPO / "build" / "sunray_tpu_native"


def jax_native_lib(build_dir=None):
    """The JAX package's native library (sunray_tpu/native), for certain.

    sunray_tpu.native.get_lib() writes g++'s output straight onto its final
    path and keeps a failed load as None for the life of the process, so a
    worker that loads the file while another worker is still writing it
    gets None, and build_sah_bvh then returns None. Where that happened,
    this builds the package's unchanged sah_builder.cpp with the package's
    own g++ command into a temporary file under build_dir (default:
    build/sunray_tpu_native/ at the repository root), renames it to a name
    that carries a hash of the source with os.replace, loads it with the
    package loader's argument types and installs it as the loader's
    library. Nothing under sunray_tpu/ changes. Raises JaxNativeUnavailable,
    naming the cause, when g++ is missing or fails."""
    import ctypes
    import hashlib
    import os
    import subprocess

    import sunray_tpu.native as jn

    lib = jn.get_lib()
    if lib is not None:
        return lib
    src = os.path.join(os.path.dirname(jn.__file__), "sah_builder.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = JAX_NATIVE_DIR if build_dir is None else build_dir
    out_dir = Path(out_dir)
    path = out_dir / f"_sunray_native_{digest}.so"
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-o", str(tmp), src]      # sunray_tpu/native/__init__.py:31-34
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise JaxNativeUnavailable(
                f"the JAX package's native SAH builder ({src}) could not be "
                f"built: {e}") from None
        if proc.returncode != 0:
            raise JaxNativeUnavailable(
                f"the JAX package's native SAH builder ({src}) could not be "
                f"built: g++ exited {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    f, i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.sunray_build_sah_bvh.restype = ctypes.c_int
    lib.sunray_build_sah_bvh.argtypes = [f, f, f, ctypes.c_int, ctypes.c_int,
                                         i, i, i, i, f, f, i]
    with jn._lock:
        jn._lib, jn._tried = lib, True
    return lib


def jax_build_sah(v0, v1, v2, leaf_size=4):
    """sunray_tpu.native.build_sah_bvh with its library loaded for certain
    (jax_native_lib); never None."""
    from sunray_tpu.native import build_sah_bvh

    jax_native_lib()
    b = build_sah_bvh(v0, v1, v2, leaf_size=leaf_size)
    assert b is not None, (
        "sunray_tpu.native.build_sah_bvh returned None with its library "
        "loaded: the native build returned no leaves")
    return b
