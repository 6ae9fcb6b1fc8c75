"""K1 / K2: brute-force closest-hit and occlusion trace on the card.

Counterpart of sunray_tpu/ops/pallas_trace.py (trace_closest_pallas,
trace_occluded_pallas); the kernels are in csrc/trace.cu. Each wrapper
takes the plain PyTorch version (ops/intersect.py) for CPU tensors and
launches its kernel for CUDA tensors; there is no other path.

`rays` counts the rays handed to each query, whatever the device: the
full-batch ray accounting of bench.py:7-13 is the sum of these.
"""

from __future__ import annotations

import collections

import torch

from sunray_tpu_torch.ops import cuda_build, intersect
from sunray_tpu_torch.ops.intersect import T_MAX, T_MIN, Hit

rays: collections.Counter = collections.Counter()


def _bound(name, x, n, device):
    """Scalar bound -> (None, value); (N,) tensor -> (tensor, 0)."""
    if torch.is_tensor(x) and x.dim() > 0:
        x = x.reshape(-1)
        if x.shape[0] != n:
            raise cuda_build.KernelError(f"{name}: bound has {x.shape[0]} "
                                         f"entries for {n} rays")
        cuda_build.require_dtype(name, x, torch.float32)
        cuda_build.require_cuda(name, x)
        if x.device != device:
            raise cuda_build.KernelError(f"{name}: bound on {x.device}")
        return x, 0.0
    return None, float(x)


def _check(name, tris, orig, d):
    v0, v1, v2 = tris
    dev = cuda_build.require_cuda(name, orig, d, v0, v1, v2)
    for t in (orig, d, v0, v1, v2):
        cuda_build.require_dtype(name, t, torch.float32)
        if t.dim() != 2 or t.shape[1] != 3:
            raise cuda_build.KernelError(f"{name}: expected (N, 3), got "
                                         f"{tuple(t.shape)}")
    if orig.shape != d.shape or not (v0.shape == v1.shape == v2.shape):
        raise cuda_build.KernelError(f"{name}: mismatched shapes")
    return dev


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_cpu(tris, *tensors):
    return all(x.device.type == "cpu" for x in (*tris, *tensors)
               if torch.is_tensor(x))


def trace_closest(tris, orig, d, tmin=T_MIN, tmax=T_MAX) -> Hit:
    """Closest hit of every ray (N, 3) over triangles (v0, v1, v2), each
    (T, 3). tmin/tmax: scalars or (N,) tensors."""
    rays["closest"] += orig.shape[0]
    if _on_cpu(tris, orig, d, tmin, tmax):
        return intersect.trace_closest_brute(tris, orig, d, tmin, tmax)
    dev = _check("trace_closest", tris, orig, d)
    n, n_tris = orig.shape[0], tris[0].shape[0]
    tn, tn_s = _bound("trace_closest", tmin, n, dev)
    tx, tx_s = _bound("trace_closest", tmax, n, dev)
    lib = cuda_build.library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    err = lib.sunray_trace_closest(
        orig.data_ptr(), d.data_ptr(), _ptr(tn), tn_s, _ptr(tx), tx_s,
        tris[0].data_ptr(), tris[1].data_ptr(), tris[2].data_ptr(),
        n, n_tris, t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        hit.data_ptr(), cuda_build.stream_ptr(),
    )
    cuda_build.check_launch("trace_closest", err)
    cuda_build.launches["trace_closest"] += 1
    return Hit(t, tri, u, v, hit)


def trace_occluded(tris, orig, d, tmax, tmin=T_MIN, exclude=None):
    """Any hit in [tmin, tmax] of every ray, skipping triangle exclude[i]
    (int32, -1 = none). Returns (N,) bool, True = occluded."""
    rays["occluded"] += orig.shape[0]
    if _on_cpu(tris, orig, d, tmin, tmax, exclude):
        return intersect.trace_occluded_brute(tris, orig, d, tmax, tmin,
                                              exclude=exclude)
    dev = _check("trace_occluded", tris, orig, d)
    n, n_tris = orig.shape[0], tris[0].shape[0]
    tn, tn_s = _bound("trace_occluded", tmin, n, dev)
    tx, tx_s = _bound("trace_occluded", tmax, n, dev)
    if exclude is not None:
        cuda_build.require_cuda("trace_occluded", orig, exclude)
        cuda_build.require_dtype("trace_occluded", exclude, torch.int32)
        if exclude.shape != (n,):
            raise cuda_build.KernelError("trace_occluded: exclude must be (N,)")
    lib = cuda_build.library()
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    err = lib.sunray_trace_occluded(
        orig.data_ptr(), d.data_ptr(), _ptr(tn), tn_s, _ptr(tx), tx_s,
        _ptr(exclude), tris[0].data_ptr(), tris[1].data_ptr(),
        tris[2].data_ptr(), n, n_tris, occ.data_ptr(), cuda_build.stream_ptr(),
    )
    cuda_build.check_launch("trace_occluded", err)
    cuda_build.launches["trace_occluded"] += 1
    return occ
