"""K1 / K2 / K14: brute-force closest-hit and occlusion trace on the card.

Counterpart of sunray_tpu/ops/pallas_trace.py (trace_closest_pallas,
trace_occluded_pallas, trace_occluded_woop); the kernels are in
csrc/trace.cu. Each wrapper takes the plain PyTorch version
(ops/intersect.py) for CPU tensors and launches its kernel for CUDA
tensors; there is no other path.

`rays` counts the rays of each query that render/trace.py serves, whatever
the tracer and the device: the full-batch ray accounting of bench.py:7-13
is the sum of these.
"""

from __future__ import annotations

import collections

import torch

from sunray_tpu_torch.ops import cuda_build, intersect
from sunray_tpu_torch.ops.intersect import T_MAX, T_MIN, Hit

rays: collections.Counter = collections.Counter()
# Trace queries by kind, one a call of render/trace.trace_closest /
# trace_occluded, counted beside `rays`.
queries: collections.Counter = collections.Counter()
# K14's launch shape (csrc/trace.cu kWoopRays, kWoopThreads; checked
# against the library's sunray_woop_launch_shape when it loads): each
# thread of a block of WOOP_THREADS traces WOOP_RAYS rays, block b thread
# t the rays b * WOOP_THREADS * WOOP_RAYS + t + j * WOOP_THREADS.
WOOP_RAYS = 8
WOOP_THREADS = 128
# K2's launch shape, the same rule (csrc/trace.cu kOccRays, kOccThreads,
# kOccWideMin; checked against sunray_occluded_launch_shape) for launches
# of OCC_WIDE_MIN rays or more; a smaller launch traces one ray a thread.
OCC_RAYS = 4
OCC_THREADS = 128
OCC_WIDE_MIN = 1 << 19
OCC_SHAPE = (OCC_RAYS, OCC_THREADS, OCC_WIDE_MIN)
# K1's launch shape, the same rule (csrc/trace.cu kCloseRays,
# kCloseThreads, kCloseWideMin; checked against
# sunray_closest_launch_shape).
CLOSEST_RAYS = 2
CLOSEST_THREADS = 128
CLOSEST_WIDE_MIN = 1 << 19
CLOSEST_SHAPE = (CLOSEST_RAYS, CLOSEST_THREADS, CLOSEST_WIDE_MIN)


def rays_a_thread(n: int, shape) -> int:
    """Rays a thread of a K2 or K1 launch over n rays at launch shape
    `shape` (rays, threads, wide_min): `rays` from wide_min rays on, else
    1."""
    return shape[0] if n >= shape[2] else 1


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


def trace_closest(tris, orig, d, tmin=T_MIN, tmax=T_MAX) -> Hit:
    """Closest hit of every ray (N, 3) over triangles (v0, v1, v2), each
    (T, 3). tmin/tmax: scalars or (N,) tensors."""
    if cuda_build.on_cpu(*tris, orig, d, tmin, tmax):
        return intersect.trace_closest_brute(tris, orig, d, tmin, tmax)
    dev = _check("trace_closest", tris, orig, d)
    n = orig.shape[0]
    tn, tn_s = _bound("trace_closest", tmin, n, dev)
    tx, tx_s = _bound("trace_closest", tmax, n, dev)
    return _launch_closest(tris, orig, d, tn, tn_s, tx, tx_s)


def _launch_closest(tris, orig, d, tn, tn_s, tx, tx_s, lib=None):
    """K1 once on checked arguments (tn, tx: per-ray bounds or None with
    the scalars tn_s, tx_s), from `lib` (default: the port's library, whose
    launches are counted)."""
    n, dev = orig.shape[0], orig.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_trace_closest(
        orig.data_ptr(), d.data_ptr(), _ptr(tn), tn_s, _ptr(tx), tx_s,
        tris[0].data_ptr(), tris[1].data_ptr(), tris[2].data_ptr(),
        n, tris[0].shape[0], t.data_ptr(), tri.data_ptr(), u.data_ptr(),
        v.data_ptr(), hit.data_ptr(), cuda_build.stream_ptr(),
    )
    cuda_build.check_launch("trace_closest", err)
    if lib is None:
        cuda_build.launches["trace_closest"] += 1
    return Hit(t, tri, u, v, hit)


def trace_occluded(tris, orig, d, tmax, tmin=T_MIN, exclude=None):
    """Any hit in [tmin, tmax] of every ray, skipping triangle exclude[i]
    (int32, -1 = none). Returns (N,) bool, True = occluded."""
    if cuda_build.on_cpu(*tris, orig, d, tmin, tmax, exclude):
        return intersect.trace_occluded_brute(tris, orig, d, tmax, tmin,
                                              exclude=exclude)
    dev = _check("trace_occluded", tris, orig, d)
    n = orig.shape[0]
    tn, tn_s = _bound("trace_occluded", tmin, n, dev)
    tx, tx_s = _bound("trace_occluded", tmax, n, dev)
    if exclude is not None:
        cuda_build.require_cuda("trace_occluded", orig, exclude)
        cuda_build.require_dtype("trace_occluded", exclude, torch.int32)
        if exclude.shape != (n,):
            raise cuda_build.KernelError("trace_occluded: exclude must be (N,)")
    return _launch_occluded(tris, orig, d, tn, tn_s, tx, tx_s, exclude)


def _launch_occluded(tris, orig, d, tn, tn_s, tx, tx_s, exclude, lib=None):
    """K2 once on checked arguments (tn, tx: per-ray bounds or None with
    the scalars tn_s, tx_s), from `lib` (default: the port's library, whose
    launches are counted)."""
    occ = torch.empty((orig.shape[0],), dtype=torch.bool, device=orig.device)
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_trace_occluded(
        orig.data_ptr(), d.data_ptr(), _ptr(tn), tn_s, _ptr(tx), tx_s,
        _ptr(exclude), tris[0].data_ptr(), tris[1].data_ptr(),
        tris[2].data_ptr(), orig.shape[0], tris[0].shape[0], occ.data_ptr(),
        cuda_build.stream_ptr(),
    )
    cuda_build.check_launch("trace_occluded", err)
    if lib is None:
        cuda_build.launches["trace_occluded"] += 1
    return occ


def trace_occluded_woop(woop, orig, d, tmax, tmin=T_MIN, exclude=None):
    """K14: any hit in [tmin, tmax] through the Woop transforms woop = (a
    (6, T, 8), eps (T, 1)) of ops/intersect.woop_matrices, skipping
    triangle exclude[i] (int32, -1 = none). Returns (N,) bool. The kernel
    packs each triangle's 22 coefficients into six 16-byte records in
    shared memory itself; the table is passed as it is."""
    a, eps = woop
    name = "trace_occluded_woop"
    if cuda_build.on_cpu(a, eps, orig, d, tmin, tmax, exclude):
        return intersect.trace_occluded_woop(woop, orig, d, tmax, tmin,
                                             exclude=exclude)
    dev = cuda_build.require_cuda(name, orig, d, a, eps)
    for x in (orig, d, a, eps):
        cuda_build.require_dtype(name, x, torch.float32)
    if orig.dim() != 2 or orig.shape[1] != 3 or orig.shape != d.shape:
        raise cuda_build.KernelError(f"{name}: expected (N, 3) rays, got "
                                     f"{tuple(orig.shape)} {tuple(d.shape)}")
    n_tris = a.shape[1]
    if a.shape != (6, n_tris, 8) or eps.shape != (n_tris, 1):
        raise cuda_build.KernelError(f"{name}: expected (6, T, 8) and (T, 1), "
                                     f"got {tuple(a.shape)} {tuple(eps.shape)}")
    n = orig.shape[0]
    tn, tn_s = _bound(name, tmin, n, dev)
    tx, tx_s = _bound(name, tmax, n, dev)
    if exclude is not None:
        cuda_build.require_cuda(name, orig, exclude)
        cuda_build.require_dtype(name, exclude, torch.int32)
        if exclude.shape != (n,):
            raise cuda_build.KernelError(f"{name}: exclude must be (N,)")
    return _launch_woop(a, eps, orig, d, tn, tn_s, tx, tx_s, exclude)


def _launch_woop(a, eps, orig, d, tn, tn_s, tx, tx_s, exclude, lib=None):
    """K14 once on checked arguments (tn, tx: per-ray bounds or None with
    the scalars tn_s, tx_s), from `lib` (default: the port's library, whose
    launches are counted)."""
    occ = torch.empty((orig.shape[0],), dtype=torch.bool, device=orig.device)
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_trace_occluded_woop(
        orig.data_ptr(), d.data_ptr(), _ptr(tn), tn_s, _ptr(tx), tx_s,
        _ptr(exclude), a.data_ptr(), eps.data_ptr(), orig.shape[0], a.shape[1],
        occ.data_ptr(), cuda_build.stream_ptr(),
    )
    cuda_build.check_launch("trace_occluded_woop", err)
    if lib is None:
        cuda_build.launches["trace_occluded_woop"] += 1
    return occ
