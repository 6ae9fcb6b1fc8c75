"""B2 and B3: the BVH stack walks (csrc/bvh.cu), one ray a thread.

B2 walks the unified BVH (sunray_tpu/ops/bvh.py's _traverse_one,
:375-475), B3 the two-level BVH (sunray_tpu/ops/bvh2.py's
_traverse_one2, :454-565). Both are jnp while-loops in the JAX package,
not pallas_calls; a per-ray stack walk is a one-thread program on the
card. Tables with inst_inv walk two levels (B3, counted "bvh2_walk"),
others one (B2, counted "bvh_walk").

walk_closest / walk_occluded take ops/bvh.WalkTables and per-ray rays
(N, 3), tmin and tmax (N,): the plain twin (ops/bvh.walk_plain) on CPU
tensors, the kernel on CUDA tensors.
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import cuda_build
from sunray_tpu_torch.ops.bvh import STACK_DEPTH, WalkTables, walk_plain
from sunray_tpu_torch.ops.intersect import Hit

# csrc/bvh.cu's launch shape (sunray_bvh_launch_shape; checked when the
# library loads): threads a block, stack entries.
THREADS = 128
LAUNCH_SHAPE = (THREADS, STACK_DEPTH)


def kernel_name(tables: WalkTables) -> str:
    return "bvh2_walk" if tables.two_level else "bvh_walk"


def walk_closest(tables: WalkTables, o, d, tmin, tmax) -> Hit:
    """Closest hit of each ray: t (inf on a miss), tri (world id, -1 on
    a miss), u, v (0 on a miss), hit."""
    if cuda_build.on_cpu(o, *tables):
        s = walk_plain(tables, o, d, tmin, tmax, any_hit=False)
        return Hit(torch.where(s.found, s.t, torch.inf), s.tri, s.u, s.v,
                   s.found)
    t, tri, u, v, hit = _launch(tables, o, d, tmin, tmax, None, any_hit=False)
    return Hit(t, tri, u, v, hit)


def walk_occluded(tables: WalkTables, o, d, tmin, tmax, exclude=None):
    """Any hit on [tmin, tmax]: bool (N,). exclude: (N,) int32 world
    triangle id to ignore, or None."""
    if cuda_build.on_cpu(o, exclude, *tables):
        return walk_plain(tables, o, d, tmin, tmax, any_hit=True,
                          exclude=exclude).found
    return _launch(tables, o, d, tmin, tmax, exclude, any_hit=True)[4]


def _check(name, tables, o, d, tmin, tmax, exclude):
    present = [x for x in tables if x is not None]
    cuda_build.require_cuda(name, o, d, tmin, tmax, *present,
                            *([] if exclude is None else [exclude]))
    for x in (o, d, tmin, tmax, tables.node_box, tables.leaf_v):
        cuda_build.require_dtype(name, x, torch.float32)
    for x in (tables.node_ids, tables.leaf_ids, tables.root):
        cuda_build.require_dtype(name, x, torch.int32)
    if tables.two_level:
        cuda_build.require_dtype(name, tables.inst_inv, torch.float32)
        cuda_build.require_dtype(name, tables.inst_off, torch.int32)
    if exclude is not None:
        cuda_build.require_dtype(name, exclude, torch.int32)
    n = o.shape[0]
    if (o.shape != (n, 3) or d.shape != (n, 3) or tmin.shape != (n,)
            or tmax.shape != (n,)
            or (exclude is not None and exclude.shape != (n,))
            or tables.node_ids.shape[1:] != (4,)
            or tables.node_box.shape[1:] != (12,)
            or tables.node_ids.shape[0] != tables.node_box.shape[0]
            or tables.leaf_v.shape != (*tables.leaf_ids.shape, 9)
            or tables.root.shape != (2,)):
        raise cuda_build.KernelError(f"{name}: bad shapes")


def _launch(tables: WalkTables, o, d, tmin, tmax, exclude, any_hit, lib=None,
            tests=None):
    """B2 or B3 once: (t, tri, u, v, hit), the first four None for any
    hit. lib: another build of the library (launches then uncounted).
    tests: an (N, 2) int32 tensor that gets each ray's box and triangle
    tests (the plain twin's box_tests and tri_tests), or None."""
    name = kernel_name(tables)
    _check(name, tables, o, d, tmin, tmax, exclude)
    n, dev = o.shape[0], o.device
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    if any_hit:
        t = tri = u = v = None
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        tri = torch.empty((n,), dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
    ptr = lambda x: None if x is None else x.data_ptr()
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_bvh_walk(
        ptr(tables.node_ids), ptr(tables.node_box), tables.node_ids.shape[0],
        ptr(tables.leaf_v), ptr(tables.leaf_ids), tables.num_leaves,
        tables.leaf_ids.shape[1], ptr(tables.root), ptr(tables.inst_inv),
        ptr(tables.inst_off), int(tables.two_level), int(any_hit),
        ptr(o), ptr(d), ptr(tmin), ptr(tmax), ptr(exclude), n,
        ptr(t), ptr(tri), ptr(u), ptr(v), ptr(hit), ptr(tests),
        cuda_build.stream_ptr())
    cuda_build.check_launch(name, err)
    if lib is None and n > 0:
        cuda_build.launches[name] += 1
    return t, tri, u, v, hit
