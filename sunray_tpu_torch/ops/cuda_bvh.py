"""B2 and B3: the BVH stack walks (csrc/bvh.cu), one ray a thread.

B2 walks the unified BVH (sunray_tpu/ops/bvh.py's _traverse_one,
:375-475), B3 the two-level BVH (sunray_tpu/ops/bvh2.py's
_traverse_one2, :454-565). Both are jnp while-loops in the JAX package,
not pallas_calls; a per-ray stack walk is a one-thread program on the
card. Tables with inst_inv walk two levels (B3, counted "bvh2_walk"),
others one (B2, counted "bvh_walk").

walk_closest / walk_occluded take ops/bvh.WalkTables and per-ray rays
(N, 3), tmin and tmax (N,): the plain twin (ops/bvh.walk_plain) on CPU
tensors, the kernel on CUDA tensors. walk_closest_alpha /
walk_occluded_alpha also take ops/texture.AlphaTables and run alpha cutout
inside the walk, a ray's rounds in its thread: one launch a query (the
plain twin ops/bvh.walk_alpha_plain on the CPU).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import cuda_build
from sunray_tpu_torch.ops.bvh import (
    STACK_DEPTH,
    WalkTables,
    walk_alpha_plain,
    walk_plain,
)
from sunray_tpu_torch.ops.intersect import Hit
from sunray_tpu_torch.ops.texture import AlphaTables

# csrc/bvh.cu's launch shape (sunray_bvh_launch_shape; checked when the
# library loads): threads a block, stack entries, the entries a thread
# keeps in shared memory, the TLAS rows staged in shared memory at most.
THREADS = 128
SHARED_ENTRIES = 16
TLAS_SMEM_ROWS = 128
LAUNCH_SHAPE = (THREADS, STACK_DEPTH, SHARED_ENTRIES, TLAS_SMEM_ROWS)


def kernel_name(tables: WalkTables) -> str:
    return "bvh2_walk" if tables.two_level else "bvh_walk"


def walk_closest(tables: WalkTables, o, d, tmin, tmax) -> Hit:
    """Closest hit of each ray on [tmin, tmax] (tmax may be inf): t (inf
    on a miss), tri (world id, -1 on a miss), u, v (0 on a miss), hit."""
    if cuda_build.on_cpu(o, *tables):
        s = walk_plain(tables, o, d, tmin, tmax, any_hit=False)
        return Hit(torch.where(s.found, s.t, torch.inf), s.tri, s.u, s.v,
                   s.found)
    return Hit(*_launch(tables, o, d, tmin, tmax, None, any_hit=False))


def walk_occluded(tables: WalkTables, o, d, tmin, tmax, exclude=None):
    """Any hit on [tmin, tmax] (tmax may be inf): bool (N,). exclude:
    (N,) int32 world triangle id to ignore, or None."""
    if cuda_build.on_cpu(o, exclude, *tables):
        return walk_plain(tables, o, d, tmin, tmax, any_hit=True,
                          exclude=exclude).found
    return _launch(tables, o, d, tmin, tmax, exclude, any_hit=True)[4]


def walk_closest_alpha(tables: WalkTables, alpha: AlphaTables, o, d, tmin,
                       tmax, rounds: int) -> Hit:
    """Closest hit past rejected alpha-cutout hits, at most `rounds` walks
    again (render/trace.py's rounds, ray by ray): as walk_closest."""
    if cuda_build.on_cpu(o, *tables, *alpha.tensors()):
        s = walk_alpha_plain(tables, alpha, o, d, tmin, tmax, rounds,
                             any_hit=False)
        return Hit(s.t, s.tri, s.u, s.v, s.found)
    return Hit(*_launch(tables, o, d, tmin, tmax, None, any_hit=False,
                        alpha=alpha, rounds=rounds))


def walk_occluded_alpha(tables: WalkTables, alpha: AlphaTables, o, d, tmin,
                        tmax, rounds: int, exclude=None):
    """Occlusion through alpha cutout on [tmin, tmax] (render/trace.py's
    rounds, ray by ray): bool (N,)."""
    if cuda_build.on_cpu(o, exclude, *tables, *alpha.tensors()):
        return walk_alpha_plain(tables, alpha, o, d, tmin, tmax, rounds,
                                any_hit=True, exclude=exclude).found
    return _launch(tables, o, d, tmin, tmax, exclude, any_hit=True,
                   alpha=alpha, rounds=rounds)[4]


def node_bits(tables: WalkTables) -> int:
    """B3's stack words: the bits of the node id when (node, code) fit in
    32 bits, else 0 (64-bit words, 2-5% slower on the real-scene frame's
    queries). B2 words hold the node id alone."""
    if not tables.two_level:
        return 0
    bits = max(1, (tables.num_leaves + tables.node_ids.shape[0] - 1).bit_length())
    codes = tables.inst_inv.shape[0] - 1
    return bits if bits < 32 and codes.bit_length() <= 32 - bits else 0


def smem_rows(tables: WalkTables) -> int:
    """The TLAS rows the kernel stages in shared memory: all of them when
    they fit, else none."""
    return tables.tlas_rows if tables.tlas_rows <= TLAS_SMEM_ROWS else 0


def _check(name, tables, o, d, tmin, tmax, exclude, alpha):
    present = [x for x in tables if torch.is_tensor(x)]
    extra = [] if alpha is None else list(alpha.tensors())
    cuda_build.require_cuda(name, o, d, tmin, tmax, *present, *extra,
                            *([] if exclude is None else [exclude]))
    if tables.leaf_e is None:
        raise cuda_build.KernelError(f"{name}: tables without leaf_e")
    for x in (o, d, tmin, tmax, tables.node_box, tables.leaf_e):
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
            or tables.leaf_e.shape != (*tables.leaf_ids.shape, 12)
            or tables.root.shape != (2,)
            or not 0 <= tables.tlas_rows <= tables.node_ids.shape[0]):
        raise cuda_build.KernelError(f"{name}: bad shapes")
    if alpha is None:
        return
    a = alpha.atlas
    for x in (alpha.uvs, alpha.base_color, alpha.cutoff, a.data):
        cuda_build.require_dtype(name, x, torch.float32)
    for x in (alpha.tri_mat, alpha.tri_vidx, alpha.mat_tex, a.size, a.wrap,
              a.filt):
        cuda_build.require_dtype(name, x, torch.int32)
    p, m = alpha.mat_tex.shape[0], a.data.shape[0]
    if (alpha.tri_vidx.shape != (alpha.tri_mat.shape[0], 3)
            or alpha.uvs.dim() != 3 or alpha.uvs.shape[1:] != (5, 2)
            or alpha.base_color.shape != (p, 4) or alpha.cutoff.shape != (p,)
            or a.data.dim() != 4 or a.data.shape[3] != 4
            or a.size.shape != (m, 2) or a.wrap.shape != (m, 2)
            or a.filt.shape != (m,)):
        raise cuda_build.KernelError(f"{name}: bad alpha table shapes")


def _launch(tables: WalkTables, o, d, tmin, tmax, exclude, any_hit, lib=None,
            tests=None, alpha=None, rounds=0):
    """B2 or B3 once: (t, tri, u, v, hit), the first four None for any
    hit. lib: another build of the library (launches then uncounted).
    tests: an (N, 2) int32 tensor that gets each ray's box and triangle
    tests (the plain twin's box_tests and tri_tests), or None. alpha:
    AlphaTables for the fused alpha walk (at most `rounds` walks again),
    or None."""
    name = kernel_name(tables)
    _check(name, tables, o, d, tmin, tmax, exclude, alpha)
    n, dev = o.shape[0], o.device
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    if any_hit:
        t = tri = u = v = None
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        tri = torch.empty((n,), dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
    nxt = torch.empty((1,), dtype=torch.int64, device=dev)  # the ray counter
    ptr = lambda x: None if x is None else x.data_ptr()
    kernels = cuda_build.library() if lib is None else lib
    walk = (ptr(tables.node_ids), ptr(tables.node_box), tables.node_ids.shape[0],
            ptr(tables.leaf_e), ptr(tables.leaf_ids), tables.num_leaves,
            tables.leaf_ids.shape[1], ptr(tables.root), ptr(tables.inst_inv),
            ptr(tables.inst_off), smem_rows(tables), node_bits(tables),
            int(any_hit))
    rays = (ptr(o), ptr(d), ptr(tmin), ptr(tmax), ptr(exclude), n, ptr(t),
            ptr(tri), ptr(u), ptr(v), ptr(hit), ptr(tests), ptr(nxt),
            cuda_build.stream_ptr())
    if alpha is None:
        err = kernels.sunray_bvh_walk(*walk, *rays)
    else:
        a = alpha.atlas
        err = kernels.sunray_bvh_walk_alpha(
            *walk, ptr(alpha.tri_mat), ptr(alpha.tri_vidx), ptr(alpha.uvs),
            ptr(alpha.mat_tex), ptr(alpha.base_color), ptr(alpha.cutoff),
            ptr(a.data), ptr(a.size), ptr(a.wrap), ptr(a.filt),
            a.data.shape[1], a.data.shape[2], int(a.trivial), int(rounds),
            *rays)
    cuda_build.check_launch(name, err)
    if lib is None and n > 0:
        cuda_build.launches[name] += 1
    return t, tri, u, v, hit
