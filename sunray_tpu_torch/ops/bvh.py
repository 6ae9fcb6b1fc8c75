"""LBVH build, refit and the unified BVH walk — port of sunray_tpu/ops/bvh.py.

Build (on the device of the triangles, no host round trip): 30-bit Morton
codes of the triangle centroids in the scene box, a stable sort, leaves
of `leaf_size` consecutive sorted triangles, the Karras 2012 topology by
fixed-trip binary searches (karras_topology) and every node's box as a
range min/max over its contiguous leaf range from a sparse table
(_range_boxes). refit_bvh recomputes the boxes of a fixed topology from
moved triangles (the AS UPDATE op).

The walk is B2 (ops/cuda_bvh.py, csrc/bvh.cu): a stack walk a ray. Its
plain twin, walk_plain, advances every ray's walk in lock step; a CPU
tensor takes it, a CUDA tensor the kernel. Both read the tables of
pack_tables:

  node_ids (max(NL-1, 1), 4) int32   children (left, right) and their
                                     instance codes (0 here: inherit);
  node_box (max(NL-1, 1), 12) f32    left min, left max, right min, right max;
  leaf_v   (NL, K, 9) f32            each leaf triangle's corners;
  leaf_ids (NL, K) int32             its triangle id, -1 for padding;
  leaf_e   (NL, K, 12) f32           corner a, e1 = b - a, e2 = c - a and
                                     3 floats of padding: the kernels'
                                     three aligned float4 a triangle.

Node ids: leaf k is id k, internal row j is id NL + j (the encoding of
sunray_tpu/ops/bvh2.py, so the unified and the two-level walks share one
walker). Ids ride int32 planes, never float bit patterns.

Alpha cutout inside the walk (one launch a query on the card):
walk_alpha_plain, the plain twin of the fused kernel, runs each ray's
rounds of render/trace.py lane by lane over ops/texture.AlphaTables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sunray_tpu_torch.ops import intersect
from sunray_tpu_torch.ops.fp import dot3
from sunray_tpu_torch.ops.texture import AlphaTables, alpha_accepts

STACK_DEPTH = 64


@dataclasses.dataclass
class Bvh:
    """Topology of N_leaves leaves and N_leaves - 1 internal nodes, in the
    JAX package's local encoding: internal ids [0, NL-2], leaf k at
    NL-1+k (bvh.py:42-61)."""

    child_l: torch.Tensor      # (NL-1,) int32
    child_r: torch.Tensor      # (NL-1,) int32
    node_min: torch.Tensor     # (2NL-1, 3)
    node_max: torch.Tensor     # (2NL-1, 3)
    leaf_tri: torch.Tensor     # (NL, K) int32, -1 pad
    range_first: torch.Tensor  # (NL-1,) int32
    range_last: torch.Tensor   # (NL-1,) int32
    num_leaves: int


class WalkTables(NamedTuple):
    """What a walk reads (module docstring). root: (2,) int32 on the
    tables' device, the root's id and instance code. inst_inv (I+1, 12)
    world->object rows and inst_off (I+1,) world-triangle offsets, by
    instance code, for the two-level walk; None for the unified one.
    tlas_rows: how many of the last node rows are this frame's TLAS (the
    kernel stages them in shared memory when they fit)."""

    node_ids: torch.Tensor
    node_box: torch.Tensor
    leaf_v: torch.Tensor
    leaf_ids: torch.Tensor
    root: torch.Tensor
    inst_inv: Optional[torch.Tensor] = None
    inst_off: Optional[torch.Tensor] = None
    leaf_e: Optional[torch.Tensor] = None
    tlas_rows: int = 0

    @property
    def num_leaves(self) -> int:
        return self.leaf_ids.shape[0]

    @property
    def two_level(self) -> bool:
        return self.inst_inv is not None


def morton3(x, y, z):
    """Interleave 10-bit ints -> 30-bit Morton codes (int64 tensors)."""

    def spread(v):
        v = v.to(torch.int64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(x) << 2) | (spread(y) << 1) | spread(z)


def clz32(x):
    """Leading zeros of the uint32 values in int64 tensor x: 32 minus the
    bit length (frexp's exponent of the exact float64 value; 0 for 0)."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def morton_codes(lo_pts, hi_pts, centroid):
    """Codes of `centroid` (N, 3) quantized in the box of the points'
    min / max (bvh.py:184-190, bvh2.py:406-412)."""
    smin = lo_pts.amin(dim=0)
    smax = hi_pts.amax(dim=0)
    extent = torch.clamp(smax - smin, min=1e-6)
    q = torch.clamp(((centroid - smin) / extent) * 1023.0, 0.0, 1023.0)
    q = q.to(torch.int64)
    return morton3(q[:, 0], q[:, 1], q[:, 2])


def karras_topology(leaf_codes):
    """Karras 2012 topology over n >= 2 sorted int64 leaf codes
    (bvh.py:90-168): (child_l, child_r, first, last), each (n-1,) int32.
    Child ids below n-1 are internal, leaf k is n-1+k; [first, last] is
    the sorted-leaf range a node covers. Fixed trip counts, as JAX's."""
    n = leaf_codes.shape[0]
    dev = leaf_codes.device
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)

    def delta(j):
        valid = (j >= 0) & (j < n)
        jj = j.clamp(0, n - 1)
        x = leaf_codes[i] ^ leaf_codes[jj]
        d_code = clz32(x)
        d_idx = 32 + clz32(i ^ jj)
        d = torch.where(x == 0, d_idx, d_code)
        return torch.where(valid, d, -1)

    d = torch.sign(delta(i + 1) - delta(i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i - d)

    lmax = torch.full((n - 1,), 2, dtype=torch.int64, device=dev)
    for _ in range(31):
        lmax = torch.where(delta(i + lmax * d) > delta_min, lmax * 2, lmax)

    l = torch.zeros_like(lmax)
    step = lmax
    for _ in range(32):
        step = torch.clamp(torch.div(step, 2, rounding_mode="floor"), min=1)
        cand = l + step
        l = torch.where(delta(i + cand * d) > delta_min, cand, l)
    j = i + l * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    delta_node = delta(j)

    gamma = i.clone()
    step = l
    for _ in range(32):
        step = torch.div(step + 1, 2, rounding_mode="floor")
        cand = gamma + step * d
        ok = (delta(cand) > delta_node) & (step > 0)
        gamma = torch.where(ok, cand, gamma)
        step = torch.where(step > 1, step, 0)
    gamma = torch.where(d > 0, gamma, gamma - 1)

    leaf_base = n - 1
    child_l = torch.where(first == gamma, leaf_base + gamma, gamma)
    child_r = torch.where(last == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    return tuple(x.to(torch.int32) for x in (child_l, child_r, first, last))


def _leaf_boxes(ids, v0, v1, v2):
    """(min, max) (NL, 3) over each leaf's valid triangles."""
    valid = (ids >= 0)[:, :, None]
    g = ids.clamp(min=0).long()
    a, b, c = v0[g], v1[g], v2[g]
    lo = torch.where(valid, torch.minimum(torch.minimum(a, b), c), torch.inf)
    hi = torch.where(valid, torch.maximum(torch.maximum(a, b), c), -torch.inf)
    return lo.amin(dim=1), hi.amax(dim=1)


def _range_boxes(leaf_min, leaf_max, first, last):
    """Node boxes, internal then leaves, from the leaf boxes and the
    internal [first, last] ranges through a sparse table of pairwise
    min / max (bvh.py:241-268)."""
    n = leaf_min.shape[0]
    levels = max(1, (n - 1).bit_length())
    mins, maxs = [leaf_min], [leaf_max]
    ar = torch.arange(n, device=leaf_min.device)
    for lev in range(1, levels + 1):
        shifted = torch.clamp(ar + (1 << (lev - 1)), max=n - 1)
        mins.append(torch.minimum(mins[-1], mins[-1][shifted]))
        maxs.append(torch.maximum(maxs[-1], maxs[-1][shifted]))
    mins, maxs = torch.stack(mins), torch.stack(maxs)
    first, last = first.long(), last.long()
    length = last - first + 1
    flev = 31 - clz32(length)
    a1 = last - (1 << flev) + 1
    node_min = torch.minimum(mins[flev, first], mins[flev, a1])
    node_max = torch.maximum(maxs[flev, first], maxs[flev, a1])
    return (torch.cat([node_min, leaf_min], dim=0),
            torch.cat([node_max, leaf_max], dim=0))


def build_bvh(tris, leaf_size: int = 4) -> Bvh:
    """LBVH over triangles (v0, v1, v2), each (T, 3) (bvh.py:171-239)."""
    v0, v1, v2 = (v.detach() for v in tris)
    t = v0.shape[0]
    k = leaf_size
    dev = v0.device
    centroid = (v0 + v1 + v2) / 3.0
    codes = morton_codes(torch.minimum(torch.minimum(v0, v1), v2),
                         torch.maximum(torch.maximum(v0, v1), v2), centroid)
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]
    nl = -(-t // k)
    pad = nl * k - t
    tri_ids = torch.cat([order.to(torch.int32),
                         torch.full((pad,), -1, dtype=torch.int32,
                                    device=dev)]).reshape(nl, k)
    pad_codes = torch.cat([sorted_codes, sorted_codes[-1:].expand(pad)])
    leaf_codes = pad_codes.reshape(nl, k)[:, 0]
    leaf_min, leaf_max = _leaf_boxes(tri_ids, v0, v1, v2)
    if nl == 1:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return Bvh(z, z, leaf_min, leaf_max, tri_ids, z, z, 1)
    child_l, child_r, first, last = karras_topology(leaf_codes)
    node_min, node_max = _range_boxes(leaf_min, leaf_max, first, last)
    return Bvh(child_l, child_r, node_min, node_max, tri_ids, first, last, nl)


def refit_bvh(bvh: Bvh, tris) -> Bvh:
    """Node boxes of a fixed topology from moved triangles (bvh.py:271-291)."""
    v0, v1, v2 = (v.detach() for v in tris)
    leaf_min, leaf_max = _leaf_boxes(bvh.leaf_tri, v0, v1, v2)
    if bvh.num_leaves == 1:
        return dataclasses.replace(bvh, node_min=leaf_min, node_max=leaf_max)
    node_min, node_max = _range_boxes(leaf_min, leaf_max, bvh.range_first,
                                      bvh.range_last)
    return dataclasses.replace(bvh, node_min=node_min, node_max=node_max)


def encode_children(child, nl, leaf_off=0, node_off=None):
    """Local Bvh child ids -> walk ids: leaf k -> leaf_off + k, internal
    j -> node_off + j (node_off defaults to the leaf count nl)."""
    child = child.long()
    base = nl if node_off is None else node_off
    return torch.where(child >= nl - 1, leaf_off + child - (nl - 1),
                       base + child).to(torch.int32)


def node_rows(bvh: Bvh, leaf_off=0, node_off=None):
    """(node_ids (NL-1, 4) int32, node_box (NL-1, 12) f32) of an internal
    row each, children encoded by encode_children, instance codes 0."""
    cl, cr = bvh.child_l.long(), bvh.child_r.long()
    nl = bvh.num_leaves
    ids = torch.stack([encode_children(cl, nl, leaf_off, node_off),
                       encode_children(cr, nl, leaf_off, node_off),
                       torch.zeros_like(bvh.child_l),
                       torch.zeros_like(bvh.child_l)], dim=1)
    box = torch.cat([bvh.node_min[cl], bvh.node_max[cl], bvh.node_min[cr],
                     bvh.node_max[cr]], dim=1)
    return ids.contiguous(), box.contiguous()


def leaf_rows(bvh: Bvh, v0, v1, v2):
    """(leaf_v (NL, K, 9), leaf_ids (NL, K)) of the leaves' triangles."""
    ids = bvh.leaf_tri
    g = ids.clamp(min=0).long()
    return torch.cat([v0[g], v1[g], v2[g]], dim=2).contiguous(), ids.contiguous()


def leaf_edges(leaf_v):
    """(NL, K, 12) float32 rows (a, b - a, c - a, 0, 0, 0) of leaf_v's
    corners: the float32 differences the walk's test takes."""
    a, b, c = leaf_v[..., 0:3], leaf_v[..., 3:6], leaf_v[..., 6:9]
    return torch.cat([a, b - a, c - a, torch.zeros_like(a)], dim=-1).contiguous()


def pack_tables(bvh: Bvh, tris) -> WalkTables:
    """The walk's tables of a unified BVH over world triangles `tris`
    (the rows of bvh.py:321-373's node_pack and leaf_pack)."""
    v0, v1, v2 = (v.detach() for v in tris)
    nl = bvh.num_leaves
    dev = v0.device
    if nl > 1:
        node_ids, node_box = node_rows(bvh)
        root = nl
    else:
        node_ids = torch.zeros((1, 4), dtype=torch.int32, device=dev)
        node_box = torch.zeros((1, 12), dtype=torch.float32, device=dev)
        root = 0
    leaf_v, leaf_ids = leaf_rows(bvh, v0, v1, v2)
    return WalkTables(node_ids, node_box, leaf_v, leaf_ids,
                      torch.tensor([root, 0], dtype=torch.int32, device=dev),
                      leaf_e=leaf_edges(leaf_v))


# -- the walk's plain twin ----------------------------------------------------

def inverse_dir(d):
    """1 / d, or 1e12 where |d| <= 1e-12 (bvh.py:383)."""
    return torch.where(d.abs() > 1e-12, 1.0 / d, 1e12)


def to_object(inst_inv, code, o, d):
    """World ray (o, d) into the object space of instance code `code`:
    rows of inst_inv (bvh2.py:497-501). o' = A o + b with each row's dot
    as fma(a2, o2, fma(a1, o1, a0 * o0)) and b added after; d' = A d, not
    renormalized. Returns (o', d') as tuples of three (N,) tensors."""
    r = inst_inv[code.long()]
    oo = tuple(dot3(r[:, 3 * i], o[0], r[:, 3 * i + 1], o[1],
                    r[:, 3 * i + 2], o[2]) + r[:, 9 + i] for i in range(3))
    dd = tuple(dot3(r[:, 3 * i], d[0], r[:, 3 * i + 1], d[1],
                    r[:, 3 * i + 2], d[2]) for i in range(3))
    return oo, dd


def tri_hits(o, d, lv, tmin, tmax, edges=False):
    """Moller-Trumbore of one ray a lane against its leaf's K triangles
    (bvh.py:304-319), rounded as the brute tracer's test
    (intersect.mt_components). o, d: tuples of three (N, 1); lv (N, K,
    9) corners, or with edges (N, K, 12) leaf_edges rows; tmin, tmax (N,
    1). (t, u, v, ok) (N, K)."""
    cols = tuple(tuple(lv[..., 3 * j + c] for c in range(3)) for j in range(3))
    test = intersect.mt_edges if edges else intersect.mt_components
    return test(o, d, *cols, tmin, tmax)


def slab(o, inv_d, lo, hi, tmin, tmax):
    """Slab test of (N,) rays against (N, 3) boxes (bvh.py:293-300):
    (hit, t_near)."""
    t1 = torch.stack([(lo[:, c] - o[c]) * inv_d[c] for c in range(3)], 1)
    t2 = torch.stack([(hi[:, c] - o[c]) * inv_d[c] for c in range(3)], 1)
    tn = torch.minimum(t1, t2).amax(dim=1)
    tf = torch.maximum(t1, t2).amin(dim=1)
    return (tn <= tf) & (tf >= tmin) & (tn <= tmax), tn


class WalkState(NamedTuple):
    t: torch.Tensor
    tri: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    found: torch.Tensor
    box_tests: torch.Tensor    # (N,) int64 slab tests run
    tri_tests: torch.Tensor    # (N,) int64 triangle tests run


def walk_plain(tables: WalkTables, o, d, tmin, tmax, any_hit: bool,
               exclude=None, edges=False) -> WalkState:
    """The walk of every ray in lock step: the plain twin of B2 (unified)
    and B3 (two-level) in csrc/bvh.cu, with JAX's rules (bvh.py:375-475,
    bvh2.py:454-565):

    - pop the top entry; a leaf tests its K triangles against [tmin,
      best t], the first of the least t in the leaf wins, and it replaces
      the best (a later leaf at an equal t too);
    - an internal node slab-tests both children against [tmin, best t],
      pushes the far child then the near one (the left is near when
      tn_l <= tn_r), the stack pointer clamped to STACK_DEPTH - 1;
    - two-level: the popped entry's instance code picks the world->object
      transform of the ray; a child's code 0 inherits its parent's; leaf
      ids become world ids by the code's offset;
    - any_hit stops a ray at its first leaf with a hit; exclude (N,)
      int32 drops that (world) triangle id.

    o, d (N, 3); tmin, tmax (N,). Also counts each ray's box and
    triangle tests (the work the reference's order needs). edges: read
    the leaf triangles from leaf_e, as the kernels do (the same bits)."""
    n, dev = o.shape[0], o.device
    nl = tables.num_leaves
    k = tables.leaf_ids.shape[1]
    n_nodes = tables.node_ids.shape[0]
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    istack = torch.zeros_like(stack)
    stack[:, 0] = tables.root[0]
    istack[:, 0] = tables.root[1]
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = tmax.to(torch.float32).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    box_tests = torch.zeros((n,), dtype=torch.int64, device=dev)
    tri_tests = torch.zeros_like(box_tests)
    oc = tuple(o[:, c] for c in range(3))
    dc = tuple(d[:, c] for c in range(3))
    inv_d = tuple(inverse_dir(x) for x in dc)
    while True:
        live = sp > 0
        if any_hit:
            live &= ~found
        lanes = live.nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        s = sp[lanes] - 1
        node = stack[lanes, s].long()
        code = istack[lanes, s]
        if tables.two_level:
            ro, rd = to_object(tables.inst_inv, code,
                               tuple(x[lanes] for x in oc),
                               tuple(x[lanes] for x in dc))
            rinv = tuple(inverse_dir(x) for x in rd)
        else:
            ro = tuple(x[lanes] for x in oc)
            rd = tuple(x[lanes] for x in dc)
            rinv = tuple(x[lanes] for x in inv_d)
        is_leaf = node < nl
        tn_lane, bt = tmin[lanes], best_t[lanes]

        # Leaf: K triangles from one row.
        row = node.clamp(0, nl - 1)
        ids = tables.leaf_ids[row]                                # (n, K)
        if tables.two_level:
            wids = ids + tables.inst_off[code.long()][:, None]
        else:
            wids = ids
        leaf = (tables.leaf_e if edges else tables.leaf_v)[row]
        t, u, v, ok = tri_hits(tuple(x[:, None] for x in ro),
                               tuple(x[:, None] for x in rd), leaf,
                               tn_lane[:, None], bt[:, None], edges)
        ok &= (ids >= 0) & is_leaf[:, None]
        if exclude is not None:
            ok &= wids != exclude[lanes, None]
        t = torch.where(ok, t, torch.inf)
        kb = torch.argmin(t, dim=1, keepdim=True)
        leaf_hit = ok.gather(1, kb)[:, 0]
        new_t = torch.where(leaf_hit, t.gather(1, kb)[:, 0], bt)
        best_t[lanes] = new_t
        best_tri[lanes] = torch.where(leaf_hit, wids.gather(1, kb)[:, 0],
                                      best_tri[lanes])
        best_u[lanes] = torch.where(leaf_hit, u.gather(1, kb)[:, 0],
                                    best_u[lanes])
        best_v[lanes] = torch.where(leaf_hit, v.gather(1, kb)[:, 0],
                                    best_v[lanes])
        found[lanes] |= leaf_hit
        tri_tests[lanes] += torch.where(is_leaf, (ids >= 0).sum(dim=1), 0)

        # Internal: both children's boxes and ids from one row.
        nrow = (node - nl).clamp(0, n_nodes - 1)
        cid = tables.node_ids[nrow]                               # (n, 4)
        box = tables.node_box[nrow]                               # (n, 12)
        hit_l, tn_l = slab(ro, rinv, box[:, 0:3], box[:, 3:6], tn_lane, new_t)
        hit_r, tn_r = slab(ro, rinv, box[:, 6:9], box[:, 9:12], tn_lane, new_t)
        hit_l &= ~is_leaf
        hit_r &= ~is_leaf
        box_tests[lanes] += torch.where(is_leaf, 0, 2)
        il = torch.where(cid[:, 2] > 0, cid[:, 2], code)
        ir = torch.where(cid[:, 3] > 0, cid[:, 3], code)
        l_near = tn_l <= tn_r
        far_c = torch.where(l_near, cid[:, 1], cid[:, 0])
        far_i = torch.where(l_near, ir, il)
        far_h = torch.where(l_near, hit_r, hit_l)
        near_c = torch.where(l_near, cid[:, 0], cid[:, 1])
        near_i = torch.where(l_near, il, ir)
        near_h = torch.where(l_near, hit_l, hit_r)
        stack[lanes, s] = torch.where(far_h, far_c, stack[lanes, s])
        istack[lanes, s] = torch.where(far_h, far_i, istack[lanes, s])
        s1 = s + far_h.long()
        s1c = s1.clamp(max=STACK_DEPTH - 1)
        stack[lanes, s1c] = torch.where(near_h, near_c, stack[lanes, s1c])
        istack[lanes, s1c] = torch.where(near_h, near_i, istack[lanes, s1c])
        sp[lanes] = (s1 + near_h.long()).clamp(max=STACK_DEPTH - 1)
    return WalkState(best_t, best_tri, best_u, best_v, found, box_tests,
                     tri_tests)


def _rays(orig, d, tmin, tmax):
    orig = orig.reshape(-1, 3).detach().to(torch.float32).contiguous()
    d = d.reshape(-1, 3).detach().to(torch.float32).contiguous()
    n = orig.shape[0]

    def per_ray(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=orig.device)
        return x.reshape(-1).expand(n).contiguous() if x.dim() else \
            x.expand(n).contiguous()

    return orig, d, per_ray(tmin), per_ray(tmax)


def trace_closest_walk(tables: WalkTables, orig, d, tmin=intersect.T_MIN,
                       tmax=intersect.T_MAX) -> intersect.Hit:
    """Closest hit through the walk: B2 or B3 (by the tables) on the card,
    walk_plain on the CPU. A miss: t = inf, tri = -1, u = v = 0
    (bvh.py:505-532)."""
    from sunray_tpu_torch.ops import cuda_bvh

    return cuda_bvh.walk_closest(tables, *_rays(orig, d, tmin, tmax))


def trace_occluded_walk(tables: WalkTables, orig, d, tmax,
                        tmin=intersect.T_MIN, exclude=None):
    """Any hit in [tmin, tmax] (bool (N,)) through the walk; exclude:
    optional (N,) int32 (world) triangle id to ignore (bvh.py:535-569)."""
    from sunray_tpu_torch.ops import cuda_bvh

    orig, d, tn, tx = _rays(orig, d, tmin, tmax)
    if exclude is not None:
        exclude = exclude.reshape(-1).to(torch.int32).contiguous()
    return cuda_bvh.walk_occluded(tables, orig, d, tn, tx, exclude)


# -- alpha cutout inside the walk ----------------------------------------------

def walk_alpha_plain(tables: WalkTables, alpha: AlphaTables, o, d, tmin,
                     tmax, rounds: int, any_hit: bool,
                     exclude=None) -> WalkState:
    """The plain twin of the fused alpha walk (csrc/bvh.cu, kAlpha): each
    ray's rounds of render/trace.py, the rays still undecided walked again
    together (walk_plain on them alone):

    - closest (any_hit False): walk on [tmin, tmax]; while the hit is
      rejected (ops/texture.alpha_accepts), walk again from t + 1e-4, at
      most `rounds` times. t (inf on a miss), tri,
      u, v, found of the last walk;
    - occlusion: at most rounds + 1 closest walks on [tmin, tmax]; the
      first hit that is not exclude's id and is accepted occludes (found);
      a miss ends the ray; t, tri, u, v are None.

    The test counts are each ray's sums over its walks."""
    n, dev = o.shape[0], o.device
    box = torch.zeros((n,), dtype=torch.int64, device=dev)
    tri_tests = torch.zeros_like(box)
    t = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    cur = tmin.to(torch.float32).clone()
    pending = torch.ones_like(found)
    for i in range(rounds + 1):
        lanes = pending.nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        s = walk_plain(tables, o[lanes], d[lanes], cur[lanes], tmax[lanes],
                       any_hit=False)
        box[lanes] += s.box_tests
        tri_tests[lanes] += s.tri_tests
        ok = alpha_accepts(alpha, torch.where(s.found, s.tri, 0), s.u, s.v)
        if any_hit:
            keep = s.found if exclude is None else s.found & (s.tri
                                                              != exclude[lanes])
            found[lanes] = keep & ok
            again = s.found & ~(keep & ok)
        else:
            t[lanes] = torch.where(s.found, s.t, torch.inf)
            tri[lanes], u[lanes], v[lanes] = s.tri, s.u, s.v
            found[lanes] = s.found
            again = s.found & ~ok & (i < rounds)
        cur[lanes] = torch.where(again, s.t + 1e-4, cur[lanes])
        pending[lanes] = again
    if any_hit:
        return WalkState(None, None, None, None, found, box, tri_tests)
    return WalkState(t, tri, u, v, found, box, tri_tests)


def trace_closest_walk_alpha(tables: WalkTables, alpha: AlphaTables, orig, d,
                             tmin, tmax, rounds: int) -> intersect.Hit:
    """Closest hit with alpha cutout in one fused walk (the kernel on the
    card, walk_alpha_plain on the CPU)."""
    from sunray_tpu_torch.ops import cuda_bvh

    return cuda_bvh.walk_closest_alpha(tables, alpha,
                                       *_rays(orig, d, tmin, tmax), rounds)


def trace_occluded_walk_alpha(tables: WalkTables, alpha: AlphaTables, orig, d,
                              tmax, tmin, rounds: int, exclude=None):
    """Occlusion with alpha cutout in one fused walk on [tmin, tmax]
    (bool (N,)); exclude: optional (N,) int32 world triangle id."""
    from sunray_tpu_torch.ops import cuda_bvh

    orig, d, tn, tx = _rays(orig, d, tmin, tmax)
    if exclude is not None:
        exclude = exclude.reshape(-1).to(torch.int32).contiguous()
    return cuda_bvh.walk_occluded_alpha(tables, alpha, orig, d, tn, tx, rounds,
                                        exclude)


def trace_closest_bvh(bvh: Bvh, tris, orig, d, tmin=intersect.T_MIN,
                      tmax=intersect.T_MAX) -> intersect.Hit:
    """Closest hit against the unified BVH over world triangles `tris`."""
    return trace_closest_walk(pack_tables(bvh, tris), orig, d, tmin, tmax)


def trace_occluded_bvh(bvh: Bvh, tris, orig, d, tmax, tmin=intersect.T_MIN,
                       exclude=None):
    """Occlusion against the unified BVH over world triangles `tris`."""
    return trace_occluded_walk(pack_tables(bvh, tris), orig, d, tmax, tmin,
                               exclude)

