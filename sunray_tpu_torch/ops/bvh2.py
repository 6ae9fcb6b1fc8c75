"""Two-level BVH: per-mesh object-space BLASes + a per-frame instance
TLAS — port of sunray_tpu/ops/bvh2.py.

build_blas_set runs once at load on the host (numpy around the native
SAH builder): one BLAS a primitive, in object space, shared by every
instance of it. build_frame_tlas runs every frame on the scene's device:
instance world boxes from the 8 transformed corners of each BLAS root
box, the Karras topology over their Morton codes (ops/bvh.py), and the
world->object rows of every instance. The walk is B3 (ops/cuda_bvh.py):
a ray enters an instance's subtree in that instance's object space (the
direction not renormalized, so t stays the world t) and a leaf's ids
become world triangle ids by the instance's offset.

Node ids, as in ops/bvh.py: leaf row k is id k; internal rows (BLAS rows
first, this frame's TLAS rows after) are ids NL + row. A node row holds
its children's ids and instance codes as int32 and their boxes as
float32 (WalkTables); code k+1 is instance k, code 0 inherits the
parent's, and row 0 of inst_inv is the identity of the TLAS level.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sunray_tpu_torch.native import build_sah_bvh
from sunray_tpu_torch.ops import intersect
from sunray_tpu_torch.ops.bvh import (
    WalkTables,
    _range_boxes,
    encode_children,
    karras_topology,
    leaf_edges,
    morton_codes,
    trace_closest_walk,
    trace_occluded_walk,
)
from sunray_tpu_torch.ops.fp import dot3, fma, sum3
from sunray_tpu_torch.scene.types import _transform_points


@dataclasses.dataclass
class BlasSet:
    """Load-time half of the two-level structure (bvh2.py:74-86)."""

    node_ids: torch.Tensor       # (n_blas_int, 4) int32
    node_box: torch.Tensor       # (n_blas_int, 12) float32
    leaf_v: torch.Tensor         # (NL, K, 9) object-space corners
    leaf_ids: torch.Tensor       # (NL, K) int32 local triangle ids, -1 pad
    prim_root: torch.Tensor      # (P,) int32 root id per primitive
    prim_root_min: torch.Tensor  # (P, 3) object-space root box
    prim_root_max: torch.Tensor  # (P, 3)
    prim_tri_count: torch.Tensor  # (P,) int32 triangles per primitive
    leaf_k: int
    n_leaf_rows: int
    n_blas_int: int
    leaf_e: Optional[torch.Tensor] = None  # (NL, K, 12) ops/bvh.leaf_edges

    def __post_init__(self):
        if self.leaf_e is None:
            self.leaf_e = leaf_edges(self.leaf_v)


def instance_runs(tri_inst: np.ndarray, num_inst: int):
    """First contiguous run (offset, count) of each instance id in the
    world triangle list (bvh2.py:109-133): capacity padding appends
    degenerate tri_inst = 0 rows at the end, a second run of 0 that is
    not taken."""
    t = tri_inst.shape[0]
    off = np.zeros(num_inst, np.int64)
    cnt = np.zeros(num_inst, np.int64)
    seen = np.zeros(num_inst, bool)
    i = 0
    while i < t:
        v = int(tri_inst[i])
        j = i
        while j < t and tri_inst[j] == v:
            j += 1
        if 0 <= v < num_inst and not seen[v]:
            off[v], cnt[v], seen[v] = i, j - i, True
        i = j
    return off, cnt


def build_blas_set(scene, leaf_size: int = 4) -> BlasSet:
    """One object-space SAH BLAS per primitive (bvh2.py:136-284), on the
    host; the tables go to the scene's device. A primitive with no
    instance gets one empty leaf (never referenced)."""
    dev = scene.positions.device
    pos = scene.positions.detach().cpu().numpy().astype(np.float32)
    tv = scene.tri_vidx.cpu().numpy().astype(np.int64)
    ti = scene.tri_inst.cpu().numpy()
    ip = scene.inst_prim.cpu().numpy()
    num_prims = scene.materials.base_color.shape[0]
    num_inst = ip.shape[0]
    k = leaf_size
    off, cnt = instance_runs(ti, num_inst)
    first_inst = np.full(num_prims, -1, np.int64)
    for i in range(num_inst):
        p = int(ip[i])
        if 0 <= p < num_prims and first_inst[p] < 0:
            first_inst[p] = i

    built = []
    for p in range(num_prims):
        fi = first_inst[p]
        if fi < 0 or cnt[fi] == 0:
            built.append(None)
            continue
        s, c = int(off[fi]), int(cnt[fi])
        tri = pos[tv[s:s + c]]
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        built.append((build_sah_bvh(v0, v1, v2, leaf_size=k), v0, v1, v2, c))
    nl_total = sum(b[0].num_leaves if b is not None else 1 for b in built)

    node_ids, node_box, leaf_v, leaf_ids = [], [], [], []
    prim_root = np.zeros(num_prims, np.int32)
    prim_min = np.zeros((num_prims, 3), np.float32)
    prim_max = np.zeros((num_prims, 3), np.float32)
    prim_cnt = np.zeros(num_prims, np.int32)
    node_off = leaf_off = 0
    for p in range(num_prims):
        if built[p] is None:
            leaf_v.append(np.zeros((1, k, 9), np.float32))
            leaf_ids.append(np.full((1, k), -1, np.int32))
            prim_root[p] = leaf_off
            leaf_off += 1
            continue
        b, v0, v1, v2, c = built[p]
        prim_cnt[p] = c
        nl = b.num_leaves
        ids = b.leaf_tri.numpy()
        g = np.maximum(ids, 0)
        leaf_v.append(np.concatenate([v0[g], v1[g], v2[g]], axis=2))
        leaf_ids.append(ids)
        nmin, nmax = b.node_min.numpy(), b.node_max.numpy()
        if nl > 1:
            cl, cr = b.child_l.long(), b.child_r.long()
            enc = [encode_children(x, nl, leaf_off, nl_total + node_off).numpy()
                   for x in (cl, cr)]
            zeros = np.zeros(cl.shape[0], np.int32)
            node_ids.append(np.stack([enc[0], enc[1], zeros, zeros], axis=1))
            cl, cr = cl.numpy(), cr.numpy()
            node_box.append(np.concatenate([nmin[cl], nmax[cl], nmin[cr],
                                            nmax[cr]], axis=1))
            prim_root[p] = nl_total + node_off
            node_off += cl.shape[0]
        else:
            prim_root[p] = leaf_off
        prim_min[p], prim_max[p] = nmin[0], nmax[0]
        leaf_off += nl
    assert leaf_off == nl_total

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return BlasSet(
        node_ids=t(np.concatenate(node_ids) if node_ids
                   else np.zeros((0, 4)), np.int32),
        node_box=t(np.concatenate(node_box) if node_box
                   else np.zeros((0, 12)), np.float32),
        leaf_v=t(np.concatenate(leaf_v), np.float32),
        leaf_ids=t(np.concatenate(leaf_ids), np.int32),
        prim_root=t(prim_root, np.int32),
        prim_root_min=t(prim_min, np.float32),
        prim_root_max=t(prim_max, np.float32),
        prim_tri_count=t(prim_cnt, np.int32),
        leaf_k=k, n_leaf_rows=nl_total, n_blas_int=node_off)


def invert_affine_rows(xf):
    """(I, 3, 4) object->world -> (I, 12) world->object rows [A^-1 | -A^-1
    t] by the adjugate (bvh2.py:287-327), rounded as XLA's CPU compile
    rounds it: each cofactor fma(a, b, -(c * d)), the determinant
    fp.sum3 of the first row and the cofactors, the translation -dot3 of
    each inverse row with t."""
    xf = xf.detach()

    def e(i, j):
        return xf[:, i, j]

    def cof(a, b, c, d):
        return fma(a, b, -(c * d))

    c00 = cof(e(1, 1), e(2, 2), e(1, 2), e(2, 1))
    c10 = cof(e(1, 2), e(2, 0), e(1, 0), e(2, 2))
    c20 = cof(e(1, 0), e(2, 1), e(1, 1), e(2, 0))
    det = sum3((e(0, 0), e(0, 1), e(0, 2)), (c00, c10, c20))
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    inv = torch.stack([
        c00,
        cof(e(0, 2), e(2, 1), e(0, 1), e(2, 2)),
        cof(e(0, 1), e(1, 2), e(0, 2), e(1, 1)),
        c10,
        cof(e(0, 0), e(2, 2), e(0, 2), e(2, 0)),
        cof(e(0, 2), e(1, 0), e(0, 0), e(1, 2)),
        c20,
        cof(e(0, 1), e(2, 0), e(0, 0), e(2, 1)),
        cof(e(0, 0), e(1, 1), e(0, 1), e(1, 0)),
    ], dim=1) * inv_det[:, None]
    t = xf[:, :, 3]
    b = torch.stack([-dot3(inv[:, 3 * i], t[:, 0], inv[:, 3 * i + 1], t[:, 1],
                           inv[:, 3 * i + 2], t[:, 2]) for i in range(3)], dim=1)
    return torch.cat([inv, b], dim=1)


_CORNER_BITS = [[(c >> a) & 1 for a in range(3)] for c in range(8)]


def build_frame_tlas(blas: BlasSet, scene) -> WalkTables:
    """This frame's TLAS over the scene's instances joined to the BLAS
    rows (bvh2.py:330-452): the tables of B3."""
    inst_prim = scene.inst_prim.long()
    xf = scene.inst_transform.detach()
    dev = xf.device
    n_inst = inst_prim.shape[0]
    nl_total = blas.n_leaf_rows

    bmin = blas.prim_root_min[inst_prim]
    bmax = blas.prim_root_max[inst_prim]
    bits = torch.tensor(_CORNER_BITS, dtype=torch.bool, device=dev)
    corners = torch.where(bits[None], bmax[:, None, :], bmin[:, None, :])
    wc = _transform_points(xf, corners)                          # (I, 8, 3)
    wmin, wmax = wc.amin(dim=1), wc.amax(dim=1)

    counts = blas.prim_tri_count[inst_prim]
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    off = torch.cat([zero, torch.cumsum(counts, 0)[:-1].to(torch.int32)])
    inst_off = torch.cat([zero, off]).contiguous()
    ident = torch.cat([torch.eye(3, dtype=torch.float32, device=dev).reshape(1, 9),
                       torch.zeros((1, 3), dtype=torch.float32, device=dev)], 1)
    inst_inv = torch.cat([ident, invert_affine_rows(xf)]).contiguous()
    roots = blas.prim_root[inst_prim]

    if n_inst == 1:
        if blas.n_blas_int > 0:
            node_ids, node_box = blas.node_ids, blas.node_box
        else:
            node_ids = torch.zeros((1, 4), dtype=torch.int32, device=dev)
            node_box = torch.zeros((1, 12), dtype=torch.float32, device=dev)
        root = torch.cat([roots[:1], torch.ones_like(roots[:1])])
        return WalkTables(node_ids, node_box, blas.leaf_v, blas.leaf_ids,
                          root.contiguous(), inst_inv, inst_off, blas.leaf_e)

    codes = morton_codes(wmin, wmax, 0.5 * (wmin + wmax))
    order = torch.argsort(codes, stable=True)
    child_l, child_r, first, last = karras_topology(codes[order])
    node_min, node_max = _range_boxes(wmin[order], wmax[order], first, last)
    leaf_base = n_inst - 1
    base = nl_total + blas.n_blas_int

    def enc(c):
        c = c.long()
        is_leaf = c >= leaf_base
        inst = order[(c - leaf_base).clamp(0, n_inst - 1)]
        child = torch.where(is_leaf, roots[inst].long(), base + c)
        code = torch.where(is_leaf, inst + 1, 0)
        return child.to(torch.int32), code.to(torch.int32)

    el, il = enc(child_l)
    er, ir = enc(child_r)
    cl, cr = child_l.long(), child_r.long()
    tlas_ids = torch.stack([el, er, il, ir], dim=1)
    tlas_box = torch.cat([node_min[cl], node_max[cl], node_min[cr],
                          node_max[cr]], dim=1)
    root = torch.tensor([base, 0], dtype=torch.int32, device=dev)
    return WalkTables(torch.cat([blas.node_ids, tlas_ids]).contiguous(),
                      torch.cat([blas.node_box, tlas_box]).contiguous(),
                      blas.leaf_v, blas.leaf_ids, root, inst_inv, inst_off,
                      blas.leaf_e, tlas_rows=n_inst - 1)


def trace_closest_bvh2(tl: WalkTables, orig, d, tmin=intersect.T_MIN,
                       tmax=intersect.T_MAX) -> intersect.Hit:
    """Closest hit through this frame's TLAS (bvh2.py:567-589): B3 on the
    card, its plain twin on the CPU; tri is a world triangle id."""
    return trace_closest_walk(tl, orig, d, tmin, tmax)


def trace_occluded_bvh2(tl: WalkTables, orig, d, tmax, tmin=intersect.T_MIN,
                        exclude=None):
    """Any hit on [tmin, tmax] through this frame's TLAS (bvh2.py:592-623);
    exclude: (N,) int32 world triangle ids."""
    return trace_occluded_walk(tl, orig, d, tmax, tmin, exclude)
