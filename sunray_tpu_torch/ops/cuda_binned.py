"""K10 / K11 / K12: the binned tracer's kernels on the card, and their plain
PyTorch versions.

Counterparts of sunray_tpu/ops/binned_trace.py's Pallas kernels; the CUDA
kernels are in csrc/binned.cu. ops/binned_trace.py prepares their inputs
(cull, work lists, sorts) and reduces their outputs. Each wrapper takes
the plain version for CPU tensors and launches its kernel for CUDA
tensors; there is no other path.

  K10 binned_round  (_round_call, _closest_kernel / _anyhit_kernel):
      rays in blocks of BLOCK_RAYS lanes; block b walks its culled
      clusters order[b, :count[b]] near to far, skipping a cluster once
      every lane's best t is below the cluster's entry bound (any-hit:
      once every lane is occluded). In the kernel a warp tests a cluster
      only where a lane's ray can meet its padded box before the lane's
      running result (lane_box_test); binned_round_warp is that walk in
      plain PyTorch, with the count of tests it runs. The outputs are
      binned_round_plain's either way.
  K11 cluster_scan  (_cluster_scan, _cluster_scan_kernel): each ray lane
      against every supercluster AABB: the first L_SLOTS hit ids in
      ascending order and the exact hit count.
  K12 pair_round    (_pair_round_call, _closest_pair_kernel /
      _anyhit_pair_kernel): (ray, supercluster) pair lanes sorted by
      supercluster id; each live lane tests the SC_K clusters of its own
      supercluster and writes its result at its unsorted pair position.
      In the kernel the lanes of one run within a warp test a cluster only
      where one of their rays can meet its padded box before the lane's
      running result, K10's rule; pair_round_warp is that walk in plain
      PyTorch, with the count of tests it runs.

Layouts: rays are (3, NL) planes (o_t, d_t) and (NL,) planes (tn, tx, ex)
with NL a multiple of BLOCK_RAYS. K10 and K12 take the ClusterSet `cs`
(ops/binned_trace.py): the plain versions read its tri_pack, (C, 16, K)
int32, rows 0-8 the float32 bits of v0, v1, v2 and row 9 the triangle id
(-1 for padding), so ids are never float bit patterns in a float
operation; the kernels read its edges (edge_pack) and walk_box
(walk_boxes), both made once per build or refit.

Tile arithmetic (binned_trace.py:249-289, as XLA's CPU backend compiles it
in interpret mode, pinned against the JAX package): cross products
fma(a1, b2, -(a2 * b1)); det and u fma(x2, y2, fma(x0, y0, x1 * y1)); v
and t fma(x2, y2, fma(x1, y1, x0 * y0)), except that the pair kernel's t
fuses as det and u do (XLA fuses each kernel body on its own). Ties: the
first slot of least t within a cluster, and a later cluster replaces the
running best only when strictly nearer (`better = tile_t < t_out`).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import cuda_build
from sunray_tpu_torch.ops.fp import fma

BLOCK_RAYS = 512      # ray lanes per block (binned_trace.py:50)
WARP = 32
BOX_PAD = 1e-4        # K10/K12 lane box test: faces out by BOX_PAD (1 + |box| + |o|)
BOX_SLACK = 1e-4      # ... and K11's slack in t
L_SLOTS = 8           # recorded superclusters per ray (binned_trace.py:665)
SC_K = 4              # clusters per supercluster (binned_trace.py:666)
DET_EPS = 1e-9
PACK_ROWS = 16
ID_ROW = 9
EDGE_ROWS = 10        # edge_pack rows (csrc/binned.cu kEdgeRows)


def _plain_elems(device):
    """Elements of one (rays x triangles) intermediate of a plain version:
    ~32 MB of float64 on the CPU, ~256 MB on a card."""
    return 1 << (25 if device.type == "cuda" else 22)


def tile_hits(o, d, tn, tx, ex, rows, pair=False):
    """Moller-Trumbore of rays against triangle slots, broadcasting.

    o, d: 3-tuples of ray components, tn/tx/ex ray planes, each shaped to
    broadcast against the slot axis (e.g. (B, R, 1)); rows: (..., 16, K)
    int32 pack rows (broadcast as (B, 1, K)). pair=True: t rounds as XLA
    compiles the pair kernel's copy of the tile, fma(x2, y2, fma(x0, y0,
    x1 * y1)) like det and u. Returns (tt, u, v, valid, ids): tt is t where
    valid else inf."""
    f = rows[..., :9, :].view(torch.float32)
    comp = [f[..., a, :].unsqueeze(-2) for a in range(9)]
    ids = rows[..., ID_ROW, :].unsqueeze(-2)
    v0 = comp[0:3]
    e1 = [comp[3 + a] - v0[a] for a in range(3)]
    e2 = [comp[6 + a] - v0[a] for a in range(3)]
    dx, dy, dz = d
    px = fma(dy, e2[2], -(dz * e2[1]))
    py = fma(dz, e2[0], -(dx * e2[2]))
    pz = fma(dx, e2[1], -(dy * e2[0]))
    det = fma(e1[2], pz, fma(e1[0], px, e1[1] * py))
    det_ok = det.abs() > DET_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tv = [o[a] - v0[a] for a in range(3)]
    u = fma(tv[2], pz, fma(tv[0], px, tv[1] * py)) * inv_det
    qx = fma(tv[1], e1[2], -(tv[2] * e1[1]))
    qy = fma(tv[2], e1[0], -(tv[0] * e1[2]))
    qz = fma(tv[0], e1[1], -(tv[1] * e1[0]))
    v = fma(dz, qz, fma(dy, qy, dx * qx)) * inv_det
    if pair:
        t = fma(e2[2], qz, fma(e2[0], qx, e2[1] * qy)) * inv_det
    else:
        t = fma(e2[2], qz, fma(e2[1], qy, e2[0] * qx)) * inv_det
    valid = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= tn) & (t <= tx) & (ids >= 0) & (ids != ex))
    return torch.where(valid, t, torch.inf), u, v, valid, ids


def _first_min(tt, u, v, valid, ids):
    """Per ray (last axis reduced): least t, the first slot holding it,
    and that slot's tri (-1 if invalid), u, v."""
    k = torch.argmin(tt, dim=-1, keepdim=True)
    take = lambda x: x.expand_as(tt).gather(-1, k)[..., 0]  # noqa: E731
    tri = torch.where(take(valid), take(ids), -1)
    return take(tt), tri, take(u), take(v)


def _rays(o_t, d_t, tn, tx, ex, lanes):
    """Ray components gathered at `lanes` (any shape), each lanes.shape."""
    o = tuple(o_t[a][lanes] for a in range(3))
    d = tuple(d_t[a][lanes] for a in range(3))
    return o, d, tn[lanes], tx[lanes], ex[lanes]


def _closest_out(best_t, best_tri, best_u, best_v):
    hit = best_tri >= 0
    return (torch.where(hit, best_t, torch.inf), best_tri,
            torch.where(hit, best_u, 0.0), torch.where(hit, best_v, 0.0))


# -- K10 ----------------------------------------------------------------------

def binned_round_plain(order, ents, count, o_t, d_t, tn, tx, ex, cs,
                       closest=True):
    """K10's function. order/ents: (NB, C) per-block cluster ids and entry
    bounds, near to far, the first count[b] of row b live; cs: the
    ClusterSet, its tri_pack the triangles. Returns
    (t, tri, u, v) per lane (t = inf, tri = -1, u = v = 0 on a miss), or
    occ (bool): lanes with tmax = -inf start resolved (t = -inf, occluded;
    binned_trace.py:302-309, :346-347) and an any-hit lane reads occluded
    only in a block that has work."""
    pack = cs.tri_pack
    nb, k = count.shape[0], pack.shape[2]
    dev = o_t.device
    dead = tx == -torch.inf
    best_t = torch.where(dead, -torch.inf, torch.inf)
    best_tri = torch.full_like(ex, -1)
    best_u = torch.zeros_like(tn)
    best_v = torch.zeros_like(tn)
    occ = dead.clone()
    lanes_of = (torch.arange(nb, device=dev)[:, None] * BLOCK_RAYS
                + torch.arange(BLOCK_RAYS, device=dev)[None, :])
    step = max(1, _plain_elems(dev) // (BLOCK_RAYS * k))
    for j in range(int(count.max()) if nb else 0):
        blocks = torch.nonzero(count > j)[:, 0]
        for s in range(0, blocks.shape[0], step):
            b = blocks[s:s + step]
            lanes = lanes_of[b]                                # (B, RB)
            if closest:
                run = ~(best_t[lanes] < ents[b, j][:, None]).all(dim=1)
            else:
                run = ~occ[lanes].all(dim=1)
            b, lanes = b[run], lanes[run]
            o, d, rn, rx, re = _rays(o_t, d_t, tn, tx, ex, lanes[..., None])
            hits = tile_hits(o, d, rn, rx, re, pack[order[b, j].long()])
            if not closest:
                occ[lanes] |= hits[3].any(dim=-1)
                continue
            tile_t, tile_tri, tile_u, tile_v = _first_min(*hits)
            better = tile_t < best_t[lanes]
            best_t[lanes] = torch.where(better, tile_t, best_t[lanes])
            best_tri[lanes] = torch.where(better, tile_tri, best_tri[lanes])
            best_u[lanes] = torch.where(better, tile_u, best_u[lanes])
            best_v[lanes] = torch.where(better, tile_v, best_v[lanes])
    if closest:
        return _closest_out(best_t, best_tri, best_u, best_v)
    return occ & (count > 0).repeat_interleave(BLOCK_RAYS)


def edge_pack(pack):
    """The kernels' staging layout of a (C, 16, K) pack: (C, 10, K) int32,
    rows v0 (3), e1 = v1 - v0 (3), e2 = v2 - v0 (3) as float32 bits and the
    triangle id; each edge word one IEEE subtraction, as tile_hits makes
    it."""
    f = pack[:, :9].view(torch.float32)
    v0 = f[:, 0:3]
    rows = torch.cat([v0, f[:, 3:6] - v0, f[:, 6:9] - v0], dim=1)
    return torch.cat([rows.view(torch.int32), pack[:, ID_ROW:ID_ROW + 1]],
                     dim=1).contiguous()


def walk_boxes(aabb_lo, aabb_hi):
    """(C, 6) float32 [lo3, hi3]: each cluster's AABB with every face moved
    out by BOX_PAD (1 + |box|), |box| the largest coordinate magnitude of
    the box; lane_box_test adds BOX_PAD |o| for the ray. Moller-Trumbore
    accepts points a few ulps of those magnitudes outside a triangle, and
    on a flat box (an axis-aligned wall) a ray nearly parallel to it turns
    that into a long stretch of t: K11's slack in t alone drops such a hit
    at the box's edge (tests/test_torch_binned_cull.py)."""
    m = torch.maximum(aabb_lo.abs(), aabb_hi.abs()).amax(dim=1, keepdim=True)
    pad = BOX_PAD * (1.0 + m)
    return torch.cat([aabb_lo - pad, aabb_hi + pad], dim=1).contiguous()


def lane_box_test(o, d, tmin, upper, box):
    """K10's and K12's lane test (csrc/binned.cu enters): whether each ray
    (o, d: (..., 3)) can meet the box (..., 6), every face moved out by
    BOX_PAD |o| (max norm), at a t in [tmin, upper]: K11's slab test and
    slack (broadcasting)."""
    inv = _inv(d)
    po = BOX_PAD * o.abs().amax(dim=-1, keepdim=True)
    t1, t2 = (box[..., :3] - po - o) * inv, (box[..., 3:] + po - o) * inv
    tnc = torch.minimum(t1, t2).amax(dim=-1)
    tfc = torch.maximum(t1, t2).amin(dim=-1)
    return ((tnc <= tfc + BOX_SLACK) & (tfc >= tmin - BOX_SLACK)
            & (tnc <= upper + BOX_SLACK))


def binned_round_warp(order, ents, count, o_t, d_t, tn, tx, ex, cs,
                      closest=True):
    """K10's walk as csrc/binned.cu makes it: binned_round_plain's, in
    which a warp of WARP lanes runs a cluster's tests only if one of its
    lanes passes lane_box_test on cs.walk_box up to its running result
    (min(tmax, best t); any-hit: tmax while not occluded). Returns
    (binned_round_plain's outputs, the (lane, cluster) tests run: WARP per
    warp and cluster)."""
    pack, box = cs.tri_pack, cs.walk_box
    nb, k = count.shape[0], pack.shape[2]
    dev = o_t.device
    o, d = o_t.T, d_t.T
    dead = tx == -torch.inf
    best_t = torch.where(dead, -torch.inf, torch.inf)
    best_tri = torch.full_like(ex, -1)
    best_u = torch.zeros_like(tn)
    best_v = torch.zeros_like(tn)
    occ = dead.clone()
    lanes_of = (torch.arange(nb, device=dev)[:, None] * BLOCK_RAYS
                + torch.arange(BLOCK_RAYS, device=dev)[None, :])
    step = max(1, _plain_elems(dev) // (BLOCK_RAYS * k))
    tests = 0
    for j in range(int(count.max()) if nb else 0):
        blocks = torch.nonzero(count > j)[:, 0]
        for s in range(0, blocks.shape[0], step):
            b = blocks[s:s + step]
            lanes = lanes_of[b]                                # (B, RB)
            if closest:
                run = ~(best_t[lanes] < ents[b, j][:, None]).all(dim=1)
            else:
                run = ~occ[lanes].all(dim=1)
            b, lanes = b[run], lanes[run]
            upper = (torch.minimum(tx[lanes], best_t[lanes]) if closest
                     else torch.where(occ[lanes], -torch.inf, tx[lanes]))
            c = order[b, j].long()
            need = lane_box_test(o[lanes], d[lanes], tn[lanes], upper,
                                 box[c][:, None])
            warps = need.reshape(-1, BLOCK_RAYS // WARP, WARP).any(dim=-1)
            lanes = lanes.reshape(-1, BLOCK_RAYS // WARP, WARP)[warps]  # (W, 32)
            c = c[:, None].expand_as(warps)[warps]
            tests += lanes.numel()
            r_o, r_d, rn, rx, re = _rays(o_t, d_t, tn, tx, ex, lanes[..., None])
            hits = tile_hits(r_o, r_d, rn, rx, re, pack[c])
            if not closest:
                occ[lanes] |= hits[3].any(dim=-1)
                continue
            tile_t, tile_tri, tile_u, tile_v = _first_min(*hits)
            better = tile_t < best_t[lanes]
            best_t[lanes] = torch.where(better, tile_t, best_t[lanes])
            best_tri[lanes] = torch.where(better, tile_tri, best_tri[lanes])
            best_u[lanes] = torch.where(better, tile_u, best_u[lanes])
            best_v[lanes] = torch.where(better, tile_v, best_v[lanes])
    if closest:
        return _closest_out(best_t, best_tri, best_u, best_v), tests
    return occ & (count > 0).repeat_interleave(BLOCK_RAYS), tests


def _check_rays(name, o_t, d_t, tn, tx):
    """The float32 ray planes (3, NL) x 2 and (NL,) x 2; returns (device,
    NL)."""
    dev = cuda_build.require_cuda(name, o_t, d_t, tn, tx)
    nl = tn.shape[0]
    for x in (o_t, d_t, tn, tx):
        cuda_build.require_dtype(name, x, torch.float32)
    if (o_t.shape != (3, nl) or d_t.shape != (3, nl) or tx.shape != (nl,)
            or nl % BLOCK_RAYS):
        raise cuda_build.KernelError(f"{name}: ray planes must be (3, NL) and "
                                     f"(NL,) with NL a multiple of {BLOCK_RAYS}")
    return dev, nl


def _check_trace_inputs(name, o_t, d_t, tn, tx, ex, cs):
    """The ray planes, the int32 exclude plane and the ClusterSet's
    (C, 10, K) int32 edge pack and (C, 6) float32 walk boxes; returns
    (device, NL, C, K)."""
    dev, nl = _check_rays(name, o_t, d_t, tn, tx)
    edges, box = cs.edges, cs.walk_box
    cuda_build.require_cuda(name, o_t, ex, edges, box)
    cuda_build.require_dtype(name, ex, torch.int32)
    cuda_build.require_dtype(name, edges, torch.int32)
    cuda_build.require_dtype(name, box, torch.float32)
    if ex.shape != (nl,):
        raise cuda_build.KernelError(f"{name}: exclude must be ({nl},)")
    c = edges.shape[0]
    if (edges.dim() != 3 or edges.shape[1] != EDGE_ROWS or box.shape != (c, 6)
            or not edges.is_contiguous() or not box.is_contiguous()):
        raise cuda_build.KernelError(
            f"{name}: edges must be (C, {EDGE_ROWS}, K) and boxes (C, 6), "
            f"contiguous, got {tuple(edges.shape)} and {tuple(box.shape)}")
    return dev, nl, c, edges.shape[2]


def binned_round(order, ents, count, o_t, d_t, tn, tx, ex, cs, closest=True):
    """K10 (see binned_round_plain)."""
    if cuda_build.on_cpu(order, ents, count, o_t, d_t, tn, tx, ex, cs.tri_pack):
        return binned_round_plain(order, ents, count, o_t, d_t, tn, tx, ex,
                                  cs, closest)
    dev, nl, c, k = _check_trace_inputs("binned_round", o_t, d_t, tn, tx, ex,
                                        cs)
    nb = nl // BLOCK_RAYS
    cuda_build.require_cuda("binned_round", o_t, order, ents, count)
    for x, dt in ((order, torch.int32), (ents, torch.float32),
                  (count, torch.int32)):
        cuda_build.require_dtype("binned_round", x, dt)
    if order.shape != (nb, c) or ents.shape != (nb, c) or count.shape != (nb,):
        raise cuda_build.KernelError("binned_round: work lists must be "
                                     f"({nb}, {c}) and ({nb},)")
    lib = cuda_build.library()
    stream = cuda_build.stream_ptr()
    args = (order.data_ptr(), ents.data_ptr(), count.data_ptr(), nb, c,
            o_t.data_ptr(), d_t.data_ptr(), tn.data_ptr(), tx.data_ptr(),
            ex.data_ptr(), cs.edges.data_ptr(), cs.walk_box.data_ptr(), k)
    if closest:
        t = torch.empty((nl,), dtype=torch.float32, device=dev)
        tri = torch.empty((nl,), dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        err = lib.sunray_binned_closest(*args, t.data_ptr(), tri.data_ptr(),
                                        u.data_ptr(), v.data_ptr(), stream)
        out = (t, tri, u, v)
    else:
        occ = torch.empty((nl,), dtype=torch.bool, device=dev)
        err = lib.sunray_binned_occluded(*args, occ.data_ptr(), stream)
        out = occ
    cuda_build.check_launch("binned_round", err)
    cuda_build.launches["binned_round"] += 1
    return out


# -- K11 ----------------------------------------------------------------------

def _inv(v):
    """1 / v with |v| < 1e-12 replaced by +-1e-12 (binned_trace.py:686-688)."""
    tiny = torch.where(v >= 0.0, 1e-12, -1e-12)
    return 1.0 / torch.where(v.abs() < 1e-12, tiny, v)


def cluster_scan_plain(o_t, d_t, tn, tx, sc_box):
    """K11's function. sc_box: (S, 6) supercluster AABBs [lo3, hi3].
    Returns (slots (L_SLOTS, NL) int32, the first hit supercluster ids in
    ascending order, -1 past the count; count (NL,) int32)."""
    nl, s = tn.shape[0], sc_box.shape[0]
    inv = [_inv(d_t[a]) for a in range(3)]
    cid = torch.arange(s, dtype=torch.int32, device=tn.device)
    slots, cnt = [], []
    step = max(1, _plain_elems(tn.device) // max(s, 1))
    for a0 in range(0, nl, step):
        sl = slice(a0, min(a0 + step, nl))
        tnear, tfar = None, None
        for a in range(3):
            o = o_t[a, sl, None]
            t1 = (sc_box[None, :, a] - o) * inv[a][sl, None]
            t2 = (sc_box[None, :, 3 + a] - o) * inv[a][sl, None]
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tnear = lo if tnear is None else torch.maximum(tnear, lo)
            tfar = hi if tfar is None else torch.minimum(tfar, hi)
        hit = ((tnear <= tfar + 1e-4) & (tfar >= tn[sl, None] - 1e-4)
               & (tnear <= tx[sl, None] + 1e-4))
        rank = torch.cumsum(hit.to(torch.int32), dim=1)
        slots.append(torch.stack([
            torch.where(hit & (rank == l + 1), cid, -1).amax(dim=1)
            if s else torch.full_like(tn[sl], -1, dtype=torch.int32)
            for l in range(L_SLOTS)]))
        cnt.append(rank[:, -1] if s else torch.zeros_like(slots[-1][0]))
    return (torch.cat(slots, dim=1).to(torch.int32),
            torch.cat(cnt).to(torch.int32))


def cluster_scan(o_t, d_t, tn, tx, sc_box):
    """K11 (see cluster_scan_plain)."""
    if cuda_build.on_cpu(o_t, d_t, tn, tx, sc_box):
        return cluster_scan_plain(o_t, d_t, tn, tx, sc_box)
    dev, nl = _check_rays("cluster_scan", o_t, d_t, tn, tx)
    cuda_build.require_cuda("cluster_scan", o_t, sc_box)
    cuda_build.require_dtype("cluster_scan", sc_box, torch.float32)
    if sc_box.dim() != 2 or sc_box.shape[1] != 6:
        raise cuda_build.KernelError("cluster_scan: boxes must be (S, 6)")
    slots = torch.empty((L_SLOTS, nl), dtype=torch.int32, device=dev)
    cnt = torch.empty((nl,), dtype=torch.int32, device=dev)
    err = cuda_build.library().sunray_cluster_scan(
        o_t.data_ptr(), d_t.data_ptr(), tn.data_ptr(), tx.data_ptr(), nl,
        sc_box.data_ptr(), sc_box.shape[0], slots.data_ptr(), cnt.data_ptr(),
        cuda_build.stream_ptr())
    cuda_build.check_launch("cluster_scan", err)
    cuda_build.launches["cluster_scan"] += 1
    return slots, cnt


# -- K12 ----------------------------------------------------------------------

def pair_round_plain(cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc,
                     closest=True):
    """K12's function. cid_s: (NP,) supercluster id per pair lane sorted
    ascending (n_sc = no pair); pos_s: (NP,) its pair position l * NL +
    ray; runs: (NP / BLOCK_RAYS,) live runs per block (the kernel's loop
    count; unused here); cs: the ClusterSet, its tri_pack the triangles.
    Every pair lane uses the first ray's tmin (binned_trace.py:954).
    Returns, indexed by pair position, (t, tri, u, v) with the misses'
    convention, or occ (bool)."""
    del runs
    pack = cs.tri_pack
    n_p, nl = cid_s.shape[0], tn.shape[0]
    c, k = pack.shape[0], pack.shape[2]
    dev = tn.device
    live = torch.nonzero(cid_s < n_sc)[:, 0]
    sub = torch.arange(SC_K, device=dev)
    if closest:
        t = torch.full((n_p,), torch.inf, device=dev)
        tri = torch.full((n_p,), -1, dtype=torch.int32, device=dev)
        u = torch.zeros((n_p,), device=dev)
        v = torch.zeros((n_p,), device=dev)
    else:
        occ = torch.zeros((n_p,), dtype=torch.bool, device=dev)
    step = max(1, _plain_elems(dev) // (SC_K * k))
    for s in range(0, live.shape[0], step):
        lane = live[s:s + step]
        pos = pos_s[lane].long()
        ray = pos % nl
        o, d, _, rx, re = _rays(o_t, d_t, tn, tx, ex, ray[:, None, None])
        cl = cid_s[lane].long()[:, None] * SC_K + sub[None, :]  # (m, SC_K)
        rows = pack[cl.clamp(max=c - 1)]                    # (m, SC_K, 16, K)
        rows = torch.where((cl < c)[:, :, None, None], rows, 0)
        rows = rows.permute(0, 2, 1, 3).reshape(-1, PACK_ROWS, SC_K * k)
        hits = tile_hits(o, d, tn[0], rx, re, rows, pair=True)
        if closest:
            bt, btri, bu, bv = _closest_out(*_first_min(*(x[:, 0] for x in hits)))
            t[pos], tri[pos], u[pos], v[pos] = bt, btri.to(torch.int32), bu, bv
        else:
            occ[pos] = hits[3][:, 0].any(dim=-1)
    return (t, tri, u, v) if closest else occ


def pair_round_warp(cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc,
                    closest=True):
    """K12's walk as csrc/binned.cu makes it: each live lane visits the
    SC_K clusters of its supercluster in order, and the lanes of one run
    within one warp (sorted lanes i // WARP, equal cid) run a cluster's
    tests only if one of them passes lane_box_test on cs.walk_box up to its
    running result (min(tmax, best t); any-hit: tmax while not occluded).
    Returns (pair_round_plain's outputs, the (lane, cluster) tests run:
    the run's lanes of each warp that tests a cluster)."""
    del runs
    pack, box = cs.tri_pack, cs.walk_box
    n_p, nl = cid_s.shape[0], tn.shape[0]
    c, k = pack.shape[0], pack.shape[2]
    dev = tn.device
    live = torch.nonzero(cid_s < n_sc)[:, 0]
    pos = pos_s[live].long()
    cid = cid_s[live].long()
    ray = pos % nl
    o, d = o_t.T[ray], d_t.T[ray]
    rx, re, tmin = tx[ray], ex[ray], tn[0]
    # Lanes are sorted by cid, so each (warp, cid) group is one run of lanes.
    _, group = torch.unique_consecutive((live // WARP) * (n_sc + 1) + cid,
                                        return_inverse=True)
    m = live.shape[0]
    best_t = torch.full((m,), torch.inf, device=dev)
    best_tri = torch.full((m,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((m,), device=dev)
    best_v = torch.zeros((m,), device=dev)
    occ = torch.zeros((m,), dtype=torch.bool, device=dev)
    step = max(1, _plain_elems(dev) // k)
    tests = 0
    for q in range(SC_K):
        cl = cid * SC_K + q
        upper = (torch.minimum(rx, best_t) if closest
                 else torch.where(occ, -torch.inf, rx))
        need = (cl < c) & lane_box_test(o, d, tmin, upper,
                                        box[cl.clamp(max=c - 1)])
        votes = torch.zeros(int(group.max()) + 1 if m else 0, dtype=torch.int32,
                            device=dev).index_add_(0, group, need.int())
        run = torch.nonzero(votes[group] > 0)[:, 0]
        tests += run.numel()
        for s in range(0, run.shape[0], step):
            lane = run[s:s + step]
            r_o = tuple(o[lane, a, None, None] for a in range(3))
            r_d = tuple(d[lane, a, None, None] for a in range(3))
            hits = tile_hits(r_o, r_d, tmin, rx[lane, None, None],
                             re[lane, None, None], pack[cl[lane]], pair=True)
            if not closest:
                occ[lane] |= hits[3][:, 0].any(dim=-1)
                continue
            tile_t, tile_tri, tile_u, tile_v = _first_min(*(x[:, 0] for x in hits))
            better = tile_t < best_t[lane]
            best_t[lane] = torch.where(better, tile_t, best_t[lane])
            best_tri[lane] = torch.where(better, tile_tri, best_tri[lane])
            best_u[lane] = torch.where(better, tile_u, best_u[lane])
            best_v[lane] = torch.where(better, tile_v, best_v[lane])
    if not closest:
        out = torch.zeros((n_p,), dtype=torch.bool, device=dev)
        out[pos] = occ
        return out, tests
    t = torch.full((n_p,), torch.inf, device=dev)
    tri = torch.full((n_p,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n_p,), device=dev)
    v = torch.zeros((n_p,), device=dev)
    t[pos], tri[pos], u[pos], v[pos] = _closest_out(best_t, best_tri, best_u,
                                                     best_v)
    return (t, tri, u, v), tests


def pair_round(cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc,
               closest=True):
    """K12 (see pair_round_plain)."""
    if cuda_build.on_cpu(cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs.tri_pack):
        return pair_round_plain(cid_s, pos_s, runs, o_t, d_t, tn, tx, ex,
                                cs, n_sc, closest)
    dev, nl, c, k = _check_trace_inputs("pair_round", o_t, d_t, tn, tx, ex,
                                        cs)
    cuda_build.require_cuda("pair_round", o_t, cid_s, pos_s, runs)
    for x in (cid_s, pos_s, runs):
        cuda_build.require_dtype("pair_round", x, torch.int32)
    n_p = cid_s.shape[0]
    if (pos_s.shape != (n_p,) or n_p % BLOCK_RAYS
            or runs.shape != (n_p // BLOCK_RAYS,)):
        raise cuda_build.KernelError("pair_round: pair planes must be (NP,) "
                                     f"with NP a multiple of {BLOCK_RAYS}")
    lib = cuda_build.library()
    stream = cuda_build.stream_ptr()
    # The kernel writes live pair positions only: the rest read as misses.
    if closest:
        t = torch.full((n_p,), torch.inf, device=dev)
        tri = torch.full((n_p,), -1, dtype=torch.int32, device=dev)
        u = torch.zeros((n_p,), device=dev)
        v = torch.zeros((n_p,), device=dev)
        err = lib.sunray_pair_closest(
            cid_s.data_ptr(), pos_s.data_ptr(), runs.data_ptr(), n_p, n_sc,
            o_t.data_ptr(), d_t.data_ptr(), tn.data_ptr(), tx.data_ptr(),
            ex.data_ptr(), nl, cs.edges.data_ptr(), cs.walk_box.data_ptr(), c, k,
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
        out = (t, tri, u, v)
    else:
        occ = torch.zeros((n_p,), dtype=torch.bool, device=dev)
        err = lib.sunray_pair_occluded(
            cid_s.data_ptr(), pos_s.data_ptr(), runs.data_ptr(), n_p, n_sc,
            o_t.data_ptr(), d_t.data_ptr(), tn.data_ptr(), tx.data_ptr(),
            ex.data_ptr(), nl, cs.edges.data_ptr(), cs.walk_box.data_ptr(), c, k,
            occ.data_ptr(), stream)
        out = occ
    cuda_build.check_launch("pair_round", err)
    cuda_build.launches["pair_round"] += 1
    return out
