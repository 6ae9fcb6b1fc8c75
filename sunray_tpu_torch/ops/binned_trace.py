"""Binned (cluster-culled) ray tracing — port of sunray_tpu/ops/binned_trace.py.

Triangles are packed into Morton-ordered clusters of K at load time
(build_cluster_set) and refit from the frame's world triangles
(refit_cluster_set). Two ways through them:

- the block path (trace_closest_binned / trace_occluded_binned): rays,
  coherence-sorted when asked, are cut into blocks of BLOCK_RAYS lanes; a
  conservative interval slab test culls (block, cluster) pairs and orders
  each block's clusters near to far (_interval_cull, _work_list); K10
  walks them with early exit;
- the pair stream (trace_closest_pairs / trace_occluded_pairs), for
  incoherent batches: K11 slab-tests every ray against every supercluster
  of SC_K clusters, each ray's first L_SLOTS hits become (ray,
  supercluster) pair lanes sorted by supercluster, K12 tests each live
  lane against its supercluster's triangles, and the slots reduce per
  ray. Rays that hit more than L_SLOTS superclusters ride the block path
  (the overflow fallback).

The cull, the sorts and the reductions are plain PyTorch on the tensors'
device; the kernels are in ops/cuda_binned.py. Nothing here waits for the
device: every shape follows from the ray count and the cluster count.
uint32 keys (the entry-order key, _spread9, the coherence key) are held in
int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sunray_tpu_torch.ops import cuda_binned
from sunray_tpu_torch.ops.cuda_binned import BLOCK_RAYS, L_SLOTS, SC_K
from sunray_tpu_torch.ops.intersect import T_MAX, T_MIN, Hit

CLUSTER_K = 128        # triangles per cluster (binned_trace.py:49)
_U32 = 0xFFFFFFFF


class ClusterSet(NamedTuple):
    """Triangle clustering on the device of the triangles it was built from.

    tri_ids: (C*K,) int32 global triangle id per pack slot (-1 padding);
        the cluster assignment is load-time topology.
    tri_pack: (C, 16, K) int32: rows 0-8 the float32 bits of v0, v1, v2,
        row 9 the triangle id, rows 10-15 zero.
    aabb_lo/aabb_hi: (C, 3) float32 cluster bounds.
    edges: (C, 10, K) int32, the pack as K10 and K12 stage it
        (cuda_binned.edge_pack).
    walk_box: (C, 6) float32, the padded boxes of K10's and K12's
        per-warp culls (cuda_binned.walk_boxes).
    Make one with cluster_set(), which derives the last two."""

    tri_ids: torch.Tensor
    tri_pack: torch.Tensor
    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor
    edges: torch.Tensor
    walk_box: torch.Tensor

    @property
    def num_clusters(self) -> int:
        return self.tri_pack.shape[0]


def cluster_set(tri_ids, tri_pack, aabb_lo, aabb_hi) -> ClusterSet:
    """A ClusterSet with the kernels' edge pack and walk boxes derived from
    its pack and bounds."""
    return ClusterSet(tri_ids, tri_pack, aabb_lo, aabb_hi,
                      cuda_binned.edge_pack(tri_pack),
                      cuda_binned.walk_boxes(aabb_lo, aabb_hi))


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (N, 3) points in [0, 1)."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))


def build_cluster_set(tris, k: int = CLUSTER_K) -> ClusterSet:
    """Host-side clustering: Morton-sort triangle centroids (stable), chunk
    into clusters of k. tris: (v0, v1, v2) tensors (T, 3); the set lives on
    their device."""
    dev = tris[0].device
    v0, v1, v2 = (v.detach().cpu().numpy().astype(np.float32) for v in tris)
    t = v0.shape[0]
    cent = (v0 + v1 + v2) / 3.0
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-9)
    order = np.argsort(_morton3((cent - lo) / span), kind="stable")
    c = max(1, -(-t // k))
    ids = np.concatenate([order, np.full(c * k - t, -1, np.int64)])
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    return cluster_set(ids, *_pack_clusters(*tris, ids, c, k))


def _pack_clusters(v0, v1, v2, ids, c, k):
    """(C, 16, K) int32 pack + (C, 3) AABBs from world triangles and slot
    ids. Padding slots take the last valid slot's triangle, which keeps
    the padded cluster's AABB tight (binned_trace.py:126-134)."""
    slot = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    last_valid = torch.where(ids >= 0, slot, -1).amax()
    gid = ids.clamp(min=0).long()
    gid = torch.where(ids >= 0, gid, gid[last_valid.clamp(min=0).long()])
    rows = torch.cat([v0, v1, v2], dim=1).float()[gid]       # (C*K, 9)
    comp = rows.T.reshape(9, c, k)
    pack = torch.zeros((c, cuda_binned.PACK_ROWS, k), dtype=torch.int32,
                       device=ids.device)
    pack[:, :9] = comp.contiguous().view(torch.int32).permute(1, 0, 2)
    pack[:, cuda_binned.ID_ROW] = ids.reshape(c, k)
    lo = torch.stack([torch.minimum(torch.minimum(comp[a], comp[3 + a]),
                                    comp[6 + a]).amin(dim=1) for a in range(3)],
                     dim=-1)
    hi = torch.stack([torch.maximum(torch.maximum(comp[a], comp[3 + a]),
                                    comp[6 + a]).amax(dim=1) for a in range(3)],
                     dim=-1)
    return pack, lo, hi


def refit_cluster_set(cs: ClusterSet, tris) -> ClusterSet:
    """Pack and AABBs from the current world triangles, keeping the
    load-time cluster assignment."""
    c, _, k = cs.tri_pack.shape
    return cluster_set(cs.tri_ids, *_pack_clusters(*tris, cs.tri_ids, c, k))


# -- the block path ------------------------------------------------------------

def _interval_cull(o_t, d_t, tn, tx, aabb_lo, aabb_hi, nb, rb=BLOCK_RAYS):
    """((NB, C) bool, (NB, C) f32 entry lower bound): False only where no
    ray of the block can hit the cluster AABB within [tmin, tmax]
    (binned_trace.py:174-233, its soundness argument there)."""
    c = aabb_lo.shape[0]
    dev = o_t.device
    entry = torch.full((nb, c), -torch.inf, device=dev)
    exit_ = torch.full((nb, c), torch.inf, device=dev)
    reach = torch.ones((nb, c), dtype=torch.bool, device=dev)
    o_b = o_t[:, :nb * rb].reshape(3, nb, rb)
    d_b = d_t[:, :nb * rb].reshape(3, nb, rb)
    tx_b = tx[:nb * rb].reshape(nb, rb).amax(dim=1)[:, None]
    tx_c = tx_b.clamp(max=3e37)        # finite: tmax = inf would make 0 * inf
    for a in range(3):
        olo = o_b[a].amin(dim=1)[:, None]
        ohi = o_b[a].amax(dim=1)[:, None]
        dlo = d_b[a].amin(dim=1)[:, None]
        dhi = d_b[a].amax(dim=1)[:, None]
        spans0 = (dlo <= 0.0) & (dhi >= 0.0)
        inv_lo = 1.0 / torch.where(spans0, 1.0, dlo)
        inv_hi = 1.0 / torch.where(spans0, 1.0, dhi)
        ilo = torch.minimum(inv_lo, inv_hi)
        ihi = torch.maximum(inv_lo, inv_hi)
        nlo = aabb_lo[None, :, a] - ohi
        nhi = aabb_hi[None, :, a] - olo
        p = (nlo * ilo, nlo * ihi, nhi * ilo, nhi * ihi)
        qlo = torch.minimum(torch.minimum(p[0], p[1]), torch.minimum(p[2], p[3]))
        qhi = torch.maximum(torch.maximum(p[0], p[1]), torch.maximum(p[2], p[3]))
        entry = torch.maximum(entry, torch.where(spans0, -torch.inf, qlo))
        exit_ = torch.minimum(exit_, torch.where(spans0, torch.inf, qhi))
        clo = olo + tx_c * dlo.clamp(max=0.0)
        chi = ohi + tx_c * dhi.clamp(min=0.0)
        reach = (reach & (chi >= aabb_lo[None, :, a])
                 & (clo <= aabb_hi[None, :, a]))
    tn_b = tn[:nb * rb].reshape(nb, rb).amin(dim=1)[:, None]
    hit = (entry <= exit_) & (exit_ >= tn_b) & (entry <= tx_b) & reach
    return hit, entry


def _order_key(x):
    """float32 -> order-preserving uint32 key (binned_trace.py:438-442),
    in int64."""
    b = x.contiguous().view(torch.int32).long() & _U32
    return torch.where(b >= 0x80000000, b ^ _U32, b | 0x80000000)


def _work_list(hit, entry):
    """Per block, its culled clusters near to far: (order (NB, C) int32,
    ents (NB, C) f32, count (NB,) int32); the first count[b] entries of
    row b are live. The sort key (miss, entry key) and its stable tie to
    the cluster index give the JAX package's order (miss, block, entry)
    restricted to each block."""
    key = ((~hit).long() << 32) | _order_key(entry)
    _, order = torch.sort(key, dim=1, stable=True)
    return (order.to(torch.int32), entry.gather(1, order),
            hit.sum(dim=1, dtype=torch.int32))


def _prep(orig, d, tmin, tmax, exclude):
    """(3, NL) / (NL,) ray planes padded to whole blocks: padding has d = 1,
    tmin = 0, tmax = -inf (never hits, counts as resolved) and exclude
    -2. Returns (o_t, d_t, tn, tx, ex, n, nb)."""
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = orig.shape[0]
    nb = -(-n // BLOCK_RAYS)
    pad = nb * BLOCK_RAYS - n
    dev = orig.device
    f = torch.nn.functional.pad

    def plane(x, dtype, fill):
        x = torch.as_tensor(x, dtype=dtype, device=dev).reshape(-1)
        return f(x.expand(n), (0, pad), value=fill)

    o_t = f(orig.T, (0, pad)).contiguous()
    d_t = f(d.T, (0, pad), value=1.0).contiguous()
    tn = plane(tmin, torch.float32, 0.0)
    tx = plane(tmax, torch.float32, -torch.inf)
    ex = plane(-2 if exclude is None else exclude, torch.int32, -2)
    return o_t, d_t, tn, tx, ex, n, nb


def _spread9(v):
    """Interleave a 9-bit lane to every 3rd bit (Morton spread)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _coherence_keys(orig, d, lo, hi):
    """Per-ray sort key (uint32 in int64): direction octant in the 3 high
    bits, then a 9-bit-per-axis origin Morton code
    (binned_trace.py:493-516)."""
    span = (hi - lo).clamp(min=1e-9)
    q = ((orig - lo) / span * 512.0).clamp(0.0, 511.0).to(torch.int64)
    morton = (_spread9(q[:, 0]) << 2) | (_spread9(q[:, 1]) << 1) | _spread9(q[:, 2])
    octant = ((d[:, 0] >= 0.0).long() * 4 + (d[:, 1] >= 0.0).long() * 2
              + (d[:, 2] >= 0.0).long())
    return (octant << 27) | morton


def _reorder_rays(cs, orig, d, tmax, exclude):
    """Coherence-sort rays (stable). Rays with tmax = -inf sort last.
    Returns (orig, d, tmax, exclude, perm): sorted position i holds ray
    perm[i]."""
    n = orig.shape[0]
    lo = cs.aabb_lo.amin(dim=0)
    hi = cs.aabb_hi.amax(dim=0)
    key = _coherence_keys(orig, d, lo, hi)
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=orig.device).reshape(-1).expand(n)
    key = torch.where(tmax == -torch.inf, _U32, key)
    ex = (torch.full((n,), -2, dtype=torch.int32, device=orig.device)
          if exclude is None else exclude.reshape(-1))
    _, perm = torch.sort(key, stable=True)
    return orig[perm], d[perm], tmax[perm], ex[perm], perm


def _unsort(perm, x):
    out = torch.empty_like(x)
    out[perm] = x
    return out


def trace_closest_binned(cs: ClusterSet, orig, d, tmin=T_MIN, tmax=T_MAX,
                         exclude=None, reorder=False) -> Hit:
    """Closest hit over a ClusterSet. orig/d: (N, 3). reorder=True:
    coherence-sort the rays first and un-sort the results."""
    if reorder:
        orig, d, tmax, exclude, perm = _reorder_rays(
            cs, orig.reshape(-1, 3), d.reshape(-1, 3), tmax, exclude)
        hit = trace_closest_binned(cs, orig, d, tmin, tmax, exclude)
        return Hit(*(_unsort(perm, x) for x in hit))
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, exclude)
    hit, entry = _interval_cull(o_t, d_t, tn, tx, cs.aabb_lo, cs.aabb_hi, nb)
    order, ents, count = _work_list(hit, entry)
    t, tri, u, v = cuda_binned.binned_round(order, ents, count, o_t, d_t, tn,
                                            tx, ex, cs)
    found = tri[:n] >= 0
    return Hit(t=t[:n], tri=tri[:n].clamp(min=0), u=u[:n], v=v[:n], hit=found)


def trace_occluded_binned(cs: ClusterSet, orig, d, tmax, tmin=T_MIN,
                          exclude=None, reorder=False):
    """Any-hit occlusion: True where something blocks [tmin, tmax]."""
    if reorder:
        orig, d, tmax, exclude, perm = _reorder_rays(
            cs, orig.reshape(-1, 3), d.reshape(-1, 3), tmax, exclude)
        return _unsort(perm, trace_occluded_binned(cs, orig, d, tmax, tmin,
                                                   exclude))
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, exclude)
    hit, entry = _interval_cull(o_t, d_t, tn, tx, cs.aabb_lo, cs.aabb_hi, nb)
    order, ents, count = _work_list(hit, entry)
    occ = cuda_binned.binned_round(order, ents, count, o_t, d_t, tn, tx, ex,
                                   cs, closest=False)
    return occ[:n]


# -- the pair stream ----------------------------------------------------------

def supercluster_boxes(cs: ClusterSet):
    """(S, 6) [lo3, hi3] unions of SC_K consecutive cluster AABBs."""
    s = -(-cs.num_clusters // SC_K)
    pad = s * SC_K - cs.num_clusters
    f = torch.nn.functional.pad
    lo = f(cs.aabb_lo, (0, 0, 0, pad), value=torch.inf)
    hi = f(cs.aabb_hi, (0, 0, 0, pad), value=-torch.inf)
    return torch.cat([lo.reshape(s, SC_K, 3).amin(dim=1),
                      hi.reshape(s, SC_K, 3).amax(dim=1)], dim=1).contiguous()


def _cluster_scan(cs: ClusterSet, o_t, d_t, tn, tx):
    """(slots (L_SLOTS, NL) int32 supercluster ids or -1, count (NL,)
    int32 exact supercluster hits per ray) through K11."""
    return cuda_binned.cluster_scan(o_t, d_t, tn, tx, supercluster_boxes(cs))


def _pair_work(cid_s, n_sc):
    """Work items of the cid-sorted pair lanes: one per (BLOCK_RAYS-lane
    block, run of one live supercluster) (binned_trace.py:915-928).
    Returns the items per block (NBP,) int32, K12's loop count."""
    prev = torch.cat([cid_s.new_full((1,), -9), cid_s[:-1]])
    pos = torch.arange(cid_s.shape[0], device=cid_s.device)
    first = ((pos % BLOCK_RAYS) == 0) | (cid_s != prev)
    item = first & (cid_s < n_sc)
    return item.reshape(-1, BLOCK_RAYS).sum(dim=1, dtype=torch.int32)


def _pair_stream_prep(cs, o_t, d_t, tn, tx):
    """Scan + pair expansion + stable sort by supercluster. Returns
    (cid_s, pos_s, runs, n_sc, overflow): pos_s is each sorted lane's pair
    position l * NL + ray; rays with more than L_SLOTS hits contribute no
    pairs (overflow, traced by the fallback)."""
    n_sc = -(-cs.num_clusters // SC_K)
    slots, cnt = _cluster_scan(cs, o_t, d_t, tn, tx)
    overflow = cnt > L_SLOTS
    cid = torch.where((slots >= 0) & ~overflow[None, :], slots, n_sc)
    cid_s, pos_s = torch.sort(cid.reshape(-1), stable=True)
    return cid_s, pos_s.to(torch.int32), _pair_work(cid_s, n_sc), n_sc, overflow


def trace_closest_pairs(cs: ClusterSet, orig, d, tmin=T_MIN,
                        tmax=T_MAX) -> Hit:
    """Closest hit via the pair stream (the incoherent-ray path); the same
    hits as trace_closest_binned."""
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, None)
    cid_s, pos_s, runs, n_sc, overflow = _pair_stream_prep(cs, o_t, d_t, tn, tx)
    nl = nb * BLOCK_RAYS
    t_p, tri_p, u_p, v_p = cuda_binned.pair_round(
        cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc)
    # Reduce over the slots: the first slot of least t (binned_trace.py:985-998).
    t_l, tri_l = t_p.reshape(L_SLOTS, nl), tri_p.reshape(L_SLOTS, nl)
    hit_l = tri_l >= 0
    k = torch.argmin(torch.where(hit_l, t_l, torch.inf), dim=0, keepdim=True)
    pick = lambda x: x.reshape(L_SLOTS, nl).gather(0, k)[0]  # noqa: E731
    best_tri = torch.where(hit_l.gather(0, k)[0], pick(tri_p), -1)
    best_t, best_u, best_v = pick(t_p), pick(u_p), pick(v_p)

    # Overflow rays through the block path, the others masked out.
    fb = trace_closest_binned(cs, o_t.T, d_t.T, tmin,
                              torch.where(overflow, tx, -torch.inf),
                              exclude=ex, reorder=True)
    tri = torch.where(overflow, torch.where(fb.hit, fb.tri, -1), best_tri)[:n]
    found = tri >= 0
    sel = lambda f, b: torch.where(overflow, f, b)[:n]  # noqa: E731
    return Hit(
        t=torch.where(found, sel(fb.t, best_t), torch.inf),
        tri=tri.clamp(min=0),
        u=torch.where(found, sel(fb.u, best_u), 0.0),
        v=torch.where(found, sel(fb.v, best_v), 0.0),
        hit=found,
    )


def trace_occluded_pairs(cs: ClusterSet, orig, d, tmax, tmin=T_MIN,
                         exclude=None):
    """Any-hit occlusion via the pair stream."""
    o_t, d_t, tn, tx, ex, n, nb = _prep(orig, d, tmin, tmax, exclude)
    cid_s, pos_s, runs, n_sc, overflow = _pair_stream_prep(cs, o_t, d_t, tn, tx)
    occ_p = cuda_binned.pair_round(cid_s, pos_s, runs, o_t, d_t, tn, tx, ex,
                                   cs, n_sc, closest=False)
    occ = occ_p.reshape(L_SLOTS, nb * BLOCK_RAYS).any(dim=0)
    fb = trace_occluded_binned(cs, o_t.T, d_t.T,
                               torch.where(overflow, tx, -torch.inf), tmin,
                               exclude=ex, reorder=True)
    return torch.where(overflow, fb, occ)[:n]
