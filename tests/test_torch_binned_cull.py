"""PyTorch port, K10's per-warp cull (ops/cuda_binned.py lane_box_test,
the ClusterSet's walk_box, binned_round_warp) on the CPU.

The CUDA K10 skips a cluster's triangle tests for a warp when no lane's
ray can meet the cluster's padded box before the lane's running result.
That is exact only if every hit Moller-Trumbore accepts lies inside the
box test. Held here on tests/torch_big_scene.py's small scene (the Cornell
box with a subdivided mirror sphere): every (ray, cluster) pair where
tile_hits finds a valid hit at t passes lane_box_test with upper = t (the
test is monotone in upper, so it then passes at any running result above
t), for camera rays, bounce rays off the visible surfaces, axis-parallel
and nearly axis-parallel rays, rays aimed at cluster box corners and faces
and at the walls' corners, and rays grazing the walls
(tests/torch_binned_cases.py). The walk restricted to the (warp, cluster)
pairs the rule keeps (binned_round_warp, the kernel's walk in plain
PyTorch) is bit-equal to binned_round_plain, on those grazing and corner
rays too. The traces made with it are held to the JAX package in
tests/test_torch_binned_walk_traces.py, the same rule at 100-1000x the
scene's scale in tests/test_torch_cull_scale.py, and K12's cull in
tests/test_torch_pair_cull.py.
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.ops import binned_trace as pbt
from sunray_tpu_torch.ops import cuda_binned as cb
from sunray_tpu_torch.ops import intersect
from torch_binned_cases import FAMILIES, cull_scene, family, unkept_hits, walk_case
from torch_parity import t


@pytest.fixture(scope="module")
def scene():
    """(world triangles as numpy, the port's ClusterSet)."""
    return cull_scene()


@pytest.mark.parametrize("kind", FAMILIES)
def test_lane_box_test_keeps_every_hit(scene, kind):
    tris, cs = scene
    o, d = family(kind, tris, cs)
    bad, pairs = unkept_hits(cs, o, d, cs.walk_box)
    assert pairs > 1000
    assert not bad, f"{len(bad)} of {pairs} hits fail the box test: {bad[:4]}"


def test_flat_box_edge_needs_the_pad(scene):
    """A ray 2.3e-4 outside the box's open face z = 2, nearly parallel to it
    (d_z = -7.8e-5), hits the red wall x = 0 on its edge z = 2, 1e-7 outside
    the cluster's box: 1.4e-3 before it enters the z slab, beyond K11's
    1e-4 slack in t, so K11's test on the cluster's own box drops it. The
    padded test keeps it."""
    _, cs = scene
    o = np.float32([[1.6852833, -0.34868064, 2.0002255]])
    d = np.float32([[-0.58299011, 0.81247926, -7.798562e-05]])
    o_t, d_t = t(o).T.contiguous(), t(d).T.contiguous()
    ro = tuple(o_t[a, :, None, None, None] for a in range(3))
    rd = tuple(d_t[a, :, None, None, None] for a in range(3))
    tmin = torch.tensor([intersect.T_MIN])
    tt, _, _, valid, _ = cb.tile_hits(ro, rd, tmin[0], torch.tensor(1e4),
                                      torch.tensor(-2), cs.tri_pack)
    hit_c = torch.nonzero(valid[0, :, 0].any(dim=-1))[:, 0].tolist()
    assert hit_c
    box = torch.cat([cs.aabb_lo, cs.aabb_hi], dim=1)
    k11 = [int(cb.cluster_scan_plain(o_t, d_t, tmin, tt[0, c, 0].amin()[None],
                                     box[c:c + 1])[1][0]) for c in hit_c]
    assert 0 in k11
    assert unkept_hits(cs, o, d, cs.walk_box) == ([], len(hit_c))


def _block_args(cs, o, d, tmax, ex, reorder=True):
    """K10's inputs as trace_*_binned makes them."""
    o, d = t(o), t(d)
    tmax = torch.as_tensor(tmax, dtype=torch.float32).expand(o.shape[0])
    ex = None if ex is None else t(ex)
    if reorder:
        o, d, tmax, ex, _ = pbt._reorder_rays(cs, o, d, tmax, ex)
    o_t, d_t, tn, tx, ex, _, nb = pbt._prep(o, d, intersect.T_MIN, tmax, ex)
    hit, entry = pbt._interval_cull(o_t, d_t, tn, tx, cs.aabb_lo, cs.aabb_hi, nb)
    return (*pbt._work_list(hit, entry), o_t, d_t, tn, tx, ex, cs)


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
@pytest.mark.parametrize("kind", ["camera", "bounce", "fallback", "short",
                                  "grazing", "wall_corners", "box_corners"])
def test_warp_walk_matches_plain(scene, kind, closest):
    """The (warp, cluster) pairs the rule keeps give binned_round_plain's
    outputs bit for bit, and the rule runs fewer tests than the blocks."""
    tris, cs = scene
    if kind == "fallback":
        cs = pbt.build_cluster_set(tuple(t(v) for v in tris), k=8)
    args = _block_args(cs, *walk_case(kind, tris, cs))
    want = cb.binned_round_plain(*args, closest=closest)
    got, tests = cb.binned_round_warp(*args, closest=closest)
    if closest:
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert (want[1] >= 0).any()
    else:
        assert torch.equal(got, want)
        assert 0.0 < want.float().mean() < 1.0
    count, tx = args[2], args[6]
    assert 0 < tests < int(count.sum()) * cb.BLOCK_RAYS
    if kind == "fallback":
        assert (count == 0).any() and (tx == -torch.inf).any()
