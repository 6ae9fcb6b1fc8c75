"""PyTorch port, K12's per-warp cull (ops/cuda_binned.py pair_round_warp)
on the CPU.

The CUDA K12 visits the SC_K clusters of a pair lane's supercluster in
order, and the lanes of one run within a warp skip a cluster's tests when
none of their rays can meet the cluster's padded box (the ClusterSet's
walk_box, K10's rule) before the lane's running result. That is exact only
if every hit that K12's Moller-Trumbore accepts lies inside the box test;
K12 rounds t as the pair kernel of the JAX package does
(tile_hits(pair=True)), not as K10 does, so the claim that
tests/test_torch_binned_cull.py holds for K10 is held again here for that
rounding, on the same eight ray families of tests/torch_binned_cases.py.
The walk (pair_round_warp) is bit-equal to pair_round_plain, closest and
any-hit, on camera, bounce, short visibility, grazing and corner rays and
on exact ties across the clusters of a supercluster, and runs fewer
cluster tests than the SC_K a live lane the unculled kernel ran. The pair
traces made with it are held to the JAX package in
tests/test_torch_binned_walk_traces.py.
"""

import pytest
import torch

from sunray_tpu_torch.ops import binned_trace as pbt
from sunray_tpu_torch.ops import cuda_binned as cb
from sunray_tpu_torch.ops import intersect
from torch_binned_cases import FAMILIES, cull_scene, family, unkept_hits, walk_case
from torch_parity import t, tie_cluster_set


@pytest.fixture(scope="module")
def scene():
    """(world triangles as numpy, the port's ClusterSet)."""
    return cull_scene()


@pytest.mark.parametrize("kind", FAMILIES)
def test_lane_box_test_keeps_every_pair_hit(scene, kind):
    tris, cs = scene
    o, d = family(kind, tris, cs)
    bad, pairs = unkept_hits(cs, o, d, cs.walk_box, pair=True)
    assert pairs > 1000
    assert not bad, f"{len(bad)} of {pairs} hits fail the box test: {bad[:4]}"


def _pair_args(cs, o, d, tmax, ex):
    """K12's inputs as trace_*_pairs makes them."""
    o_t, d_t, tn, tx, ex, _, _ = pbt._prep(t(o), t(d), intersect.T_MIN, t(tmax),
                                           None if ex is None else t(ex))
    cid_s, pos_s, runs, n_sc, _ = pbt._pair_stream_prep(cs, o_t, d_t, tn, tx)
    return cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
@pytest.mark.parametrize("kind", ["camera", "bounce", "short", "grazing",
                                  "box_corners", "ties"])
def test_pair_walk_matches_plain(scene, kind, closest):
    """The (warp, run, cluster) tests the rule keeps give pair_round_plain's
    outputs at every pair position, bit for bit, in fewer tests. "ties":
    the camera rays on a ClusterSet whose second cluster of each
    supercluster repeats the first's triangles under other ids."""
    tris, cs = scene
    shift = int(cs.tri_ids.max()) + 1
    if kind == "ties":
        cs = tie_cluster_set(cs)
    args = _pair_args(cs, *walk_case("camera" if kind == "ties" else kind,
                                     tris, cs))
    cid_s, n_sc = args[0], args[9]
    want = cb.pair_round_plain(*args, closest=closest)
    got, tests = cb.pair_round_warp(*args, closest=closest)
    if closest:
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert (want[1] >= 0).any()
    else:
        assert torch.equal(got, want)
        assert want.any()
    assert 0 < tests < int((cid_s < n_sc).sum()) * cb.SC_K
    if kind == "ties" and closest:
        # Every hit on a first cluster's triangle is tied by its copy in the
        # second cluster; slot order keeps the first, so no copy wins.
        c, k = cs.tri_pack.shape[0], cs.tri_pack.shape[2]
        firsts = cs.tri_ids.reshape(c, k)[0::cb.SC_K].reshape(-1)
        hit_tri = want[1][want[1] >= 0]
        assert torch.isin(hit_tri, firsts[firsts >= 0]).any()
        assert not (hit_tri >= shift).any()
