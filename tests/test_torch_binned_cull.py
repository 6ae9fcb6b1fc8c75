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
and at the walls' corners, and rays grazing the walls. The walk restricted
to the (warp, cluster) pairs the rule keeps (binned_round_warp, the
kernel's walk in plain PyTorch) is bit-equal to binned_round_plain, on
those grazing and corner rays too, and
the traces made with it equal the JAX package's binned tracer in
interpret mode (the comparison of tests/test_torch_binned.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops import binned_trace as jbt
from sunray_tpu_torch.camera import Camera, camera_matrices, generate_rays
from sunray_tpu_torch.ops import binned_trace as pbt
from sunray_tpu_torch.ops import cuda_binned as cb
from sunray_tpu_torch.ops import intersect
from sunray_tpu_torch.scene.types import MaterialTable, build_scene
from torch_big_scene import big_scene_args
from torch_parity import CAMERA, n, t

SUBDIV, K = 3, 32           # 1,316 triangles, 42 clusters
RTOL, ATOL = 1e-6, 1e-7     # tests/test_torch_binned.py's t/u/v bar


@pytest.fixture(scope="module")
def scene():
    """(world triangles as numpy, the port's ClusterSet)."""
    args = big_scene_args(SUBDIV)
    sc = build_scene(**dict(args, device="cpu", materials=MaterialTable.build(
        args["materials"], "cpu")))
    tris = tuple(n(v) for v in sc.world_triangle_vertices())
    return tris, pbt.build_cluster_set(tuple(t(v) for v in tris), k=K)


def _unit(d):
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _camera_rays(w=96, h=64):
    mats = camera_matrices(Camera(**CAMERA), w, h, device="cpu")
    o, d = generate_rays(mats, w, h)
    return n(o).reshape(-1, 3), n(d).reshape(-1, 3)


def _family(kind, tris, cs, m=4000, seed=0):
    """(origins, unit directions) of one ray family, float32."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        return _camera_rays()
    if kind == "bounce":
        co, cd = _camera_rays()
        hit = intersect.trace_closest_brute(tuple(t(v) for v in tris), t(co), t(cd))
        keep = n(hit.hit)
        p = co[keep] + cd[keep] * n(hit.t)[keep, None]
        d = _unit(rng.normal(size=p.shape))
        return (p + d * 1e-3).astype(np.float32), d
    o = rng.uniform(0.0, 2.0, (m, 3))
    axis = rng.integers(0, 3, m)
    if kind in ("axis", "near_axis"):
        d = np.zeros((m, 3))
        d[np.arange(m), axis] = rng.choice([-1.0, 1.0], m)
        if kind == "near_axis":
            d += rng.normal(size=(m, 3)) * rng.choice([1e-13, 1e-9, 1e-6, 1e-4],
                                                      (m, 1))
        return o.astype(np.float32), _unit(d)
    if kind == "grazing":
        o[np.arange(m), axis] = (rng.choice([0.0, 2.0], m)
                                 + rng.normal(size=m) * 0.05)
        d = rng.normal(size=(m, 3))
        d[np.arange(m), axis] = rng.normal(size=m) * rng.choice(
            [1e-2, 1e-4, 1e-6], m)
        return o.astype(np.float32), _unit(d)
    lo, hi = n(cs.aabb_lo), n(cs.aabb_hi)
    if kind == "wall_corners":
        target = rng.choice([0.0, 2.0], (m, 3))
    else:
        c = rng.integers(0, lo.shape[0], m)
        target = np.where(rng.integers(0, 2, (m, 3)).astype(bool), lo[c], hi[c])
        if kind == "box_faces":
            target[np.arange(m), axis] = rng.uniform(lo[c, axis], hi[c, axis])
    o = rng.uniform(-0.5, 2.5, (m, 3))
    return o.astype(np.float32), _unit(target - o)


def _unkept_hits(cs, o, d, box, step=256):
    """(ray, cluster) pairs with a valid tile_hits hit at t whose
    lane_box_test at upper = t fails, and the number of pairs with a hit."""
    o, d = t(o), t(d)
    tmin, tmax, ex = torch.tensor(intersect.T_MIN), torch.tensor(1e4), torch.tensor(-2)
    bad, pairs = [], 0
    for s in range(0, o.shape[0], step):
        ro = tuple(o[s:s + step, a, None, None, None] for a in range(3))
        rd = tuple(d[s:s + step, a, None, None, None] for a in range(3))
        tt, _, _, valid, _ = cb.tile_hits(ro, rd, tmin, tmax, ex, cs.tri_pack)
        t_hit, has = tt[:, :, 0].amin(dim=-1), valid[:, :, 0].any(dim=-1)
        ok = cb.lane_box_test(o[s:s + step, None], d[s:s + step, None], tmin,
                              t_hit, box[None])
        pairs += int(has.sum())
        bad += [(s + r, c) for r, c in torch.nonzero(has & ~ok).tolist()]
    return bad, pairs


FAMILIES = ["camera", "bounce", "axis", "near_axis", "box_corners", "box_faces",
            "wall_corners", "grazing"]


@pytest.mark.parametrize("kind", FAMILIES)
def test_lane_box_test_keeps_every_hit(scene, kind):
    tris, cs = scene
    o, d = _family(kind, tris, cs)
    bad, pairs = _unkept_hits(cs, o, d, cs.walk_box)
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
    assert _unkept_hits(cs, o, d, cs.walk_box) == ([], len(hit_c))


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


def _walk_case(kind, tris, cs, seed=3):
    """(o, d, tmax, exclude) numpy rays for the walk: "camera" (segments
    that end before or after the back wall), "bounce"
    (incoherent, from the visible surfaces), "fallback" (the overflow rays
    of a pair-stream query at cluster_k 8, the others masked to tmax =
    -inf: whole dead blocks after the sort), "short" (bounce rays with
    short segments and exclude ids, as the visibility queries send them),
    and the box rule's hardest families of _family: "grazing",
    "wall_corners" and "box_corners"."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        o, d = _camera_rays()
        return o, d, rng.uniform(1.0, 6.0, o.shape[0]).astype(np.float32), None
    if kind in ("grazing", "wall_corners", "box_corners"):
        o, d = _family(kind, tris, cs, seed=seed)
        return o, d, np.full(o.shape[0], 1e4, np.float32), None
    o, d = _family("bounce", tris, cs, seed=seed)
    m = o.shape[0] - 37                              # padding lanes
    o, d = o[:m], d[:m]
    ex = rng.integers(-1, tris[0].shape[0], m).astype(np.int32)
    if kind == "short":
        return o, d, rng.uniform(0.05, 2.0, m).astype(np.float32), ex
    tmax = np.full(m, 1e4, np.float32)
    if kind == "fallback":
        cs8 = pbt.build_cluster_set(tuple(t(v) for v in tris), k=8)
        o_t, d_t, tn, tx, _, _, _ = pbt._prep(t(o), t(d), intersect.T_MIN,
                                               t(tmax), None)
        _, cnt = pbt._cluster_scan(cs8, o_t, d_t, tn, tx)
        over = n(cnt[:m] > cb.L_SLOTS)
        assert 0.01 < over.mean() < 0.9
        tmax = np.where(over, tmax, -np.inf).astype(np.float32)
    return o, d, tmax, ex


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
@pytest.mark.parametrize("kind", ["camera", "bounce", "fallback", "short",
                                  "grazing", "wall_corners", "box_corners"])
def test_warp_walk_matches_plain(scene, kind, closest):
    """The (warp, cluster) pairs the rule keeps give binned_round_plain's
    outputs bit for bit, and the rule runs fewer tests than the blocks."""
    tris, cs = scene
    if kind == "fallback":
        cs = pbt.build_cluster_set(tuple(t(v) for v in tris), k=8)
    args = _block_args(cs, *_walk_case(kind, tris, cs))
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


def _jax_pair(tris, k):
    return (jbt.build_cluster_set(tuple(jnp.asarray(v) for v in tris), k=k),
            pbt.build_cluster_set(tuple(t(v) for v in tris), k=k))


def _check_hits(got, want):
    w_hit = np.asarray(want.hit)
    np.testing.assert_array_equal(n(got.hit), w_hit)
    np.testing.assert_array_equal(n(got.tri)[w_hit], np.asarray(want.tri)[w_hit])
    for g, w in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(n(g)[w_hit], np.asarray(w)[w_hit],
                                   rtol=RTOL, atol=ATOL)
    assert w_hit.any()


@pytest.mark.parametrize("query", ["camera_block", "bounce_pairs",
                                   "visibility_pairs"])
def test_warp_walk_traces_match_jax(scene, query, monkeypatch):
    """The port's traces with K10 as the warp walk against the JAX
    package's, its Pallas kernels in interpret mode: camera rays through the
    block path; bounce rays (closest) and short visibility segments with
    exclude ids (any-hit) through the pair stream at cluster_k 8, whose
    overflow rays take the block path."""
    tris, _ = scene
    monkeypatch.setattr(cb, "binned_round",
                        lambda *a, **kw: cb.binned_round_warp(*a, **kw)[0])
    if query == "camera_block":
        jcs, pcs = _jax_pair(tris, K)
        o, d, tmax, _ = _walk_case("camera", tris, pcs)
        want = jbt.trace_closest_binned(jcs, jnp.asarray(o), jnp.asarray(d),
                                        tmax=jnp.asarray(tmax), reorder=True)
        got = pbt.trace_closest_binned(pcs, t(o), t(d), tmax=t(tmax),
                                       reorder=True)
        _check_hits(got, want)
        return
    jcs, pcs = _jax_pair(tris, 8)
    o, d, tmax, ex = _walk_case("short" if query == "visibility_pairs"
                                else "bounce", tris, pcs)
    o, d = o[:1500], d[:1500]
    tmax, ex = tmax[:1500], ex[:1500]
    _, cnt = pbt._cluster_scan(pcs, *pbt._prep(t(o), t(d), intersect.T_MIN,
                                                t(tmax), None)[:4])
    assert (cnt > cb.L_SLOTS).any()                  # the fallback runs
    if query == "bounce_pairs":
        want = jbt.trace_closest_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                       tmax=jnp.asarray(tmax))
        _check_hits(pbt.trace_closest_pairs(pcs, t(o), t(d), tmax=t(tmax)),
                    want)
    else:
        want = jbt.trace_occluded_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(tmax),
                                        exclude=jnp.asarray(ex))
        got = pbt.trace_occluded_pairs(pcs, t(o), t(d), t(tmax), exclude=t(ex))
        np.testing.assert_array_equal(n(got), np.asarray(want))
        assert 0.0 < n(got).mean() < 1.0
