"""Inputs and checks shared by the binned tracer's parity tests
(tests/test_torch_binned*.py, test_torch_pair_cull.py,
test_torch_cull_scale.py): scenes, ray families and the comparisons with
the JAX package, which each test file feeds through its own fixtures.

Two kinds of scene: random triangle soups and a subdivided icosphere for
the tracer against sunray_tpu/ops/binned_trace.py (SCENES, rays()); and
tests/torch_big_scene.py's small scene (the Cornell box with a subdivided
mirror sphere, cull_scene()) for the kernels' per-warp culls, with the ray
families that stress their box rule (family(), walk_case())."""

import jax.numpy as jnp
import numpy as np
import torch

from sunray_tpu.ops import binned_trace as jbt
from sunray_tpu_torch.camera import Camera, camera_matrices, generate_rays
from sunray_tpu_torch.ops import binned_trace as pbt
from sunray_tpu_torch.ops import cuda_binned as cb
from sunray_tpu_torch.ops import intersect
from sunray_tpu_torch.scene.types import MaterialTable, build_scene
from torch_big_scene import big_scene_args, icosphere
from torch_parity import CAMERA, n, t

TRI_AGREE = 0.999
RTOL, ATOL = 1e-6, 1e-7


# -- the tracer against JAX: random soups and an icosphere ---------------------

def random_tris(count, seed, spread=1.0, size=0.3):
    rng = np.random.default_rng(seed)
    v0 = (rng.normal(size=(count, 3)) * spread).astype(np.float32)
    return (v0, v0 + (rng.normal(size=(count, 3)) * size).astype(np.float32),
            v0 + (rng.normal(size=(count, 3)) * size).astype(np.float32))


def sphere_tris(subdiv=3):
    verts, faces = icosphere(subdiv)
    return tuple(np.ascontiguousarray(verts[faces[:, c]]) for c in range(3))


def rays(kind, count, seed):
    """(orig, d, tmax, exclude) numpy rays: "random" over the scene,
    "center" from near its middle (rays that cross many superclusters,
    the overflow case), "camera" a common-origin fan, "away" rays that hit
    nothing."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        o = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), (count, 3)).copy()
        d = np.concatenate([rng.uniform(-0.4, 0.4, (count, 2)),
                            np.full((count, 1), -1.0)], axis=1)
    else:
        scale = {"random": 2.0, "center": 0.1, "away": 1.0}[kind]
        o = rng.normal(size=(count, 3)) * scale
        d = rng.normal(size=(count, 3))
        if kind == "away":
            o = o + np.float32([0.0, 0.0, 50.0])
            d[:, 2] = np.abs(d[:, 2])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.abs(rng.normal(size=count)) * 4.0 + 0.5
    ex = rng.integers(-1, 2000, size=count)
    return (o.astype(np.float32), d.astype(np.float32),
            tmax.astype(np.float32), ex.astype(np.int32))


def jax_pair(tris, k):
    """The JAX ClusterSet and the port's, each built by its own package."""
    return (jbt.build_cluster_set(tuple(jnp.asarray(v) for v in tris), k=k),
            pbt.build_cluster_set(tuple(t(v) for v in tris), k=k))


SCENES = {
    "random": lambda: jax_pair(random_tris(2000, 0), 128),
    "random_k32": lambda: jax_pair(random_tris(2000, 0), 32),
    "sphere": lambda: jax_pair(sphere_tris(3), 64),
}


def check_hits(got, want, tri_agree=TRI_AGREE):
    """Hit / miss equal, t/u/v within RTOL/ATOL where JAX hits, t = inf
    where it misses, tri equal on >= tri_agree of the hits."""
    w_hit = np.asarray(want.hit)
    np.testing.assert_array_equal(n(got.hit), w_hit)
    for g, w in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(n(g)[w_hit], np.asarray(w)[w_hit],
                                   rtol=RTOL, atol=ATOL)
    assert np.isinf(n(got.t)[~w_hit]).all()
    if w_hit.any():
        agree = (n(got.tri)[w_hit] == np.asarray(want.tri)[w_hit]).mean()
        assert agree >= tri_agree, agree


# -- the kernels' culls: the small big-mesh scene -----------------------------

SUBDIV, K = 3, 32           # 1,316 triangles, 42 clusters
FAMILIES = ["camera", "bounce", "axis", "near_axis", "box_corners", "box_faces",
            "wall_corners", "grazing"]


def cull_scene():
    """(world triangles as numpy, the port's ClusterSet at cluster_k K)."""
    args = big_scene_args(SUBDIV)
    sc = build_scene(**dict(args, device="cpu", materials=MaterialTable.build(
        args["materials"], "cpu")))
    tris = tuple(n(v) for v in sc.world_triangle_vertices())
    return tris, pbt.build_cluster_set(tuple(t(v) for v in tris), k=K)


def _unit(d):
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def camera_rays(w=96, h=64):
    mats = camera_matrices(Camera(**CAMERA), w, h, device="cpu")
    o, d = generate_rays(mats, w, h)
    return n(o).reshape(-1, 3), n(d).reshape(-1, 3)


def family(kind, tris, cs, m=4000, seed=0):
    """(origins, unit directions) of one ray family, float32."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        return camera_rays()
    if kind == "bounce":
        co, cd = camera_rays()
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


def unkept_hits(cs, o, d, box, pair=False, step=256):
    """(ray, cluster) pairs with a valid tile_hits hit at t (t rounded as
    K12 rounds it if pair, else as K10 does) whose lane_box_test at upper
    = t fails, and the number of pairs with a hit."""
    o, d = t(o), t(d)
    tmin, tmax, ex = torch.tensor(intersect.T_MIN), torch.tensor(1e4), torch.tensor(-2)
    bad, pairs = [], 0
    for s in range(0, o.shape[0], step):
        ro = tuple(o[s:s + step, a, None, None, None] for a in range(3))
        rd = tuple(d[s:s + step, a, None, None, None] for a in range(3))
        tt, _, _, valid, _ = cb.tile_hits(ro, rd, tmin, tmax, ex, cs.tri_pack,
                                          pair=pair)
        t_hit, has = tt[:, :, 0].amin(dim=-1), valid[:, :, 0].any(dim=-1)
        ok = cb.lane_box_test(o[s:s + step, None], d[s:s + step, None], tmin,
                              t_hit, box[None])
        pairs += int(has.sum())
        bad += [(s + r, c) for r, c in torch.nonzero(has & ~ok).tolist()]
    return bad, pairs


def walk_case(kind, tris, cs, seed=3):
    """(o, d, tmax, exclude) numpy rays for the walks: "camera" (segments
    that end before or after the back wall), "bounce"
    (incoherent, from the visible surfaces), "fallback" (the overflow rays
    of a pair-stream query at cluster_k 8, the others masked to tmax =
    -inf: whole dead blocks after the sort), "short" (bounce rays with
    short segments and exclude ids, as the visibility queries send them),
    and the box rule's hardest families of family(): "grazing",
    "wall_corners" and "box_corners"."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        o, d = camera_rays()
        return o, d, rng.uniform(1.0, 6.0, o.shape[0]).astype(np.float32), None
    if kind in ("grazing", "wall_corners", "box_corners"):
        o, d = family(kind, tris, cs, seed=seed)
        return o, d, np.full(o.shape[0], 1e4, np.float32), None
    o, d = family("bounce", tris, cs, seed=seed)
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


def check_hits_exact(got, want):
    """check_hits with tri equal on every hit, and some hit."""
    check_hits(got, want, tri_agree=1.0)
    assert np.asarray(want.hit).any()
