"""PyTorch port, alpha cutout inside the BVH walks: the plain twin of the
fused kernel (ops/bvh.walk_alpha_plain, each ray's rounds lane by lane)
against the port's batch rounds (render/trace.py on the CPU; t, tri, u, v
and hit bit-equal, occlusion equal) and against JAX's trace_closest /
trace_occluded with alpha_mask_tracing under jax.jit (bit-equal too: t,
tri, u, v, hit and occlusion on every lane), for the
unified (bvh) and two-level (bvh2) tables, with and without exclude ids,
on four scenes:

  - "glb": tools/synth_gltf.py's scene at 8x8 textures and two 20-triangle
    spheres, rays through its MASK panel grid (clamp, nearest);
  - "layered": tests/test_torch_alpha.py's stack of cutout layers, more
    than alpha_rounds deep;
  - "tunnel": six checker cutout layers with the same uvs in front of an
    opaque quad: a ray through a hole passes every layer, so the round
    limit decides it;
  - "wraps": a row of MASK quads, each texture with its own size, wrap
    mode per axis (repeat, clamp, mirror) and filter (nearest, bilinear),
    their uvs running from -2.3 to 3.4 (negative texel coordinates), a
    MASK NULL_TEXTURE quad below its cutoff and one above, a second
    instance of every quad behind the first and an opaque back wall.

Also: the alpha test read from a scene's tables (ops/texture.alpha_tables,
alpha_accepts) equals JAX's jitted _alpha_accepts on every hit, and
walk_plain reading the kernels' edge rows (ops/bvh.leaf_edges) gives the
same bits as reading the corners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.render import trace as jtrace
from sunray_tpu.scene import gltf as jgltf
from sunray_tpu.scene import types as jtypes
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import bvh, cuda_bvh, intersect, texture
from sunray_tpu_torch.render import trace
from test_torch_alpha import layered_scene, tracers
from torch_bvh_cases import alpha_scene_rays, tunnel_arrays, wraps_arrays
from torch_parity import n, t, to_numpy

ROUNDS = 4          # render/trace.py TracerCtx.alpha_rounds


def jax_scene(arrays):
    """A JAX SceneBuffers from torch_bvh_cases' arrays."""
    data, size, wrap, filt = (jnp.asarray(x) for x in arrays["atlas"])
    pos = arrays["positions"]
    return jtypes.build_scene(
        pos, np.tile(np.float32([[0, 0, 1]]), (pos.shape[0], 1)),
        arrays["tri_vidx"], arrays["prim_of_tri"],
        jtypes.MaterialTable.build(arrays["records"]), arrays["instances"],
        uvs=arrays["uvs"],
        textures=jtypes.TextureAtlas(data=data, size=size, wrap=wrap,
                                     filt=filt))


def glb_scene(tmp_path_factory):
    from tools.synth_gltf import write_scene

    path = tmp_path_factory.mktemp("glb") / "scene.glb"
    write_scene(str(path), seed=3, tex=8, subdiv=0, spheres=2)
    return jgltf.load_gltf(str(path))


def scene_rays(which, count=600, seed=0):
    from tools.synth_gltf import CAMERA

    return alpha_scene_rays(which, count, seed, CAMERA["position"])


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    return glb_scene(tmp_path_factory)


def jscene_of(which, glb):
    return {"glb": lambda: glb, "layered": layered_scene,
            "tunnel": lambda: jax_scene(tunnel_arrays()),
            "wraps": lambda: jax_scene(wraps_arrays())}[which]()


def jax_closest(jctx, o, d):
    return jax.jit(lambda a, b: jtrace.trace_closest(jctx, a, b))(
        jnp.asarray(o), jnp.asarray(d))


def jax_occluded(jctx, o, d, tmax, exclude):
    if exclude is None:
        f = jax.jit(lambda a, b, c: jtrace.trace_occluded(jctx, a, b, c))
        return f(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    f = jax.jit(lambda a, b, c, e: jtrace.trace_occluded(jctx, a, b, c,
                                                         exclude=e))
    return f(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
             jnp.asarray(exclude))


def bits(x):
    return n(x).view(np.int32)


@pytest.mark.parametrize("tracer", ["bvh", "bvh2"])
@pytest.mark.parametrize("which", ["glb", "layered", "tunnel", "wraps"])
def test_fused_twin_matches_rounds_and_jax(which, tracer, glb):
    jctx, pctx = tracers(jscene_of(which, glb), tracer)
    assert pctx.walk is not None and pctx.alpha is not None
    o, d, tmax = scene_rays(which)
    rays = bvh._rays(t(o), t(d), intersect.T_MIN, intersect.T_MAX)
    twin = bvh.walk_alpha_plain(pctx.walk, pctx.alpha, *rays, ROUNDS,
                                any_hit=False)
    via = cuda_bvh.walk_closest_alpha(pctx.walk, pctx.alpha, *rays, ROUNDS)
    rounds = trace.trace_closest(pctx, t(o), t(d))
    jh = jax_closest(jctx, o, d)
    hit = n(rounds.hit)
    assert hit.any()
    for got in (twin, via):
        np.testing.assert_array_equal(n(got[4] if got is via else got.found),
                                      hit)
    for name, k in (("t", 0), ("u", 2), ("v", 3)):
        np.testing.assert_array_equal(bits(twin[k]), bits(rounds[k]), name)
        np.testing.assert_array_equal(bits(via[k]), bits(rounds[k]), name)
    np.testing.assert_array_equal(n(twin.tri), n(rounds.tri))
    np.testing.assert_array_equal(hit, np.asarray(jh.hit))
    np.testing.assert_array_equal(n(twin.tri)[hit], np.asarray(jh.tri)[hit])
    for k, name in ((0, "t"), (2, "u"), (3, "v")):
        np.testing.assert_array_equal(bits(twin[k])[hit],
                                      np.asarray(jh[k]).view(np.int32)[hit], name)

    ex = np.where(np.arange(o.shape[0]) % 2 == 0,
                  np.where(hit, n(twin.tri), -1), -1).astype(np.int32)
    seg = t(tmax - np.float32(1e-3))
    for exclude in (None, ex):
        tex = None if exclude is None else t(exclude)
        occ = bvh.walk_alpha_plain(
            pctx.walk, pctx.alpha, *bvh._rays(t(o), t(d), intersect.T_MIN, seg),
            ROUNDS, any_hit=True, exclude=tex)
        po = trace.trace_occluded(pctx, t(o), t(d), t(tmax), exclude=tex)
        jo = np.asarray(jax_occluded(jctx, o, d, tmax, exclude))
        np.testing.assert_array_equal(n(occ.found), n(po))
        np.testing.assert_array_equal(n(po), jo)
        assert occ.t is None and (occ.box_tests > 0).all()


def test_round_limit_decides():
    """In the tunnel scene some rays end on a rejected hit after
    alpha_rounds re-walks (their tests sum over the walks), and a ray the
    round limit stops is visible to the occlusion query although the
    opaque quad lies within its segment."""
    _, pctx = tracers(jax_scene(tunnel_arrays()), "bvh")
    o, d, _ = scene_rays("tunnel")
    rays = bvh._rays(t(o), t(d), intersect.T_MIN, intersect.T_MAX)
    twin = bvh.walk_alpha_plain(pctx.walk, pctx.alpha, *rays, ROUNDS,
                                any_hit=False)
    tri = torch.where(twin.found, twin.tri, 0)
    rejected = twin.found & ~texture.alpha_accepts(pctx.alpha, tri, twin.u,
                                                   twin.v)
    assert bool(rejected.any())
    one = bvh.walk_plain(pctx.walk, *rays, any_hit=False)
    assert bool((twin.box_tests[rejected] > one.box_tests[rejected]).all())
    fewer = bvh.walk_alpha_plain(pctx.walk, pctx.alpha, *rays, 1,
                                 any_hit=False)
    assert not torch.equal(fewer.tri, twin.tri)
    far = bvh._rays(t(o), t(d), intersect.T_MIN, 20.0)
    occ = bvh.walk_alpha_plain(pctx.walk, pctx.alpha, *far, ROUNDS,
                               any_hit=True)
    deep = bvh.walk_alpha_plain(pctx.walk, pctx.alpha, *far, 8, any_hit=True)
    assert bool((~occ.found & deep.found).any())


@pytest.mark.parametrize("which", ["glb", "layered", "tunnel", "wraps"])
def test_alpha_tables_match_jax(which, glb):
    """Every hit's alpha test read from the tables equals JAX's jitted
    _alpha_accepts on the scene, masked hits of every material included."""
    jscene = jscene_of(which, glb)
    _, pctx = tracers(jscene, "bvh")
    o, d, _ = scene_rays(which, count=2000, seed=1)
    hits = []
    for tmin in (intersect.T_MIN, 3.0, 6.0, 7.9):
        h = bvh.walk_plain(pctx.walk, *bvh._rays(t(o), t(d), tmin,
                                                 intersect.T_MAX),
                           any_hit=False)
        hits.append(h)
    tri = torch.cat([torch.where(h.found, h.tri, 0) for h in hits])
    u = torch.cat([h.u for h in hits])
    v = torch.cat([h.v for h in hits])
    want = np.asarray(jax.jit(lambda *a: jtrace._alpha_accepts(jscene, *a))(
        *(jnp.asarray(n(x)) for x in (tri, u, v))))
    got = n(texture.alpha_accepts(pctx.alpha, tri, u, v))
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    if which == "wraps":
        mats = n(pctx.alpha.tri_mat[tri.long()])
        assert set(np.unique(mats[mats >= 0])) == set(range(8))


@pytest.mark.parametrize("tracer", ["bvh", "bvh2"])
def test_walk_reads_edges(tracer, glb):
    """walk_plain on the edge rows (a, b - a, c - a) the kernels read gives
    the bits of the walk on the corners."""
    _, pctx = tracers(glb, tracer)
    assert pctx.walk.leaf_e.shape == (*pctx.walk.leaf_ids.shape, 12)
    o, d, tmax = scene_rays("glb", seed=2)
    rays = bvh._rays(t(o), t(d), intersect.T_MIN, t(tmax))
    for any_hit in (False, True):
        a = bvh.walk_plain(pctx.walk, *rays, any_hit=any_hit)
        b = bvh.walk_plain(pctx.walk, *rays, any_hit=any_hit, edges=True)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(n(x).view(np.uint8), n(y).view(np.uint8))


def test_tracer_ctx_alpha_tables(glb):
    """make_tracer builds the alpha tables once a context, for every
    tracer, with alpha cutout on; with it off, none."""
    for tracer in ("brute", "bvh", "bvh2"):
        _, pctx = tracers(glb, tracer)
        assert pctx.alpha is not None
        assert pctx.alpha.tri_mat.shape[0] == pctx.tris[0].shape[0]
    pscene = convert.scene_from_numpy(to_numpy(glb), device="cpu")
    off = trace.make_tracer(pscene, RenderConfig(width=8, height=8,
                                                 tracer="bvh"))
    assert off.alpha is None
