"""PyTorch port, ops/bvh2.py: the BLAS set (host SAH per primitive) equal
to JAX's build_blas_set, the instance inverses and the per-frame TLAS
tables bit-equal to JAX's jitted build_frame_tlas, and B3's plain twin
against JAX's trace_closest_bvh2 / trace_occluded_bvh2 (tri and hit equal
on every lane, t, u, v within 1e-5; occlusion with exclude ids) and the
brute tracer, for many instances, one instance, and a scene padded to
capacity (scene/manager.pad_scene_capacity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.ops import bvh2 as jbvh2
from sunray_tpu.scene import types as jtypes
from sunray_tpu.scene.manager import pad_scene_capacity as jpad
from sunray_tpu_torch import convert
from sunray_tpu_torch.ops import bvh2, intersect
from torch_bvh_cases import ray_families
from torch_parity import jax_native_lib, n, t, to_numpy

TUV_ATOL = 1e-5


def _xf(angle, scale, shift):
    c, s = np.cos(angle), np.sin(angle)
    m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * scale
    m[1, 1] *= 1.3
    return np.concatenate([m, np.asarray(shift, np.float32)[:, None]], 1)


def instanced_scene(n_inst, seed=0, pad=False):
    """Two blob primitives (60 and 25 triangles), n_inst instances
    alternating between them, rotated, scaled and moved."""
    g = np.random.default_rng(seed)
    pos, tv, pt, off = [], [], [], 0
    for p, cnt in enumerate((60, 25)):
        c = g.uniform(-1, 1, (cnt, 3))
        v = np.stack([c, c + g.normal(0, .3, (cnt, 3)),
                      c + g.normal(0, .3, (cnt, 3))], 1).astype(np.float32)
        pos.append(v.reshape(-1, 3))
        tv.append(np.arange(3 * cnt).reshape(cnt, 3) + off)
        pt.append(np.full(cnt, p))
        off += 3 * cnt
    pos = np.concatenate(pos)
    nrm = np.tile(np.float32([[0, 0, 1]]), (pos.shape[0], 1))
    inst = [(i % 2, _xf(0.4 * i, 0.6 + 0.1 * i, g.uniform(-3, 3, 3)))
            for i in range(n_inst)]
    js = jtypes.build_scene(pos, nrm, np.concatenate(tv), np.concatenate(pt),
                            jtypes.MaterialTable.build([{}, {}]), inst)
    if pad:
        js = jpad(js)
    return js, convert.scene_from_numpy(to_numpy(js), device="cpu")


@pytest.fixture(scope="module", params=["many", "one", "padded"])
def case(request):
    jax_native_lib()    # JAX's build_blas_set takes the LBVH without it
    js, ps = instanced_scene(*{"many": (7,), "one": (1,),
                               "padded": (5, 1, True)}[request.param])
    jbl = jbvh2.build_blas_set(js, leaf_size=4)
    jtl = jax.jit(lambda s: jbvh2.build_frame_tlas(jbl, s))(js)
    pbl = bvh2.build_blas_set(ps, leaf_size=4)
    return dict(js=js, ps=ps, jbl=jbl, jtl=jtl, pbl=pbl,
                ptl=bvh2.build_frame_tlas(pbl, ps))


def test_blas_set_matches_jax(case):
    want = convert.blas_set_from_numpy(to_numpy(case["jbl"]), device="cpu")
    got = case["pbl"]
    for f in ("node_ids", "node_box", "leaf_v", "leaf_ids", "prim_root",
              "prim_root_min", "prim_root_max", "prim_tri_count"):
        np.testing.assert_array_equal(n(getattr(got, f)), n(getattr(want, f)),
                                      err_msg=f)
    for f in ("leaf_k", "n_leaf_rows", "n_blas_int"):
        assert getattr(got, f) == getattr(want, f)


def test_frame_tlas_matches_jax(case):
    jtl, ptl = case["jtl"], case["ptl"]
    np.testing.assert_array_equal(n(ptl.inst_inv), np.asarray(jtl.inst_inv_ext))
    np.testing.assert_array_equal(n(ptl.inst_off), np.asarray(jtl.inst_world_off))
    node = np.asarray(jtl.node_pack)
    np.testing.assert_array_equal(n(ptl.node_ids), node[:, :4].view(np.int32))
    np.testing.assert_array_equal(n(ptl.node_box), node[:, 4:])
    assert tuple(n(ptl.root)) == (int(jtl.root), int(jtl.root_icode))


def test_invert_affine_rows_matches_jax():
    g = np.random.default_rng(3)
    xf = np.concatenate([g.normal(size=(32, 3, 3)), g.normal(size=(32, 3, 1))],
                        2).astype(np.float32)
    xf[0] = 0.0     # a padded instance: singular, zero inverse
    want = jax.jit(jbvh2._invert_affine_rows)(jnp.asarray(xf))
    np.testing.assert_array_equal(n(bvh2.invert_affine_rows(t(xf))),
                                  np.asarray(want))


def _world(js):
    return tuple(t(np.asarray(v)) for v in js.world_triangle_vertices())


@pytest.mark.parametrize("family", ["camera", "bounce", "grazing", "axis"])
def test_walk_matches_jax_and_brute(case, family):
    wt = _world(case["js"])
    o, d = ray_families(tuple(n(v) for v in wt), n=600, seed=11)[family]
    want = jax.jit(lambda o, d: jbvh2.trace_closest_bvh2(case["jtl"], o, d))(
        jnp.asarray(o), jnp.asarray(d))
    got = bvh2.trace_closest_bvh2(case["ptl"], t(o), t(d))
    np.testing.assert_array_equal(n(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(n(got.tri), np.asarray(want.tri))
    m = np.asarray(want.hit)
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(n(getattr(got, f))[m],
                                   np.asarray(getattr(want, f))[m],
                                   atol=TUV_ATOL, rtol=0, err_msg=f)
    brute = intersect.trace_closest_brute(wt, t(o), t(d))
    np.testing.assert_array_equal(n(got.hit), n(brute.hit))
    other = n(got.hit) & (n(got.tri) != n(brute.tri))
    np.testing.assert_allclose(n(got.t)[other], n(brute.t)[other], rtol=1e-5)

    tmax = np.random.default_rng(2).uniform(0.2, 6, o.shape[0]).astype(np.float32)
    ex = np.where(np.arange(o.shape[0]) % 3 == 0, n(got.tri), -1).astype(np.int32)
    occ_want = jax.jit(lambda o, d, tx, e: jbvh2.trace_occluded_bvh2(
        case["jtl"], o, d, tx, exclude=e))(jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(tmax), jnp.asarray(ex))
    occ = bvh2.trace_occluded_bvh2(case["ptl"], t(o), t(d), t(tmax),
                                   exclude=t(ex))
    np.testing.assert_array_equal(n(occ), np.asarray(occ_want))
