"""PyTorch port, ops/bvh.py and the native SAH builder: the LBVH build
(Morton codes, clz, Karras topology) equal to JAX's jitted build_bvh,
boxes and refit bit-equal, the walk's tables bit-equal to JAX's
_pack_tables, the port's SAH copy equal to JAX's build_sah_bvh; B2's
plain twin (walk_plain) against JAX's trace_closest_bvh /
trace_occluded_bvh on camera, bounce, grazing and axis-parallel rays (tri
and hit equal on every lane, t, u, v within 1e-5), and against the brute
tracer (the same triangle except at exact ties)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops import bvh as jbvh
from sunray_tpu_torch import convert
from sunray_tpu_torch.native import build_sah_bvh
from sunray_tpu_torch.ops import bvh, intersect
from torch_bvh_cases import ray_families, soup
from torch_parity import jax_build_sah as jbuild_sah
from torch_parity import n, t, to_numpy

FIELDS = ("child_l", "child_r", "node_min", "node_max", "leaf_tri",
          "range_first", "range_last")
TUV_ATOL = 1e-5


def assert_bvh_equal(jb, pb):
    assert int(jb.num_leaves) == pb.num_leaves
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                      n(getattr(pb, f)), err_msg=f)


@pytest.fixture(scope="module")
def scene():
    tris = soup()
    jt = tuple(jnp.asarray(v) for v in tris)
    pt = tuple(t(v) for v in tris)
    jb = jax.jit(lambda x: jbvh.build_bvh(x, leaf_size=4))(jt)
    return dict(tris=tris, jt=jt, pt=pt, jb=jb, pb=bvh.build_bvh(pt, 4))


def test_morton_and_clz_match_jax():
    g = np.random.default_rng(0)
    q = g.integers(0, 1024, (3, 4096)).astype(np.uint32)
    want = np.asarray(jbvh._morton3(*(jnp.asarray(x) for x in q)))
    got = n(bvh.morton3(*(t(x.astype(np.int64)) for x in q)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    x = np.concatenate([[0, 1, 2, 3, 2 ** 31, 2 ** 32 - 1],
                        g.integers(0, 2 ** 32, 4096)]).astype(np.uint32)
    np.testing.assert_array_equal(n(bvh.clz32(t(x.astype(np.int64)))),
                                  np.asarray(jbvh._clz32(jnp.asarray(x))))


@pytest.mark.parametrize("dup", [False, True])
def test_karras_topology_matches_jax(dup):
    """Sorted codes, with runs of duplicates (the index tiebreak) or not."""
    g = np.random.default_rng(1)
    codes = np.sort(g.integers(0, 2 ** 30, 777)).astype(np.uint32)
    if dup:
        codes = np.sort(np.repeat(codes[::7], 7)[:777])
    want = jax.jit(jbvh.karras_topology)(jnp.asarray(codes))
    got = bvh.karras_topology(t(codes.astype(np.int64)))
    for w, p in zip(want, got):
        np.testing.assert_array_equal(n(p), np.asarray(w))


@pytest.mark.parametrize("count,leaf", [(1, 4), (4, 4), (5, 4), (300, 4),
                                        (300, 2), (1000, 8)])
def test_build_matches_jax(count, leaf):
    tris = tuple(v[:count] for v in soup(max(count, 1), seed=count))
    jb = jax.jit(lambda x: jbvh.build_bvh(x, leaf_size=leaf))(
        tuple(jnp.asarray(v) for v in tris))
    assert_bvh_equal(jb, bvh.build_bvh(tuple(t(v) for v in tris), leaf))


def test_refit_matches_jax(scene):
    moved = tuple(v + np.float32([0.3, -0.1, 0.25]) * (1 + k)
                  for k, v in enumerate(scene["tris"]))
    want = jax.jit(jbvh.refit_bvh)(scene["jb"], tuple(jnp.asarray(v)
                                                      for v in moved))
    got = bvh.refit_bvh(scene["pb"], tuple(t(v) for v in moved))
    assert_bvh_equal(want, got)


def test_pack_tables_match_jax(scene):
    node, leaf = jax.jit(jbvh._pack_tables)(scene["jb"], scene["jt"])
    node, leaf = np.asarray(node), np.asarray(leaf)
    tab = bvh.pack_tables(scene["pb"], scene["pt"])
    nl = scene["pb"].num_leaves
    # JAX's children ids (internal < NL-1, leaf at NL-1+k) in the walk's
    # encoding (leaf k -> k, internal j -> NL + j).
    ids = node[:, :2].view(np.int32)
    enc = np.where(ids >= nl - 1, ids - (nl - 1), nl + ids)
    np.testing.assert_array_equal(n(tab.node_ids[:, :2]), enc)
    np.testing.assert_array_equal(n(tab.node_ids[:, 2:]), 0)
    np.testing.assert_array_equal(n(tab.node_box).view(np.int32),
                                  node[:, 2:14].view(np.int32))
    lp = leaf.reshape(nl, -1, 10)
    np.testing.assert_array_equal(n(tab.leaf_v).view(np.int32),
                                  lp[..., :9].view(np.int32))
    np.testing.assert_array_equal(n(tab.leaf_ids), lp[..., 9].view(np.int32))
    assert tuple(n(tab.root)) == (nl, 0)


@pytest.mark.parametrize("count", [1, 5, 200, 3000])
def test_sah_copy_matches_jax(count):
    tris = soup(count, seed=count + 7, floor=0)
    assert_bvh_equal(jbuild_sah(*tris, leaf_size=4),
                     build_sah_bvh(*tris, leaf_size=4))


def test_convert_bvh_from_numpy(scene):
    got = convert.bvh_from_numpy(to_numpy(scene["jb"]), device="cpu")
    assert_bvh_equal(scene["jb"], got)


def jax_closest(jb, jt, o, d):
    return jax.jit(lambda b, o, d: jbvh.trace_closest_bvh(b, jt, o, d))(
        jb, jnp.asarray(o), jnp.asarray(d))


def assert_hits_match(jh, ph):
    np.testing.assert_array_equal(n(ph.hit), np.asarray(jh.hit))
    np.testing.assert_array_equal(n(ph.tri), np.asarray(jh.tri))
    m = np.asarray(jh.hit)
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(n(getattr(ph, f))[m],
                                   np.asarray(getattr(jh, f))[m],
                                   atol=TUV_ATOL, rtol=0, err_msg=f)
    assert np.isinf(n(ph.t)[~m]).all()


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
@pytest.mark.parametrize("family", ["camera", "bounce", "grazing", "axis"])
def test_walk_closest_matches_jax_and_brute(scene, family, builder):
    o, d = ray_families(scene["tris"])[family]
    if builder == "lbvh":
        jb, pb = scene["jb"], scene["pb"]
    else:
        jb = jbuild_sah(*scene["tris"], leaf_size=4)
        pb = build_sah_bvh(*scene["tris"], leaf_size=4)
    ph = bvh.trace_closest_bvh(pb, scene["pt"], t(o), t(d))
    assert_hits_match(jax_closest(jb, scene["jt"], o, d), ph)
    bh = intersect.trace_closest_brute(scene["pt"], t(o), t(d))
    np.testing.assert_array_equal(n(ph.hit), n(bh.hit))
    other = n(ph.hit) & (n(ph.tri) != n(bh.tri))
    # a different triangle only at an exact tie in t
    np.testing.assert_array_equal(n(ph.t)[other], n(bh.t)[other])


@pytest.mark.parametrize("family", ["camera", "bounce", "grazing", "axis"])
def test_walk_occluded_matches_jax(scene, family):
    o, d = ray_families(scene["tris"])[family]
    g = np.random.default_rng(5)
    tmax = g.uniform(0.1, 6.0, o.shape[0]).astype(np.float32)
    closest = bvh.trace_closest_bvh(scene["pb"], scene["pt"], t(o), t(d))
    # every other ray excludes the triangle it would hit first
    ex = np.where(np.arange(o.shape[0]) % 2 == 0, n(closest.tri),
                  -1).astype(np.int32)
    for exclude in (None, ex):
        want = jax.jit(lambda b, o, d, tx, e: jbvh.trace_occluded_bvh(
            b, scene["jt"], o, d, tx, exclude=e))(
            scene["jb"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
            None if exclude is None else jnp.asarray(exclude))
        got = bvh.trace_occluded_bvh(scene["pb"], scene["pt"], t(o), t(d),
                                     t(tmax), exclude=None if exclude is None
                                     else t(exclude))
        np.testing.assert_array_equal(n(got), np.asarray(want))
        brute = intersect.trace_occluded_brute(
            scene["pt"], t(o), t(d), t(tmax),
            exclude=None if exclude is None else t(exclude))
        np.testing.assert_array_equal(n(got), n(brute))


def test_walk_counts_tests(scene):
    """The plain twin's counters: two slab tests an internal node popped,
    a triangle test for every valid leaf slot; any hit stops early."""
    o, d = ray_families(scene["tris"])["camera"]
    tab = bvh.pack_tables(scene["pb"], scene["pt"])
    n_rays = o.shape[0]
    tn = torch.full((n_rays,), intersect.T_MIN)
    tx = torch.full((n_rays,), intersect.T_MAX)
    full = bvh.walk_plain(tab, t(o), t(d), tn, tx, any_hit=False)
    anyh = bvh.walk_plain(tab, t(o), t(d), tn, tx, any_hit=True)
    assert (full.box_tests % 2 == 0).all() and (full.box_tests > 0).all()
    assert (anyh.box_tests <= full.box_tests).all()
    assert (anyh.tri_tests <= full.tri_tests).all()
    assert bool((anyh.found == full.found).all())
