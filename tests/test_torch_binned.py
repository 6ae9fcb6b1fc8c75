"""PyTorch port, the binned tracer (K10-K12 and the PyTorch around them)
against sunray_tpu/ops/binned_trace.py, its Pallas kernels in interpret
mode, on the same numpy inputs.

Held exactly: the cluster build (tri_ids, pack bits, AABBs), the interval
cull (mask and entry bounds, bit for bit), the coherence keys, the cluster
scan (slots and counts) and the pair work items. Traces, on the block path
(with and without the coherence reorder) and the pair stream (with the
overflow fallback): hit / occluded equal, t/u/v within 1e-6 relative
(1e-7 absolute), tri equal on >= 99.9% of hits (the bar of
tests/test_binned_trace.py:41-49; on these inputs they agree on every
ray). The CUDA kernels are held to the plain versions in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops import binned_trace as jbt
from sunray_tpu_torch import convert
from sunray_tpu_torch.ops import binned_trace as pbt
from torch_big_scene import icosphere
from torch_parity import n, t

TRI_AGREE = 0.999
RTOL, ATOL = 1e-6, 1e-7


def _random_tris(count, seed, spread=1.0, size=0.3):
    rng = np.random.default_rng(seed)
    v0 = (rng.normal(size=(count, 3)) * spread).astype(np.float32)
    return (v0, v0 + (rng.normal(size=(count, 3)) * size).astype(np.float32),
            v0 + (rng.normal(size=(count, 3)) * size).astype(np.float32))


def _sphere_tris(subdiv=3):
    verts, faces = icosphere(subdiv)
    return tuple(np.ascontiguousarray(verts[faces[:, c]]) for c in range(3))


def _rays(kind, count, seed):
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


def _pair(tris, k):
    """The JAX ClusterSet and the port's, each built by its own package."""
    jcs = jbt.build_cluster_set(tuple(jnp.asarray(v) for v in tris), k=k)
    return jcs, pbt.build_cluster_set(tuple(t(v) for v in tris), k=k)


SCENES = {
    "random": lambda: _pair(_random_tris(2000, 0), 128),
    "random_k32": lambda: _pair(_random_tris(2000, 0), 32),
    "sphere": lambda: _pair(_sphere_tris(3), 64),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return request.param, SCENES[request.param]()


def test_build_cluster_set_matches_jax(scene):
    _, (jcs, pcs) = scene
    np.testing.assert_array_equal(n(pcs.tri_ids), np.asarray(jcs.tri_ids))
    np.testing.assert_array_equal(n(pcs.tri_pack),
                                  np.asarray(jcs.tri_pack).view(np.int32))
    np.testing.assert_array_equal(n(pcs.aabb_lo), np.asarray(jcs.aabb_lo))
    np.testing.assert_array_equal(n(pcs.aabb_hi), np.asarray(jcs.aabb_hi))
    assert pcs.tri_pack.dtype == torch.int32
    carried = convert.cluster_set_from_numpy(
        {k: np.asarray(v) for k, v in jcs._asdict().items()}, device="cpu")
    for a, b in zip(carried, pcs):
        assert torch.equal(a, b)


def test_refit_matches_jax():
    """The load-time assignment kept, geometry moved (refit_cluster_set)."""
    tris = _random_tris(700, 3)
    jcs, pcs = _pair(tris, 64)
    moved = tuple((v * 1.5 + np.float32(0.25)).astype(np.float32) for v in tris)
    j = jbt.refit_cluster_set(jcs, tuple(jnp.asarray(v) for v in moved))
    p = pbt.refit_cluster_set(pcs, tuple(t(v) for v in moved))
    np.testing.assert_array_equal(n(p.tri_pack), np.asarray(j.tri_pack).view(np.int32))
    np.testing.assert_array_equal(n(p.aabb_lo), np.asarray(j.aabb_lo))
    np.testing.assert_array_equal(n(p.aabb_hi), np.asarray(j.aabb_hi))


def _preps(o, d, tmax, ex):
    jp = jbt._prep(jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tmax),
                   jnp.asarray(ex))
    pp = pbt._prep(t(o), t(d), 1e-3, t(tmax), t(ex))
    return jp, pp


@pytest.mark.parametrize("kind", ["random", "camera", "center"])
def test_interval_cull_and_work_list_match_jax(scene, kind):
    _, (jcs, pcs) = scene
    o, d, tmax, ex = _rays(kind, 1500, 7)
    (jo, jd, jtn, jtx, jex, _, nb), (po, pd, ptn, ptx, pex, _, _) = _preps(
        o, d, tmax, ex)
    for a, b in ((jo, po), (jd, pd), (jtn, ptn), (jtx, ptx), (jex, pex)):
        np.testing.assert_array_equal(n(b), np.asarray(a).reshape(n(b).shape))
    jhit, jent = jax.jit(jbt._interval_cull, static_argnums=(6, 7))(
        jo, jd, jtn, jtx, jcs.aabb_lo, jcs.aabb_hi, nb, jbt.BLOCK_RAYS)
    phit, pent = pbt._interval_cull(po, pd, ptn, ptx, pcs.aabb_lo, pcs.aabb_hi,
                                    nb)
    np.testing.assert_array_equal(n(phit), np.asarray(jhit))
    np.testing.assert_array_equal(n(pent).view(np.int32),
                                  np.asarray(jent).view(np.int32))
    # The work list: JAX's global (miss, block, entry) order, cut per block.
    order, ents, count = pbt._work_list(phit, pent)
    jorder, jents, jnnz, _ = jbt._work_list(jhit, jent, nb, pcs.num_clusters,
                                            10**9)
    c = pcs.num_clusters
    live = torch.arange(c)[None, :] < count[:, None]
    flat = (torch.arange(nb)[:, None] * c + order)[live]
    assert int(count.sum()) == int(jnnz)
    np.testing.assert_array_equal(n(flat), np.asarray(jorder)[:int(jnnz)])
    np.testing.assert_array_equal(n(ents[live]), np.asarray(jents)[:int(jnnz)])


def test_coherence_keys_match_jax():
    o, d, _, _ = _rays("random", 4096, 11)
    lo, hi = np.float32([-3.0, -2.5, -4.0]), np.float32([3.5, 2.0, 3.0])
    want = np.asarray(jbt._coherence_keys(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(lo), jnp.asarray(hi)))
    got = pbt._coherence_keys(t(o), t(d), t(lo), t(hi))
    np.testing.assert_array_equal(n(got), want.astype(np.int64))


@pytest.mark.parametrize("kind", ["random", "center", "away"])
def test_cluster_scan_and_pair_work_match_jax(scene, kind):
    _, (jcs, pcs) = scene
    o, d, tmax, ex = _rays(kind, 1500, 13)
    (jo, jd, jtn, jtx, jex, _, nb), (po, pd, ptn, ptx, _, _, _) = _preps(
        o, d, tmax, ex)
    jslots, jcnt = jbt._cluster_scan(jcs, jo, jd, jtn, jtx, nb)
    slots, cnt = pbt._cluster_scan(pcs, po, pd, ptn, ptx)
    np.testing.assert_array_equal(n(slots), np.asarray(jslots))
    np.testing.assert_array_equal(n(cnt), np.asarray(jcnt))
    jprep = jbt._pair_stream_prep(jcs, jo, jd, jtn, jtx, jex, nb)
    cid_s, pos_s, runs, _, overflow = pbt._pair_stream_prep(pcs, po, pd, ptn, ptx)
    np.testing.assert_array_equal(n(cid_s), np.asarray(jprep[5])[0])
    np.testing.assert_array_equal(n(pos_s), np.asarray(jprep[6]))
    assert int(runs.sum()) == int(jprep[9])
    np.testing.assert_array_equal(n(overflow), np.asarray(jprep[11]))


def _check_hits(got, want):
    w_hit = np.asarray(want.hit)
    np.testing.assert_array_equal(n(got.hit), w_hit)
    for g, w in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(n(g)[w_hit], np.asarray(w)[w_hit],
                                   rtol=RTOL, atol=ATOL)
    assert np.isinf(n(got.t)[~w_hit]).all()
    if w_hit.any():
        agree = (n(got.tri)[w_hit] == np.asarray(want.tri)[w_hit]).mean()
        assert agree >= TRI_AGREE, agree


PATHS = ["block", "block_reorder", "pairs"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["random", "camera", "center", "away"])
def test_closest_matches_jax(scene, kind, path):
    name, (jcs, pcs) = scene
    o, d, tmax, ex = _rays(kind, 1100, 17)
    if path == "pairs":
        want = jbt.trace_closest_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                       tmax=jnp.asarray(tmax))
        got = pbt.trace_closest_pairs(pcs, t(o), t(d), tmax=t(tmax))
    else:
        reorder = path == "block_reorder"
        want = jbt.trace_closest_binned(jcs, jnp.asarray(o), jnp.asarray(d),
                                        tmax=jnp.asarray(tmax),
                                        exclude=jnp.asarray(ex),
                                        reorder=reorder)
        got = pbt.trace_closest_binned(pcs, t(o), t(d), tmax=t(tmax),
                                       exclude=t(ex), reorder=reorder)
    _check_hits(got, want)
    assert (kind == "away") == (not n(got.hit).any())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["random", "center"])
def test_occluded_matches_jax(scene, kind, path):
    _, (jcs, pcs) = scene
    o, d, tmax, ex = _rays(kind, 1100, 19)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    if path == "pairs":
        want = jbt.trace_occluded_pairs(jcs, *args, exclude=jnp.asarray(ex))
        got = pbt.trace_occluded_pairs(pcs, t(o), t(d), t(tmax), exclude=t(ex))
    else:
        reorder = path == "block_reorder"
        want = jbt.trace_occluded_binned(jcs, *args, exclude=jnp.asarray(ex),
                                         reorder=reorder)
        got = pbt.trace_occluded_binned(pcs, t(o), t(d), t(tmax),
                                        exclude=t(ex), reorder=reorder)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert 0.0 < n(got).mean() < 1.0


def test_overflow_fallback_runs():
    """Centre rays at cluster_k = 32 cross more than L_SLOTS superclusters:
    the pair stream hands them to the block path, and the result is still
    the JAX package's."""
    jcs, pcs = SCENES["random_k32"]()
    o, d, tmax, _ = _rays("center", 1100, 23)
    po, pd, ptn, ptx, _, _, _ = pbt._prep(t(o), t(d), 1e-3, t(tmax), None)
    _, cnt = pbt._cluster_scan(pcs, po, pd, ptn, ptx)
    assert (cnt > pbt.L_SLOTS).float().mean() > 0.05
    want = jbt.trace_closest_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                   tmax=jnp.asarray(tmax))
    _check_hits(pbt.trace_closest_pairs(pcs, t(o), t(d), tmax=t(tmax)), want)


def test_entry_points_default_to_the_card():
    """The entry points run on the card unless asked for the CPU: with no
    card, a call that names no device raises; with one, it lands there."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState
    from sunray_tpu_torch.scene import cornell_box

    calls = [lambda: cornell_box().positions,
             lambda: camera_matrices(Camera(), 8, 8)["view_proj"],
             lambda: RenderState.create(RenderConfig(width=8, height=8)).accum,
             lambda: convert.mats_from_numpy({"m": np.eye(4)})["m"]]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
