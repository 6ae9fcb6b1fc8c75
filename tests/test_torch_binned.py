"""PyTorch port, the binned tracer's PyTorch around its kernels against
sunray_tpu/ops/binned_trace.py, its Pallas kernels in interpret mode, on
the same numpy inputs.

Held exactly: the cluster build (tri_ids, pack bits, AABBs), the interval
cull (mask and entry bounds, bit for bit), the coherence keys, the cluster
scan (slots and counts) and the pair work items; the overflow fallback's
trace as tests/test_torch_binned_trace.py holds traces. The traces of
the block path and the pair stream are in tests/test_torch_binned_trace.py
and tests/test_torch_binned_pairs.py; the CUDA kernels are held to the
plain versions in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops import binned_trace as jbt
from sunray_tpu_torch import convert
from sunray_tpu_torch.ops import binned_trace as pbt
from torch_binned_cases import SCENES, check_hits, jax_pair, random_tris, rays
from torch_parity import n, t


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
    tris = random_tris(700, 3)
    jcs, pcs = jax_pair(tris, 64)
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
    o, d, tmax, ex = rays(kind, 1500, 7)
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
    o, d, _, _ = rays("random", 4096, 11)
    lo, hi = np.float32([-3.0, -2.5, -4.0]), np.float32([3.5, 2.0, 3.0])
    want = np.asarray(jbt._coherence_keys(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(lo), jnp.asarray(hi)))
    got = pbt._coherence_keys(t(o), t(d), t(lo), t(hi))
    np.testing.assert_array_equal(n(got), want.astype(np.int64))


@pytest.mark.parametrize("kind", ["random", "center", "away"])
def test_cluster_scan_and_pair_work_match_jax(scene, kind):
    _, (jcs, pcs) = scene
    o, d, tmax, ex = rays(kind, 1500, 13)
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


def test_overflow_fallback_runs():
    """Centre rays at cluster_k = 32 cross more than L_SLOTS superclusters:
    the pair stream hands them to the block path, and the result is still
    the JAX package's."""
    jcs, pcs = SCENES["random_k32"]()
    o, d, tmax, _ = rays("center", 1100, 23)
    po, pd, ptn, ptx, _, _, _ = pbt._prep(t(o), t(d), 1e-3, t(tmax), None)
    _, cnt = pbt._cluster_scan(pcs, po, pd, ptn, ptx)
    assert (cnt > pbt.L_SLOTS).float().mean() > 0.05
    want = jbt.trace_closest_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                   tmax=jnp.asarray(tmax))
    check_hits(pbt.trace_closest_pairs(pcs, t(o), t(d), tmax=t(tmax)), want)


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
