"""K2's 16-byte triangle records and its R-rays-a-thread walk, modelled in
plain PyTorch on the CPU.

csrc/trace.cu's staging loop stores each triangle as three 16-byte
records in shared memory, v0, e1 = v1 - v0 and e2 = v2 - v0 (w unused),
and occ_hit reads nothing else; a thread of a block of OCC_THREADS traces
OCC_RAYS rays, b * OCC_THREADS * OCC_RAYS + t + j * OCC_THREADS, tests all
of them against each triangle in order, sets a ray's bit in one mask of
decided rays at its first accepted hit that is not its exclude id, and
leaves the triangle loop once every bit is set (a ray past the last one
starts decided); a launch of fewer than OCC_WIDE_MIN rays traces one ray
a thread. `occ_records` builds the records, `hits_from_records` tests in
occ_hit's order, and `walk` runs the bitmask rule. The walk's
result must equal intersect.trace_occluded_brute bit for bit and the JAX
trace_occluded_pallas in interpret mode on the same seeded rays, on 1, 36,
129 and 300 triangles (degenerate ones included), with exclude ids of -1
and in range, at ray counts that are not multiples of 128 * R; and the
tests it runs a warp are chip_smoke.warp_rule_tests's count. The kernel is
held to the plain version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sunray_tpu.ops import pallas_trace as jpt
from sunray_tpu_torch.ops import cuda_trace, intersect
from sunray_tpu_torch.ops.fp import fma
from torch_parity import n, t

RAYS = cuda_trace.OCC_RAYS
THREADS = cuda_trace.OCC_THREADS


def occ_records(tris):
    """(T, 3, 4) float32: the kernel's shared-memory records of each
    triangle, v0 | v1 - v0 | v2 - v0, each with w = 0."""
    v0, v1, v2 = tris
    rows = torch.stack([v0, v1 - v0, v2 - v0], dim=1)
    return torch.cat([rows, torch.zeros_like(rows[..., :1])], dim=-1)


def hits_from_records(rec, orig, d, tmin, tmax):
    """(B, T) accept mask from the records alone, in occ_hit's order."""
    a, e1, e2 = (rec[:, k, :3] for k in range(3))
    ox, oy, oz = (orig[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    px = fma(dy, e2[:, 2], -(dz * e2[:, 1]))
    py = fma(dz, e2[:, 0], -(dx * e2[:, 2]))
    pz = fma(dx, e2[:, 1], -(dy * e2[:, 0]))
    det = fma(e1[:, 2], pz, fma(e1[:, 1], py, e1[:, 0] * px))
    det_ok = det.abs() > intersect.DET_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tx, ty, tz = ox - a[:, 0], oy - a[:, 1], oz - a[:, 2]
    u = fma(tz, pz, fma(ty, py, tx * px)) * inv_det
    qx = fma(ty, e1[:, 2], -(tz * e1[:, 1]))
    qy = fma(tz, e1[:, 0], -(tx * e1[:, 2]))
    qz = fma(tx, e1[:, 1], -(ty * e1[:, 0]))
    v = fma(dz, qz, fma(dy, qy, dx * qx)) * inv_det
    tt = fma(e2[:, 2], qz, fma(e2[:, 1], qy, e2[:, 0] * qx)) * inv_det
    return (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt >= tmin)
            & (tt <= tmax))


def walk(rec, orig, d, tmax, exclude=None, rays=RAYS, threads=THREADS):
    """The kernel's walk on the records: (occluded (N,), ray-triangle tests
    the warps issue). A warp issues a triangle's tests, rays x 32, while
    one of its threads has an undecided ray."""
    n_rays, n_tris = orig.shape[0], rec.shape[0]
    per = rays * threads
    n_blocks = -(-n_rays // per)
    hits = hits_from_records(rec, orig, d, intersect.T_MIN, tmax[:, None])
    if exclude is not None:
        hits &= torch.arange(n_tris)[None, :] != exclude[:, None]
    # ray i of the padded launch -> (block, j, thread)
    pad = torch.zeros((n_blocks * per, n_tris), dtype=torch.bool)
    pad[:n_rays] = hits
    live = torch.arange(n_blocks * per) < n_rays
    by_thread = pad.reshape(n_blocks, rays, threads, n_tris).permute(0, 2, 1, 3)
    bit = (1 << torch.arange(rays, dtype=torch.int64))[None, None, :]
    done = ((~live).reshape(n_blocks, rays, threads).permute(0, 2, 1)
            * bit).sum(-1)
    all_bits = (1 << rays) - 1
    tests = 0
    for k in range(n_tris):
        active = done != all_bits
        warps = active.reshape(n_blocks, threads // 32, 32).any(-1)
        tests += int(warps.sum()) * 32 * rays
        if not active.any():
            break
        got = (by_thread[..., k] * bit).sum(-1)
        done = torch.where(active, done | got, done)
    occ = ((done[..., None] & bit) != 0).permute(0, 2, 1).reshape(-1)
    return occ[:n_rays], tests


def _case(n_tris, n_rays, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    tris = [v0, (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32),
            (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32)]
    tris[2][::17] = tris[0][::17]         # degenerate: a zero edge
    o = (rng.normal(size=(n_rays, 3)) * 2).astype(np.float32)
    dn = rng.normal(size=(n_rays, 3))
    d = (dn / np.linalg.norm(dn, axis=-1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.1, 6.0, size=n_rays).astype(np.float32)
    ex = rng.integers(-1, n_tris, size=n_rays).astype(np.int32)
    ex[::5] = -1
    return tuple(tris), o, d, tmax, ex


@pytest.mark.parametrize("n_tris", [1, 36, 129, 300])
def test_records_hold_the_triangles(n_tris):
    tris, o, d, tmax, _ = _case(n_tris, 700, n_tris)
    tt = tuple(t(x) for x in tris)
    rec = occ_records(tt)
    assert rec.shape == (n_tris, 3, 4)
    assert (rec[..., 3] == 0.0).all()
    assert (rec[::17, 2, :3] == 0.0).all()          # degenerate: e2 = 0
    _, _, _, want = intersect.moller_trumbore(
        t(o), t(d), *tt, intersect.T_MIN, t(tmax)[:, None])
    got = hits_from_records(rec, t(o), t(d), intersect.T_MIN, t(tmax)[:, None])
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_exclude", [False, True])
@pytest.mark.parametrize("n_tris,n_rays", [(1, 1500), (36, 2 * RAYS * THREADS + 37),
                                           (129, 1500), (300, 999)])
def test_walk_matches_plain_and_jax(n_tris, n_rays, use_exclude):
    assert n_rays % (RAYS * THREADS)
    tris, o, d, tmax, ex = _case(n_tris, n_rays, 200 + n_tris)
    ex = ex if use_exclude else None
    tt = tuple(t(x) for x in tris)
    ex_t = None if ex is None else t(ex)
    got, tests = walk(occ_records(tt), t(o), t(d), t(tmax), ex_t)
    plain = intersect.trace_occluded_brute(tt, t(o), t(d), t(tmax), exclude=ex_t)
    assert torch.equal(got, plain)
    want = np.asarray(jpt.trace_occluded_pallas(
        tuple(jnp.asarray(x) for x in tris), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), exclude=None if ex is None else jnp.asarray(ex)))
    np.testing.assert_array_equal(n(got), want)
    if n_tris > 1:
        assert 0.0 < want.mean() < 1.0
    first = chip_smoke.occluded_first(tt, t(o), t(d), t(tmax), ex_t)
    assert tests == chip_smoke.warp_rule_tests(first, RAYS, THREADS)
    assert tests >= int(first.sum())


def test_walk_with_one_ray_a_thread_is_k1s_rule():
    """R = 1, the narrow launch's rule and PR 7's kernel's: each warp runs
    until its last lane is decided; the same answer."""
    shape = cuda_trace.OCC_SHAPE
    assert cuda_trace.rays_a_thread(cuda_trace.OCC_WIDE_MIN, shape) == RAYS
    assert cuda_trace.rays_a_thread(cuda_trace.OCC_WIDE_MIN - 1, shape) == 1
    tris, o, d, tmax, ex = _case(36, 1000, 7)
    tt = tuple(t(x) for x in tris)
    got8, tests8 = walk(occ_records(tt), t(o), t(d), t(tmax), t(ex))
    got1, tests1 = walk(occ_records(tt), t(o), t(d), t(tmax), t(ex), rays=1)
    assert torch.equal(got1, got8)
    first = chip_smoke.occluded_first(tt, t(o), t(d), t(tmax), t(ex))
    assert tests1 == chip_smoke.warp_rule_tests(first, 1, THREADS)
