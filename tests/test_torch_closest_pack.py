"""K1's 16-byte triangle records and its R-rays-a-thread closest-hit walk,
modelled in plain PyTorch on the CPU.

csrc/trace.cu's closest_kernel stages each triangle as K2 does, three
16-byte records v0, e1 = v1 - v0 and e2 = v2 - v0 (w unused), and tests
on nothing else; a thread of a block of CLOSEST_THREADS traces
CLOSEST_RAYS rays, b * CLOSEST_THREADS * CLOSEST_RAYS + t + j *
CLOSEST_THREADS (a ray past the last one is all zeros), and tests every
one of them against every triangle in increasing id. Each ray keeps its
best t and triangle, replaced by selects where the test accepts and t is
strictly below the best (so among equal t the lowest id wins), and u and
v are recomputed once after the loop by the same test on the winner's
record; a miss is t = inf, tri = 0, u = v = 0, hit = false. A launch of
fewer than CLOSEST_WIDE_MIN rays traces one ray a thread.
`record_tests` tests in the kernel's order and `walk` runs the
rule. The walk must equal intersect.trace_closest_brute bit for bit on
every field, and the JAX trace_closest_pallas in interpret mode on tri
and hit (t, u and v within tests/test_torch_trace.py's 1e-5), on 1,
36, 129 and 300 triangles with degenerate ones and exact duplicates at
equal t, at ray counts that are not multiples of the rays a block, on
both sides of the wide-launch threshold. The kernel is held to the plain
version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops import pallas_trace as jpt
from sunray_tpu_torch.ops import cuda_trace, intersect
from sunray_tpu_torch.ops.fp import fma
from torch_parity import n, t

SHAPE = cuda_trace.CLOSEST_SHAPE
FIELDS = ("t", "tri", "u", "v", "hit")
JAX_ATOL = 1e-5                  # tests/test_torch_trace.py


def tri_records(tris):
    """(T, 3, 4) float32: the kernel's shared-memory records of each
    triangle, v0 | v1 - v0 | v2 - v0, each with w = 0."""
    v0, v1, v2 = tris
    rows = torch.stack([v0, v1 - v0, v2 - v0], dim=1)
    return torch.cat([rows, torch.zeros_like(rows[..., :1])], dim=-1)


def _test(a, e1, e2, o, d, tmin, tmax):
    """tri_test on broadcastable components (a, e1, e2: the record's rows;
    o, d: the ray's): (accept, t, u, v)."""
    px = fma(d[1], e2[2], -(d[2] * e2[1]))
    py = fma(d[2], e2[0], -(d[0] * e2[2]))
    pz = fma(d[0], e2[1], -(d[1] * e2[0]))
    det = fma(e1[2], pz, fma(e1[1], py, e1[0] * px))
    det_ok = det.abs() > intersect.DET_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tx, ty, tz = o[0] - a[0], o[1] - a[1], o[2] - a[2]
    u = fma(tz, pz, fma(ty, py, tx * px)) * inv_det
    qx = fma(ty, e1[2], -(tz * e1[1]))
    qy = fma(tz, e1[0], -(tx * e1[2]))
    qz = fma(tx, e1[1], -(ty * e1[0]))
    v = fma(d[2], qz, fma(d[1], qy, d[0] * qx)) * inv_det
    tt = fma(e2[2], qz, fma(e2[1], qy, e2[0] * qx)) * inv_det
    ok = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt >= tmin)
          & (tt <= tmax))
    return ok, tt, u, v


def _rows(rec):
    return [[rec[:, k, c] for c in range(3)] for k in range(3)]


def record_tests(rec, orig, d, tmin, tmax):
    """(accept, t, u, v), each (B, T), of B rays against the records (T, 3,
    4) alone, in tri_test's order."""
    return _test(*_rows(rec), [orig[:, c:c + 1] for c in range(3)],
                 [d[:, c:c + 1] for c in range(3)], tmin, tmax)


def walk(rec, orig, d, tmin, tmax, shape=SHAPE, step=1 << 15):
    """The kernel's walk on the records at launch shape `shape`: Hit of
    every ray (N,)."""
    n_rays, n_tris = orig.shape[0], rec.shape[0]
    rays = cuda_trace.rays_a_thread(n_rays, shape)
    per = rays * shape[1]
    padded = -(-n_rays // per) * per
    # ray i of the padded launch -> (block, j, thread); past the last ray:
    # zeros (direction 0, bounds 0), which never hit
    o, dd = torch.zeros((padded, 3)), torch.zeros((padded, 3))
    o[:n_rays], dd[:n_rays] = orig, d
    tn, tx = torch.zeros(padded), torch.zeros(padded)
    tn[:n_rays] = intersect._per_ray(tmin, n_rays, orig.device).reshape(-1)
    tx[:n_rays] = intersect._per_ray(tmax, n_rays, orig.device).reshape(-1)
    best_t = torch.full((padded,), torch.inf)
    best = torch.full((padded,), -1, dtype=torch.int32)
    for s in range(0, padded, step):
        sl = slice(s, s + step)
        ok, tt, _, _ = record_tests(rec, o[sl], dd[sl], tn[sl, None],
                                          tx[sl, None])
        for k in range(n_tris):
            take = ok[:, k] & (tt[:, k] < best_t[sl])
            best_t[sl] = torch.where(take, tt[:, k], best_t[sl])
            best[sl] = torch.where(take, k, best[sl])
    assert (best[n_rays:] < 0).all()
    best_t, best = best_t[:n_rays], best[:n_rays]
    hit = best >= 0
    # u, v: the test once more, on the winner's record
    win = rec[best.clamp(min=0).long()]                         # (N, 3, 4)
    _, _, u, v = _test(*_rows(win), [orig[:, c] for c in range(3)],
                       [d[:, c] for c in range(3)], 0.0, 0.0)
    return intersect.Hit(torch.where(hit, best_t, torch.inf),
                         torch.where(hit, best, 0),
                         torch.where(hit, u, 0.0), torch.where(hit, v, 0.0), hit)


def _case(n_tris, n_rays, seed):
    """Random triangles (every 17th degenerate, and the last fifth exact
    copies of earlier ones, so that their hits tie at equal t) and rays
    with per-ray tmin and tmax."""
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    tris = [v0, (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32),
            (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32)]
    tris[2][::17] = tris[0][::17]         # degenerate: a zero edge
    dup = n_tris // 5
    for x in tris:
        x[n_tris - dup:] = x[:dup]
    o = (rng.normal(size=(n_rays, 3)) * 2).astype(np.float32)
    dn = rng.normal(size=(n_rays, 3))
    d = (dn / np.linalg.norm(dn, axis=-1, keepdims=True)).astype(np.float32)
    tmin = rng.uniform(1e-4, 0.5, size=n_rays).astype(np.float32)
    tmax = rng.uniform(0.5, 8.0, size=n_rays).astype(np.float32)
    return tuple(tris), o, d, tmin, tmax


def _equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


@pytest.mark.parametrize("n_tris", [1, 36, 129, 300])
def test_records_give_the_plain_tests(n_tris):
    tris, o, d, tmin, tmax = _case(n_tris, 700, n_tris)
    tt = tuple(t(x) for x in tris)
    rec = tri_records(tt)
    assert rec.shape == (n_tris, 3, 4)
    assert (rec[..., 3] == 0.0).all()
    keep = n_tris - n_tris // 5            # past it, copies of earlier ones
    assert (rec[:keep:17, 2, :3] == 0.0).all()      # degenerate: e2 = 0
    want = intersect.moller_trumbore(t(o), t(d), *tt, t(tmin)[:, None],
                                     t(tmax)[:, None])
    got = record_tests(rec, t(o), t(d), t(tmin)[:, None], t(tmax)[:, None])
    assert torch.equal(got[0], want[3])
    for a, b in zip(got[1:], want[:3]):
        assert torch.equal(a[want[3]].view(torch.int32),
                           b[want[3]].view(torch.int32))


@pytest.mark.parametrize("n_tris,n_rays", [(1, 1500), (36, 2 * 512 + 37),
                                           (129, 1500), (300, 999)])
def test_walk_matches_plain_and_jax(n_tris, n_rays):
    assert n_rays % (SHAPE[0] * SHAPE[1])
    tris, o, d, tmin, tmax = _case(n_tris, n_rays, 300 + n_tris)
    tt = tuple(t(x) for x in tris)
    got = walk(tri_records(tt), t(o), t(d), t(tmin), t(tmax))
    plain = intersect.trace_closest_brute(tt, t(o), t(d), t(tmin), t(tmax))
    _equal(got, plain)
    if n_tris > 1:                      # the one triangle is degenerate
        assert 0.0 < n(got.hit).mean() < 1.0
    if n_tris >= 5:
        # a duplicate's hit ties its original's at equal t: the original,
        # the lower id, wins
        dup = n_tris // 5
        assert not (n(got.tri) >= n_tris - dup).any()
    want = jpt.trace_closest_pallas(
        tuple(jnp.asarray(x) for x in tris), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax))
    # XLA rounds the interpret-mode kernel's t, u and v a last bit apart
    # on ~1% of rays (tests/test_torch_trace.py's tolerance); the hits
    # and their triangles agree on every ray.
    for f in ("tri", "hit"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=JAX_ATOL, err_msg=f)


@pytest.mark.parametrize("n_rays", [SHAPE[2] - 37, SHAPE[2] + 37])
def test_walk_on_both_sides_of_the_wide_launch(n_rays):
    """One ray a thread below CLOSEST_WIDE_MIN rays, CLOSEST_RAYS from it
    on; scalar bounds, as the frames pass them."""
    assert cuda_trace.rays_a_thread(n_rays, SHAPE) == (
        SHAPE[0] if n_rays >= SHAPE[2] else 1)
    tris, o, d, _, _ = _case(12, n_rays, 17)
    tt = tuple(t(x) for x in tris)
    got = walk(tri_records(tt), t(o), t(d), intersect.T_MIN, 4.0)
    _equal(got, intersect.trace_closest_brute(tt, t(o), t(d), intersect.T_MIN,
                                              4.0))
    assert 0.0 < n(got.hit).mean() < 1.0


def test_walk_is_the_same_at_every_launch_shape():
    """The rays a thread change no ray's answer: R = 1, 2 and 4, and the
    host's shape (read from cuda_trace, which the library is checked
    against when it loads)."""
    tris, o, d, tmin, tmax = _case(129, 1000, 5)
    tt = tuple(t(x) for x in tris)
    rec = tri_records(tt)
    want = walk(rec, t(o), t(d), t(tmin), t(tmax))
    for rays in (1, 2, 4):
        _equal(walk(rec, t(o), t(d), t(tmin), t(tmax), (rays, 128, 0)), want)
