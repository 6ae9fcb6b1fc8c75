"""Ray-triangle intersection and the brute-force tracer — the plain
PyTorch versions of kernels K1, K2 and K14.

Port of sunray_tpu/ops/intersect.py: Moller-Trumbore over dense
(rays x triangles) blocks, no backface culling, closest-hit and
occlusion queries. Cross products and dot products round as XLA's CPU
backend rounds the JAX code's jnp.cross / jnp.sum (ops/fp.py), and the
CUDA kernel (csrc/trace.cu) uses fmaf() in the same places, so the three
agree bit for bit on the same rays.

The Woop occlusion test (trace_impl="woop") is the plain version of K14:
woop_matrices and trace_occluded_woop port sunray_tpu/ops/pallas_trace.py
(woop_matrices, _occluded_woop_kernel), with the kernel's matmul written
out as multiply-adds in the order XLA's CPU backend evaluates it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sunray_tpu_torch.ops.fp import cross, cross3, dot, dot3, fma

T_MIN = 1e-3      # ray.TMin = 0.001 everywhere in the reference shaders
T_MAX = 1e4       # ray.TMax = 10000.0
DET_EPS = 1e-9

# Elements of one (rays x triangles) intermediate per block: blocks of
# BLOCK_ELEMS // T rays keep each of the ~20 temporaries at 32 MB.
BLOCK_ELEMS = 1 << 23


class Hit(NamedTuple):
    """Closest-hit result for a ray batch. All (N,)."""

    t: torch.Tensor        # hit distance; inf on a miss
    tri: torch.Tensor      # int32 winning triangle id (0 on a miss)
    u: torch.Tensor        # barycentric of vertex 1
    v: torch.Tensor        # barycentric of vertex 2
    hit: torch.Tensor      # bool


def _per_ray(x, n, device):
    """Scalar or (N,) bound -> (N, 1) float32 for broadcasting."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.reshape(-1, 1).expand(n, 1) if x.dim() else x.expand(n, 1)


def moller_trumbore(orig, d, v0, v1, v2, tmin, tmax):
    """Batched ray-vs-triangle-set test.

    orig, d: (B, 3); v0, v1, v2: (T, 3); tmin/tmax: (B, 1) or scalars.
    Returns (t, u, v, valid), each (B, T)."""
    return mt_components(tuple(orig[:, c:c + 1] for c in range(3)),
                         tuple(d[:, c:c + 1] for c in range(3)),
                         *(tuple(x[:, c] for c in range(3))
                           for x in (v0, v1, v2)), tmin, tmax)


def mt_components(o, dd, a, b, c, tmin, tmax):
    """Moller-Trumbore on tuples of three broadcastable component tensors:
    ray origin o and direction dd, triangle corners a, b, c. Returns (t,
    u, v, valid) in their broadcast shape. The one rounding of the test:
    the brute tracer and the BVH walks' plain twins (ops/bvh.py) call it."""
    return mt_edges(o, dd, a, tuple(b[k] - a[k] for k in range(3)),
                    tuple(c[k] - a[k] for k in range(3)), tmin, tmax)


def mt_edges(o, dd, a, e1, e2, tmin, tmax):
    """mt_components from corner a and the edges e1 = b - a, e2 = c - a
    (float32 differences, as B2 and B3 read them from ops/bvh.leaf_edges)."""
    p = cross3(dd, e2)
    det = dot3(e1[0], p[0], e1[1], p[1], e1[2], p[2])
    det_ok = det.abs() > DET_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)

    tv = tuple(o[k] - a[k] for k in range(3))
    u = dot3(tv[0], p[0], tv[1], p[1], tv[2], p[2]) * inv_det
    q = cross3(tv, e1)
    v = dot3(dd[0], q[0], dd[1], q[1], dd[2], q[2]) * inv_det
    t = dot3(e2[0], q[0], e2[1], q[1], e2[2], q[2]) * inv_det
    valid = (
        det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin) & (t <= tmax)
    )
    return t, u, v, valid


def _block(n_tris: int) -> int:
    return max(1, BLOCK_ELEMS // max(n_tris, 1))


def trace_closest_brute(tris, orig, d, tmin=T_MIN, tmax=T_MAX) -> Hit:
    """Closest hit over all triangles. tris: (v0, v1, v2) each (T, 3).

    Ties in t go to the lowest triangle id (torch.argmin returns the first
    minimum). Misses: t = inf, tri = 0, u = v = 0, hit = False."""
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = orig.shape[0]
    tn = _per_ray(tmin, n, orig.device)
    tx = _per_ray(tmax, n, orig.device)
    v0, v1, v2 = tris
    outs = []
    step = _block(v0.shape[0])
    for s in range(0, n, step):
        sl = slice(s, min(s + step, n))
        t, u, v, valid = moller_trumbore(orig[sl], d[sl], v0, v1, v2,
                                         tn[sl], tx[sl])
        t = torch.where(valid, t, torch.inf)
        idx = torch.argmin(t, dim=-1, keepdim=True)
        best_t = t.gather(1, idx)[:, 0]
        hit = torch.isfinite(best_t)
        outs.append((
            best_t,
            torch.where(hit, idx[:, 0], 0).to(torch.int32),
            torch.where(hit, u.gather(1, idx)[:, 0], 0.0),
            torch.where(hit, v.gather(1, idx)[:, 0], 0.0),
            hit,
        ))
    if not outs:
        z = orig.new_zeros((0,))
        return Hit(z, z.to(torch.int32), z, z, z.bool())
    return Hit(*(torch.cat(c) for c in zip(*outs)))


def trace_occluded_brute(tris, orig, d, tmax, tmin=T_MIN, exclude=None):
    """Any hit in [tmin, tmax]: True = occluded. tmax: (N,) segment length.

    exclude: optional (N,) int32 triangle id ignored per ray; -1 = none."""
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = orig.shape[0]
    tn = _per_ray(tmin, n, orig.device)
    tx = _per_ray(tmax, n, orig.device)
    v0, v1, v2 = tris
    ids = torch.arange(v0.shape[0], dtype=torch.int32, device=orig.device)
    outs = []
    step = _block(v0.shape[0])
    for s in range(0, n, step):
        sl = slice(s, min(s + step, n))
        _, _, _, valid = moller_trumbore(orig[sl], d[sl], v0, v1, v2,
                                         tn[sl], tx[sl])
        if exclude is not None:
            valid = valid & (ids[None, :] != exclude[sl, None])
        outs.append(valid.any(dim=-1))
    if not outs:
        return torch.zeros((0,), dtype=torch.bool, device=orig.device)
    return torch.cat(outs)


def woop_matrices(tris):
    """Per-triangle Woop transforms (pallas_trace.py:158-205): the rows of
    W = [e1 e2 n]^-1 = [e2 x n; n x e1; n] / n.n, so that a point's
    barycentric and height coordinates are W (x - v0).

    Returns (a (6, T, 8) float32, eps (T, 1)): component-major rows
    [uo, vo, wo, ud, vd, wd]; an o-row is (r, -r.v0, 0, 0, 0, 0) against
    X = (o, 1, d, 0), a d-row (0, 0, 0, 0, r, 0). eps = DET_EPS / n.n, the
    |wd| threshold equal to Moller-Trumbore's |det| > DET_EPS; degenerate
    triangles get +inf (never hit). Rounded as jax.jit rounds the JAX
    function (bit-equal, tests/test_torch_switches.py)."""
    v0, v1, v2 = tris
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    nn = dot(n, n)
    ok = nn > 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, nn, 1.0), 0.0)
    a = v0.new_zeros((6, v0.shape[0], 8))
    for k, r in enumerate((cross(e2, n) * inv[:, None],
                           cross(n, e1) * inv[:, None],
                           n * inv[:, None])):
        a[k, :, 0:3] = r
        a[k, :, 3] = -dot(r, v0)
        a[3 + k, :, 4:7] = r
    eps = torch.where(ok, DET_EPS * inv, torch.inf)[:, None]
    return a.contiguous(), eps.contiguous()


def woop_hits(woop, orig, d, tmin, tmax):
    """The (B, T) hit mask of rays (B, 3) against every triangle: the
    division-free test of _occluded_woop_kernel. The six dot products are
    the o-rows fma(r2, oz, fma(r1, oy, r0 * ox)) + c and the d-rows
    fma(r2, dz, fma(r1, dy, r0 * dx)), as XLA's CPU dot sums the kernel's
    matmul. With sw = sign(wd), den = |wd|, U = fma(uo, wd, -(wo * ud)) *
    sw (= u * |wd|), V likewise and S = -wo * sw (= t * |wd|), a hit is
    den > eps, U, V >= 0, U + V <= den and tmin * den <= S <= tmax * den.
    tmin, tmax: (B, 1) or scalars."""
    a, eps = woop
    o = [orig[:, c:c + 1] for c in range(3)]
    dd = [d[:, c:c + 1] for c in range(3)]
    uo, vo, wo = [dot3(a[k, :, 0], o[0], a[k, :, 1], o[1], a[k, :, 2], o[2])
                  + a[k, :, 3] for k in range(3)]
    ud, vd, wd = [dot3(a[k, :, 4], dd[0], a[k, :, 5], dd[1], a[k, :, 6], dd[2])
                  for k in range(3, 6)]
    sw = torch.where(wd >= 0.0, 1.0, -1.0)
    den = wd * sw
    us = fma(uo, wd, -(wo * ud)) * sw
    vs = fma(vo, wd, -(wo * vd)) * sw
    ws = -wo * sw
    return ((den > eps[:, 0]) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= den)
            & (ws >= tmin * den) & (ws <= tmax * den))


def trace_occluded_woop(woop, orig, d, tmax, tmin=T_MIN, exclude=None):
    """Any hit in [tmin, tmax] through the Woop transforms (woop_hits):
    True = occluded. woop: (a, eps) from woop_matrices; exclude: optional
    (N,) int32 triangle id ignored per ray, -1 = none."""
    orig = orig.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = orig.shape[0]
    tn = _per_ray(tmin, n, orig.device)
    tx = _per_ray(tmax, n, orig.device)
    n_tris = woop[0].shape[1]
    ids = torch.arange(n_tris, dtype=torch.int32, device=orig.device)
    outs = []
    step = _block(n_tris)
    for s in range(0, n, step):
        sl = slice(s, min(s + step, n))
        valid = woop_hits(woop, orig[sl], d[sl], tn[sl], tx[sl])
        if exclude is not None:
            valid = valid & (ids[None, :] != exclude[sl, None])
        outs.append(valid.any(dim=-1))
    if not outs:
        return torch.zeros((0,), dtype=torch.bool, device=orig.device)
    return torch.cat(outs)
