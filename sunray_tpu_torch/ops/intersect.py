"""Ray-triangle intersection and the brute-force tracer — the plain
PyTorch versions of kernels K1 and K2.

Port of sunray_tpu/ops/intersect.py: Moller-Trumbore over dense
(rays x triangles) blocks, no backface culling, closest-hit and
occlusion queries. Cross products and dot products round as XLA's CPU
backend rounds the JAX code's jnp.cross / jnp.sum (ops/fp.py), and the
CUDA kernel (csrc/trace.cu) uses fmaf() in the same places, so the three
agree bit for bit on the same rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sunray_tpu_torch.ops.fp import cross3, dot3

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
    e1 = tuple(v1[:, c] - v0[:, c] for c in range(3))
    e2 = tuple(v2[:, c] - v0[:, c] for c in range(3))
    o = tuple(orig[:, c:c + 1] for c in range(3))
    dd = tuple(d[:, c:c + 1] for c in range(3))

    p = cross3(dd, e2)
    det = dot3(e1[0], p[0], e1[1], p[1], e1[2], p[2])
    det_ok = det.abs() > DET_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)

    tv = tuple(o[c] - v0[:, c] for c in range(3))
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
