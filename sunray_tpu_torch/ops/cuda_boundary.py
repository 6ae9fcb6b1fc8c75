"""B1: per-pixel top-K silhouette-edge candidates of the shadow-boundary
term (render/boundary.py).

Counterpart of the pruning stage of sunray_tpu/render/boundary.py
(nee_boundary_term's candidate loop, :205-231, and _candidate_score,
:252-297): jnp there, with no pallas_call, but at 720p it scores 921,600
pixels x 64 edges a light and keeps (P, E, 3) temporaries of 708 MB, so
on the card it is a hand kernel (csrc/boundary.cu). The selection is
pure forward work: every input is detached and the extraction is
discrete, so the kernel has no backward.

boundary_candidates(xs, nee_mask, edges, lights, k) takes, for each
pixel and light, the k edges of largest candidate score in the order k
successive argmax extractions give (score descending, then edge index
ascending, zeros included), and returns for each (light, rank) the edge
index, the silhouette flag and the face whose opposite corner is the
side reference (face2: the second face), and for each (light, pixel) the
number of live (positive) scores. The plain version,
boundary_candidates_plain, computes the same arrays with PyTorch; a CPU
tensor takes it, a CUDA tensor the kernel.

edges is the (E, EDGE_WORDS) table of edge_table and lights the
(L, LIGHT_WORDS) table of light_table: both are built here in PyTorch,
once a call, so kernel and plain version read the same derived values.

The kernel is instantiated for every K from 1 to MAX_K (kernel_k),
stages the edge table in shared memory EDGE_TILE edges at a time, covers
LIGHT_GROUP lights of a pixel in a thread, and reads the lights from
constant memory, CONST_LIGHTS a launch (launches_for).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import cuda_build
from sunray_tpu_torch.ops.fp import cross, dot, fma, sqrt

EDGE_WORDS = 24     # csrc/boundary.cu kEdgeWords
LIGHT_WORDS = 12    # csrc/boundary.cu kLightWords
# csrc/boundary.cu's launch shape (sunray_boundary_launch_shape; checked
# when the library loads): threads a block, lights a thread, the largest
# K, edges a shared-memory tile, lights a launch.
THREADS = 128
LIGHT_GROUP = 2
MAX_K = 16
EDGE_TILE = 256
CONST_LIGHTS = 1024
LAUNCH_SHAPE = (THREADS, LIGHT_GROUP, MAX_K, EDGE_TILE, CONST_LIGHTS)
PLAIN_CHUNK = 1 << 16   # pixels a step of the plain version (memory)

# float32 constants of the reference's comparisons.
DENOM_EPS = 1e-9
BEYOND = float(torch.tensor(1.0 + 1e-6, dtype=torch.float32))


def edge_table(a, b, n1, c1, n2, c2, has2):
    """(E, EDGE_WORDS) float32 rows: a, b, mid = 0.5 (a + b), |b - a|, the
    two faces' unit normals n1, n2 and points c1, c2, has2 (1.0 where the
    edge has a second face), a pad word. Inputs detached (E, 3) / (E,)."""
    mid = 0.5 * (a + b)
    ab = b - a
    elen = sqrt(dot(ab, ab))
    return torch.cat([a, b, mid, elen[:, None], n1, c1, n2, c2,
                      has2.to(a.dtype)[:, None], torch.zeros_like(elen)[:, None]],
                     dim=1).contiguous()


def light_table(v0, v1, v2):
    """(L, LIGHT_WORDS) float32 rows: p0, the unit normal nl_u, and the
    light's axis-aligned box widened by 0.6 of its longest side (the
    `near` test of boundary.py:281-287). Inputs detached (L, 3)."""
    nl = cross(v1 - v0, v2 - v0)
    nl_u = nl / torch.clamp(sqrt(dot(nl, nl)), min=1e-12)[:, None]

    def side(p, q):
        return sqrt(dot(q - p, q - p))

    scale = torch.maximum(torch.maximum(side(v0, v1), side(v1, v2)),
                          side(v2, v0))[:, None]
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    return torch.cat([v0, nl_u, fma(-scale, 0.6, lo), fma(scale, 0.6, hi)],
                     dim=1).contiguous()


def silhouette(xs, edges):
    """(silhouette, face2), each (P, E), of the points xs (P, 3) and the
    edge_table rows (boundary.py:159-195): an edge is a silhouette from x
    where its two faces' sides of x differ, or where it has one face;
    face2 marks the edges whose side reference is the second face's
    opposite corner (x behind the first face, before the second)."""
    n1, c1, n2, c2 = (edges[:, i:i + 3] for i in (10, 13, 16, 19))
    has2 = edges[:, 22] > 0.0
    x = xs[:, None, :]
    front1 = dot(x - c1, n1) > 0.0
    front2 = dot(x - c2, n2) > 0.0
    return torch.where(has2, front1 ^ front2, True), ~front1 & has2 & front2


def candidate_score(xs, nee_mask, edges, light):
    """boundary.py's _candidate_score for one light row of light_table:
    (score (P, E), silhouette (P, E), face2 (P, E)). score is positive iff
    the edge is a silhouette from x, heads toward the light's plane with
    the plane beyond it, and projects near the light at an endpoint or
    the midpoint; its value is |b - a| / max(|mid - x|, 1e-3)."""
    a, b, mid, elen = edges[:, 0:3], edges[:, 3:6], edges[:, 6:9], edges[:, 9]
    p0, nl, lo, hi = (light[i:i + 3] for i in (0, 3, 6, 9))
    x = xs[:, None, :]
    sil, face2 = silhouette(xs, edges)
    cnum = dot(p0 - xs, nl)[:, None]

    def project_ok(pt):
        d = pt - x
        denom = dot(d, nl)
        heading = denom * cnum > 0.0
        t_hit = cnum / torch.where(denom.abs() > DENOM_EPS, denom, DENOM_EPS)
        y = fma(t_hit[..., None], d, x)
        near = ((y > lo) & (y < hi)).all(dim=-1)
        return heading & (t_hit > BEYOND) & near

    ok = project_ok(a) | project_ok(b) | project_ok(mid)
    v = mid - x
    dist = torch.clamp(sqrt(dot(v, v)), min=1e-3)
    score = torch.where(ok & sil & nee_mask[:, None], elen / dist, 0.0)
    return score, sil, face2


def boundary_candidates_plain(xs, nee_mask, edges, lights, k):
    """The plain PyTorch version: (idx (L, K, P) int32, n_live (L, P)
    int32, sil (L, K, P) bool, face2 (L, K, P) bool). A stable descending
    sort takes the argmax extractions' order (ties by edge index)."""
    out = ([], [], [], [])
    for light in lights:
        parts = ([], [], [], [])
        for s in range(0, xs.shape[0], PLAIN_CHUNK):
            score, sil, face2 = candidate_score(
                xs[s:s + PLAIN_CHUNK], nee_mask[s:s + PLAIN_CHUNK], edges,
                light)
            order = torch.sort(score, dim=1, descending=True,
                               stable=True).indices[:, :k]
            parts[0].append(order.T)
            parts[1].append((score > 0.0).sum(dim=1))
            parts[2].append(sil.gather(1, order).T)
            parts[3].append(face2.gather(1, order).T)
        for o, p in zip(out, parts):
            o.append(torch.cat(p, dim=-1))
    idx, n_live, sil, face2 = (torch.stack(o) for o in out)
    return (idx.to(torch.int32).contiguous(), n_live.to(torch.int32),
            sil.contiguous(), face2.contiguous())


def boundary_candidates(xs, nee_mask, edges, lights, k):
    """B1: xs (P, 3) float32 shading points, nee_mask (P,) bool, edges
    (E, EDGE_WORDS), lights (L, LIGHT_WORDS), 1 <= k < E (k <= MAX_K on
    the card). Returns boundary_candidates_plain's arrays: the plain
    version on CPU tensors, the kernel on CUDA tensors."""
    name = "boundary_candidates"
    e_n, l_n = edges.shape[0], lights.shape[0]
    if (xs.dim() != 2 or xs.shape[1] != 3 or nee_mask.shape != xs.shape[:1]
            or tuple(edges.shape[1:]) != (EDGE_WORDS,)
            or tuple(lights.shape[1:]) != (LIGHT_WORDS,)):
        raise cuda_build.KernelError(
            f"{name}: expected (P, 3), (P,), (E, {EDGE_WORDS}) and "
            f"(L, {LIGHT_WORDS}), got {tuple(xs.shape)}, "
            f"{tuple(nee_mask.shape)}, {tuple(edges.shape)} and "
            f"{tuple(lights.shape)}")
    if not 1 <= k < e_n:
        raise cuda_build.KernelError(f"{name}: k = {k} of {e_n} edges")
    if cuda_build.on_cpu(xs, nee_mask, edges, lights):
        return boundary_candidates_plain(xs, nee_mask, edges, lights, k)
    cuda_build.require_cuda(name, xs, nee_mask, edges, lights)
    for t in (xs, edges, lights):
        cuda_build.require_dtype(name, t, torch.float32)
    cuda_build.require_dtype(name, nee_mask, torch.bool)
    kernel_k(k)
    return _launch(xs, nee_mask, edges, lights, k)


def kernel_k(k):
    """The K of the kernel instantiation that keeps k candidates (each of
    1..MAX_K has its own); raises for any other k."""
    if not 1 <= k <= MAX_K:
        raise cuda_build.KernelError(f"boundary_candidates: k = {k}, the "
                                     f"kernel is built for 1 to {MAX_K}")
    return k


def launches_for(l_n):
    """Kernel launches of one call with l_n lights: CONST_LIGHTS a launch."""
    return -(-l_n // CONST_LIGHTS)


def _launch(xs, nee_mask, edges, lights, k, lib=None):
    """B1 once on checked arguments, from `lib` (default: the port's
    library, whose launches are counted)."""
    p, dev = xs.shape[0], xs.device
    l_n = lights.shape[0]
    idx = torch.empty((l_n, k, p), dtype=torch.int32, device=dev)
    n_live = torch.empty((l_n, p), dtype=torch.int32, device=dev)
    sil = torch.empty((l_n, k, p), dtype=torch.bool, device=dev)
    face2 = torch.empty((l_n, k, p), dtype=torch.bool, device=dev)
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_boundary_candidates(
        xs.data_ptr(), nee_mask.data_ptr(), edges.data_ptr(), edges.shape[0],
        lights.data_ptr(), l_n, p, k, idx.data_ptr(), n_live.data_ptr(),
        sil.data_ptr(), face2.data_ptr(), cuda_build.stream_ptr())
    cuda_build.check_launch("boundary_candidates", err)
    if lib is None and p > 0:
        cuda_build.launches["boundary_candidates"] += launches_for(l_n)
    return idx, n_live, sil, face2
