"""Tracer dispatch — port of sunray_tpu/render/trace.py.

TracerCtx holds the frame's world triangles and what one backend needs:
  - brute force: K1 / K2 (ops/cuda_trace.py), or the Woop transforms of
    K14 for occlusion with trace_impl="woop";
  - the binned tracer: a load-time ClusterSet refit to this frame
    (ops/binned_trace.py: K10 on coherent batches, K11 / K12 on the pair
    stream for incoherent ones);
  - the unified BVH: a load-time Bvh (host SAH or device LBVH) refit to
    this frame, or an LBVH built in the frame, walked by B2;
  - the two-level BVH: a load-time BlasSet and this frame's TLAS, walked
    by B3 (ops/bvh.py, ops/bvh2.py, ops/cuda_bvh.py).
Every wrapper launches its CUDA kernel for tensors on the card and runs
its plain PyTorch version on the CPU.

Alpha cutout (any_hit.slang:11-43), with cfg.alpha_mask_tracing: a closest
hit on a MASK material whose base-colour alpha is below its cutoff is
skipped and the ray traced again past it, up to alpha_rounds times; an
occlusion query walks closest hits until an accepted one, over every
backend (trace.py:134-166, 218-253, 264-301). The rounds are JAX's
fixed-shape batches (closest_alpha_rounds, occluded_alpha_rounds); each
lane's rounds depend on no other lane, so on the card the BVH tracers run
them inside the walk, a ray's rounds in its thread, in one launch a query
(ops/bvh.trace_*_walk_alpha over ctx.alpha, the same bits). The CPU, the
brute and the binned tracers keep the batch rounds.

`cuda_trace.rays` counts each query's rays once, here: the full-batch ray
accounting of bench.py:7-13 is the sum (re-traces are not counted again);
`cuda_trace.queries` counts the queries.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sunray_tpu_torch.ops import (
    binned_trace,
    bvh,
    bvh2,
    cuda_build,
    cuda_trace,
    intersect,
    texture,
)

# The brute tracer's triangle limit on the CPU: its plain versions' (rays
# x triangles) blocks grow with the triangle count (JAX caps the jnp
# fallback the same way off the TPU, trace.py:113-116).
CPU_BRUTE_MAX_TRIS = 512


class TracerCtx(NamedTuple):
    tris: tuple     # (v0, v1, v2) world-space, each (T, 3), contiguous
    # Binned backend: the load-time ClusterSet refit to this frame's
    # triangles (render/trace.py:83-92).
    binned: Optional[binned_trace.ClusterSet] = None
    # trace_impl="woop" on the brute path: (a (6, T, 8), eps (T, 1)) from
    # intersect.woop_matrices (render/trace.py:120-126).
    woop: Optional[tuple] = None
    # Unified or two-level BVH: the walk's tables (ops/bvh.WalkTables).
    walk: Optional[bvh.WalkTables] = None
    # Alpha cutout: the tables of the scene's alpha test
    # (ops/texture.alpha_tables), or None when it is off.
    alpha: Optional[texture.AlphaTables] = None
    alpha_rounds: int = 4


def brute_limit(cfg, device) -> int:
    """Triangles up to which "auto" traces brute force: the config's limit
    on the card, at most CPU_BRUTE_MAX_TRIS on the CPU."""
    if torch.device(device).type == "cpu":
        return min(cfg.brute_force_max_tris, CPU_BRUTE_MAX_TRIS)
    return cfg.brute_force_max_tris


def make_tracer(scene, cfg, accel=None) -> TracerCtx:
    """Build the per-frame tracer context (trace.py:51-127).

    accel: a load-time ClusterSet, Bvh or BlasSet; it serves every query,
    whatever cfg.tracer says. A Bvh's boxes are refit to this frame's
    triangles (the AS UPDATE path); a BlasSet gets this frame's TLAS.
    Without one, tracer="bvh" (or "auto" above brute_limit) builds an
    LBVH in the frame; anything else traces brute force."""
    if cfg.trace_impl not in ("mt", "woop"):
        raise NotImplementedError(f"trace_impl={cfg.trace_impl!r} is not ported")
    if cfg.tracer not in ("auto", "brute", "bvh", "bvh2", "binned"):
        raise ValueError(f"unknown tracer {cfg.tracer!r}")
    # The tracer is a discrete oracle: gradients reach the frame through
    # the hit recompute in render/shade.py, never through traversal, so
    # the triangles and rays handed to the kernels are detached (JAX's
    # stop_gradient, render/trace.py:63-71, 213-217, 267).
    tris = tuple(t.detach().contiguous()
                 for t in scene.world_triangle_vertices())
    base = TracerCtx(tris=tris)
    if cfg.alpha_mask_tracing:
        base = base._replace(alpha=texture.alpha_tables(scene))
    if accel is not None:
        if isinstance(accel, binned_trace.ClusterSet):
            return base._replace(
                binned=binned_trace.refit_cluster_set(accel, tris))
        if isinstance(accel, bvh2.BlasSet):
            return base._replace(walk=bvh2.build_frame_tlas(accel, scene))
        if isinstance(accel, bvh.Bvh):
            return base._replace(walk=bvh.pack_tables(
                bvh.refit_bvh(accel, tris), tris))
        raise TypeError(f"unknown accel {type(accel).__name__}")
    if cfg.tracer == "bvh" or (cfg.tracer == "auto" and scene.num_tris
                               > brute_limit(cfg, tris[0].device)):
        built = bvh.build_bvh(tris, leaf_size=cfg.bvh_leaf_size)
        return base._replace(walk=bvh.pack_tables(built, tris))
    woop = intersect.woop_matrices(tris) if cfg.trace_impl == "woop" else None
    return base._replace(woop=woop)


def _raw_closest(ctx: TracerCtx, orig, d, tmin, tmax, coherent=True):
    if ctx.walk is not None:
        return bvh.trace_closest_walk(ctx.walk, orig, d, tmin, tmax)
    if ctx.binned is not None:
        if not coherent:
            return binned_trace.trace_closest_pairs(ctx.binned, orig, d, tmin,
                                                    tmax)
        return binned_trace.trace_closest_binned(ctx.binned, orig, d, tmin,
                                                 tmax, reorder=True)
    return cuda_trace.trace_closest(ctx.tris, orig, d, tmin, tmax)


def _accepted(ctx, hit):
    tri = torch.where(hit.hit, hit.tri, 0)
    return ~hit.hit | texture.alpha_accepts(ctx.alpha, tri, hit.u, hit.v)


def _fused(ctx: TracerCtx, orig) -> bool:
    """Alpha cutout inside the walk: BVH tables, alpha, CUDA rays."""
    return (ctx.walk is not None and ctx.alpha is not None
            and not cuda_build.on_cpu(orig))


def trace_closest(ctx: TracerCtx, orig, d, tmin=intersect.T_MIN,
                  tmax=intersect.T_MAX, coherent=True) -> intersect.Hit:
    """Closest hit of (N, 3) rays. coherent=False: the caller knows the
    batch is incoherent (bounce/GI rays); the binned tracer then takes the
    pair stream, else the block path with the coherence reorder
    (trace.py:169-186). The other tracers ignore the hint."""
    cuda_trace.rays["closest"] += orig.shape[0]
    cuda_trace.queries["closest"] += 1
    orig, d = orig.detach().contiguous(), d.detach().contiguous()
    if torch.is_tensor(tmin):
        tmin = tmin.detach()
    if torch.is_tensor(tmax):
        tmax = tmax.detach()
    if _fused(ctx, orig):
        return bvh.trace_closest_walk_alpha(ctx.walk, ctx.alpha, orig, d, tmin,
                                            tmax, ctx.alpha_rounds)
    if ctx.alpha is None:
        return _raw_closest(ctx, orig, d, tmin, tmax, coherent)
    return closest_alpha_rounds(ctx, orig, d, tmin, tmax, coherent)


def closest_alpha_rounds(ctx: TracerCtx, orig, d, tmin, tmax, coherent=True):
    """trace_closest's batch rounds: re-trace past rejected MASK hits
    (IgnoreHit), up to alpha_rounds times for every ray of the batch
    (trace.py:218-253). orig, d detached and contiguous."""
    hit = _raw_closest(ctx, orig, d, tmin, tmax, coherent)
    for _ in range(ctx.alpha_rounds):
        accepted = _accepted(ctx, hit)
        if bool(accepted.all()):
            break
        new_tmin = torch.where(accepted, torch.as_tensor(
            tmin, dtype=torch.float32, device=orig.device), hit.t + 1e-4)
        nxt = _raw_closest(ctx, orig, d, new_tmin.contiguous(), tmax)
        hit = intersect.Hit(*(torch.where(accepted, a, b)
                              for a, b in zip(hit, nxt)))
    return hit


def trace_occluded(ctx: TracerCtx, orig, d, tmax, tmin=intersect.T_MIN,
                   exclude=None, coherent=True):
    """Boolean occlusion along segments. Degenerate segments (<= 1e-3 past
    tmin, the reference's TMax < TMin guard, e.g. ray_gen_ris.slang:287)
    are visible.

    exclude: per-ray int32 triangle id to ignore — the shadow ray's own
    target triangle (trace.py:270, :347). coherent: as in trace_closest
    (trace.py:308-319)."""
    cuda_trace.rays["occluded"] += orig.shape[0]
    cuda_trace.queries["occluded"] += 1
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=orig.device).detach()
    degenerate = tmax - tmin <= intersect.T_MIN
    orig, d = orig.detach().contiguous(), d.detach().contiguous()
    seg = (tmax - 1e-3).contiguous()
    exclude = None if exclude is None else exclude.contiguous()
    if _fused(ctx, orig):
        occ = bvh.trace_occluded_walk_alpha(ctx.walk, ctx.alpha, orig, d, seg,
                                            tmin, ctx.alpha_rounds, exclude)
    elif ctx.alpha is not None:
        occ = occluded_alpha_rounds(ctx, orig, d, seg, tmin, exclude)
    elif ctx.walk is not None:
        occ = bvh.trace_occluded_walk(ctx.walk, orig, d, seg, tmin,
                                      exclude=exclude)
    elif ctx.woop is not None:
        occ = cuda_trace.trace_occluded_woop(ctx.woop, orig, d, seg, tmin,
                                             exclude=exclude)
    elif ctx.binned is None:
        occ = cuda_trace.trace_occluded(ctx.tris, orig, d, seg, tmin,
                                        exclude=exclude)
    elif not coherent:
        occ = binned_trace.trace_occluded_pairs(ctx.binned, orig, d, seg, tmin,
                                                exclude=exclude)
    else:
        occ = binned_trace.trace_occluded_binned(ctx.binned, orig, d, seg, tmin,
                                                 exclude=exclude, reorder=True)
    return occ & ~degenerate


def occluded_alpha_rounds(ctx, orig, d, seg, tmin, exclude):
    """Alpha-aware occlusion in batch rounds (trace.py:264-301): walk
    closest hits on [tmin, seg], skipping cutouts and the excluded
    triangle, until an accepted hit or none; at most alpha_rounds + 1
    closest queries."""
    n = orig.shape[0]
    o2, d2 = orig.reshape(-1, 3), d.reshape(-1, 3)
    seg = seg.reshape(-1).expand(n).contiguous()
    cur_tmin = torch.as_tensor(tmin, dtype=torch.float32,
                               device=orig.device).expand(n).clone()
    occluded = torch.zeros((n,), dtype=torch.bool, device=orig.device)
    undecided = torch.ones_like(occluded)
    ex = None if exclude is None else exclude.reshape(-1)
    for _ in range(ctx.alpha_rounds + 1):
        if not bool(undecided.any()):
            break
        hit = _raw_closest(ctx, o2, d2, cur_tmin, seg)
        live = undecided & hit.hit
        keep = live if ex is None else live & (hit.tri != ex)
        accepted = keep & texture.alpha_accepts(
            ctx.alpha, torch.where(hit.hit, hit.tri, 0), hit.u, hit.v)
        occluded |= accepted
        undecided = live & ~accepted
        cur_tmin = torch.where(undecided, hit.t + 1e-4, cur_tmin).contiguous()
    return occluded
