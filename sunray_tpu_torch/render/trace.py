"""Tracer dispatch — port of the brute-force and binned paths of
sunray_tpu/render/trace.py.

TracerCtx holds the frame's world triangles and, with a ClusterSet accel,
the set refit from them. trace_closest/trace_occluded go to the brute
wrappers (K1/K2, ops/cuda_trace.py) or to the binned tracer
(ops/binned_trace.py: the block path with K10 for coherent batches, the
pair stream with K11/K12 for incoherent ones). With trace_impl="woop" and
no accel, occlusion queries go through the Woop transforms (K14), built
once per frame. Every wrapper launches its CUDA kernel for tensors on the
card and runs its plain PyTorch version on the CPU. The BVH, two-level and
alpha-cutout backends are not ported.

`cuda_trace.rays` counts each query's rays once, here: the full-batch ray
accounting of bench.py:7-13 is the sum (the binned overflow fallback's
re-trace is not counted again).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sunray_tpu_torch.ops import binned_trace, cuda_trace, intersect


class TracerCtx(NamedTuple):
    tris: tuple     # (v0, v1, v2) world-space, each (T, 3), contiguous
    # Binned backend: the load-time ClusterSet refit to this frame's
    # triangles (render/trace.py:83-92); None = brute force.
    binned: Optional[binned_trace.ClusterSet] = None
    # trace_impl="woop" on the brute path: (a (6, T, 8), eps (T, 1)) from
    # intersect.woop_matrices (render/trace.py:120-126); None = Moller-
    # Trumbore.
    woop: Optional[tuple] = None


def make_tracer(scene, cfg, accel=None) -> TracerCtx:
    """Build the per-frame tracer context.

    accel: a load-time binned_trace.ClusterSet, refit here from the frame's
    world triangles; the binned tracer then serves every query, whatever
    cfg.tracer says (as on the TPU). Without one, "auto" resolves to brute
    force up to cfg.brute_force_max_tris and "binned" to brute force (the
    JAX make_tracer, trace.py:113-127); anything else raises. The binned
    tracer ignores trace_impl, as the JAX make_tracer returns before its
    Woop check (trace.py:79-92)."""
    if cfg.trace_impl not in ("mt", "woop"):
        raise NotImplementedError(f"trace_impl={cfg.trace_impl!r} is not ported")
    if cfg.alpha_mask_tracing or scene.has_alpha_mask:
        raise NotImplementedError("alpha-cutout tracing is not ported")
    # The tracer is a discrete oracle: gradients reach the frame through
    # the hit recompute in render/shade.py, never through traversal, so
    # the triangles and rays handed to the kernels are detached (JAX's
    # stop_gradient, render/trace.py:63-71, 213-217, 267).
    tris = tuple(t.detach().contiguous()
                 for t in scene.world_triangle_vertices())
    if accel is not None:
        if not isinstance(accel, binned_trace.ClusterSet):
            raise NotImplementedError(f"accel {type(accel).__name__} is not "
                                      "ported (ClusterSet only)")
        return TracerCtx(tris=tris,
                         binned=binned_trace.refit_cluster_set(accel, tris))
    if cfg.tracer not in ("auto", "brute", "binned"):
        raise NotImplementedError(f"tracer={cfg.tracer!r} is not ported")
    if cfg.tracer == "auto" and scene.num_tris > cfg.brute_force_max_tris:
        raise NotImplementedError(
            f"{scene.num_tris} triangles exceed brute_force_max_tris="
            f"{cfg.brute_force_max_tris} and no ClusterSet accel was given; "
            "the LBVH backend (ops/bvh.py) is not ported"
        )
    woop = intersect.woop_matrices(tris) if cfg.trace_impl == "woop" else None
    return TracerCtx(tris=tris, woop=woop)


def trace_closest(ctx: TracerCtx, orig, d, tmin=intersect.T_MIN,
                  tmax=intersect.T_MAX, coherent=True) -> intersect.Hit:
    """Closest hit of (N, 3) rays. coherent=False: the caller knows the
    batch is incoherent (bounce/GI rays); the binned tracer then takes the
    pair stream, else the block path with the coherence reorder
    (trace.py:169-186). The brute tracer ignores the hint."""
    cuda_trace.rays["closest"] += orig.shape[0]
    orig, d = orig.detach().contiguous(), d.detach().contiguous()
    if ctx.binned is None:
        return cuda_trace.trace_closest(ctx.tris, orig, d, tmin, tmax)
    if not coherent:
        return binned_trace.trace_closest_pairs(ctx.binned, orig, d, tmin, tmax)
    return binned_trace.trace_closest_binned(ctx.binned, orig, d, tmin, tmax,
                                             reorder=True)


def trace_occluded(ctx: TracerCtx, orig, d, tmax, tmin=intersect.T_MIN,
                   exclude=None, coherent=True):
    """Boolean occlusion along segments. Degenerate segments (<= 1e-3 past
    tmin, the reference's TMax < TMin guard, e.g. ray_gen_ris.slang:287)
    are visible.

    exclude: per-ray int32 triangle id to ignore — the shadow ray's own
    target triangle (trace.py:270, :347). coherent: as in trace_closest
    (trace.py:308-319)."""
    cuda_trace.rays["occluded"] += orig.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=orig.device).detach()
    degenerate = tmax - tmin <= intersect.T_MIN
    orig, d = orig.detach().contiguous(), d.detach().contiguous()
    seg = (tmax - 1e-3).contiguous()
    exclude = None if exclude is None else exclude.contiguous()
    if ctx.woop is not None:
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
