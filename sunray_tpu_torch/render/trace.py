"""Tracer dispatch — port of the brute-force path of sunray_tpu/render/trace.py.

TracerCtx holds the frame's world triangles; trace_closest/trace_occluded
call the K1/K2 wrappers (ops/cuda_trace.py), which launch the CUDA kernels
for tensors on the card and run the plain PyTorch versions on the CPU.
The BVH, two-level, binned and alpha-cutout backends are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sunray_tpu_torch.ops import cuda_trace, intersect


class TracerCtx(NamedTuple):
    tris: tuple     # (v0, v1, v2) world-space, each (T, 3), contiguous


def make_tracer(scene, cfg) -> TracerCtx:
    """Build the per-frame tracer context (brute force only).

    tracer="auto" resolves to brute force up to cfg.brute_force_max_tris,
    as on the TPU (render/trace.py:113-117); anything else raises."""
    if cfg.tracer not in ("auto", "brute"):
        raise NotImplementedError(f"tracer={cfg.tracer!r} is not ported")
    if cfg.tracer == "auto" and scene.num_tris > cfg.brute_force_max_tris:
        raise NotImplementedError(
            f"{scene.num_tris} triangles exceed brute_force_max_tris="
            f"{cfg.brute_force_max_tris}; the BVH backends are not ported"
        )
    if cfg.trace_impl != "mt":
        raise NotImplementedError(f"trace_impl={cfg.trace_impl!r} is not ported")
    if cfg.alpha_mask_tracing or scene.has_alpha_mask:
        raise NotImplementedError("alpha-cutout tracing is not ported")
    tris = tuple(t.contiguous() for t in scene.world_triangle_vertices())
    return TracerCtx(tris=tris)


def trace_closest(ctx: TracerCtx, orig, d, tmin=intersect.T_MIN,
                  tmax=intersect.T_MAX) -> intersect.Hit:
    """Closest hit of (N, 3) rays."""
    return cuda_trace.trace_closest(ctx.tris, orig.contiguous(),
                                    d.contiguous(), tmin, tmax)


def trace_occluded(ctx: TracerCtx, orig, d, tmax, tmin=intersect.T_MIN,
                   exclude=None):
    """Boolean occlusion along segments. Degenerate segments (<= 1e-3 past
    tmin, the reference's TMax < TMin guard, e.g. ray_gen_ris.slang:287)
    are visible.

    exclude: per-ray int32 triangle id to ignore — the shadow ray's own
    target triangle (trace.py:270, :347)."""
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=orig.device)
    degenerate = tmax - tmin <= intersect.T_MIN
    occ = cuda_trace.trace_occluded(
        ctx.tris, orig.contiguous(), d.contiguous(),
        (tmax - 1e-3).contiguous(), tmin,
        exclude=None if exclude is None else exclude.contiguous(),
    )
    return occ & ~degenerate
