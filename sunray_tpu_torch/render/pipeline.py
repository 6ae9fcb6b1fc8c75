"""The per-frame pipeline — port of sunray_tpu/render/pipeline.py.

render_frame(scene, cfg, state, mats) -> (state', ldr, aux), in the pass
order of build_unified_graph (src/lib.rs:1347-1619): G-buffer walk ->
final walk -> temporal accumulation -> denoise xN -> tonemap. Everything
runs on the device of the scene tensors; the frame never moves to the
CPU on its own.

Covered: lighting "restir" (shared or per-pixel spatial taps, f32 or
bf16 shading attributes; the joint DI+GI history gather), "nee" and
"brdf"; the brute-force tracer (Moller-Trumbore or Woop occlusion), the
binned tracer with a ClusterSet accel, the unified and two-level BVH
walks (a Bvh or BlasSet accel, or an LBVH built in the frame), alpha
cutout, textured atlases, any number of samples per pixel (cfg.samples;
cfg.dtype is read nowhere, as in the JAX package); TAA on the plain path
or K9, history reads plain or through K13. A differentiable frame
(cfg.differentiable) runs what the JAX frame runs then: the tracer and
K8 (forward and backward), and the plain versions of K3-K7, K9 and K13,
with its stages' activations recomputed in the backward pass
(ops/loops.py), and the two visibility terms: the shadow-boundary
gradients (cfg.shadow_boundary_grads, render/boundary.py, dense or with
B1's top-K candidates) and primary edge antialiasing (cfg.edge_antialias,
render/antialias.py); with bf16 shading, its target functions' backwards
round as XLA's compile of the JAX VJP (ops/brdf.py). check_supported()
raises NotImplementedError for the configurations left out (an unknown
lighting, history_gather_force) instead of rendering something else. The
stages run under torch.profiler ranges named as the JAX package's named
scopes (ris_pass, final_pass, taa, denoise, postprocess);
render_prefix() runs the frame up to a stage, for utils/profiling.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from sunray_tpu_torch.render import restir
from sunray_tpu_torch.render.antialias import primary_edge_aa
from sunray_tpu_torch.render.gbuffer import ris_pass
from sunray_tpu_torch.render.pathtrace import final_pass
from sunray_tpu_torch.render.postprocess import (
    atrous_denoise,
    temporal_accumulate,
    tonemap,
)
from sunray_tpu_torch.render.trace import make_tracer


@dataclasses.dataclass
class RenderState:
    """Cross-frame renderer state (src/lib.rs:320-331) with the JAX
    package's fields and shapes."""

    accum: torch.Tensor              # (H, W, 3) TAA history
    res_di: restir.ReservoirDI       # previous frame's DI reservoirs
    res_gi: restir.ReservoirGI       # previous frame's GI reservoirs
    prev_view_proj: torch.Tensor     # (4, 4)
    frame_count: torch.Tensor        # () int32

    @staticmethod
    def create(cfg, device="cuda") -> "RenderState":
        p = cfg.width * cfg.height
        return RenderState(
            accum=torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                              device=device),
            res_di=restir.ReservoirDI.empty(p, device),
            res_gi=restir.ReservoirGI.empty(p, device),
            prev_view_proj=torch.zeros((4, 4), dtype=torch.float32,
                                       device=device),
            frame_count=torch.zeros((), dtype=torch.int32, device=device),
        )


    def detach(self) -> "RenderState":
        """This state without the graph of the frame that made it
        (render_frame cuts a differentiable frame's input state so)."""
        def cut(x):
            if torch.is_tensor(x):
                return x.detach()
            return type(x)(**{f.name: cut(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return cut(self)


def check_supported(scene, cfg) -> None:
    """Raise NotImplementedError for a configuration this port does not
    cover (the tracer checks live in render/trace.make_tracer)."""
    unsupported = {
        f"lighting={cfg.lighting!r}": cfg.lighting not in ("restir", "nee",
                                                           "brdf"),
        # A TPU workaround of the history gather, not ported (ROADMAP).
        "history_gather_force=True": cfg.history_gather_force is True,
    }
    missing = [name for name, hit in unsupported.items() if hit]
    if missing:
        raise NotImplementedError(
            "sunray_tpu_torch does not port: " + ", ".join(missing)
        )


# render_frame's stages in order (utils/profiling.stage_timings' keys):
# pass 1, pass 2 with edge antialiasing, and TAA, denoise and tonemap.
FRAME_STAGES = ("ris_pass", "final_pass", "post_pipeline")


def render_frame(scene, cfg, state: RenderState, mats, accel=None):
    """One frame. mats: camera matrices dict from camera_matrices().

    accel: optional load-time binned_trace.ClusterSet, bvh.Bvh or
    bvh2.BlasSet (render/renderer.Renderer builds them as the JAX
    Renderer does, renderer.py:77-266), refit or completed inside
    (render/trace.make_tracer).
    Returns (new_state, ldr (H, W, 3) in [0, 1], aux)."""
    return render_prefix(scene, cfg, state, mats, accel)


def render_prefix(scene, cfg, state: RenderState, mats, accel=None,
                  last: str = "post_pipeline"):
    """render_frame's stages (FRAME_STAGES) in order, up to and including
    `last`; the whole frame with the default. Returns render_frame's
    (new_state, ldr, aux) after the last stage, else None: a prefix is
    run for its time (utils/profiling.stage_timings)."""
    if last not in FRAME_STAGES:
        raise ValueError(f"last={last!r} is not one of {FRAME_STAGES}")
    check_supported(scene, cfg)
    if cfg.differentiable:
        # Gradients stop at the input state, as a JAX step's do when the
        # state comes in as an argument of value_and_grad.
        state = state.detach()
    w, h = cfg.width, cfg.height
    frame_count = state.frame_count

    tracer = make_tracer(scene, cfg, accel)
    lights = restir.Lights(scene) if scene.num_lights > 0 else None

    with record_function("ris_pass"):
        gbuf, r_di, r_gi, hitd, ris_rounds = ris_pass(
            scene, cfg, tracer, lights, mats, state.prev_view_proj,
            state.res_di, state.res_gi, frame_count,
        )
    if last == "ris_pass":
        return None
    # cfg.samples > 1 (pipeline.py:76-92): pass 1 runs once, then `samples`
    # final passes with salted PCG streams, each on pass 1's primary hit;
    # their raw colours and walk rounds are summed, the colours averaged.
    first_hit = (hitd.first_tri, hitd.first_t)
    with record_function("final_pass"):
        raw, final_rounds = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi, frame_count,
            first_hit=first_hit,
        )
        for s in range(1, cfg.samples):
            raw_s, rounds_s = final_pass(
                scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
                frame_count, sample_idx=s, first_hit=first_hit,
            )
            raw = raw + raw_s
            final_rounds = final_rounds + rounds_s
    if cfg.samples > 1:
        raw = raw / cfg.samples

    raw_img = raw.reshape(h, w, 3)
    if cfg.edge_antialias:
        raw_img = primary_edge_aa(scene, cfg, tracer, mats, raw_img,
                                  tri=hitd.first_tri, t_hit=hitd.first_t)
    if last == "final_pass":
        return None
    motion_img = gbuf.motion.reshape(h, w, 2)
    depth = gbuf.depth.reshape(h, w)
    normal = gbuf.normal.reshape(h, w, 3)
    diffuse = gbuf.diffuse.reshape(h, w, 3)

    accum = raw_img
    if cfg.enable_taa:
        with record_function("taa"):
            accum = temporal_accumulate(
                raw_img, motion_img, state.accum, frame_count,
                cfg.accumulation_factor,
                # A differentiable frame takes the plain clamp and blend
                # (JAX pipeline.py:120), as it takes the plain denoise.
                kernel="jnp" if cfg.differentiable else cfg.taa_kernel,
                history_select_kernel=restir.history_kernel_ok(cfg))
    den = accum
    if cfg.denoise_passes > 0:
        with record_function("denoise"):
            den = atrous_denoise(accum, depth, normal,
                                 gbuf.roughness.reshape(h, w).contiguous(),
                                 diffuse, cfg.denoise_passes,
                                 kernel=("jnp" if cfg.differentiable
                                         else cfg.denoise_kernel))
    with record_function("postprocess"):
        ldr = tonemap(den, cfg.exposure, cfg.tonemap, cfg.gamma)

    new_state = RenderState(
        accum=accum,
        res_di=r_di,
        res_gi=r_gi,
        prev_view_proj=mats["view_proj"],
        frame_count=frame_count + 1,
    )
    aux = {
        "raw": raw_img,
        "depth": depth,
        "normal": normal,
        "diffuse": diffuse,
        "motion": motion_img,
        # Full-batch trace rounds of the two walks (Python ints; the final
        # walk's round 0 reuses pass 1's primary hit, bench.py:7-13).
        "ris_rounds": ris_rounds,
        "final_rounds": final_rounds,
    }
    return new_state, ldr, aux


def render_frame_with_camera(scene, cfg, state: RenderState, camera,
                             accel=None):
    """render_frame with the camera matrices computed inside
    (pipeline.py:164-167), on the scene's device."""
    from sunray_tpu_torch.camera import camera_matrices

    mats = camera_matrices(camera, cfg.width, cfg.height,
                           device=scene.positions.device)
    return render_frame(scene, cfg, state, mats, accel)
