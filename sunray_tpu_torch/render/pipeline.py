"""The per-frame pipeline — port of sunray_tpu/render/pipeline.py.

render_frame(scene, cfg, state, mats) -> (state', ldr, aux), in the pass
order of build_unified_graph (src/lib.rs:1347-1619): G-buffer walk ->
final walk -> temporal accumulation -> denoise xN -> tonemap. Everything
runs on the device of the scene tensors; the frame never moves to the
CPU on its own.

Covered: lighting "nee" and "brdf", the brute-force tracer, a trivial
texture atlas, one sample per pixel, forward only. check_supported()
raises NotImplementedError for every other configuration instead of
rendering something else. The stages run under torch.profiler ranges
named as the JAX package's named scopes (ris_pass, final_pass, taa,
denoise, postprocess).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from sunray_tpu_torch.render import restir
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
    def create(cfg, device="cpu") -> "RenderState":
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


def check_supported(scene, cfg) -> None:
    """Raise NotImplementedError for a configuration this port does not
    cover (the tracer checks live in render/trace.make_tracer)."""
    unsupported = {
        "lighting='restir'": cfg.lighting == "restir" and scene.num_lights > 0,
        f"lighting={cfg.lighting!r}": cfg.lighting not in ("restir", "nee",
                                                           "brdf"),
        "textured atlases": not scene.textures.trivial,
        "edge_antialias": cfg.edge_antialias,
        "samples > 1": cfg.samples != 1,
        "differentiable frames": cfg.differentiable,
        "shadow_boundary_grads": cfg.shadow_boundary_grads,
        f"taa_kernel={cfg.taa_kernel!r} (K9)": (cfg.enable_taa
                                               and cfg.taa_kernel != "jnp"),
        "history_gather_force=True": cfg.history_gather_force is True,
        f"dtype={cfg.dtype!r}": cfg.dtype != "float32",
    }
    missing = [name for name, hit in unsupported.items() if hit]
    if missing:
        raise NotImplementedError(
            "sunray_tpu_torch does not port: " + ", ".join(missing)
        )


def render_frame(scene, cfg, state: RenderState, mats):
    """One frame. mats: camera matrices dict from camera_matrices().

    Returns (new_state, ldr (H, W, 3) in [0, 1], aux)."""
    check_supported(scene, cfg)
    w, h = cfg.width, cfg.height
    frame_count = state.frame_count

    tracer = make_tracer(scene, cfg)
    lights = restir.Lights(scene) if scene.num_lights > 0 else None

    with record_function("ris_pass"):
        gbuf, r_di, r_gi, hitd, ris_rounds = ris_pass(
            scene, cfg, tracer, lights, mats, state.prev_view_proj,
            state.res_di, state.res_gi, frame_count,
        )
    with record_function("final_pass"):
        raw, final_rounds = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi, frame_count,
            first_hit=(hitd.first_tri, hitd.first_t),
        )

    raw_img = raw.reshape(h, w, 3)
    motion_img = gbuf.motion.reshape(h, w, 2)
    depth = gbuf.depth.reshape(h, w)
    normal = gbuf.normal.reshape(h, w, 3)
    diffuse = gbuf.diffuse.reshape(h, w, 3)

    accum = raw_img
    if cfg.enable_taa:
        with record_function("taa"):
            accum = temporal_accumulate(raw_img, motion_img, state.accum,
                                        frame_count, cfg.accumulation_factor)
    den = accum
    if cfg.denoise_passes > 0:
        with record_function("denoise"):
            den = atrous_denoise(accum, depth, normal,
                                 gbuf.roughness.reshape(h, w).contiguous(),
                                 diffuse, cfg.denoise_passes)
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
