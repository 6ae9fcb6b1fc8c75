"""Execution-path provenance for benchmark records — port of
sunray_tpu/utils/provenance.py.

The frame picks between the hand kernels of csrc/ and their plain PyTorch
versions from (cfg, device): each wrapper launches its kernel for CUDA
tensors and takes the plain version for CPU tensors, and a
differentiable frame takes the plain versions of K3-K7, K9 and K13. This
mirrors those predicates in one queryable place, so a measurement can
record which path it took. It keeps the JAX record's keys; a stage's
value is "cuda" where a hand kernel serves it, "plain" where plain
PyTorch does and "off" where the stage does not run.

Must stay in sync with:
  - render/gbuffer._restir_samples (K3 audition, K4 DI temporal merge:
    kernel unless cfg.differentiable) and the ReSTIR gate of ris_pass
    (lighting "restir" with at least one light);
  - render/restir.history_kernel_ok (K13 history reads, in the GI
    temporal merge, the joint gather and TAA's history fetch);
  - render/pathtrace._spatial_reuse (K5, K6: shared taps, not
    differentiable; per-pixel taps are plain);
  - render/pipeline.render_frame (TAA through K9 for taa_kernel "pallas",
    or "auto" on the card; the denoise through K7 for denoise_kernel
    "auto"/"pallas"; both plain on a differentiable frame).
tests/test_torch_utils.py holds this mirror to those predicates.
"""

from __future__ import annotations

from sunray_tpu_torch.ops.cuda_restir import RIS_SMEM_LIGHTS
from sunray_tpu_torch.render.restir import history_kernel_ok


def exec_paths(cfg, num_lights: int, backend: str | None = None) -> dict:
    """Returns {stage: "cuda" | "plain" | "off", ...} + the inputs that
    decided it. backend: "cuda" or "cpu", the device type of the frame's
    tensors; it defaults to "cuda", the device the port's entry points
    use."""
    if backend is None:
        backend = "cuda"
    cuda = backend == "cuda"
    fwd = cuda and not cfg.differentiable
    restir = cfg.lighting == "restir" and num_lights > 0
    shared = cfg.spatial_taps == "shared"

    def route(kernel, on=True):
        return "off" if not on else ("cuda" if kernel else "plain")

    return {
        "backend": backend,
        "tracer": cfg.tracer,
        "num_lights": num_lights,
        # K3 keeps the records of up to this many lights in shared memory.
        "exact_fetch_max_lights": RIS_SMEM_LIGHTS,
        "differentiable": cfg.differentiable,
        "ris_audition": route(fwd, restir),
        "ris_fetch": (("shared" if num_lights <= RIS_SMEM_LIGHTS
                       else "global") if fwd and restir else "-"),
        "di_temporal": route(fwd, restir),
        "di_spatial": route(fwd and shared, restir),
        "gi_spatial": route(fwd and shared, restir),
        "denoise": route(fwd and cfg.denoise_kernel in ("auto", "pallas"),
                         cfg.denoise_passes > 0),
        "taa": route(fwd and cfg.taa_kernel in ("auto", "pallas"),
                     cfg.enable_taa),
        # K13 reads the GI history (and the DI one with the joint gather)
        # of a ReSTIR frame and TAA's history corners.
        "history": route(cuda and history_kernel_ok(cfg),
                         restir or cfg.enable_taa),
    }
