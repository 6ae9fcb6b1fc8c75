"""Post pipeline: temporal accumulation (TAA), a-trous denoise, tonemap.

Port of sunray_tpu/render/postprocess.py. The TAA history is read by the
direct bilinear_sample (postprocess.py:50-75), which is what the JAX
package does off the TPU (plain gathers, ops/banded.py); the TPU-only band
rejection is not ported. With history_select_kernel the four bilinear
corners are fetched in one K13 launch (ops/cuda_history.py); kernel
"pallas" (or "auto" on the card) runs the clamp and blend as K9
(ops/cuda_image.taa_clamp_blend), else its plain version. The denoise
dispatches to K7. All images are (H, W, C) float32. The history fetch and
blend round their multiply-adds as the reference does (ops/fp.py), and
the tonemap's clips pass JAX's gradient at their bounds (fp.clip).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.camera import pixel_centers
from sunray_tpu_torch.ops import cuda_history, cuda_image
from sunray_tpu_torch.ops.fp import clip, fma
from sunray_tpu_torch.ops.cuda_image import (
    LUMA,
    atrous_denoise,
    atrous_denoise_pass,
)

# The plain clamp and blend (the JAX package's jnp taa_clamp_blend).
taa_clamp_blend = cuda_image.taa_clamp_blend_plain

ACCUMULATION_FACTOR = 0.14   # temporal_accumulation.slang:30

__all__ = [
    "LUMA", "ACCUMULATION_FACTOR", "bilinear_sample", "taa_clamp_blend",
    "temporal_accumulate", "atrous_denoise_pass", "atrous_denoise",
    "aces_film", "srgb_encode", "tonemap",
]


def bilinear_sample(img, uv, select_kernel=False):
    """Manual bilinear fetch at continuous uv, clamp-to-edge
    (temporal_accumulation.slang:42-58). img: (H, W, C); uv: (H, W, 2).
    select_kernel: fetch the four corners in one history_gather (K13)."""
    h, w = img.shape[:2]
    px = fma(uv[..., 0], float(w), -0.5)
    py = fma(uv[..., 1], float(h), -0.5)
    bx = torch.floor(px).to(torch.int64)
    by = torch.floor(py).to(torch.int64)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]

    def flat(ix, iy):
        return iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)

    corners = [flat(bx, by), flat(bx + 1, by), flat(bx, by + 1),
               flat(bx + 1, by + 1)]
    table = img.reshape(h * w, -1)
    if select_kernel:
        rows = cuda_history.history_gather(
            [table], torch.cat([c.reshape(-1) for c in corners]))[0]
        h00, h10, h01, h11 = rows.reshape(4, *img.shape)
    else:
        h00, h10, h01, h11 = (table[c] for c in corners)
    top = fma(h00, 1 - fx, h10 * fx)
    bottom = fma(h01, 1 - fx, h11 * fx)
    return fma(top, 1 - fy, bottom * fy)


def temporal_accumulate(raw, motion, history, frame_count,
                        accumulation_factor=ACCUMULATION_FACTOR, kernel="jnp",
                        history_select_kernel=False):
    """TAA (temporal_accumulation.slang:60-132). raw, history: (H, W, 3);
    motion: (H, W, 2); frame_count: int or 0-d tensor. Returns the new
    accumulation image (next frame's history).

    kernel: "pallas" runs the clamp and blend as K9, "auto" does so on the
    card, "jnp" takes the plain version (the JAX switch's names).
    history_select_kernel: fetch the history corners through K13."""
    h, w = raw.shape[:2]
    dev = raw.device
    vv, uu = torch.meshgrid(pixel_centers(h, dev), pixel_centers(w, dev),
                            indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)
    prev_uv = uv - motion

    off_screen = ((prev_uv < 0.0) | (prev_uv > 1.0)).any(dim=-1)
    hist = bilinear_sample(history, prev_uv, history_select_kernel)
    use_history = (~off_screen) & (torch.as_tensor(frame_count, device=dev) > 2)
    if kernel == "pallas" or (kernel == "auto" and dev.type == "cuda"):
        return cuda_image.taa_clamp_blend(raw.contiguous(), hist.contiguous(),
                                          use_history, accumulation_factor)
    return taa_clamp_blend(raw, hist, use_history, accumulation_factor)


def aces_film(x):
    """ACES fitted (Narkowicz) — postprocess.slang:14-18."""
    x = clip(x, 0.0, 100.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def srgb_encode(x):
    """Exact sRGB OETF."""
    x = clip(x, 0.0, 1.0)
    lo = x * 12.92
    hi = 1.055 * clip(x, 1e-8) ** (1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, lo, hi)


def tonemap(color, exposure=1.0, mode="aces", gamma=2.2):
    """NaN/Inf scrub -> exposure -> ACES -> transfer curve
    (postprocess.slang:20-42). mode: "aces" | "aces_srgb" | "none"."""
    bad = (~torch.isfinite(color)).any(dim=-1, keepdim=True)
    color = torch.where(bad, 0.0, color)
    color = color * exposure
    if mode in ("aces", "aces_srgb"):
        color = aces_film(color)
    else:
        color = clip(color, 0.0, 1.0)
    if mode == "aces_srgb":
        return srgb_encode(color)
    return clip(color, 1e-8) ** (1.0 / gamma)
