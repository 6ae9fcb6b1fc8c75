"""Post pipeline: temporal accumulation (TAA), a-trous denoise, tonemap.

Port of sunray_tpu/render/postprocess.py. The TAA history is read by the
direct bilinear_sample (postprocess.py:50-75), which is what the JAX
package does off the TPU (plain gathers, ops/banded.py); the TPU-only band
rejection is not ported. The denoise dispatches to K7
(ops/cuda_image.py). All images are (H, W, C) float32. The history fetch
and blend round their multiply-adds as the reference does (ops/fp.py).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.camera import pixel_centers
from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.ops.cuda_image import (
    LUMA,
    atrous_denoise,
    atrous_denoise_pass,
    luminance,
    shift2d,
)

ACCUMULATION_FACTOR = 0.14   # temporal_accumulation.slang:30

__all__ = [
    "LUMA", "ACCUMULATION_FACTOR", "bilinear_sample", "taa_clamp_blend",
    "temporal_accumulate", "atrous_denoise_pass", "atrous_denoise",
    "aces_film", "srgb_encode", "tonemap",
]


def bilinear_sample(img, uv):
    """Manual bilinear fetch at continuous uv, clamp-to-edge
    (temporal_accumulation.slang:42-58). img: (H, W, C); uv: (H, W, 2)."""
    h, w = img.shape[:2]
    px = fma(uv[..., 0], float(w), -0.5)
    py = fma(uv[..., 1], float(h), -0.5)
    bx = torch.floor(px).to(torch.int64)
    by = torch.floor(py).to(torch.int64)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]

    def at(ix, iy):
        return img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]

    h00 = at(bx, by)
    h10 = at(bx + 1, by)
    h01 = at(bx, by + 1)
    h11 = at(bx + 1, by + 1)
    top = fma(h00, 1 - fx, h10 * fx)
    bottom = fma(h01, 1 - fx, h11 * fx)
    return fma(top, 1 - fy, bottom * fy)


def taa_clamp_blend(raw, hist, use_history, accumulation_factor):
    """3x3 luminance-gated neighbourhood min/max of `raw`, history clamped
    into that box, lerped by `accumulation_factor`, falling back to `raw`
    where `use_history` is False (temporal_accumulation.slang:60-132)."""
    center_luma = luminance(raw)
    luma_threshold = torch.clamp(center_luma * 5.0, min=0.08)
    min_c = raw
    max_c = raw
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nb = shift2d(raw, dy, dx)
            ok = ((luminance(nb) - center_luma).abs() < luma_threshold)[..., None]
            min_c = torch.where(ok, torch.minimum(min_c, nb), min_c)
            max_c = torch.where(ok, torch.maximum(max_c, nb), max_c)
    clamped = torch.minimum(torch.maximum(hist, min_c), max_c)
    blended = fma(raw - clamped, accumulation_factor, clamped)
    return torch.where(use_history[..., None], blended, raw)


def temporal_accumulate(raw, motion, history, frame_count,
                        accumulation_factor=ACCUMULATION_FACTOR):
    """TAA (temporal_accumulation.slang:60-132). raw, history: (H, W, 3);
    motion: (H, W, 2); frame_count: int or 0-d tensor. Returns the new
    accumulation image (next frame's history)."""
    h, w = raw.shape[:2]
    dev = raw.device
    vv, uu = torch.meshgrid(pixel_centers(h, dev), pixel_centers(w, dev),
                            indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)
    prev_uv = uv - motion

    off_screen = ((prev_uv < 0.0) | (prev_uv > 1.0)).any(dim=-1)
    hist = bilinear_sample(history, prev_uv)
    use_history = (~off_screen) & (torch.as_tensor(frame_count, device=dev) > 2)
    return taa_clamp_blend(raw, hist, use_history, accumulation_factor)


def aces_film(x):
    """ACES fitted (Narkowicz) — postprocess.slang:14-18."""
    x = torch.clamp(x, 0.0, 100.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def srgb_encode(x):
    """Exact sRGB OETF."""
    x = torch.clamp(x, 0.0, 1.0)
    lo = x * 12.92
    hi = 1.055 * torch.clamp(x, min=1e-8) ** (1.0 / 2.4) - 0.055
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
        color = torch.clamp(color, 0.0, 1.0)
    if mode == "aces_srgb":
        return srgb_encode(color)
    return torch.clamp(color, min=1e-8) ** (1.0 / gamma)
