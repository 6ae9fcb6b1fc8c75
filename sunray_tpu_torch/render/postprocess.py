"""Post pipeline: temporal accumulation (TAA), a-trous denoise, tonemap.

Port of sunray_tpu/render/postprocess.py. The TAA history is read by the
direct bilinear_sample (postprocess.py:50-75), which is what the JAX
package does off the TPU (plain gathers, ops/banded.py); the TPU-only band
rejection is not ported. With history_select_kernel the four bilinear
corners are fetched in one K13 launch (ops/cuda_history.py); kernel
"pallas" (or "auto" on the card) runs the clamp and blend as K9
(ops/cuda_image.taa_clamp_blend; its window form in a row-sharded
frame), else its plain version. The denoise
dispatches to K7. All images are (H, W, C) float32. In a row-sharded
frame (grid, parallel/halo.py) the history fetch reads a halo_t-row
window of the history, the 3x3 clamp a 1-row edge-extended raw, and the
denoise runs K7's window form on each pass's exchanged window
(atrous_denoise_grid, postprocess.py:169-300, 401-429). The history fetch and
blend round their multiply-adds as the reference does (ops/fp.py), and
the tonemap's clips pass JAX's gradient at their bounds (fp.clip).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.camera import pixel_centers, pixel_rows
from sunray_tpu_torch.ops import cuda_history, cuda_image
from sunray_tpu_torch.ops.fp import clip, fma
from sunray_tpu_torch.ops.cuda_image import (
    DENOISE_KERNELS,
    LUMA,
    atrous_denoise,
    atrous_denoise_pass,
)
from sunray_tpu_torch.parallel.halo import exchange_rows

# The plain clamp and blend (the JAX package's jnp taa_clamp_blend).
taa_clamp_blend = cuda_image.taa_clamp_blend_plain

ACCUMULATION_FACTOR = 0.14   # temporal_accumulation.slang:30

__all__ = [
    "LUMA", "ACCUMULATION_FACTOR", "bilinear_sample", "taa_clamp_blend",
    "temporal_accumulate", "atrous_denoise_pass", "atrous_denoise",
    "atrous_denoise_grid",
    "aces_film", "srgb_encode", "tonemap",
]


def bilinear_sample(img, uv, select_kernel=False, grid=None):
    """Manual bilinear fetch at continuous uv, clamp-to-edge
    (temporal_accumulation.slang:42-58). img: (H, W, C); uv: (H, W, 2).
    select_kernel: fetch the four corners in one history_gather (K13).

    grid: img holds the band's rows of a row-sharded history; it is
    exchanged with halo_t rows and the corners are read there at their
    clamped global rows (postprocess.py:169-200). Returns (color, valid),
    valid False where a corner row lies outside the window. The corners
    and weights are the single-device fetch's, so one rank's frame is the
    single-device frame bit for bit (the JAX grid fetch clamps uv first,
    which rounds the edge columns' weights apart)."""
    h, w = img.shape[:2]
    hg, row_base, n_rows = h, 0, h
    if grid is not None:
        img = exchange_rows(img, grid.halo_t, grid.halo_t, grid)
        hg, row_base, n_rows = grid.h, grid.row0 - grid.halo_t, img.shape[0]
    px = fma(uv[..., 0], float(w), -0.5)
    py = fma(uv[..., 1], float(hg), -0.5)
    bx = torch.floor(px).to(torch.int64)
    by = torch.floor(py).to(torch.int64)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]

    def flat(ix, iy):
        row = iy.clamp(0, hg - 1) - row_base
        if grid is not None:
            row = row.clamp(0, n_rows - 1)
        return row * w + ix.clamp(0, w - 1)

    corners = [flat(bx, by), flat(bx + 1, by), flat(bx, by + 1),
               flat(bx + 1, by + 1)]
    table = img.reshape(n_rows * w, -1)
    if select_kernel:
        rows = cuda_history.history_gather(
            [table], torch.cat([c.reshape(-1) for c in corners]))[0]
        h00, h10, h01, h11 = rows.reshape(4, *uv.shape[:-1], -1)
    else:
        h00, h10, h01, h11 = (table[c] for c in corners)
    top = fma(h00, 1 - fx, h10 * fx)
    bottom = fma(h01, 1 - fx, h11 * fx)
    out = fma(top, 1 - fy, bottom * fy)
    if grid is None:
        return out
    valid = ((by.clamp(0, hg - 1) >= row_base)
             & ((by + 1).clamp(0, hg - 1) <= row_base + n_rows - 1))
    return out, valid


def temporal_accumulate(raw, motion, history, frame_count,
                        accumulation_factor=ACCUMULATION_FACTOR, kernel="jnp",
                        history_select_kernel=False, grid=None):
    """TAA (temporal_accumulation.slang:60-132). raw, history: (H, W, 3);
    motion: (H, W, 2); frame_count: int or 0-d tensor. Returns the new
    accumulation image (next frame's history).

    kernel: "pallas" runs the clamp and blend as K9, "auto" does so on the
    card, "jnp" takes the plain version (the JAX switch's names).
    history_select_kernel: fetch the history corners through K13.
    grid: a row-sharded frame (postprocess.py:241-293): the images hold
    the band's rows, the history is fetched from its halo_t window
    (history beyond it is rejected like off-screen history) and the clamp
    reads a 1-row edge-extended raw, through K9's window form where the
    kernel is switched on."""
    h, w = raw.shape[:2]
    dev = raw.device
    k9 = kernel == "pallas" or (kernel == "auto" and dev.type == "cuda")
    row0 = None if grid is None else grid.row0
    vv, uu = torch.meshgrid(pixel_rows(h if grid is None else grid.h, dev,
                                       row0, h),
                            pixel_centers(w, dev), indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)
    prev_uv = uv - motion

    off_screen = ((prev_uv < 0.0) | (prev_uv > 1.0)).any(dim=-1)
    use_history = (~off_screen) & (torch.as_tensor(frame_count, device=dev) > 2)
    if grid is not None:
        hist, valid = bilinear_sample(history, prev_uv, history_select_kernel,
                                      grid)
        raw_x = exchange_rows(raw, 1, 1, grid, edge="edge")
        blend = cuda_image.taa_clamp_blend if k9 else taa_clamp_blend
        return blend(raw, hist, use_history & valid, accumulation_factor,
                     raw_x=raw_x)
    hist = bilinear_sample(history, prev_uv, history_select_kernel)
    if k9:
        return cuda_image.taa_clamp_blend(raw.contiguous(), hist.contiguous(),
                                          use_history, accumulation_factor)
    return taa_clamp_blend(raw, hist, use_history, accumulation_factor)


def atrous_denoise_grid(color, depth, normal, roughness, diffuse,
                        passes: int, grid, kernel: str = "auto"):
    """`passes` a-trous passes over a row-sharded image
    (postprocess.py:401-429): the guides are exchanged once to the
    largest reach (2 * 2^(passes-1) rows) and the colour before each pass
    to that pass's 2 * step rows, so every rank computes its rows exactly
    as the single-device passes would. Each pass runs on the window:
    K7's window form (kernel "auto" or "pallas" on the card), else the
    plain pass with the same row0 / h_global."""
    if kernel not in DENOISE_KERNELS:
        raise ValueError(f"denoise kernel {kernel!r} is not one of "
                         f"{DENOISE_KERNELS}")
    if passes <= 0:
        return color
    one_pass = (cuda_image.atrous_denoise_pass if kernel == "jnp"
                else cuda_image.atrous_pass)
    gmax = 2 * (1 << (passes - 1))
    dep_x, nor_x, rgh_x, dif_x = (exchange_rows(g, gmax, gmax, grid)
                                  for g in (depth, normal, roughness,
                                            diffuse))
    hl = color.shape[0]
    for i in range(passes):
        s = 1 << i
        hp = 2 * s
        tr, end = gmax - hp, gmax + hl + hp
        col_x = exchange_rows(color, hp, hp, grid)
        out = one_pass(col_x, dep_x[tr:end], nor_x[tr:end], rgh_x[tr:end],
                       dif_x[tr:end], s, row0=grid.row0 - hp,
                       h_global=grid.h)
        color = out[hp:hp + hl]
    return color


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
