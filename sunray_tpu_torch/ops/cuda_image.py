"""K7: edge-avoiding a-trous denoise, one kernel launch per pass.

Counterpart of the a-trous half of sunray_tpu/ops/pallas_image.py
(atrous_denoise_tpu); the kernel is csrc/atrous.cu. The plain PyTorch
version of a pass, atrous_denoise_pass, ports the jnp pass
sunray_tpu/render/postprocess.py:307-375 (which the JAX tests hold equal
to the Pallas kernel). All images are (H, W, C) float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sunray_tpu_torch.ops import cuda_build
from sunray_tpu_torch.ops.brdf import vec_norm

LUMA = (0.2126, 0.7152, 0.0722)
ATROUS_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def luminance(c):
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def shift2d(img, dy: int, dx: int):
    """out[y, x] = img[clamp(y + dy), clamp(x + dx)]: the edge-padded
    shifted window of postprocess._shift2d. img: (H, W) or (H, W, C)."""
    h, w = img.shape[:2]
    ady, adx = abs(dy), abs(dx)
    x = img if img.dim() == 3 else img[..., None]
    padded = F.pad(x.permute(2, 0, 1)[None], (adx, adx, ady, ady),
                   mode="replicate")[0].permute(1, 2, 0)
    out = padded[ady + dy:ady + dy + h, adx + dx:adx + dx + w]
    return out if img.dim() == 3 else out[..., 0]


def atrous_denoise_pass(color, depth, normal, roughness, diffuse,
                        step_width: int):
    """One a-trous pass (denoise.slang:27-116) in plain PyTorch.

    color: (H,W,3); depth: (H,W); normal: (H,W,3); roughness: (H,W);
    diffuse: (H,W,3) demodulation albedo; step_width: int."""
    h, w = color.shape[:2]
    dev = color.device
    bypass = (depth >= 10000.0) | (roughness < 0.1)

    center_diffuse = torch.clamp(diffuse, min=0.001)
    center_illum = color / center_diffuse
    center_luma = luminance(center_illum)

    kc = ATROUS_KERNEL[2] * ATROUS_KERNEL[2]
    sum_color = center_illum * kc
    sum_weight = torch.full((h, w), kc, dtype=color.dtype, device=dev)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)

    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dx == 0 and dy == 0:
                continue
            oy = dy * step_width
            ox = dx * step_width
            iy = ys + oy
            ix = xs + ox
            in_b = (((iy >= 0) & (iy < h))[:, None]
                    & ((ix >= 0) & (ix < w))[None, :])
            s_color = shift2d(color, oy, ox)
            s_depth = shift2d(depth, oy, ox)
            s_normal = shift2d(normal, oy, ox)
            s_diffuse = shift2d(diffuse, oy, ox)

            s_illum = s_color / torch.clamp(s_diffuse, min=0.001)
            s_luma = luminance(s_illum)
            diffuse_diff = vec_norm(center_diffuse - s_diffuse)
            luma_diff = (center_luma - s_luma).abs()
            luma_sigma = torch.maximum(center_luma, s_luma) * 0.4 + 0.01
            luma_ratio = luma_diff / luma_sigma

            power = (
                -(depth - s_depth).abs() * 8.0
                + ((normal * s_normal).sum(dim=-1) - 1.0) * 80.0
                - diffuse_diff * 50.0
                - luma_ratio * luma_ratio
            )
            wgt = (torch.exp(power) * ATROUS_KERNEL[dx + 2]
                   * ATROUS_KERNEL[dy + 2])
            wgt = torch.where(in_b, wgt, 0.0)
            sum_color = sum_color + s_illum * wgt[..., None]
            sum_weight = sum_weight + wgt

    out = (sum_color / torch.clamp(sum_weight, min=1e-4)[..., None]
           * center_diffuse)
    return torch.where(bypass[..., None], color, out)


def atrous_denoise_plain(color, depth, normal, roughness, diffuse,
                         passes: int):
    for i in range(passes):
        color = atrous_denoise_pass(color, depth, normal, roughness, diffuse,
                                    1 << i)
    return color


def atrous_denoise(color, depth, normal, roughness, diffuse, passes: int):
    """`passes` a-trous passes at step widths 1, 2, 4, ... (src/lib.rs:42).

    CPU tensors take the plain passes; CUDA tensors launch K7 once per pass,
    the color ping-ponging between two buffers."""
    guides = (color, depth, normal, roughness, diffuse)
    if all(t.device.type == "cpu" for t in guides):
        return atrous_denoise_plain(color, depth, normal, roughness, diffuse,
                                    passes)
    name = "atrous_pass"
    dev = cuda_build.require_cuda(name, *guides)
    h, w = color.shape[:2]
    for t, shape in ((color, (h, w, 3)), (depth, (h, w)), (normal, (h, w, 3)),
                     (roughness, (h, w)), (diffuse, (h, w, 3))):
        cuda_build.require_dtype(name, t, torch.float32)
        if tuple(t.shape) != shape:
            raise cuda_build.KernelError(f"{name}: expected {shape}, got "
                                         f"{tuple(t.shape)}")
    if passes <= 0:
        return color
    lib = cuda_build.library()
    bufs = [torch.empty((h, w, 3), dtype=torch.float32, device=dev)
            for _ in range(min(passes, 2))]
    src = color
    for i in range(passes):
        dst = bufs[i % 2]
        err = lib.sunray_atrous_pass(
            src.data_ptr(), depth.data_ptr(), normal.data_ptr(),
            roughness.data_ptr(), diffuse.data_ptr(), h, w, 1 << i,
            dst.data_ptr(), cuda_build.stream_ptr(),
        )
        cuda_build.check_launch(name, err)
        cuda_build.launches[name] += 1
        src = dst
    return src
