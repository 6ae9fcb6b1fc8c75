"""K7: edge-avoiding a-trous denoise, one kernel launch per pass; K9: the
TAA 3x3 clamp and blend.

Counterpart of sunray_tpu/ops/pallas_image.py (atrous_denoise_tpu,
taa_clamp_blend_tpu); the kernels are csrc/atrous.cu and csrc/taa.cu. The
plain PyTorch versions port the jnp passes of
sunray_tpu/render/postprocess.py (atrous_denoise_pass, :307-375, and
taa_clamp_blend, :204-232), which the JAX tests hold equal to the Pallas
kernels. All images are (H, W, C) float32.

Both kernels are differentiable as the TPU kernels' custom_vjps make
them (pallas_image.py:257-280, 389-411): an autograd Function whose
forward is the kernel and whose backward is the vector-Jacobian product
of the plain version, recomputed from the saved inputs. The differentiable
frame itself takes the plain passes, as the JAX frame does
(render/pipeline.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sunray_tpu_torch.ops import cuda_build
from sunray_tpu_torch.ops.brdf import vec_norm
from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.ops.loops import checkpointed

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
                        step_width: int, row0: int = 0, h_global=None):
    """One a-trous pass (denoise.slang:27-116) in plain PyTorch.

    color: (H,W,3); depth: (H,W); normal: (H,W,3); roughness: (H,W);
    diffuse: (H,W,3) demodulation albedo; step_width: int.

    row0/h_global: the window form (a row-sharded frame,
    postprocess.py:307-316): the inputs are a halo-extended row window
    whose row 0 sits at global row row0 of an h_global-row image; the
    taps' in-image test then runs on global rows."""
    h, w = color.shape[:2]
    dev = color.device
    bypass = (depth >= 10000.0) | (roughness < 0.1)

    center_diffuse = torch.clamp(diffuse, min=0.001)
    center_illum = color / center_diffuse
    center_luma = luminance(center_illum)

    kc = ATROUS_KERNEL[2] * ATROUS_KERNEL[2]
    sum_color = center_illum * kc
    sum_weight = torch.full((h, w), kc, dtype=color.dtype, device=dev)
    ys = torch.arange(h, device=dev) + row0
    hb = h if h_global is None else h_global
    xs = torch.arange(w, device=dev)

    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dx == 0 and dy == 0:
                continue
            oy = dy * step_width
            ox = dx * step_width
            iy = ys + oy
            ix = xs + ox
            in_b = (((iy >= 0) & (iy < hb))[:, None]
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
    """`passes` plain passes. Under autograd each pass is recomputed in the
    backward pass (ops/loops.checkpointed): a pass's 24 taps would
    otherwise keep ~3 KB a pixel for the backward."""
    guides = (color, depth, normal, roughness, diffuse)
    remat = any(g.requires_grad for g in guides)
    for i in range(passes):
        color = checkpointed(atrous_denoise_pass, color, depth, normal,
                             roughness, diffuse, 1 << i, enabled=remat)
    return color


DENOISE_KERNELS = ("auto", "pallas", "jnp")   # RenderConfig.denoise_kernel
# K7's block: a (ATROUS_TILE[1], ATROUS_TILE[0]) tile of one sub-lattice
# of the pass (pixels with equal x mod step and y mod step) and a halo of
# ATROUS_HALO lattice pixels, staged once in shared memory (csrc/atrous.cu
# kTileX, kTileY, kHalo, checked against the library's
# sunray_atrous_tile_shape when it loads; tests/test_torch_atrous_tiles.py
# models it).
ATROUS_TILE = (32, 8)
ATROUS_HALO = 2


def _check_guides(name, guides):
    dev = cuda_build.require_cuda(name, *guides)
    h, w = guides[0].shape[:2]
    for t, shape in zip(guides, ((h, w, 3), (h, w), (h, w, 3), (h, w),
                                 (h, w, 3))):
        cuda_build.require_dtype(name, t, torch.float32)
        if tuple(t.shape) != shape:
            raise cuda_build.KernelError(f"{name}: expected {shape}, got "
                                         f"{tuple(t.shape)}")
    return dev, h, w


def _launch_pass(src, depth, normal, roughness, diffuse, step, dst, lib=None,
                 window=None):
    """K7 once from `lib` (default: the port's library, whose launches are
    counted): dst = one pass of src at `step` (all checked by the caller;
    each tensor held by the caller until the launch returns). window:
    (row0, h_global), K7's window form (sunray_atrous_pass_window,
    counted as "atrous_pass_window")."""
    h, w = src.shape[:2]
    kernels = cuda_build.library() if lib is None else lib
    ptrs = (src.data_ptr(), depth.data_ptr(), normal.data_ptr(),
            roughness.data_ptr(), diffuse.data_ptr(), h, w, step)
    name = "atrous_pass" if window is None else "atrous_pass_window"
    if window is None:
        err = kernels.sunray_atrous_pass(*ptrs, dst.data_ptr(),
                                         cuda_build.stream_ptr())
    else:
        err = kernels.sunray_atrous_pass_window(*ptrs, *window,
                                                dst.data_ptr(),
                                                cuda_build.stream_ptr())
    cuda_build.check_launch(name, err)
    if lib is None:
        cuda_build.launches[name] += 1


def atrous_pass(color, depth, normal, roughness, diffuse, step_width: int,
                row0: int = 0, h_global=None):
    """One a-trous pass at any step width: K7 on CUDA tensors, the plain
    pass on CPU tensors. row0/h_global: the window form
    (atrous_denoise_pass), K7's window instantiation on the card."""
    guides = (color, depth, normal, roughness, diffuse)
    if cuda_build.on_cpu(*guides):
        return atrous_denoise_pass(*guides, step_width, row0, h_global)
    dev, h, w = _check_guides("atrous_pass", guides)
    if step_width <= 0:
        raise cuda_build.KernelError(f"atrous_pass: step {step_width} <= 0")
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    window = None
    if (row0, h_global) != (0, None):
        window = (row0, h if h_global is None else h_global)
    _launch_pass(color, depth, normal, roughness, diffuse, step_width, out,
                 window=window)
    return out


def _plain_vjp(plain, inputs, ct):
    """The gradients of plain(*inputs) along ct for the inputs that need
    one (None for the others), recomputed with autograd on."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(x.dtype.is_floating_point)
              for x in inputs]
        out = plain(*xs)
        want = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, want, ct, allow_unused=True))
    return tuple(next(grads) if x.requires_grad else None for x in xs)


class _Atrous(torch.autograd.Function):
    """K7's passes forward, the plain passes' VJP backward."""

    @staticmethod
    def forward(ctx, color, depth, normal, roughness, diffuse, passes):
        ctx.passes = passes
        ctx.save_for_backward(color, depth, normal, roughness, diffuse)
        return _atrous_kernel(color, depth, normal, roughness, diffuse,
                              passes)

    @staticmethod
    def backward(ctx, ct):
        grads = _plain_vjp(
            lambda *g: atrous_denoise_plain(*g, ctx.passes),
            ctx.saved_tensors, ct)
        return (*grads, None)


def _atrous_kernel(color, depth, normal, roughness, diffuse, passes):
    """`passes` K7 launches, the color ping-ponging between two buffers."""
    dev, h, w = _check_guides("atrous_pass", (color, depth, normal,
                                              roughness, diffuse))
    if passes <= 0:
        return color
    bufs = [torch.empty((h, w, 3), dtype=torch.float32, device=dev)
            for _ in range(min(passes, 2))]
    src = color
    for i in range(passes):
        dst = bufs[i % 2]
        _launch_pass(src, depth, normal, roughness, diffuse, 1 << i, dst)
        src = dst
    return src


def atrous_denoise(color, depth, normal, roughness, diffuse, passes: int,
                   kernel: str = "auto"):
    """`passes` a-trous passes at step widths 1, 2, 4, ... (src/lib.rs:42).

    kernel: "jnp" takes the plain passes; "auto" and "pallas" (the JAX
    switch's names) launch K7 once per pass on CUDA tensors, the color
    ping-ponging between two buffers, and take the plain passes on CPU
    tensors."""
    if kernel not in DENOISE_KERNELS:
        raise ValueError(f"denoise kernel {kernel!r} is not one of "
                         f"{DENOISE_KERNELS}")
    guides = (color, depth, normal, roughness, diffuse)
    if kernel == "jnp" or cuda_build.on_cpu(*guides):
        return atrous_denoise_plain(color, depth, normal, roughness, diffuse,
                                    passes)
    if torch.is_grad_enabled() and any(g.requires_grad for g in guides):
        return _Atrous.apply(*guides, passes)
    return _atrous_kernel(*guides, passes)


def taa_clamp_blend_plain(raw, hist, use_history, accumulation_factor,
                          raw_x=None):
    """3x3 luminance-gated neighbourhood min/max of `raw`, history clamped
    into that box, lerped by `accumulation_factor`, falling back to `raw`
    where `use_history` is False (temporal_accumulation.slang:60-132).
    raw_x: `raw` with one row exchanged above and below (a row-sharded
    frame, postprocess.py:287-292); the neighbours are read there."""
    center_luma = luminance(raw)
    luma_threshold = torch.clamp(center_luma * 5.0, min=0.08)
    min_c = raw
    max_c = raw
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nb = (shift2d(raw, dy, dx) if raw_x is None
                  else shift2d(raw_x, dy, dx)[1:-1])
            ok = ((luminance(nb) - center_luma).abs() < luma_threshold)[..., None]
            min_c = torch.where(ok, torch.minimum(min_c, nb), min_c)
            max_c = torch.where(ok, torch.maximum(max_c, nb), max_c)
    clamped = torch.minimum(torch.maximum(hist, min_c), max_c)
    blended = fma(raw - clamped, accumulation_factor, clamped)
    return torch.where(use_history[..., None], blended, raw)


def taa_clamp_blend(raw, hist, use_history, accumulation_factor,
                    raw_x=None):
    """K9: taa_clamp_blend_plain in one launch. raw, hist: (H, W, 3)
    float32; use_history: (H, W) bool. Differentiable in raw and hist
    (the plain version's VJP, _TaaClampBlend).

    raw_x: K9's window form (a row-sharded frame's band): raw with one
    edge-extended row above and below, (H + 2, W, 3), which the kernel
    reads alone (raw is its rows 1..H); its gradient reaches raw
    through raw_x."""
    if cuda_build.on_cpu(raw, hist, use_history):
        return taa_clamp_blend_plain(raw, hist, use_history,
                                     accumulation_factor, raw_x=raw_x)
    grad = torch.is_grad_enabled()
    if raw_x is not None:
        if grad and (raw_x.requires_grad or hist.requires_grad):
            return _TaaClampBlendWindow.apply(raw_x, hist, use_history,
                                              accumulation_factor)
        return _taa_kernel(raw_x, hist, use_history, accumulation_factor,
                           window=True)
    if grad and (raw.requires_grad or hist.requires_grad):
        return _TaaClampBlend.apply(raw, hist, use_history,
                                    accumulation_factor)
    return _taa_kernel(raw, hist, use_history, accumulation_factor)


class _TaaClampBlend(torch.autograd.Function):
    """K9 forward, the plain clamp and blend's VJP backward."""

    @staticmethod
    def forward(ctx, raw, hist, use_history, accumulation_factor):
        ctx.factor = accumulation_factor
        ctx.save_for_backward(raw, hist, use_history)
        return _taa_kernel(raw, hist, use_history, accumulation_factor)

    @staticmethod
    def backward(ctx, ct):
        grads = _plain_vjp(
            lambda r, h, u: taa_clamp_blend_plain(r, h, u, ctx.factor),
            ctx.saved_tensors, ct)
        return (*grads[:2], None, None)


class _TaaClampBlendWindow(torch.autograd.Function):
    """K9's window form forward on raw_x, the plain window clamp and
    blend's VJP backward (raw_x's rows 1..H are the centres)."""

    @staticmethod
    def forward(ctx, raw_x, hist, use_history, accumulation_factor):
        ctx.factor = accumulation_factor
        ctx.save_for_backward(raw_x, hist, use_history)
        return _taa_kernel(raw_x, hist, use_history, accumulation_factor,
                           window=True)

    @staticmethod
    def backward(ctx, ct):
        grads = _plain_vjp(
            lambda r, h, u: taa_clamp_blend_plain(r[1:-1], h, u, ctx.factor,
                                                  raw_x=r),
            ctx.saved_tensors, ct)
        return (*grads[:2], None, None)


def _taa_kernel(src, hist, use_history, accumulation_factor, window=False,
                lib=None):
    """K9 once from `lib` (default: the port's library, whose launches are
    counted): src is raw (H, W, 3), or with `window` raw_x (H + 2, W, 3)
    and the launch is the window form (counted as
    "taa_clamp_blend_window")."""
    name = "taa_clamp_blend_window" if window else "taa_clamp_blend"
    dev = cuda_build.require_cuda(name, src, hist, use_history)
    h, w = hist.shape[:2]
    for x, rows in ((src, h + 2 if window else h), (hist, h)):
        cuda_build.require_dtype(name, x, torch.float32)
        if tuple(x.shape) != (rows, w, 3) or not x.is_contiguous():
            raise cuda_build.KernelError(
                f"{name}: expected a contiguous {(rows, w, 3)}, got "
                f"{tuple(x.shape)}")
    cuda_build.require_dtype(name, use_history, torch.bool)
    if tuple(use_history.shape) != (h, w) or not use_history.is_contiguous():
        raise cuda_build.KernelError(f"{name}: use mask {tuple(use_history.shape)}")
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    kernels = cuda_build.library() if lib is None else lib
    entry = (kernels.sunray_taa_clamp_blend_window if window
             else kernels.sunray_taa_clamp_blend)
    err = entry(src.data_ptr(), hist.data_ptr(), use_history.data_ptr(), h, w,
                float(accumulation_factor), out.data_ptr(),
                cuda_build.stream_ptr())
    cuda_build.check_launch(name, err)
    if lib is None:
        cuda_build.launches[name] += 1
    return out
