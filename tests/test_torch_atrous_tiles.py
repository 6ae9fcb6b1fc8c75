"""K7's staged design, modelled in plain PyTorch on the CPU.

csrc/atrous.cu gives each block a tile of one sub-lattice of the pass
(the pixels with equal x mod step and y mod step), stages the tile and a
halo of two lattice pixels once (each staged pixel's illuminance and
luma computed once, a halo pixel outside the image staged as the
edge-clamped pixel) and reads every tap from the staged tile.
`staged_pass` does the same, tile by tile, with the plain pass's
arithmetic; it must equal cuda_image.atrous_denoise_pass bit for bit at
steps 1, 2, 4 and 8 on images whose lattice tiles are ragged, sky and
bypass pixels included, and its four passes must stay within 1e-5 of the
JAX atrous_denoise (tests/test_torch_postprocess.py's tolerance). The
kernel itself is held to the plain pass in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.render import postprocess as jpost
from sunray_tpu_torch.ops import cuda_image
from sunray_tpu_torch.ops.brdf import vec_norm
from sunray_tpu_torch.ops.cuda_image import (ATROUS_HALO, ATROUS_KERNEL,
                                             ATROUS_TILE, luminance)
from torch_parity import n, t

SIZES = [(37, 53), (27, 48)]


def _guides(h, w, seed):
    """A sky band, ~10% rough-bypass pixels, two normal planes, albedo
    zeros (the neighbour illuminance then divides by 0.001)."""
    rng = np.random.default_rng(seed)
    color = (rng.uniform(size=(h, w, 3)) * 2.0).astype(np.float32)
    depth = (1.0 + 3.0 * rng.uniform(size=(h, w))).astype(np.float32)
    depth[: h // 6] = 100000.0
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    normal[:, w // 2:] = (0.0, 1.0, 0.0)
    normal += rng.normal(size=normal.shape).astype(np.float32) * 0.05
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    rough = rng.uniform(size=(h, w)).astype(np.float32)
    diffuse = rng.uniform(size=(h, w, 3)).astype(np.float32)
    diffuse[::7, ::5] = 0.0
    return color, depth, normal, rough, diffuse


def lattice_len(n_px, a, step):
    return -(-(n_px - a) // step) if a < n_px else 0


def staged_pass(color, depth, normal, roughness, diffuse, step,
                tile=ATROUS_TILE, halo=ATROUS_HALO, zero_fill=False):
    """One a-trous pass computed as K7's blocks compute it. zero_fill:
    stage out-of-image halo pixels as zeros instead of the edge-clamped
    pixel (what the kernel must not do)."""
    h, w = depth.shape
    tx, ty = tile
    out = torch.full_like(color, float("nan"))
    kc = ATROUS_KERNEL[2] * ATROUS_KERNEL[2]
    for ay in range(min(step, h)):
        for ax in range(min(step, w)):
            lw, lh = lattice_len(w, ax, step), lattice_len(h, ay, step)
            for ly0 in range(0, lh, ty):
                for lx0 in range(0, lw, tx):
                    # Stage the tile and its halo: real coordinates of the
                    # lattice pixels, clamped into the image.
                    sx = ax + (lx0 + torch.arange(tx + 2 * halo) - halo) * step
                    sy = ay + (ly0 + torch.arange(ty + 2 * halo) - halo) * step
                    qy, qx = sy.clamp(0, h - 1)[:, None], sx.clamp(0, w - 1)[None, :]
                    s_dif = diffuse[qy, qx]
                    s_il = color[qy, qx] / torch.clamp(s_dif, min=0.001)
                    s_dep, s_nrm = depth[qy, qx], normal[qy, qx]
                    if zero_fill:
                        inside = (((sy >= 0) & (sy < h))[:, None]
                                  & ((sx >= 0) & (sx < w))[None, :])
                        s_dif, s_il, s_dep, s_nrm = (
                            torch.where(inside if x.dim() == 2 else inside[..., None],
                                        x, 0.0)
                            for x in (s_dif, s_il, s_dep, s_nrm))
                    s_lum = luminance(s_il)
                    # The tile's centres (ragged at the lattice's edge).
                    cy = min(ty, lh - ly0)
                    cx = min(tx, lw - lx0)
                    yy = sy[halo:halo + cy]
                    xx = sx[halo:halo + cx]
                    c = (slice(halo, halo + cy), slice(halo, halo + cx))
                    c_dif = torch.clamp(s_dif[c], min=0.001)
                    c_il, c_lum = s_il[c], s_lum[c]
                    c_dep, c_nrm = s_dep[c], s_nrm[c]
                    sum_color = c_il * kc
                    sum_weight = torch.full((cy, cx), kc, dtype=color.dtype)
                    for dy in range(-2, 3):
                        for dx in range(-2, 3):
                            if dx == 0 and dy == 0:
                                continue
                            q = (slice(halo + dy, halo + dy + cy),
                                 slice(halo + dx, halo + dx + cx))
                            iy, ix = yy + dy * step, xx + dx * step
                            in_b = (((iy >= 0) & (iy < h))[:, None]
                                    & ((ix >= 0) & (ix < w))[None, :])
                            n_il, n_lum = s_il[q], s_lum[q]
                            diffuse_diff = vec_norm(c_dif - s_dif[q])
                            luma_diff = (c_lum - n_lum).abs()
                            luma_sigma = torch.maximum(c_lum, n_lum) * 0.4 + 0.01
                            luma_ratio = luma_diff / luma_sigma
                            power = (
                                -(c_dep - s_dep[q]).abs() * 8.0
                                + ((c_nrm * s_nrm[q]).sum(dim=-1) - 1.0) * 80.0
                                - diffuse_diff * 50.0
                                - luma_ratio * luma_ratio
                            )
                            wgt = (torch.exp(power) * ATROUS_KERNEL[dx + 2]
                                   * ATROUS_KERNEL[dy + 2])
                            wgt = torch.where(in_b, wgt, 0.0)
                            sum_color = sum_color + n_il * wgt[..., None]
                            sum_weight = sum_weight + wgt
                    res = (sum_color / torch.clamp(sum_weight, min=1e-4)[..., None]
                           * c_dif)
                    py, px = yy[:, None], xx[None, :]
                    bypass = ((depth[py, px] >= 10000.0)
                              | (roughness[py, px] < 0.1))
                    out[py, px] = torch.where(bypass[..., None], color[py, px], res)
    return out


def _bits(x):
    return n(x).view(np.uint32)


@pytest.mark.parametrize("step", [1, 2, 4, 8])
@pytest.mark.parametrize("size", SIZES)
def test_staged_pass_bit_equal_to_plain(size, step):
    args = tuple(t(a) for a in _guides(*size, seed=step))
    want = cuda_image.atrous_denoise_pass(*args, step)
    got = staged_pass(*args, step)
    assert not torch.isnan(got).any()      # every pixel written once
    np.testing.assert_array_equal(_bits(got), _bits(want))
    sky = args[1] >= 10000.0
    assert torch.equal(got[sky], args[0][sky])


@pytest.mark.parametrize("size", SIZES)
def test_staged_passes_match_jax(size):
    guides = _guides(*size, seed=11)
    want = jpost.atrous_denoise(*(jnp.asarray(a) for a in guides), 4,
                                kernel="jnp")
    args = tuple(t(a) for a in guides)
    color = args[0]
    for i in range(4):
        color = staged_pass(color, *args[1:], 1 << i)
    np.testing.assert_allclose(n(color), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(
        _bits(color), _bits(cuda_image.atrous_denoise(*args, 4)))


def test_halo_is_the_clamped_pixel_not_zero():
    """An infinite illuminance on the image's edge (color inf) reaches the
    out-of-image taps of its neighbours as the clamped pixel, whose weight
    the mask zeroes: inf x 0 = NaN, as the plain pass computes. A
    zero-filled halo would give those pixels finite sums instead."""
    args = [t(a) for a in _guides(27, 48, seed=5)]
    args[1][:] = 2.0                          # no sky: every pixel denoised
    args[3][:] = 0.5
    args[0][:, 0] = float("inf")
    want = cuda_image.atrous_denoise_pass(*args, 2)
    got = staged_pass(*args, 2)
    np.testing.assert_array_equal(n(got), n(want))     # NaN where want is
    assert torch.isnan(want).any()
    zero = staged_pass(*args, 2, zero_fill=True)
    assert not np.array_equal(n(zero), n(want))


def test_lattice_tiles_cover_each_pixel_once():
    """Every pixel is the centre of exactly one block at every step, so the
    blocks' tile grid (the widest lattice's tile counts, blocks past a
    narrower lattice's edge exiting) covers the image."""
    tx, ty = ATROUS_TILE
    for h, w in SIZES + [(1, 1), (5, 70), (1080, 1920)]:
        for step in (1, 2, 4, 8):
            tiles_x = -(-(-(-w // step)) // tx)
            tiles_y = -(-(-(-h // step)) // ty)
            seen = np.zeros((h, w), np.int32)
            for block in range(step * step * tiles_x * tiles_y):
                lat, tile = block % (step * step), block // (step * step)
                ax, ay = lat % step, lat // step
                lx0, ly0 = (tile % tiles_x) * tx, (tile // tiles_x) * ty
                lw, lh = lattice_len(w, ax, step), lattice_len(h, ay, step)
                if lx0 >= lw or ly0 >= lh:
                    continue
                xs = ax + step * np.arange(lx0, min(lx0 + tx, lw))
                ys = ay + step * np.arange(ly0, min(ly0 + ty, lh))
                seen[np.ix_(ys, xs)] += 1
            assert (seen == 1).all(), (h, w, step)
