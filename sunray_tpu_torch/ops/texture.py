"""Texture atlas sampling — port of sunray_tpu/ops/texture.py.

Bilinear or nearest filtering at level 0 (the reference never samples
mips), per-texture wrap modes (repeat, clamp, mirror) on each axis, and
the NULL_TEXTURE fallback (rt_utils.slang:121-133). A textureless scene
carries the static 1x1x1 atlas, for which every lookup is the fallback or
the white dummy texel, with no uv work (texture.py:44-46).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.scene.types import (
    NULL_TEXTURE,
    WRAP_CLAMP,
    WRAP_MIRROR,
    WRAP_REPEAT,
)


def apply_wrap(coord, size, mode):
    """Integer texel coordinate wrap (texture.py:18-30). coord, size, mode:
    (...,) integer tensors."""
    size = torch.clamp(size, min=1)
    repeat = torch.remainder(coord, size)
    clamp = torch.minimum(torch.clamp(coord, min=0), size - 1)
    period = 2 * size
    m = torch.remainder(torch.remainder(coord, period) + period, period)
    mirror = torch.where(m < size, m, period - 1 - m)
    out = torch.where(mode == WRAP_REPEAT, repeat, 0)
    out = out + torch.where(mode == WRAP_CLAMP, clamp, 0)
    return out + torch.where(mode == WRAP_MIRROR, mirror, 0)


def sample_texture(atlas, tex_id, uv, fallback):
    """Sample atlas[tex_id] at uv. tex_id (N,) int32, uv (N, 2), fallback
    (N, 4); NULL_TEXTURE takes the fallback. Returns (N, 4)."""
    is_null = tex_id == NULL_TEXTURE
    if atlas.trivial:
        return torch.where(is_null[:, None], fallback, torch.ones_like(fallback))
    tid = torch.where(is_null, 0, tex_id).long()
    size = atlas.size[tid].long()                  # (N, 2) (w, h)
    wrap = atlas.wrap[tid]
    filt = atlas.filt[tid]
    w, h = size[:, 0], size[:, 1]
    wf, hf = w.to(torch.float32), h.to(torch.float32)
    # Rounded as XLA's CPU compile rounds texture.py:55-74: the texel
    # position unfused, each bilinear sum with its left product fused.
    px = uv[:, 0] * wf - 0.5
    py = uv[:, 1] * hf - 0.5
    bx = torch.floor(px)
    by = torch.floor(py)
    fx = (px - bx)[:, None]
    fy = (py - by)[:, None]
    bx, by = bx.long(), by.long()

    def texel(ix, iy):
        ix = apply_wrap(ix, w, wrap[:, 0])
        iy = apply_wrap(iy, h, wrap[:, 1])
        return atlas.data[tid, iy, ix]

    t00, t10 = texel(bx, by), texel(bx + 1, by)
    t01, t11 = texel(bx, by + 1), texel(bx + 1, by + 1)
    gx, gy = 1 - fx, 1 - fy
    bilinear = fma(fma(t00, gx, t10 * fx), gy, fma(t01, gx, t11 * fx) * fy)

    nx = apply_wrap(torch.floor(uv[:, 0] * wf).long(), w, wrap[:, 0])
    ny = apply_wrap(torch.floor(uv[:, 1] * hf).long(), h, wrap[:, 1])
    nearest = atlas.data[tid, ny, nx]
    out = torch.where((filt == 1)[:, None], bilinear, nearest)
    return torch.where(is_null[:, None], fallback, out)
