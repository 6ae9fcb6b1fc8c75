"""Texture atlas sampling — port of sunray_tpu/ops/texture.py.

Bilinear or nearest filtering at level 0 (the reference never samples
mips), per-texture wrap modes (repeat, clamp, mirror) on each axis, and
the NULL_TEXTURE fallback (rt_utils.slang:121-133). A textureless scene
carries the static 1x1x1 atlas, for which every lookup is the fallback or
the white dummy texel, with no uv work (texture.py:44-46).

The five texel fetches of a sample (four bilinear taps, the nearest tap)
are one indexed load data[tid, y, x] of (5, N) coordinates; where the
atlas data requires grad they go through _TexelFetch, whose backward
sums into the atlas viewed as (T * H * W, 4) rows with K8's backward
(ops/cuda_gather.gather_rows_bwd: the runs path on the card, index_add_
on the CPU), as jax.grad differentiates the reference's plain indexing
(texture.py:65, 81). The load keeps three index tensors: on an H100 one
flat row index (data.view(-1, 4)[rows]) took PyTorch's row-gather kernel
at ~6 ms a sample call against ~0.3 ms.

The any-hit alpha test of alpha cutout (render/trace.py, the fused BVH
walk of csrc/bvh.cu) reads a scene's AlphaTables (alpha_tables,
alpha_accepts).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sunray_tpu_torch.ops import cuda_gather
from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.scene.types import (
    ALPHA_MASK,
    NULL_TEXTURE,
    TEX_BASE_COLOR,
    WRAP_CLAMP,
    WRAP_MIRROR,
    WRAP_REPEAT,
    TextureAtlas,
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


class _TexelFetch(torch.autograd.Function):
    """data (T, H, W, 4) at (tid, y, x), each (G, N) int64 -> (G, N, 4): the
    plain indexed load; the backward sums the cotangent rows into the
    atlas's (T*H*W, 4) rows (gather_rows_bwd, ct read as (G, 4, N)
    through its strides)."""

    @staticmethod
    def forward(ctx, data, tid, y, x):
        _, h, w, _ = data.shape
        ctx.save_for_backward(((tid * h + y) * w + x).to(torch.int32))
        ctx.shape = data.shape
        return data[tid, y, x]

    @staticmethod
    def backward(ctx, ct):
        rows, = ctx.saved_tensors
        k = ctx.shape[0] * ctx.shape[1] * ctx.shape[2]
        grad = cuda_gather.gather_rows_bwd(ct.permute(0, 2, 1), rows, k)
        return grad.reshape(ctx.shape), None, None, None


def fetch_texels(data, tid, y, x):
    """data (T, H, W, 4) at (tid, y, x), each (G, N) int64: (G, N, 4),
    differentiable in data (_TexelFetch)."""
    if data.requires_grad and torch.is_grad_enabled():
        return _TexelFetch.apply(data, tid, y, x)
    return data[tid, y, x]


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

    nx = torch.floor(uv[:, 0] * wf).long()
    ny = torch.floor(uv[:, 1] * hf).long()
    xs = torch.stack([bx, bx + 1, bx, bx + 1, nx])
    ys = torch.stack([by, by, by + 1, by + 1, ny])
    xs = apply_wrap(xs, w, wrap[:, 0])
    ys = apply_wrap(ys, h, wrap[:, 1])
    t00, t10, t01, t11, nearest = fetch_texels(
        atlas.data, tid.expand(5, -1), ys, xs)
    gx, gy = 1 - fx, 1 - fy
    bilinear = fma(fma(t00, gx, t10 * fx), gy, fma(t01, gx, t11 * fx) * fy)
    out = torch.where((filt == 1)[:, None], bilinear, nearest)
    return torch.where(is_null[:, None], fallback, out)


class AlphaTables(NamedTuple):
    """What the alpha test reads of a scene: tri_mat (T,) int32, the
    primitive of each triangle whose material is MASK and -1 where it is
    opaque (an opaque hit reads nothing more); tri_vidx (T, 3) int32; uvs
    (V, 5, 2) f32; mat_tex (P,) int32 base-colour texture or NULL_TEXTURE;
    base_color (P, 4) and cutoff (P,) f32; the scene's TextureAtlas."""

    tri_mat: torch.Tensor
    tri_vidx: torch.Tensor
    uvs: torch.Tensor
    mat_tex: torch.Tensor
    base_color: torch.Tensor
    cutoff: torch.Tensor
    atlas: TextureAtlas

    def tensors(self):
        a = self.atlas
        return (*self[:6], a.data, a.size, a.wrap, a.filt)


def alpha_tables(scene) -> AlphaTables:
    """The alpha test's tables of `scene` (built once a tracer context)."""
    mats = scene.materials
    prim = scene.inst_prim.long()[scene.tri_inst.long()]
    mask = mats.alpha_mode[prim] == ALPHA_MASK
    return AlphaTables(
        torch.where(mask, prim, -1).to(torch.int32).contiguous(),
        scene.tri_vidx.to(torch.int32).contiguous(),
        scene.uvs.detach().contiguous(),
        mats.tex_index[:, TEX_BASE_COLOR].to(torch.int32).contiguous(),
        mats.base_color.detach().contiguous(),
        mats.alpha_cutoff.detach().contiguous(), scene.textures)


def alpha_accepts(alpha: AlphaTables, tri, u, v):
    """Any-hit alpha test (trace.py:134-166, any_hit.slang:11-43): True =
    the hit (tri, u, v) is accepted. OPAQUE materials accept; MASK
    materials sample the base colour's alpha at the interpolated
    base-colour uv and reject below the cutoff."""
    tri = tri.long()
    prim = alpha.tri_mat[tri].long()
    p = prim.clamp(min=0)
    vidx = alpha.tri_vidx[tri].long()
    uv_table = alpha.uvs[:, TEX_BASE_COLOR, :]
    w = ((1.0 - u - v)[:, None], u[:, None], v[:, None])
    c = [uv_table[vidx[:, k]] for k in range(3)]
    uv = fma(w[2], c[2], fma(w[0], c[0], w[1] * c[1]))
    color = sample_texture(alpha.atlas, alpha.mat_tex[p], uv,
                           alpha.base_color[p])
    return (prim < 0) | (color[:, 3] >= alpha.cutoff[p])
