"""Bands and halo windows cut from whole seeded frames, for the window
forms of K5 and K7 (tests/test_torch_window_kernels.py on the CPU and on
the card). Imports no JAX."""

import numpy as np
import torch

from torch_di_spatial_cases import di_spatial_args


def window(x, height, row0, rows, halo):
    """Rows row0 - halo .. row0 + rows + halo - 1 of an (H, ...) image or
    raster-flat (H*W, ...) field, zero-filled beyond the image (what
    parallel/halo.exchange_rows gives a band)."""
    flat = x.shape[0] != height
    img = x.reshape((height, -1) + tuple(x.shape[1:])) if flat else x
    out = img.new_zeros((rows + 2 * halo,) + tuple(img.shape[1:]))
    lo, hi = max(row0 - halo, 0), min(row0 + rows + halo, height)
    out[lo - (row0 - halo):hi - (row0 - halo)] = img[lo:hi]
    return out.reshape((-1,) + tuple(x.shape[1:])) if flat else out


def di_spatial_band(taps, seed, width, height, row0, rows, halo,
                    device="cpu"):
    """(whole-frame di_spatial args, the band's args, the window keywords
    row0 / halo / h_global, the band's lanes)."""
    whole = di_spatial_args(taps, seed, width, height, device)
    (table, seeds, center, taps, pending, gnormal, gdepth, cur, pos, normal,
     view, albedo, rough, metal, w, h, clamps) = whole
    lanes = slice(row0 * w, (row0 + rows) * w)

    def win(x):
        return window(x, h, row0, rows, halo).contiguous()

    band = (table, seeds[lanes], {k: win(v) for k, v in center.items()},
            taps, pending[lanes], win(gnormal), win(gdepth), cur[lanes],
            pos[lanes], normal[lanes], view[lanes], albedo[lanes],
            rough[lanes], metal[lanes], w, rows, clamps)
    return whole, band, dict(row0=row0, halo=halo, h_global=h), lanes


def atrous_window(guides, row0, rows, hp):
    """A band's a-trous window (hp rows above and below) of whole (H, W,
    ...) guides, and the pass's row0 / h_global."""
    h = guides[0].shape[0]
    win = tuple(window(g, h, row0, rows, hp).contiguous() for g in guides)
    return win, dict(row0=row0 - hp, h_global=h)


def same_bits(a, b):
    """Tensors equal bit for bit (floats compared as their int32 words)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def atrous_guides(h, w, seed):
    """tests/test_torch_postprocess.py's guides: a sky band, bypassed
    patches, two normal planes, albedo zeros."""
    rng = np.random.default_rng(seed)
    color = (rng.uniform(size=(h, w, 3)) * 2.0).astype(np.float32)
    depth = (1.0 + 3.0 * rng.uniform(size=(h, w))).astype(np.float32)
    depth[: h // 8] = 100000.0
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    normal[:, w // 2:] = (0.0, 1.0, 0.0)
    normal += rng.normal(size=normal.shape).astype(np.float32) * 0.05
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    rough = rng.uniform(size=(h, w)).astype(np.float32)
    diffuse = rng.uniform(size=(h, w, 3)).astype(np.float32)
    diffuse[::7, ::5] = 0.0
    return tuple(torch.from_numpy(x) for x in
                 (color, depth, normal, rough, diffuse))
