"""First-bounce noise texture.

The reference samples a checked-in blue-noise PNG (util_files/noise.png,
loaded at lib.rs:281-299) for the first BRDF bounce's random pair, offset per
frame by golden-ratio-like constants (ray_gen_final.slang:44-50,393-399). We
generate an R2 low-discrepancy lattice instead of shipping an asset: the
plastic-constant sequence has blue-noise-like spectral distribution and is
deterministic. Texture size 64x64 (the reference's noise.png is also small
and tiled by `pixel % size`).
"""

from __future__ import annotations

import numpy as np

NOISE_SIZE = 64
# Plastic-constant (R2 sequence) increments; the same constants the reference
# uses for per-frame offsets (ray_gen_final.slang:394-395).
_A1 = 0.75487766624669276
_A2 = 0.56984029099805326


def noise_texture(size: int = NOISE_SIZE) -> np.ndarray:
    """(size, size) float32 in [0,1): R2 lattice."""
    x = np.arange(size)
    y = np.arange(size)
    xx, yy = np.meshgrid(x, y)
    return np.mod(_A1 * xx + _A2 * yy, 1.0).astype(np.float32)
