"""Counter-based PCG RNG, bit-exact with sunray_tpu/ops/rng.py.

The JAX package runs PCG in uint32. torch supports uint32 arithmetic only
in part, so seeds ride int64 tensors holding values in [0, 2^32) and every
multiply and add is masked back to 32 bits. Multiplies are split into
16-bit halves of the constant so no int64 product can overflow.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
# float32(1 / 4294967295), the multiplier of rng.py:51, rounded once.
_INV_U32_MAX = torch.tensor(1.0 / 4294967295.0, dtype=torch.float32).item()


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _u32(x, device=None):
    if not torch.is_tensor(x):
        x = torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def pcg_hash(x):
    """rt_utils.slang:38-45."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def init_seed(pixel_idx, frame):
    """rt_utils.slang:47-52: seed = pcg_hash(pixel_idx ^ pcg_hash(frame))."""
    pixel_idx = _u32(pixel_idx)
    frame = _u32(frame, pixel_idx.device)
    return pcg_hash(pixel_idx ^ pcg_hash(frame))


def rnd(seed):
    """rt_utils.slang:54-59. Returns (new_seed, uniform float32 in [0, 1])."""
    seed = (_mul32(seed, 747796405) + 2891336453) & _MASK
    shift = (seed >> 28) + 4
    word = _mul32((seed >> shift) ^ seed, 277803737)
    result = (word >> 22) ^ word
    return seed, result.to(torch.float32) * _INV_U32_MAX


def rnd2(seed):
    """Two consecutive draws. Returns (new_seed, u1, u2)."""
    seed, u1 = rnd(seed)
    seed, u2 = rnd(seed)
    return seed, u1, u2
