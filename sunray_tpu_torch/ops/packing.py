"""GPU pack/unpack formats and octahedral normal encoding — port of
sunray_tpu/ops/packing.py.

Bit-compatible with shaders/rt_utils.slang:68-114 (the GLSL pack/unpack
builtins) and with the JAX package. torch has no uint32 arithmetic, so a
packed word is carried as int32 holding the same 32 bits (view it as
uint32 with numpy's .view(np.uint32)); words are assembled in int64 and
wrapped to int32, and every right shift that must be logical is masked
after the (arithmetic) int32 shift. No module calls these yet; the
differentiable frame keeps float32 (packing is a hard quantization).

The results are those of the jitted JAX functions, bit for bit: XLA folds
a division by a constant into a multiplication by its float32
reciprocal, so the unpacks multiply by 1/32767 and 1/255 (an eager JAX
call divides, and differs in the last bit on some words). Half-float NaNs
are converted in integer arithmetic, as XLA's CPU converts them (payload
kept, quiet bit set): torch's CPU and CUDA conversions make every NaN
canonical.
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import fp


_INV_SNORM = 1.0 / 32767.0   # float32(1/32767): XLA's folded reciprocal
_INV_UNORM = 1.0 / 255.0


def _word(x):
    """int64 tensor holding a value in [0, 2^32) -> int32 with its bits."""
    return (x & 0xFFFFFFFF).to(torch.int32)


def _to_int(x):
    """float -> integer as XLA converts: NaN becomes 0 (the values here
    are already clipped, so no other saturation is reachable)."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), x).to(torch.int64)


def pack_snorm_2x16(v):
    """rt_utils.slang:68-71. v: (..., 2) float -> (...,) int32 word."""
    i = _to_int(torch.round(torch.clamp(v, -1.0, 1.0) * 32767.0))
    return _word((i[..., 0] & 0xFFFF) | ((i[..., 1] & 0xFFFF) << 16))


def unpack_snorm_2x16(p):
    """rt_utils.slang:72-76."""
    p = p.to(torch.int32)
    x = ((p & 0xFFFF) ^ 0x8000) - 0x8000     # sign-extend the low half
    y = p >> 16                              # arithmetic: the high half
    v = torch.stack([x, y], dim=-1).to(torch.float32) * _INV_SNORM
    return torch.clamp(v, -1.0, 1.0)


def pack_unorm_4x8(v):
    """rt_utils.slang:77-80. v: (..., 4) float -> (...,) int32 word."""
    c = _to_int(torch.round(torch.clamp(v, 0.0, 1.0) * 255.0))
    return _word(c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
                 | (c[..., 3] << 24))


def unpack_unorm_4x8(p):
    """rt_utils.slang:81-88."""
    p = p.to(torch.int32)
    return torch.stack(
        [((p >> s) & 0xFF).to(torch.float32) * _INV_UNORM
         for s in (0, 8, 16, 24)],
        dim=-1,
    )


def _f32_to_f16_bits(x):
    x = x.to(torch.float32)
    h = x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    b = x.view(torch.int32).to(torch.int64)
    nan = ((b >> 31) << 15) & 0x8000 | 0x7E00 | ((b & 0x7FFFFF) >> 13)
    return torch.where(torch.isnan(x), nan, h)


def _f16_bits_to_f32(bits):
    """bits: int32 in [0, 2^16) -> float32."""
    f = bits.to(torch.int16).view(torch.float16).to(torch.float32)
    mant = bits & 0x3FF
    nan = (((bits >> 15) << 31) | 0x7FC00000 | (mant << 13)).view(
        torch.float32)
    return torch.where(((bits & 0x7C00) == 0x7C00) & (mant != 0), nan, f)


def pack_half_2x16(v):
    """rt_utils.slang:89-91. v: (..., 2) float -> (...,) int32 word."""
    return _word(_f32_to_f16_bits(v[..., 0])
                 | (_f32_to_f16_bits(v[..., 1]) << 16))


def unpack_half_2x16(p):
    """rt_utils.slang:92-94."""
    p = p.to(torch.int32)
    # int32 -> int16 keeps the low 16 bits; the high half's shift is
    # masked so that a set top bit does not smear.
    return torch.stack(
        [_f16_bits_to_f32(p & 0xFFFF), _f16_bits_to_f32((p >> 16) & 0xFFFF)],
        dim=-1,
    )


def _sign_not_zero(v):
    return torch.where(v >= 0.0, 1.0, -1.0)


def pack_normal(n):
    """Octahedral normal packing (rt_utils.slang:101-105).

    n: (..., 3) unit vectors -> (...,) int32 words.
    """
    a = torch.abs(n)
    n = n / (a[..., 0:1] + a[..., 1:2] + a[..., 2:3])
    xy = n[..., :2]
    folded = (1.0 - torch.abs(n[..., [1, 0]])) * _sign_not_zero(xy)
    p = torch.where(n[..., 2:3] >= 0.0, xy, folded)
    return pack_snorm_2x16(p)


def unpack_normal(p):
    """rt_utils.slang:107-114. -> (..., 3) unit vectors."""
    v = unpack_snorm_2x16(p)
    z = 1.0 - torch.abs(v[..., 0]) - torch.abs(v[..., 1])
    t = torch.clamp(-z, min=0.0)
    x = v[..., 0] + torch.where(v[..., 0] >= 0.0, -t, t)
    y = v[..., 1] + torch.where(v[..., 1] >= 0.0, -t, t)
    n = torch.stack([x, y, z], dim=-1)
    return n / fp.sqrt(fp.dot(n, n))[..., None]
