"""Multiply-adds rounded the way the reference rounds them.

XLA's CPU backend, which renders the goldens, contracts a multiply that
feeds an add inside one fused computation into a fused multiply-add: one
rounding instead of two. A length-3 sum of products (jnp.sum(a * b, -1),
jnp.linalg.norm) becomes fma(a2, b2, fma(a1, b1, a0 * b0)), and a cross
product component a1*b2 - a2*b1 becomes fma(a1, b2, -(a2 * b1)). Holding
the trace decisions to the reference at crack edges (a ray through the
shared edge of two quads) needs the same roundings, so the geometry that
feeds the tracer uses these helpers, and csrc/trace.cu calls fmaf() in the
same places.

fma() is computed in float64: the product of two float32 values is exact
there, so the one float64 rounding of the sum followed by the float32
rounding differs from a true fused multiply-add only when the float64
result sits exactly on a float32 rounding midpoint.
"""

from __future__ import annotations

import torch


def _f64(x):
    """float64 copy of a float32 tensor, or the float32 value of a scalar."""
    if torch.is_tensor(x):
        return x.double()
    return torch.tensor(x, dtype=torch.float32).item()


def fma(a, b, c):
    """float32 a * b + c with the product unrounded. Scalars act as the
    float32 constants the reference would hold."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def dot3(x0, y0, x1, y1, x2, y2):
    """x0*y0 + x1*y1 + x2*y2 as XLA's CPU backend contracts it."""
    return fma(x2, y2, fma(x1, y1, x0 * y0))


def cross3(a, b):
    """Components of a x b for tuples of three tensors."""
    return (
        fma(a[1], b[2], -(a[2] * b[1])),
        fma(a[2], b[0], -(a[0] * b[2])),
        fma(a[0], b[1], -(a[1] * b[0])),
    )


def dot(a, b):
    """Sum over the last axis (size 3) of a * b."""
    return dot3(a[..., 0], b[..., 0], a[..., 1], b[..., 1], a[..., 2], b[..., 2])


def cross(a, b):
    """Cross product of (..., 3) vectors."""
    return torch.stack(
        cross3((a[..., 0], a[..., 1], a[..., 2]), (b[..., 0], b[..., 1], b[..., 2])),
        dim=-1,
    )
