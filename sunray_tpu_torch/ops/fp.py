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

Two more roundings differ from the reference unless they are written out:

- sqrt(): XLA's square root is correctly rounded; torch's vectorised CPU
  float32 sqrt is not on every value (it moved the last bit of 0.7% of
  the 1080p camera-ray norms). The float64 root of a float32 value,
  rounded to float32, is the correctly rounded float32 root.
- clip(): jnp.clip's gradient at its bounds (half), where torch.clamp
  passes all of it.
- maximum(): jnp.maximum's gradient as a product, the cotangent times 1,
  1/2 or 0, where torch's backward selects: an inf cotangent where the
  bound wins (a square root's at 0) is NaN in JAX and 0 in torch.
- cos(), sin(): XLA's CPU calls glibc's cosf / sinf; the float64 value
  rounded to float32 equals theirs on ~98.7% of [0, 2 pi), torch's
  vectorised float32 functions on ~95%, and it is the same on the card
  (torch's float32 functions differ between the CPU and the card, so
  bounce directions did too).
- pow5(): JAX lowers x ** 5 (lax.integer_pow) to x * ((x*x) * (x*x));
  torch's x ** 5 calls pow, which agrees on about half of all values.
  The CUDA kernels multiply in the same order.
"""

from __future__ import annotations

import torch


def _f64(x):
    """float64 copy of a float32 tensor, or the float32 value of a scalar."""
    if torch.is_tensor(x):
        return x.double()
    return torch.tensor(x, dtype=torch.float32).item()


def _fma_value(a, b, c):
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def _records(*xs) -> bool:
    """True when autograd records an op on these arguments."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(x) and x.requires_grad for x in xs)


class _Fma(torch.autograd.Function):
    """fma's gradient in float32: grad_a = g * b, grad_b = g * a,
    grad_c = g. It saves the float32 operands, where autograd through the
    float64 forward would save their float64 copies. The gradients are
    those of float32 a * b + c, bit for bit; without broadcasting they
    are also those of the float64 graph (the float64 product of two
    float32 values is exact, so rounding it gives the float32 product)."""

    @staticmethod
    def forward(ctx, a, b, c):
        # A scalar operand is kept as its float32 value, a tensor saved.
        ctx.scalars = tuple(None if torch.is_tensor(x) else _f64(x)
                            for x in (a, b))
        ctx.save_for_backward(*(x for x in (a, b) if torch.is_tensor(x)))
        ctx.shapes = tuple(x.shape if torch.is_tensor(x) else None
                           for x in (a, b, c))
        return _fma_value(a, b, c)

    @staticmethod
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        a, b = (next(saved) if x is None else x for x in ctx.scalars)
        ga = gb = gc = None
        if ctx.needs_input_grad[0]:
            ga = (g * b).sum_to_size(ctx.shapes[0])
        if ctx.needs_input_grad[1]:
            gb = (g * a).sum_to_size(ctx.shapes[1])
        if ctx.needs_input_grad[2]:
            gc = g.sum_to_size(ctx.shapes[2])
        return ga, gb, gc


def fma(a, b, c):
    """float32 a * b + c with the product unrounded. Scalars act as the
    float32 constants the reference would hold. Under autograd the
    gradient is computed in float32 (_Fma); a forward frame takes the
    plain float64 expression."""
    if _records(a, b, c):
        return _Fma.apply(a, b, c)
    return _fma_value(a, b, c)


def _sqrt_value(x):
    if x.is_cuda:
        return torch.sqrt(x)
    d = x.double()
    r = torch.sqrt(d).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    dn = torch.nextafter(r, torch.zeros_like(r))
    mid_up = (r.double() + up.double()) * 0.5
    mid_dn = (r.double() + dn.double()) * 0.5
    return torch.where(mid_up * mid_up < d, up,
                       torch.where(mid_dn * mid_dn > d, dn, r))


class _Sqrt(torch.autograd.Function):
    """sqrt's gradient as JAX writes it, g * (0.5 / sqrt(x)), from the
    saved float32 root: the CPU correction's float64 copies are not
    kept."""

    @staticmethod
    def forward(ctx, x):
        out = _sqrt_value(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return g * (0.5 / out)


def sqrt(x):
    """Correctly rounded float32 square root of x >= 0 (torch.sqrt on a
    card is IEEE). On the CPU, torch's root is within an ulp; one exact
    correction step settles it: the midpoint between two neighbouring
    float32 values and its square are exact in float64, so comparing that
    square with x picks the nearer neighbour."""
    if _records(x):
        return _Sqrt.apply(x)
    return _sqrt_value(x)


def cos(x):
    """float32 cos(x) through float64 (the module docstring)."""
    return torch.cos(x.double()).to(torch.float32)


def sin(x):
    """float32 sin(x) through float64 (the module docstring)."""
    return torch.sin(x.double()).to(torch.float32)


def pow5(x):
    """x ** 5 multiplied in lax.integer_pow's order."""
    x2 = x * x
    return x * (x2 * x2)


def clip(x, lo=None, hi=None):
    """jnp.clip(x, lo, hi) with JAX's gradient at a bound: torch.clamp
    passes the whole gradient to x where x equals a bound, jnp.clip (like
    jnp.maximum / jnp.minimum) half of it. Used where a tie with the bound
    is reachable on a differentiable value, e.g. a metallic of exactly 0.
    The values are torch.clamp's."""
    # Bounds made on x's device (new_full), not copied from the host: a
    # blocking copy would wait for the card's queue.
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


class _Maximum(torch.autograd.Function):
    """max(x, lo) for a scalar lo with lax.max's JVP: g * (1 where x > lo,
    1/2 where x == lo, 0 where x < lo), a product, so g * 0 is NaN where g
    is inf or NaN."""

    @staticmethod
    def forward(ctx, x, lo):
        ctx.save_for_backward(x)
        ctx.lo = lo
        return torch.clamp(x, min=lo)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        w = torch.where(x > ctx.lo, 1.0, torch.where(x == ctx.lo, 0.5, 0.0))
        return g * w, None


def maximum(x, lo):
    """jnp.maximum(x, lo) for a float lo, with JAX's gradient (_Maximum);
    the values are torch.clamp's. Used where the reference takes the
    square root of the result, so that its NaN gradients are the port's
    too (ops/brdf.sample_ggx_vndf)."""
    if _records(x):
        return _Maximum.apply(x, float(lo))
    return torch.clamp(x, min=lo)


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


def sum3(x, y):
    """x[0]*y[0] + x[1]*y[1] + x[2]*y[2] written out, as XLA's CPU backend
    contracts it: the left product of the first add is the fused one."""
    return fma(x[2], y[2], fma(x[0], y[0], x[1] * y[1]))
