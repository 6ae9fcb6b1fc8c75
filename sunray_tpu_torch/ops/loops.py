"""Loop helpers: early-exit wavefront loops with a differentiable variant;
port of sunray_tpu/ops/loops.py.

The bounce walks are masked full-batch loops. A forward frame runs rounds
while `cond` holds (the walks usually end after one or two). Eager
autograd needs no fixed trip count, so a differentiable frame keeps the
same early exit; what it changes is memory: each round after the peeled
ones runs under torch.utils.checkpoint, which keeps the round's carry
and recomputes its body in the backward pass, as the JAX package's
jax.checkpoint around each scan iteration does (loops.py:39-66).

The recompute is exact: the walks draw from PCG streams on explicit
seeds (ops/rng.py), never from torch's generators. It re-launches the
round's trace kernels, so a differentiable frame launches K1/K2 once
more for every checkpointed round.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def checkpointed(fn, *args, enabled=True):
    """fn(*args), its activations recomputed in the backward pass when
    `enabled` and autograd records; else fn(*args) as it is. Nothing in
    the frame draws from torch's generators, so no RNG state is kept."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


class _ScanCarry(torch.autograd.Function):
    """The carry at a boundary of the reference's differentiable scan,
    unchanged. Its backward hands every float tensor of the carry a
    cotangent, zeros where nothing downstream reads it: the transpose of
    jax.lax.scan instantiates the zero cotangents of the carry, so the
    reference's backward runs each round's body for every carry output,
    read or not (0 * inf is NaN there, e.g. an unused bounce direction's
    root at 0, ops/brdf.sample_ggx_vndf)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        return cts


def _scan_carry(carry: dict) -> dict:
    """carry with its float tensors that require grad through _ScanCarry."""
    keys = [k for k, v in carry.items()
            if torch.is_tensor(v) and v.requires_grad]
    if not keys:
        return carry
    out = dict(carry)
    out.update(zip(keys, _ScanCarry.apply(*(carry[k] for k in keys))))
    return out


def bounded_loop(cond, body, init, rounds: int, differentiable: bool,
                 peel: int = 0, loop_body=None):
    """Run `body` on the carry (a dict) while cond(carry) holds. cond
    returns a Python bool and includes the round bound `rounds`.

    peel: rounds run unconditionally first (at most `rounds`), each
    through `body`; the looped rounds run through `loop_body` (default
    `body`), e.g. the walks trace their peeled camera round as coherent.
    Callers keep the body a masked no-op for lanes whose cond already
    failed.
    differentiable: the looped rounds run under checkpointed(), and where
    the reference scans (rounds > peel) the carry passes _ScanCarry at
    each round's boundary, so that its backward reaches every carry
    output as the scan's transpose does."""
    peel = min(peel, rounds)
    scan = differentiable and rounds > peel and torch.is_grad_enabled()
    carry = init
    for _ in range(peel):
        carry = body(carry)
    loop_body = body if loop_body is None else loop_body
    if scan:
        carry = _scan_carry(carry)
    while cond(carry):
        carry = checkpointed(loop_body, carry, enabled=differentiable)
        if scan:
            carry = _scan_carry(carry)
    return carry
