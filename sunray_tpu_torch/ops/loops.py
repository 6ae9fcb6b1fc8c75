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


def bounded_loop(cond, body, init, differentiable: bool, peel: int = 0,
                 loop_body=None):
    """Run `body` on the carry while cond(carry) holds. cond returns a
    Python bool and includes the round bound.

    peel: rounds run unconditionally first, each through `body`; the
    looped rounds run through `loop_body` (default `body`), e.g. the
    walks trace their peeled camera round as coherent. Callers keep the
    body a masked no-op for lanes whose cond already failed.
    differentiable: the looped rounds run under checkpointed()."""
    carry = init
    for _ in range(peel):
        carry = body(carry)
    loop_body = body if loop_body is None else loop_body
    while cond(carry):
        carry = checkpointed(loop_body, carry, enabled=differentiable)
    return carry
