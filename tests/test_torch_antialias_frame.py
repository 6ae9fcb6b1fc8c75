"""PyTorch port, the differentiable NEE frame with both visibility terms:
edge antialiasing (edge_antialias=True, render/antialias.py) and the
dense shadow-boundary term, against JAX's value_and_grad on the CPU at
the frame of tests/test_grads.py:13-20 (tests/torch_grad_cases.py).
Bars as in test_torch_grads.py: loss 1e-5 relative; gradients within
rtol 1e-4 and a floor of 1e-6 of the largest entry.

The Cornell box's diagonal edges project through pixel centres at this
camera, so a few adjacent pairs cross their edge at e exactly 0 or 1,
where the last bit of the crossing decides whether the pair blends. The
reference rounds those pairs apart in its own compiles: its forward
compile (and the base_color / metallic gradients' compile) fuses the
denominator's scale, fma(pb_u, scale, -pa); a compile that
differentiates the positions fuses the numerator's too (its loss is
1.9e-3 apart on this frame). The port renders as the forward compile
does and is held to it on the loss, base_color and metallic; for the
positions gradient it is given the gradient compile's crossing
(torch_boundary_cases.gradient_compile_crossing) and held to that
compile's loss and gradient.
"""

import numpy as np
import pytest

from sunray_tpu_torch.render import antialias
from torch_boundary_cases import gradient_compile_crossing
from torch_grad_cases import (
    LOSS_RTOL,
    assert_grads_close,
    jax_value_and_grads,
    port_value_and_grads,
)

KW = dict(lighting="nee", shadow_boundary_grads=True, edge_antialias=True)


def port_as_gradient_compile():
    inner = antialias._edge_crossing
    antialias._edge_crossing = gradient_compile_crossing
    try:
        return port_value_and_grads(topology=True, **KW)
    finally:
        antialias._edge_crossing = inner


@pytest.fixture(scope="module")
def grads():
    return (jax_value_and_grads(topology=True, with_positions_value=True,
                                **KW),
            port_value_and_grads(topology=True, **KW),
            port_as_gradient_compile())


def test_loss_matches_jax(grads):
    (jl, _, _), (pl, _), _ = grads
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("param", ["base_color", "metallic"])
def test_gradient_matches_jax(grads, param):
    (_, jg, _), (_, pg), _ = grads
    assert np.isfinite(pg[param]).all()
    assert_grads_close(pg[param], jg[param], param)


def test_positions_gradient_matches_jax(grads):
    (jl, jg, jl_pos), (pl, pg), (pl_pos, pg_pos) = grads
    assert np.isfinite(pg["positions"]).all()
    np.testing.assert_allclose(pl_pos, jl_pos, rtol=LOSS_RTOL)
    assert_grads_close(pg_pos["positions"], jg["positions"], "positions")


def test_reference_compiles_round_the_crossings_apart(grads):
    (jl, _, jl_pos), _, _ = grads
    assert abs(jl_pos - jl) > 1e-4 * abs(jl)


def test_antialias_moves_loss_and_positions(grads):
    _, (pl, pg), _ = grads
    off_l, off_g = port_value_and_grads(topology=True, lighting="nee",
                                        shadow_boundary_grads=True)
    assert pl != off_l
    assert (np.abs(pg["positions"] - off_g["positions"]).max()
            > 0.05 * np.abs(off_g["positions"]).max())
