"""PyTorch port, the differentiable ReSTIR frame: the white material's
base_color tie, read two more ways than test_torch_grads_restir.py reads
it (tests/torch_grad_cases.py has the frame).

The white base_color (0.73, 0.73, 0.73) ties its three channels in every
channel max of the ReSTIR target function; how each max splits the tie
sets the white row of the gradient. test_torch_grads_restir.py holds the
port to JAX's gradients from compiles that keep the tie. Here:

  - one jax.jit of the gradient w.r.t. base_color and positions together
    rounds one tied channel an ulp apart: it moves the white row alone,
    by a * (1, 1, -2) (the tie's whole gradient to one channel), and
    every other row equals the port's;
  - JAX without jit (jax.disable_jit, every op rounded alone) shows no
    such move against the port. It rounds without XLA's fused
    multiply-adds, which the port mirrors, so it flips a few reservoir
    picks and differs from the port by ~1e-3 on every row; only the
    white row's (1, 1, -2) component is held, below 5% of the joint
    compile's.

~2 min, nearly all of it the JAX compile and the op-by-op JAX frame.
"""

import numpy as np
import pytest

from torch_grad_cases import (
    assert_grads_close,
    jax_base_color_grad,
    port_value_and_grads,
)

KW = dict(lighting="restir")
WHITE = 0          # scene/procedural.py's first material
MOVE_FLOOR = 5e-4  # the joint compile's move, measured at 1.27e-3
EAGER_SHARE = 0.05


def tie_move(d):
    """a of the least-squares fit of a * (1, 1, -2) to d[:3]."""
    return float(d[0] + d[1] - 2.0 * d[2]) / 6.0


@pytest.fixture(scope="module")
def grads():
    _, port = port_value_and_grads(**KW)
    return port["base_color"], jax_base_color_grad(True, **KW)


def test_joint_compile_moves_only_the_white_tie(grads):
    port, joint = grads
    others = [r for r in range(port.shape[0]) if r != WHITE]
    assert_grads_close(port[others], joint[others], "rows without a tie")
    d = joint[WHITE] - port[WHITE]
    a = tie_move(d)
    assert abs(a) > MOVE_FLOOR, d
    np.testing.assert_allclose(d[:3], a * np.array([1.0, 1.0, -2.0]),
                               rtol=1e-2, err_msg="not a tie split")


def test_unjitted_jax_has_no_tie_move(grads):
    port, joint = grads
    eager = jax_base_color_grad(False, **KW)
    assert np.abs(eager[WHITE, :3]).min() > 1e-2
    a_eager = tie_move(eager[WHITE] - port[WHITE])
    a_joint = tie_move(joint[WHITE] - port[WHITE])
    print(f"white row: port {port[WHITE]}, un-jitted JAX {eager[WHITE]}, "
          f"joint compile {joint[WHITE]}; tie move un-jitted {a_eager:.3e}, "
          f"joint {a_joint:.3e}; un-jitted against the port, largest "
          f"difference {np.abs(eager - port).max():.3e}, relative "
          f"{(np.abs(eager - port) / np.abs(port).clip(1e-30)).max():.3e}")
    assert abs(a_eager) < EAGER_SHARE * abs(a_joint), (a_eager, a_joint)
