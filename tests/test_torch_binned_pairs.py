"""PyTorch port, the binned tracer's pair stream (K11, the pair sort, K12,
the slot reduction and the overflow fallback) against
sunray_tpu/ops/binned_trace.py's trace_closest_pairs /
trace_occluded_pairs, its Pallas kernels in interpret mode, on the same
numpy inputs and with the comparison of tests/test_torch_binned_trace.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.ops import binned_trace as jbt
from sunray_tpu_torch.ops import binned_trace as pbt
from torch_binned_cases import SCENES, check_hits, rays
from torch_parity import n, t


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return request.param, SCENES[request.param]()


PATHS = ["pairs"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["random", "camera", "center", "away"])
def test_closest_matches_jax(scene, kind, path):
    _, (jcs, pcs) = scene
    o, d, tmax, _ = rays(kind, 1100, 17)
    want = jbt.trace_closest_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                   tmax=jnp.asarray(tmax))
    got = pbt.trace_closest_pairs(pcs, t(o), t(d), tmax=t(tmax))
    check_hits(got, want)
    assert (kind == "away") == (not n(got.hit).any())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["random", "center"])
def test_occluded_matches_jax(scene, kind, path):
    _, (jcs, pcs) = scene
    o, d, tmax, ex = rays(kind, 1100, 19)
    want = jbt.trace_occluded_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(tmax), exclude=jnp.asarray(ex))
    got = pbt.trace_occluded_pairs(pcs, t(o), t(d), t(tmax), exclude=t(ex))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert 0.0 < n(got).mean() < 1.0
