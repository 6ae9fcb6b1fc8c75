"""PyTorch port, the binned tracer's block path (interval cull, work
lists, K10, with and without the coherence reorder) against
sunray_tpu/ops/binned_trace.py's trace_closest_binned /
trace_occluded_binned, its Pallas kernels in interpret mode, on the same
numpy inputs (tests/torch_binned_cases.py): hit / occluded equal, t/u/v
within 1e-6 relative (1e-7 absolute), tri equal on >= 99.9% of hits (the
bar of tests/test_binned_trace.py:41-49; on these inputs they agree on
every ray). The pair stream's traces are in
tests/test_torch_binned_pairs.py.
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


PATHS = ["block", "block_reorder"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["random", "camera", "center", "away"])
def test_closest_matches_jax(scene, kind, path):
    _, (jcs, pcs) = scene
    o, d, tmax, ex = rays(kind, 1100, 17)
    reorder = path == "block_reorder"
    want = jbt.trace_closest_binned(jcs, jnp.asarray(o), jnp.asarray(d),
                                    tmax=jnp.asarray(tmax),
                                    exclude=jnp.asarray(ex), reorder=reorder)
    got = pbt.trace_closest_binned(pcs, t(o), t(d), tmax=t(tmax),
                                   exclude=t(ex), reorder=reorder)
    check_hits(got, want)
    assert (kind == "away") == (not n(got.hit).any())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["random", "center"])
def test_occluded_matches_jax(scene, kind, path):
    _, (jcs, pcs) = scene
    o, d, tmax, ex = rays(kind, 1100, 19)
    reorder = path == "block_reorder"
    want = jbt.trace_occluded_binned(jcs, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(tmax), exclude=jnp.asarray(ex),
                                     reorder=reorder)
    got = pbt.trace_occluded_binned(pcs, t(o), t(d), t(tmax), exclude=t(ex),
                                    reorder=reorder)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert 0.0 < n(got).mean() < 1.0
