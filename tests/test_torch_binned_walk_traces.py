"""PyTorch port, the binned traces made with the plain models of the
kernels' walks (binned_round_warp for K10, pair_round_warp for K12,
ops/cuda_binned.py) against the JAX package's binned tracer, its Pallas
kernels in interpret mode, on tests/torch_big_scene.py's small scene:
camera rays through the block path; bounce rays (closest) and short
visibility segments with exclude ids (any-hit) through the pair stream at
cluster_k 8, whose overflow rays take the block path. Hit and tri equal,
t/u/v within tests/test_torch_binned_trace.py's bar. Each JAX reference
is computed once and held against every walk that makes the same trace.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.ops import binned_trace as jbt
from sunray_tpu_torch.ops import binned_trace as pbt
from sunray_tpu_torch.ops import cuda_binned as cb
from sunray_tpu_torch.ops import intersect
from torch_binned_cases import K, check_hits_exact, cull_scene, jax_pair, walk_case
from torch_parity import n, t


@pytest.fixture(scope="module")
def reference():
    """query -> (port ClusterSet, (o, d, tmax, exclude), JAX result),
    computed at first use."""
    tris, _ = cull_scene()
    cache = {}

    def get(query):
        if query in cache:
            return cache[query]
        if query == "camera_block":
            jcs, pcs = jax_pair(tris, K)
            o, d, tmax, _ = walk_case("camera", tris, pcs)
            want = jbt.trace_closest_binned(jcs, jnp.asarray(o), jnp.asarray(d),
                                            tmax=jnp.asarray(tmax), reorder=True)
            cache[query] = pcs, (o, d, tmax, None), want
            return cache[query]
        jcs, pcs = jax_pair(tris, 8)
        o, d, tmax, ex = (x[:1500] for x in walk_case(
            "short" if query == "visibility_pairs" else "bounce", tris, pcs))
        _, cnt = pbt._cluster_scan(pcs, *pbt._prep(t(o), t(d), intersect.T_MIN,
                                                    t(tmax), None)[:4])
        assert (cnt > cb.L_SLOTS).any()              # the fallback runs
        if query == "bounce_pairs":
            want = jbt.trace_closest_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                           tmax=jnp.asarray(tmax))
        else:
            want = jbt.trace_occluded_pairs(jcs, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(tmax),
                                            exclude=jnp.asarray(ex))
        cache[query] = pcs, (o, d, tmax, ex), want
        return cache[query]

    return get


def _check(query, reference):
    """The port's trace of `query` with whatever the kernels are patched to,
    against the JAX reference."""
    cs, (o, d, tmax, ex), want = reference(query)
    if query == "camera_block":
        check_hits_exact(pbt.trace_closest_binned(cs, t(o), t(d), tmax=t(tmax),
                                                  reorder=True), want)
    elif query == "bounce_pairs":
        check_hits_exact(pbt.trace_closest_pairs(cs, t(o), t(d), tmax=t(tmax)),
                         want)
    else:
        got = pbt.trace_occluded_pairs(cs, t(o), t(d), t(tmax), exclude=t(ex))
        np.testing.assert_array_equal(n(got), np.asarray(want))
        assert 0.0 < n(got).mean() < 1.0


def _k10_walk(monkeypatch):
    monkeypatch.setattr(cb, "binned_round",
                        lambda *a, **kw: cb.binned_round_warp(*a, **kw)[0])


@pytest.mark.parametrize("query", ["camera_block", "bounce_pairs",
                                   "visibility_pairs"])
def test_warp_walk_traces_match_jax(reference, query, monkeypatch):
    """K10 as its warp walk."""
    _k10_walk(monkeypatch)
    _check(query, reference)


@pytest.mark.parametrize("query", ["bounce_pairs", "visibility_pairs"])
def test_pair_walk_traces_match_jax(reference, query, monkeypatch):
    """K12 as its warp walk (and the fallback's K10 as its own); the pair
    lanes' slot reduction and the merge with the fallback as they are."""
    _k10_walk(monkeypatch)
    calls = []

    def pair_walk(*args, **kw):
        out, tests = cb.pair_round_warp(*args, **kw)
        calls.append(tests)
        return out

    monkeypatch.setattr(cb, "pair_round", pair_walk)
    _check(query, reference)
    assert len(calls) == 1 and calls[0] > 0
