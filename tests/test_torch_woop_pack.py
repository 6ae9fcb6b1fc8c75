"""K14's packed Woop records, modelled in plain PyTorch on the CPU.

csrc/trace.cu's staging loop packs each triangle's 22 coefficients of
the (6, T, 8) table and eps (ops/intersect.woop_matrices) into six
16-byte records in shared memory: three o-rows (r0, r1, r2, c) and three
d-rows (r0, r1, r2, w), w = eps in the first d-row and 0 in the others;
a test reads the six records and nothing else. `woop_records` builds the
same layout and `occluded_from_records` traces with it, reading each
coefficient from its record slot, in the kernel's fmaf order. It must
equal intersect.woop_hits / trace_occluded_woop bit for bit on 1, 36,
129 and 300 triangles (degenerate ones included), with and without
exclude ids, and the JAX trace_occluded_woop in interpret mode on the
same seeded rays. The kernel is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops import pallas_trace as jpt
from sunray_tpu_torch.ops import cuda_trace, intersect
from sunray_tpu_torch.ops.fp import fma
from torch_parity import n, t


def woop_records(woop):
    """(T, 6, 4) float32: the kernel's shared-memory records of each
    triangle, o-rows then d-rows."""
    a, eps = woop
    o = a[0:3, :, 0:4]
    d = torch.cat([a[3:6, :, 4:7], torch.zeros_like(a[3:6, :, :1])], dim=-1)
    d[0, :, 3] = eps[:, 0]
    return torch.cat([o, d]).permute(1, 0, 2).contiguous()


def hits_from_records(rec, orig, d, tmin, tmax):
    """(B, T) hit mask from the records alone, in csrc/trace.cu woop_hit's
    order: dot products fmaf(r2, x2, fmaf(r1, x1, r0 * x0)) (+ c)."""
    ox, oy, oz = (orig[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    uo, vo, wo = (fma(rec[:, k, 2], oz, fma(rec[:, k, 1], oy, rec[:, k, 0] * ox))
                  + rec[:, k, 3] for k in range(3))
    ud, vd, wd = (fma(rec[:, k, 2], dz, fma(rec[:, k, 1], dy, rec[:, k, 0] * dx))
                  for k in range(3, 6))
    sw = torch.where(wd >= 0.0, 1.0, -1.0)
    den = wd * sw
    us = fma(uo, wd, -(wo * ud)) * sw
    vs = fma(vo, wd, -(wo * vd)) * sw
    ws = -wo * sw
    return ((den > rec[:, 3, 3]) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= den)
            & (ws >= tmin * den) & (ws <= tmax * den))


def occluded_from_records(rec, orig, d, tmax, exclude=None):
    valid = hits_from_records(rec, orig, d, intersect.T_MIN, tmax[:, None])
    if exclude is not None:
        ids = torch.arange(rec.shape[0], dtype=torch.int32)
        valid = valid & (ids[None, :] != exclude[:, None])
    return valid.any(dim=-1)


def _case(n_tris, seed, k=1500):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    tris = [v0, (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32),
            (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32)]
    tris[2][::17] = tris[0][::17]         # degenerate: a zero edge, eps = inf
    o = (rng.normal(size=(k, 3)) * 2).astype(np.float32)
    dn = rng.normal(size=(k, 3))
    d = (dn / np.linalg.norm(dn, axis=-1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.1, 6.0, size=k).astype(np.float32)
    ex = rng.integers(-1, n_tris, size=k).astype(np.int32)
    return tuple(tris), o, d, tmax, ex


@pytest.mark.parametrize("n_tris", [1, 36, 129, 300])
def test_records_hold_the_woop_rows(n_tris):
    tris, o, d, tmax, _ = _case(n_tris, n_tris)
    woop = intersect.woop_matrices(tuple(t(x) for x in tris))
    rec = woop_records(woop)
    assert rec.shape == (n_tris, 6, 4)
    want = intersect.woop_hits(woop, t(o), t(d), intersect.T_MIN, t(tmax)[:, None])
    got = hits_from_records(rec, t(o), t(d), intersect.T_MIN, t(tmax)[:, None])
    assert torch.equal(got, want)
    assert torch.isinf(rec[::17, 3, 3]).all()       # degenerate: never hit
    assert (rec[:, 4:6, 3] == 0.0).all()


@pytest.mark.parametrize("use_exclude", [False, True])
@pytest.mark.parametrize("n_tris", [1, 36, 129, 300])
def test_records_trace_matches_plain_and_jax(n_tris, use_exclude):
    tris, o, d, tmax, ex = _case(n_tris, 100 + n_tris)
    ex = ex if use_exclude else None
    woop = intersect.woop_matrices(tuple(t(x) for x in tris))
    ex_t = None if ex is None else t(ex)
    got = occluded_from_records(woop_records(woop), t(o), t(d), t(tmax), ex_t)
    plain = cuda_trace.trace_occluded_woop(woop, t(o), t(d), t(tmax), exclude=ex_t)
    assert torch.equal(got, plain)
    want = np.asarray(jpt.trace_occluded_woop(
        tuple(jnp.asarray(x) for x in tris), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), exclude=None if ex is None else jnp.asarray(ex)))
    np.testing.assert_array_equal(n(got), want)
    if n_tris > 1:
        assert 0.0 < want.mean() < 1.0
