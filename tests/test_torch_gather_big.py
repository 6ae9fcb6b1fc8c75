"""PyTorch port, K8's backward above MAX_ROWS (512) rows and the texel
gradient (ops/cuda_gather.py, ops/texture.py).

- gather_rows_bwd on CPU tensors (index_add_, the plain version of the
  runs path) against jax.vjp of the reference's plain indexing,
  table[clip(idx)] (sunray_tpu/ops/linalg.py:27 above 128 rows), at
  k in {513, 3,518, 70,001}, C in {4, 9, 20} and G in {1, 3, 5}, with
  heavy duplicates (runs longer than a block's 256 threads) and rare ones,
  and indices clamped at both ends;
- gather_rows_bwd_runs_model, the plain model of the kernels' order of
  work (stable order, runs of at most 32 by one thread, longer runs by
  256 threads, the warp's butterfly, the warps in order; float64 sums),
  within 1e-6 of a row's sum of |ct| of the float64 sums, on a cotangent
  read through strides as the card reads it;
- sample_texture's gradient w.r.t. the atlas data (the five texel fetches
  through _TexelFetch) against jax.vjp of JAX's sample_texture.

Tolerance: within 1e-6 of each row's sum of |ct| (float32 sums in other
orders; the float64 model is within float32's last bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from sunray_tpu.ops import texture as jtex
from sunray_tpu_torch.ops import cuda_gather, texture
from test_torch_texture import W, atlas, lookups
from torch_parity import n, t

KS = (513, 3518, 70001)
CS = {4: 1, 9: 3, 20: 5}          # columns: groups
NIDX = 2_003


def case(k, c, g, dup, seed):
    """(ct (G, C, N) float32, idx (G, N) int32) as numpy: "heavy" puts four
    in five indices on six rows (two of them clamped from below and
    above), "rare" spreads them over [-5, k + 5)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-5, k + 5, size=(g, NIDX))
    if dup == "heavy":
        hot = np.asarray([-2, 0, 7, k // 2, k - 1, k + 3])
        pick = rng.random((g, NIDX)) < 0.8
        idx = np.where(pick, hot[rng.integers(0, 6, (g, NIDX))], idx)
    ct = rng.standard_normal((g, c, NIDX)).astype(np.float32)
    return ct, idx.astype(np.int32)


def jax_bwd(ct, idx, k):
    """jax.vjp of the reference's plain gather (G, C, N) w.r.t. the table."""
    c = ct.shape[1]

    def gather(table):
        return jnp.transpose(table[jnp.clip(idx, 0, k - 1)], (0, 2, 1))

    _, vjp = jax.vjp(gather, jnp.zeros((k, c), jnp.float32))
    return np.asarray(vjp(jnp.asarray(ct))[0])


def row_scale(ct, idx, k):
    """Each row's sum of |ct| (float64)."""
    return n(cuda_gather.gather_rows_bwd_plain(t(np.abs(ct)).double(),
                                               t(idx), k))


@pytest.mark.parametrize("dup", ["heavy", "rare"])
@pytest.mark.parametrize("c", sorted(CS))
@pytest.mark.parametrize("k", KS)
def test_plain_matches_jax(k, c, dup):
    ct, idx = case(k, c, CS[c], dup, seed=k + c)
    got = n(cuda_gather.gather_rows_bwd(t(ct), t(idx), k))
    want = jax_bwd(ct, idx, k)
    assert got.shape == (k, c)
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-6 * row_scale(ct, idx, k) + 1e-30)
    # rows no index reaches are exact zeros in both
    hit = np.zeros(k, bool)
    hit[np.clip(idx, 0, k - 1).reshape(-1)] = True
    assert not got[~hit].any() and not want[~hit].any()


@pytest.mark.parametrize("dup", ["heavy", "rare"])
@pytest.mark.parametrize("k", KS)
def test_runs_model_matches_float64_sums(k, dup):
    """The model of the kernels' order, on a (G, N, C) cotangent viewed as
    (G, C, N) (the texel call's layout), within 1e-6 of a row's sum of
    |ct| of the float64 sums; runs above 256 indices exist in "heavy"."""
    c, g = 9, 3
    ct, idx = case(k, c, g, dup, seed=7 * k)
    strided = t(np.ascontiguousarray(ct.transpose(0, 2, 1))).permute(0, 2, 1)
    assert not strided.is_contiguous()
    got = n(cuda_gather.gather_rows_bwd_runs_model(strided, t(idx), k))
    want = n(cuda_gather.gather_rows_bwd_plain(t(ct).double(), t(idx), k))
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-6 * row_scale(ct, idx, k) + 1e-30)
    counts = np.bincount(np.clip(idx, 0, k - 1).reshape(-1), minlength=k)
    assert (counts > cuda_gather.RUN_THREADS).any() == (dup == "heavy")
    assert ((counts > 0) & (counts <= cuda_gather.RUN_SHORT)).any()


def test_runs_model_split_and_order():
    """Runs of 1, RUN_SHORT, RUN_SHORT + 1, 1,000, RUN_CHUNK and
    2 RUN_CHUNK + 7 indices of one row each, interleaved: the model's sums
    equal a float64 sum taken in the kernels' order (one thread in index
    order up to RUN_SHORT; else chunks of RUN_CHUNK positions, in each
    thread t of RUN_THREADS summing positions t, t + RUN_THREADS, ...,
    the warp's butterfly, the warps in order; the chunks in order), bit
    for bit."""
    chunk = cuda_gather.RUN_CHUNK
    lengths = {3: 1, 9: cuda_gather.RUN_SHORT, 11: cuda_gather.RUN_SHORT + 1,
               600: 1000, 640: chunk, 650: 2 * chunk + 7}
    rng = np.random.default_rng(3)
    idx = np.concatenate([np.full(m, r) for r, m in lengths.items()])
    rng.shuffle(idx)
    ct = rng.standard_normal((1, 2, idx.size)).astype(np.float32) * 1e3
    got = n(cuda_gather.gather_rows_bwd_runs_model(t(ct), t(idx[None]
                                                           .astype(np.int32)),
                                                   700))
    for r, m in lengths.items():
        vals = ct[0][:, idx == r].astype(np.float64)        # index order
        if m <= cuda_gather.RUN_SHORT:
            acc = np.zeros(2)
            for e in range(m):
                acc = acc + vals[:, e]
        else:
            acc = None
            for q in range(0, m, chunk):
                lanes = np.zeros((cuda_gather.RUN_THREADS, 2))
                for e in range(q, min(m, q + chunk)):
                    lanes[(e - q) % cuda_gather.RUN_THREADS] += vals[:, e]
                warps = lanes.reshape(-1, 32, 2)
                lane = np.arange(32)
                for off in (16, 8, 4, 2, 1):
                    warps = warps + warps[:, lane ^ off]
                part = warps[0, 0]
                for w in range(1, warps.shape[0]):
                    part = part + warps[w, 0]
                acc = part if acc is None else acc + part
        np.testing.assert_array_equal(got[r], acc.astype(np.float32))
    others = np.setdiff1d(np.arange(700), list(lengths))
    assert not got[others].any()


@pytest.mark.parametrize("filt", [0, 1])
@pytest.mark.parametrize("wrap", [(W[0], W[0]), (W[1], W[2])])
def test_texel_gradient_matches_jax(wrap, filt):
    """d(sum(w * sample)) / d(atlas.data) through the five texel fetches,
    against jax.vjp of JAX's sample_texture; the forward bit-equal to the
    non-differentiable sample."""
    ja, pa = atlas(wrap, filt)
    tex, uv, fb = lookups()
    w = np.random.default_rng(4).standard_normal((tex.size, 4)) \
        .astype(np.float32)

    def jsample(data):
        return jtex.sample_texture(ja.replace(data=data), jnp.asarray(tex),
                                   jnp.asarray(uv), jnp.asarray(fb))

    _, vjp = jax.vjp(jsample, ja.data)
    want = np.asarray(vjp(jnp.asarray(w))[0])
    data = pa.data.clone().requires_grad_()
    leaf = dataclasses.replace(pa, data=data)
    out = texture.sample_texture(leaf, t(tex), t(uv), t(fb))
    got, = torch.autograd.grad(out, data, t(w))
    scale = np.abs(want).max()
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-6 * scale)
    plain = texture.sample_texture(pa, t(tex), t(uv), t(fb))
    assert torch.equal(out.detach(), plain)
