"""PyTorch port, the window forms of K5, K6 and K7 that the row-sharded
frame runs (parallel/spmd.py): a band of rows at global row row0 of an
h_global-row image, its neighbours read from a window of halo rows above
and below, zero-filled beyond the image.

On the CPU: K5's plain window form (di_spatial_plain with row0, halo,
h_global) on bands at the top, middle and bottom of seeded frames is
bit-equal to the whole-frame plain version on the band's lanes; K6's
taps cut from a window (cuda_restir.shift_window, neighbour_ok) are the
whole frame's on every lane whose neighbour is on the image; K7's plain
window pass (atrous_denoise_pass with row0, h_global) is within 1e-5 of
the JAX package's grid pass (postprocess.atrous_denoise_pass with the
same row0 / h_global, which atrous_denoise_grid runs) and bit-equal to
the whole-image pass on the band's rows. On the card (marked gpu, skipped
here): K5's window kernel bit-equal to its plain window form, K7's
within 1e-5, and both window entry points at row0 0 with no halo
bit-equal to the whole-frame kernels."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread in this process)
from sunray_tpu.render import postprocess as jpost
from sunray_tpu_torch.ops import cuda_image, cuda_restir
from torch_di_spatial_cases import FIELDS
from torch_parity import n
from torch_window_cases import (
    atrous_guides,
    atrous_window,
    di_spatial_band,
    same_bits,
    window,
)

W, H, HL, HALO = 32, 24, 6, 7
BANDS = [0, 6, 18]                       # top, middle, bottom
TAPS = [(-5, 7), (3, -7), (0, 4), (31, 0), (-2, -1)]


@pytest.mark.parametrize("row0", BANDS)
def test_di_spatial_window_plain_is_whole_frame(row0):
    whole, band, win, lanes = di_spatial_band(TAPS, 5 + row0, W, H, row0,
                                              HL, HALO)
    seed_w, want = cuda_restir.di_spatial_plain(*whole)
    seed_b, got = cuda_restir.di_spatial_plain(*band, **win)
    assert torch.equal(seed_b, seed_w[lanes])
    for k in FIELDS:
        assert same_bits(got[k], want[k][lanes]), k
    assert 0.0 < got["has"].float().mean().item() < 1.0


@pytest.mark.parametrize("row0", BANDS)
def test_gi_taps_from_window_are_whole_frame(row0):
    """The GI tap fields and neighbour test K6's planes are built from:
    shift_window of a window equals shift_flat of the whole frame on every
    lane whose neighbour is on the image, and the tests agree."""
    whole, band, win, lanes = di_spatial_band(TAPS, 9, W, H, row0, HL, HALO)
    normal, cur = whole[9], whole[7]
    for dx, dy in TAPS:
        ok_w, nd_w = cuda_restir.neighbour_ok(dx, dy, W, H, normal, cur,
                                              whole[5], whole[6])
        ok_b, nd_b = cuda_restir.neighbour_ok(dx, dy, W, HL, normal[lanes],
                                              cur[lanes], band[5], band[6],
                                              **win)
        assert torch.equal(ok_b, ok_w[lanes])
        assert torch.equal(nd_b[ok_b], nd_w[lanes][ok_b])
        for k in ("light_pos", "W", "light_idx"):
            got = cuda_restir.shift_window(band[2][k], dx, dy, W, HL, HALO)
            want = cuda_restir.shift_flat(whole[2][k], dx, dy, H, W)[lanes]
            assert torch.equal(got[ok_b], want[ok_b]), k


STEPS = (1, 2, 4, 8)
A_H, A_W, A_ROWS = 48, 40, 16


@functools.lru_cache(maxsize=None)
def _atrous_case(row0):
    """Each step's window of seeded guides around the band at row0, the
    port's plain window pass and the JAX grid pass on it (all four steps
    in one jit, row0 traced: one compile for every band)."""
    wins = [atrous_window(atrous_guides(A_H, A_W, seed=s), row0, A_ROWS,
                          2 * s) for s in STEPS]
    got = [cuda_image.atrous_denoise_pass(*win, s, **kw)
           for (win, kw), s in zip(wins, STEPS)]
    want = _jax_passes(tuple(tuple(jnp.asarray(n(g)) for g in win)
                             for win, _ in wins), jnp.int32(row0))
    return got, [np.asarray(x) for x in want]


@jax.jit
def _jax_passes(wins, row0):
    return [jpost.atrous_denoise_pass(*win, s, row0=row0 - 2 * s,
                                      h_global=A_H)
            for win, s in zip(wins, STEPS)]


@pytest.mark.parametrize("k", range(len(STEPS)))
@pytest.mark.parametrize("row0", [0, 16, 32])
def test_atrous_window_pass_matches_jax(k, row0):
    step, hp = STEPS[k], 2 * STEPS[k]
    got, want = _atrous_case(row0)
    np.testing.assert_allclose(n(got[k]), want[k], atol=1e-5)
    whole = cuda_image.atrous_denoise_pass(
        *atrous_guides(A_H, A_W, seed=step), step)
    assert same_bits(got[k][hp:hp + A_ROWS], whole[row0:row0 + A_ROWS])


def test_window_cuts_zero_fill():
    x = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    got = window(x, 4, 0, 2, 3)
    assert torch.equal(got[:3], torch.zeros(3, 3))
    assert torch.equal(got[3:7], x)
    assert torch.equal(got[7:], torch.zeros(1, 3))
