"""PyTorch port, the ReSTIR frame with per-pixel spatial taps
(spatial_taps="perpixel", the reference-exact estimator of
sunray_tpu/config.py:162-170 that the converged truths of
tests/test_quality.py were made with): render_frame against the JAX
render_frame at the golden size, three frames. The taps run as plain
PyTorch on both devices, as JAX runs them as jnp (use_di_kernel needs
shared taps, pathtrace.py:722-725): per tap two draws for the disc
offset, a gather at the clamped pixel, the target function and a merge
draw, in JAX's order; the GI taps one visibility trace each.

Bars: PSNR > 40 dB on ldr, aux["raw"] within 1e-4, and the reservoirs
each frame hands the next by the take-flip scheme (M equal, winner,
position and W agreeing on more than 99.5% of lanes).
"""

import numpy as np
import pytest

from torch_frame_cases import port_frame, reservoir_agreement, run_frames
from torch_parity import GOLDEN_KW, WINNER_AGREE, n, psnr

FRAMES = 3
PSNR_MIN = 40.0
KW = dict(GOLDEN_KW, lighting="restir", spatial_taps="perpixel")


@pytest.fixture(scope="module")
def frames():
    return run_frames(KW, FRAMES)


def test_frame_matches_jax(frames):
    for i, ((jl, _, _), (pl, _, _)) in enumerate(zip(frames["jax"],
                                                     frames["port"])):
        assert np.isfinite(pl).all()
        p = psnr(pl, jl)
        assert p > PSNR_MIN, f"frame {i}: PSNR vs JAX {p:.2f} dB"


def test_raw_matches_jax(frames):
    for (_, ja, _), (_, pa, _) in zip(frames["jax"], frames["port"]):
        np.testing.assert_allclose(n(pa["raw"]), ja["raw"], atol=1e-4)


@pytest.mark.parametrize("res,win,pos", [
    ("res_di", "light_idx", "light_pos"),
    ("res_gi", "sample_tri", "sample_pos")])
def test_reservoirs_match_jax(frames, res, win, pos):
    for i, ((_, _, js), (_, _, st)) in enumerate(zip(frames["jax"],
                                                     frames["port"])):
        agree = reservoir_agreement(st, js, res, win, pos)
        assert agree > WINNER_AGREE, f"frame {i} {res}: {agree}"


def test_perpixel_differs_from_shared(frames):
    """The option reaches pass 2: the shared-tap frame is another image."""
    shared, _ = port_frame(frames, spatial_taps="shared")
    assert psnr(frames["port"][0][0], shared) < 80.0
