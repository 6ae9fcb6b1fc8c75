"""PyTorch port, the ReSTIR frame with four samples a pixel against the
JAX frame at the golden size, three frames: the checks of
test_torch_frame_samples.py (PSNR > 40 dB, raw within 1e-4, the walk
rounds, the rays of every sample), in a file of its own so that
--dist loadfile compiles its JAX frame in another worker.
"""

import pytest

import test_torch_frame_samples as checks
from torch_frame_cases import run_frames


@pytest.fixture(scope="module")
def frames():
    return run_frames(checks.CASES["restir_s4"], checks.FRAMES)


def test_frame_matches_jax(frames):
    checks.test_frame_matches_jax(frames)


def test_raw_and_rounds_match_jax(frames):
    checks.test_raw_and_rounds_match_jax(frames)


def test_rays_count_every_sample(frames):
    checks.test_rays_count_every_sample(frames)
