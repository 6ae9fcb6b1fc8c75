"""PyTorch port, the sharded frame's remaining reads on 4 gloo ranks
(tests/torch_dist.py) against the port's single-device render_frame on
the CPU, at tests/test_spmd.py's 64x48 config and bars:
sharding.render_frame_sharded on the (1, 4) mesh with edge
antialiasing (static camera, 2e-5) and under fast motion, the camera
moving far beyond the configured 16-row history halo (2e-4; its history
halo reaches the whole image, so no reprojected history is discarded at
a band edge), at least 99.5% of pixels, all finite; and the row-sharded
frame with taa_kernel="pallas", whose CPU tensors take K9's plain
window twin, bit-equal to taa_kernel="jnp". The single-device frames
run in this process while the ranks run."""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread in this process)
from torch_dist import (
    SPMD_KW,
    assert_close_frames,
    run_ranks,
    sharded_runs,
    single_frames,
)

AA_KW = dict(SPMD_KW, edge_antialias=True)
RUNS = {"aa": ("sharded", AA_KW, "static", 2),
        "fast": ("sharded", SPMD_KW, "fast", 3),
        "taa_jnp": ("spmd", dict(SPMD_KW, taa_kernel="jnp"), "slow", 3),
        "taa_pallas": ("spmd", dict(SPMD_KW, taa_kernel="pallas"), "slow",
                       3)}


@pytest.fixture(scope="module")
def frames():
    names = list(RUNS)
    got, ref = run_ranks(
        4, sharded_runs, [RUNS[k] for k in names],
        meanwhile=lambda: {k: single_frames(*RUNS[k][1:])
                           for k in ("aa", "fast")})
    return {k: [r[i] for r in got] for i, k in enumerate(names)}, ref


def test_edge_antialias_matches_single_device(frames):
    got, ref = frames
    assert_close_frames(ref["aa"], got["aa"][0], 2e-5, 2e-5)


def test_fast_motion_matches_single_device(frames):
    got, ref = frames
    assert_close_frames(ref["fast"], got["fast"][0], 2e-4, 2e-4)
    for ldr in got["fast"][0]:
        assert ldr.max() > 0.01


@pytest.mark.parametrize("name", ["aa", "fast", "taa_pallas"])
def test_every_rank_has_the_same_image(frames, name):
    got, _ = frames
    for r in got[name][1:]:
        for a, b in zip(got[name][0], r):
            np.testing.assert_array_equal(a, b)


def test_taa_kernel_pallas_is_the_plain_window_on_the_cpu(frames):
    got, _ = frames
    for a, b in zip(got["taa_jnp"][0], got["taa_pallas"][0]):
        np.testing.assert_array_equal(b, a)


def test_history_halo_reaches_the_whole_image():
    """render_frame_sharded's grid: halo_t = H - hl (and the spmd frame's
    the configured 16 rows); the boundary term's flag on."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.halo import make_grid

    cfg = RenderConfig(**SPMD_KW)
    grid = make_grid(cfg, whole_frame=True)
    assert (grid.halo_t, grid.whole_frame) == (max(cfg.height - grid.hl, 1),
                                               True)
    assert make_grid(cfg).halo_t == cfg.history_gather_halo == 16
