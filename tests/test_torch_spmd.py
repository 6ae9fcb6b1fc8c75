"""PyTorch port, the row-sharded frame (parallel/spmd.py) on gloo ranks
(tests/torch_dist.py) against the port's single-device render_frame on
the CPU, at the bars of tests/test_spmd.py: 4 ranks at its 64x48 config
(test_spmd.py:31-38), a static camera for 3 frames (2e-5), the slow
orbit (2e-4) and per-pixel taps (2e-5) on at least 99.5% of pixels, and
fast motion finite and lit; the realistic shard height (256x544 over 8
ranks, 68 rows a rank, the reference radii: DI 30, GI 20, 4 a-trous
passes, halo_t 16; test_spmd.py:127-157); and on one rank the sharded
frame bit-equal to render_frame. Every rank's traffic tally is the same
JAX-counted bytes. The single-device frames run in this process while
the ranks run."""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread in this process)
from torch_dist import (
    SPMD_KW,
    assert_close_frames,
    mesh_frames,
    run_ranks,
    single_frames,
    spmd_frames,
)

RUNS = {"static": (SPMD_KW, "static", 3), "slow": (SPMD_KW, "slow", 3),
        "fast": (SPMD_KW, "fast", 3),
        "perpixel": (dict(SPMD_KW, spatial_taps="perpixel"), "static", 2)}
REAL_KW = dict(SPMD_KW, width=256, height=544, di_spatial_samples=5,
               di_spatial_radius=30.0, gi_spatial_samples=3,
               gi_spatial_radius=20.0, denoise_passes=4)


def _refs(names):
    return {k: single_frames(*RUNS[k]) for k in names}


@pytest.fixture(scope="module")
def four():
    names = list(RUNS)
    got, ref = run_ranks(4, spmd_frames, [RUNS[k] for k in names],
                         meanwhile=lambda: _refs(("static", "slow",
                                                  "perpixel")))
    return {k: [r[i] for r in got] for i, k in enumerate(names)}, ref


def test_static_matches_single_device(four):
    got, ref = four
    assert_close_frames(ref["static"], got["static"][0][0], 2e-5, 2e-5)


def test_slow_motion_matches_single_device(four):
    got, ref = four
    assert_close_frames(ref["slow"], got["slow"][0][0], 2e-4, 2e-4)


def test_perpixel_taps_match_single_device(four):
    got, ref = four
    assert_close_frames(ref["perpixel"], got["perpixel"][0][0], 2e-5, 2e-5)


def test_fast_motion_stays_finite(four):
    got, _ = four
    for ldr in got["fast"][0][0]:
        assert np.isfinite(ldr).all()
        assert ldr.max() > 0.01


def test_every_rank_gathers_the_same_image(four):
    got, _ = four
    for name, ranks in got.items():
        for r in ranks[1:]:
            for a, b in zip(ranks[0][0], r[0]):
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_traffic_tally(four):
    """Each frame's tally on every rank: the hop bytes of every exchange
    (450,560 at this config and 4 or 8 ranks, the JAX count,
    tests/test_torch_spmd_jax.py). An edge rank sends every hop in one
    direction only, half of them; a middle rank more, but not the second
    hop of the 16-row temporal halo past an edge."""
    got, _ = four
    for rank, r in enumerate(got["slow"]):
        for t in r[1]:
            assert t["bytes"] == 450560
            if rank in (0, 3):
                assert t["sent_bytes"] == t["bytes"] // 2
            else:
                assert t["bytes"] // 2 < t["sent_bytes"] < t["bytes"]


def test_realistic_shard_height():
    cfg = REAL_KW
    hl = cfg["height"] // 8
    halo_s = int(max(cfg["di_spatial_radius"], cfg["gi_spatial_radius"])) + 1
    assert hl >= max(halo_s, 16, 2 * (1 << (cfg["denoise_passes"] - 1)))
    got, ref = run_ranks(8, spmd_frames, [(cfg, "static", 2)],
                         meanwhile=lambda: single_frames(cfg, "static", 2))
    assert_close_frames(ref, got[0][0][0], 2e-5, 2e-5)


def test_world_one_is_render_frame():
    """One gloo rank: the sharded frame is render_frame bit for bit."""
    names = ("static", "slow")
    got, ref = run_ranks(1, spmd_frames, [RUNS[k] for k in names],
                         meanwhile=lambda: _refs(names))
    for i, k in enumerate(names):
        for a, b in zip(ref[k], got[0][i][0]):
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_render_frame_sharded_on_a_mesh(four):
    """make_mesh() over 4 ranks is (2, 2): each dp row renders the frame
    over its 2 sp ranks and every rank gets the whole image."""
    _, ref = four
    got = run_ranks(4, mesh_frames, SPMD_KW, 3)
    for rank, (place, ldrs, rep, rows) in enumerate(got):
        assert place == (2, 2, rank // 2, rank % 2)
        assert_close_frames(ref["static"], ldrs, 2e-5, 2e-5)
        np.testing.assert_array_equal(rep, np.zeros(3, np.float32))
        hl = SPMD_KW["height"] // 2
        np.testing.assert_array_equal(
            rows, ldrs[-1][(rank % 2) * hl:(rank % 2 + 1) * hl])
