"""PyTorch port, the row-sharded frame on 8 gloo ranks (tests/torch_dist.py)
against the JAX package's make_spmd_step on 8 shards of the conftest's
virtual devices, at test_spmd.py's 64x48 config for 3 frames of fast
motion: the camera moves far beyond the 16-row history halo, so halo
rejection decides which history each pixel reuses, and only the JAX
sharded frame can be the reference there. The port meets test_spmd.py's
moving bar (2e-4 on at least 99.5% of pixels, all finite), and its
traffic tally equals the JAX trace-time tally: 450,560 bytes a shard a
frame. One JAX compile (~30 s), run while the ranks render."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_parity  # noqa: F401  (one torch thread in this process)
from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.parallel.halo import traffic_tally as jtraffic_tally
from sunray_tpu.parallel.spmd import make_spmd_step, shard_state
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.scene import cornell_box as jcornell_box
from torch_dist import (
    SPMD_KW,
    assert_close_frames,
    cameras,
    run_ranks,
    spmd_frames,
)

RANKS = 8
FRAMES = 3


def _jax_frames():
    cfg = JConfig(**SPMD_KW)
    scene = jcornell_box()
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]).reshape(RANKS), ("sp",))
    step = make_spmd_step(scene, cfg, mesh)
    state = shard_state(JState.create(cfg), cfg, mesh)
    ldrs, tally = [], None
    for cam in cameras("fast", FRAMES):
        mats = jcamera_matrices(JCamera(position=cam.position,
                                        target=cam.target, fov_y=cam.fov_y),
                                cfg.width, cfg.height)
        if tally is None:
            # The first call traces the step: the tally counts its
            # ppermutes (sunray_tpu/parallel/halo.py:78-104).
            with jtraffic_tally() as t:
                state, ldr, _ = step(scene, state, mats)
            tally = dict(t)
        else:
            state, ldr, _ = step(scene, state, mats)
        ldrs.append(np.asarray(ldr))
    return ldrs, tally


@pytest.fixture(scope="module")
def frames():
    return run_ranks(RANKS, spmd_frames, [(SPMD_KW, "fast", FRAMES)],
                     meanwhile=_jax_frames)


def test_fast_motion_matches_jax_spmd(frames):
    got, (ref, _) = frames
    assert_close_frames(ref, got[0][0][0], 2e-4, 2e-4)
    for ldr in got[0][0][0]:
        assert ldr.max() > 0.01


def test_traffic_tally_matches_jax(frames):
    got, (_, tally) = frames
    assert tally["bytes"] == 450560
    for r in got:
        for t in r[0][1]:
            assert t["bytes"] == tally["bytes"]
