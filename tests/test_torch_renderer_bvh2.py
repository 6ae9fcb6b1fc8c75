"""PyTorch port, the Renderer facade with tracer="bvh2" on a small
synthetic textured GLB (tests/torch_renderer_cases.py): load_gltf and
three render() frames above 40 dB PSNR against the JAX Renderer, the
accel and the tracer it picks equal to JAX's."""

import numpy as np
import pytest

from torch_parity import psnr
from torch_renderer_cases import FRAMES, PSNR_MIN, frames, glb, renderers

TRACER = "bvh2"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = glb(tmp_path_factory)
    jr, pr = renderers(tracer=TRACER)
    ji, pi = jr.load_gltf(path), pr.load_gltf(path)
    out = dict(jr=jr, pr=pr, ji=ji, pi=pi, frames=[], ops=[])
    for _ in range(FRAMES):
        out["frames"] += frames(jr, pr, 1)
        out["ops"].append((jr.last_accel_op, pr.last_accel_op))
    return out


def test_frames_match_jax(run):
    for k, (jl, pl) in enumerate(run["frames"]):
        assert pl.shape == jl.shape == (32, 48, 3)
        assert np.isfinite(pl).all()
        p = psnr(pl, jl)
        assert p > PSNR_MIN, f"frame {k}: PSNR vs JAX {p:.2f} dB"


def test_scene_and_accel_match_jax(run):
    jr, pr = run["jr"], run["pr"]
    assert [k for k, _ in run["ji"]] == [k for k, _ in run["pi"]]
    assert pr.scene.num_tris == jr.scene.num_tris == 1024
    assert pr.config.alpha_mask_tracing and jr.config.alpha_mask_tracing
    assert type(pr._accel).__name__ == type(jr._accel).__name__
    assert run["ops"] == [(a, a) for a, _ in run["ops"]]
