"""PyTorch port, frames with several samples a pixel (cfg.samples > 1):
render_frame against the JAX render_frame at the golden size
(tests/test_golden.py:36-40), ReSTIR at samples 2 and 4 (4 in
test_torch_frame_samples4.py) and NEE at samples 2, three frames each.
Pass 1 runs once, then `samples` final passes on salted PCG streams
(frame_count * samples + s, uint32), each on pass 1's primary hit, their
raw colours averaged and their walk rounds summed (JAX
pipeline.py:76-92, pathtrace.py:131-137).

Bars: PSNR > 40 dB on ldr (test_golden.py:80), aux["raw"] within 1e-4,
the walk rounds equal, and the rays the port traces equal to bench.py's
count with every sample's final-pass rays. Also the dtype repair:
cfg.dtype is read nowhere in the JAX package, and the port's frame with
dtype="bfloat16" is the float32 frame, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import rng as prng
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from torch_frame_cases import run_frames
from torch_parity import GOLDEN_KW, n, psnr

FRAMES = 3
PSNR_MIN = 40.0
CASES = {
    "restir_s2": dict(GOLDEN_KW, lighting="restir", samples=2),
    "restir_s4": dict(GOLDEN_KW, lighting="restir", samples=4),
    "nee_s2": dict(GOLDEN_KW, lighting="nee", samples=2),
}
# restir_s4 runs in test_torch_frame_samples4.py, so that --dist loadfile
# compiles its JAX frame in another worker.
HERE = ("restir_s2", "nee_s2")


@pytest.fixture(scope="module", params=HERE)
def frames(request):
    return run_frames(CASES[request.param], FRAMES)


def test_frame_matches_jax(frames):
    for i, ((jl, _, _), (pl, _, _)) in enumerate(zip(frames["jax"],
                                                     frames["port"])):
        assert pl.shape == jl.shape == (64, 96, 3)
        assert np.isfinite(pl).all()
        p = psnr(pl, jl)
        assert p > PSNR_MIN, f"frame {i}: PSNR vs JAX {p:.2f} dB"


def test_raw_and_rounds_match_jax(frames):
    for (_, ja, _), (_, pa, _) in zip(frames["jax"], frames["port"]):
        np.testing.assert_allclose(n(pa["raw"]), ja["raw"], atol=1e-4)
        assert pa["ris_rounds"] == int(ja["ris_rounds"])
        assert pa["final_rounds"] == int(ja["final_rounds"])


def test_rays_count_every_sample(frames):
    """bench.py:7-13 with S final passes: P * (ris_rounds + 3 +
    final_rounds - S + S * (2 + T_gi)) for ReSTIR (each pass reuses pass
    1's camera hit, then traces its GI-tap visibility and its two final
    rays); P * (ris_rounds + 2 * final_rounds - S) for NEE (a closest and
    a shadow ray a round, round 0's closest reused)."""
    cfg = frames["cfg"]
    p, s = cfg.width * cfg.height, cfg.samples
    for rays, (_, aux, _) in zip(frames["rays"], frames["port"]):
        if cfg.lighting == "restir":
            want = p * (aux["ris_rounds"] + 3 + aux["final_rounds"] - s
                        + s * (2 + cfg.gi_spatial_samples))
        else:
            want = p * (aux["ris_rounds"] + 2 * aux["final_rounds"] - s)
        assert rays == want


def test_salt_wraps_in_uint32():
    """frame * samples + index mod 2^32 (pathtrace.py:131-136)."""
    fc = torch.tensor([0, 7, 2**31 - 1], dtype=torch.int32)
    got = prng.salt(fc, 4, 3)
    want = (np.array([0, 7, 2**31 - 1], np.uint64) * 4 + 3) % 2**32
    np.testing.assert_array_equal(n(got), want.astype(np.int64))


@pytest.mark.parametrize("lighting", ["nee", "restir"])
def test_dtype_is_read_nowhere(lighting):
    """cfg.dtype="bfloat16" renders the float32 frame bit for bit, as the
    JAX frame does (RenderConfig.dtype is read nowhere under sunray_tpu/)."""
    from sunray_tpu_torch import convert
    from sunray_tpu.camera import Camera as JCamera
    from sunray_tpu.camera import camera_matrices as jcm
    from sunray_tpu.scene import cornell_box as jcornell_box
    from torch_parity import CAMERA, to_numpy

    kw = dict(GOLDEN_KW, lighting=lighting, width=48, height=32)
    scene = convert.scene_from_numpy(to_numpy(jcornell_box()), device="cpu")
    mats = convert.mats_from_numpy(
        {k: np.asarray(v) for k, v in jcm(JCamera(**CAMERA), 48, 32).items()},
        device="cpu")
    out = []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(RenderConfig(**kw), dtype=dtype)
        state = RenderState.create(cfg, device="cpu")
        for _ in range(2):
            state, ldr, _ = render_frame(scene, cfg, state, mats)
        out.append(ldr)
    assert torch.equal(out[0].view(torch.int32), out[1].view(torch.int32))
