"""PyTorch port, the ReSTIR frame with bf16 shading attributes
(shading_dtype="bf16", sunray_tpu/config.py:53-61): render_frame against
the JAX render_frame at the golden size, three frames, and phase B's DI
and GI spatial reuse (K5's and K6's plain versions on bf16 planes)
against JAX's on the frame's own inputs.

The JAX frame casts normal, view, albedo, roughness and metallic to
bfloat16 before the RIS audition, DI temporal reuse, the GI initial
sample's target function, GI temporal reuse (gbuffer.py:280-295, 393,
416) and spatial reuse (pathtrace.py:494-501); positions and distances
stay float32, and the neighbour tests, rays and contributions read the
float32 attributes. The port rounds as XLA's CPU backend compiles those
jnp operations (ops/brdf.py).

Bars: PSNR > 40 dB on ldr, aux["raw"] within 1e-4, the reservoirs by the
take-flip scheme; phase B by the bars of test_torch_restir.py's shared
phase-B tests.
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.ops import brdf as pb
from sunray_tpu_torch.ops import cuda_restir as cr
from sunray_tpu_torch.ops import rng as prng
from sunray_tpu_torch.render import pathtrace as ppt
from sunray_tpu_torch.render.shade import shading_planes
from torch_frame_cases import (
    phase_b_case,
    port_frame,
    reservoir_agreement,
    run_frames,
)
from torch_parity import GOLDEN_KW, WINNER_AGREE, n, psnr

FRAMES = 3
PSNR_MIN = 40.0
KW = dict(GOLDEN_KW, lighting="restir", shading_dtype="bf16")


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


def test_bf16_differs_from_f32(frames):
    """The switch reaches the target functions: the f32 frame's raw
    colours are not the bf16 frame's."""
    _, f32 = port_frame(frames, shading_dtype="f32")
    assert not np.array_equal(n(f32["raw"]), n(frames["port"][0][1]["raw"]))


@pytest.fixture(scope="module")
def phase_b():
    return phase_b_case(KW)


def _shade(args):
    cfg, c = args[0], args[8]
    return shading_planes(cfg, c["f_normal"], c["f_view"], c["f_albedo"],
                          c["f_rough"], c["f_metal"])


def test_di_spatial_bf16_matches_jax(phase_b):
    """K5's plain version on the bf16 planes, the neighbour test on the
    float32 normal."""
    (cfg, _, lights, _, gbuf, r_di, _, seed, c, cam_origin,
     fc) = phase_b["args"]
    taps = ppt._shared_taps(fc, cfg.di_spatial_samples, cfg.di_spatial_radius,
                            0x51A7D1)
    pos = c["f_pos"]
    shade = _shade(phase_b["args"])
    assert shade[0].dtype == torch.bfloat16
    _, di = cr.di_spatial_plain(
        lights.table, seed,
        {k: getattr(r_di, k) for k in ("light_pos", "light_normal", "W", "M",
                                       "light_idx")},
        taps, c["pending"], gbuf.normal, gbuf.depth,
        pb.vec_norm(pos - cam_origin), pos, *shade, cfg.width, cfg.height,
        (cfg.di_temporal_w_clamp, cfg.di_temporal_m_clamp,
         cfg.di_spatial_w_clamp), test_normal=c["f_normal"])
    jp = phase_b["jparts"]
    pend = n(c["pending"])
    np.testing.assert_array_equal(n(di["has"]), jp["has"])
    same = n(lights.world_tri[di["light_idx"].long()]) == jp["di_exclude"]
    assert same[pend].mean() > WINNER_AGREE
    sp = same & pend
    np.testing.assert_allclose(n(di["w_spatial"])[sp], jp["w_spatial"][sp],
                               rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(n(di["f_y_w"])[sp], jp["f_y_w"][sp],
                               rtol=3e-4, atol=1e-5)


def test_gi_spatial_bf16_matches_jax(phase_b):
    """K6's plain version with the bf16 target-function planes beside the
    float32 ones of the final ray and contribution."""
    cfg, tracer, _, mats, gbuf, _, r_gi, seed, c, cam_origin, fc = (
        phase_b["args"])
    pending, pos = c["pending"], c["f_pos"]
    taps = ppt._shared_taps(fc, cfg.gi_spatial_samples, cfg.gi_spatial_radius,
                            0x6E5B2F)
    planes = ppt._gi_tap_prep(cfg, tracer, mats, gbuf, r_gi, taps, pending,
                              pos, c["f_normal"], pb.vec_norm(pos - cam_origin),
                              cam_origin)
    s, _ = prng.rnd_chain(seed, 1 + cfg.di_spatial_samples)
    shade = _shade(phase_b["args"])
    _, gi = cr.gi_spatial_plain(
        s, {k: getattr(r_gi, k) for k in ("sample_pos", "sample_radiance",
                                          "sample_tri", "w_sum", "M")},
        planes, pending, pos, c["f_normal"], c["f_albedo"], c["f_metal"],
        cfg.gi_spatial_w_clamp, shade=(shade[0], shade[2], shade[4]))
    jp = phase_b["jparts"]
    pend = n(pending)
    same = n(gi["sample_tri"]) == jp["sample_tri"]
    assert same[pend].mean() > WINNER_AGREE
    sp = same & pend
    np.testing.assert_array_equal(n(gi["try_gi"])[sp], jp["try_gi"][sp])
    np.testing.assert_allclose(n(gi["gdir"])[sp], jp["gdir"][sp], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(gi["contrib_pre"])[sp], jp["contrib_pre"][sp],
                               rtol=3e-4, atol=1e-5)


def test_spatial_reuse_radiance_matches_jax(phase_b):
    got, want = n(phase_b["out"]), np.asarray(phase_b["jout"])
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() > WINNER_AGREE, close.mean()
