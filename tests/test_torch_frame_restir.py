"""PyTorch port, the default ReSTIR frame: render_frame with
lighting="restir" against the JAX render_frame at the golden config
(tests/test_golden.py:36-40, eight frames) and against
tests/goldens/cornell_restir.npy, PSNR > 40 dB on ldr (the bar of
test_golden.py:80); the G-buffer within 1e-4; the reservoirs the frames
carry held to the take-flip scheme of tests/test_restir_math.py (M exact,
winners agreeing on > 99.5% of lanes); and the JAX state carried into the
port through convert. The frame on a card is held to the CPU in
tests/test_torch_cuda.py."""

import os

import jax
import numpy as np
import pytest
import torch

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_trace
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from torch_parity import CAMERA, GOLDEN_KW, n, psnr, to_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cornell_restir.npy")
KW = dict(GOLDEN_KW, lighting="restir")
FRAMES = 8
PSNR_MIN = 40.0
WINNER_AGREE = 0.995


@pytest.fixture(scope="module")
def frames():
    """Eight frames of both packages from the identical scene and
    matrices; the port's trace batch sizes per frame."""
    jcfg = JConfig(**KW)
    jscene = jcornell_box()
    jmats = jcamera_matrices(JCamera(**CAMERA), jcfg.width, jcfg.height)
    step = jax.jit(lambda st: jrender_frame(jscene, jcfg, st, jmats))
    jstate = JState.create(jcfg)

    cfg = RenderConfig(**KW)
    scene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    mats = convert.mats_from_numpy({k: np.asarray(v)
                                    for k, v in jmats.items()}, device="cpu")
    state = RenderState.create(cfg, device="cpu")

    out = dict(jax=[], port=[], jstates=[], states=[], rays=[], scene=scene,
               mats=mats, cfg=cfg)
    for _ in range(FRAMES):
        jstate, jldr, jaux = step(jstate)
        before = sum(cuda_trace.rays.values())
        state, ldr, aux = render_frame(scene, cfg, state, mats)
        out["rays"].append(sum(cuda_trace.rays.values()) - before)
        out["jax"].append((np.asarray(jldr), {k: np.asarray(v)
                                              for k, v in jaux.items()}))
        out["port"].append((n(ldr), aux))
        out["jstates"].append(to_numpy(jstate))
        out["states"].append(state)
    return out


def test_frame_matches_jax(frames):
    for i, ((jl, _), (pl, _)) in enumerate(zip(frames["jax"],
                                               frames["port"])):
        assert pl.shape == jl.shape == (64, 96, 3)
        assert np.isfinite(pl).all()
        p = psnr(pl, jl)
        assert p > PSNR_MIN, f"frame {i}: PSNR vs JAX = {p:.2f} dB"


def test_frame_matches_golden(frames):
    p = psnr(frames["port"][-1][0], np.load(GOLDEN))
    assert p > PSNR_MIN, f"PSNR vs golden = {p:.2f} dB"


def test_gbuffer_matches_jax(frames):
    for (_, ja), (_, pa) in zip(frames["jax"], frames["port"]):
        for k in ("depth", "normal", "diffuse", "motion"):
            np.testing.assert_allclose(n(pa[k]), ja[k], atol=1e-4, err_msg=k)
        assert pa["ris_rounds"] == int(ja["ris_rounds"])
        assert pa["final_rounds"] == int(ja["final_rounds"])


@pytest.mark.parametrize("res,win,pos", [
    ("res_di", "light_idx", "light_pos"),
    ("res_gi", "sample_tri", "sample_pos")])
def test_reservoirs_match_jax(frames, res, win, pos):
    """The reservoirs each frame hands the next, frames 1-8. The Cornell
    box has two light triangles, so the sample itself (id and position)
    is the winner that must agree, with its W. A take flip in one frame
    reaches the neighbours' and the next frames' sums, so the agreement is
    counted over lanes, as the take-flip scheme counts winners."""
    for i, (st, js) in enumerate(zip(frames["states"], frames["jstates"])):
        mine = getattr(st, res)
        want = js[res]
        np.testing.assert_array_equal(n(mine.M), want["M"],
                                      err_msg=f"frame {i} {res}.M")
        assert getattr(mine, win).dtype == torch.int32
        same = ((n(getattr(mine, win)) == want[win])
                & np.isclose(n(getattr(mine, pos)), want[pos], rtol=1e-5,
                             atol=1e-6).all(-1)
                & np.isclose(n(mine.W), want["W"], rtol=3e-4, atol=1e-5))
        assert same.mean() > WINNER_AGREE, f"frame {i}: {same.mean()}"


def test_rays_per_frame_as_bench_counts(frames):
    """bench.py:7-13: P * (ris_rounds + 3 + final_rounds - 1 + 2 + T_gi)."""
    cfg = frames["cfg"]
    p = cfg.width * cfg.height
    for rays, (_, aux) in zip(frames["rays"], frames["port"]):
        assert rays == p * (aux["ris_rounds"] + 3 + aux["final_rounds"] - 1
                            + 2 + cfg.gi_spatial_samples)


def test_state_from_numpy_continues_jax_frames(frames):
    """The JAX state after four frames, carried across with its live
    reservoirs, renders frame 5."""
    state = convert.state_from_numpy(frames["jstates"][3], device="cpu")
    assert int(state.frame_count) == 4
    assert state.res_di.light_idx.dtype == torch.int32
    assert state.res_gi.sample_tri.dtype == torch.int32
    assert float(state.res_di.M.max()) > 0.0
    _, ldr, _ = render_frame(frames["scene"], frames["cfg"], state,
                             frames["mats"])
    p = psnr(n(ldr), frames["jax"][4][0])
    assert p > PSNR_MIN, f"PSNR vs JAX frame 5 = {p:.2f} dB"
