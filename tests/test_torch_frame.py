"""PyTorch port, the whole slice: render_frame with lighting="nee" against
the JAX render_frame at the golden config (tests/test_golden.py:36-40,
four frames) and against tests/goldens/cornell_nee.npy, PSNR > 40 dB on
ldr (the bar of test_golden.py:80); the G-buffer within 1e-4; the JAX
state carried into the port through convert; and uncovered
configurations raising. The frame on a card is held to the CPU in
tests/test_torch_cuda.py."""

import dataclasses
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
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene.types import TextureAtlas
from torch_parity import CAMERA, GOLDEN_KW, n, psnr, to_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_nee.npy")
FRAMES = 4
PSNR_MIN = 40.0


@pytest.fixture(scope="module")
def frames():
    """Four frames of both packages from the identical scene and matrices."""
    jcfg = JConfig(**GOLDEN_KW)
    jscene = jcornell_box()
    jmats = jcamera_matrices(JCamera(**CAMERA), jcfg.width, jcfg.height)
    step = jax.jit(lambda st: jrender_frame(jscene, jcfg, st, jmats))
    jstate = JState.create(jcfg)

    cfg = RenderConfig(**GOLDEN_KW)
    scene = convert.scene_from_numpy(to_numpy(jscene))
    mats = convert.mats_from_numpy({k: np.asarray(v) for k, v in jmats.items()})
    state = RenderState.create(cfg)

    out = dict(jax=[], port=[], jstates=[], scene=scene, mats=mats, cfg=cfg)
    for _ in range(FRAMES):
        jstate, jldr, jaux = step(jstate)
        state, ldr, aux = render_frame(scene, cfg, state, mats)
        out["jax"].append((np.asarray(jldr), {k: np.asarray(v)
                                              for k, v in jaux.items()}))
        out["port"].append((n(ldr), aux))
        out["jstates"].append(to_numpy(jstate))
    out["state"] = state
    return out


def test_frame_matches_jax(frames):
    for (jl, _), (pl, _) in zip(frames["jax"], frames["port"]):
        assert pl.shape == jl.shape == (64, 96, 3)
        assert np.isfinite(pl).all()
        p = psnr(pl, jl)
        assert p > PSNR_MIN, f"PSNR vs JAX = {p:.2f} dB"


def test_frame_matches_golden(frames):
    golden = np.load(GOLDEN)
    p = psnr(frames["port"][-1][0], golden)
    assert p > PSNR_MIN, f"PSNR vs golden = {p:.2f} dB"


def test_gbuffer_matches_jax(frames):
    for (_, ja), (_, pa) in zip(frames["jax"], frames["port"]):
        for k in ("depth", "normal", "diffuse", "motion"):
            np.testing.assert_allclose(n(pa[k]), ja[k], atol=1e-4, err_msg=k)
        assert pa["ris_rounds"] == int(ja["ris_rounds"])
        assert pa["final_rounds"] == int(ja["final_rounds"])


def test_state_shapes_and_counter(frames):
    st = frames["state"]
    js = frames["jstates"][-1]
    assert int(st.frame_count) == int(js["frame_count"]) == FRAMES
    assert st.frame_count.dtype == torch.int32
    for name in ("light_pos", "light_idx", "W"):
        assert tuple(getattr(st.res_di, name).shape) == js["res_di"][name].shape
    assert st.res_gi.sample_tri.dtype == torch.int32
    np.testing.assert_allclose(n(st.prev_view_proj), js["prev_view_proj"],
                               atol=1e-6)


def test_state_from_numpy_continues_jax_frames(frames):
    """The JAX state after two frames, carried across, renders frame 3."""
    state = convert.state_from_numpy(frames["jstates"][1])
    assert int(state.frame_count) == 2
    _, ldr, _ = render_frame(frames["scene"], frames["cfg"], state,
                             frames["mats"])
    p = psnr(n(ldr), frames["jax"][2][0])
    assert p > PSNR_MIN, f"PSNR vs JAX frame 3 = {p:.2f} dB"


UNCOVERED = {
    "restir": dict(lighting="restir"),
    "bvh": dict(tracer="bvh"),
    "edge_antialias": dict(edge_antialias=True),
    "samples": dict(samples=2),
    "differentiable": dict(differentiable=True),
    "taa_kernel": dict(taa_kernel="pallas"),
}


@pytest.mark.parametrize("name", sorted(UNCOVERED) + ["textured_atlas"])
def test_uncovered_configs_raise(name, frames):
    cfg = dataclasses.replace(RenderConfig(**GOLDEN_KW),
                              **UNCOVERED.get(name, {}))
    scene = frames["scene"]
    if name == "textured_atlas":
        atlas = TextureAtlas.empty()
        atlas.data = torch.ones((2, 4, 4, 4))
        scene = dataclasses.replace(scene, textures=atlas)
    with pytest.raises(NotImplementedError):
        render_frame(scene, cfg, RenderState.create(cfg), frames["mats"])

