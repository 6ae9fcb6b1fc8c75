"""PyTorch port, the whole slice: render_frame with lighting="nee" against
the JAX render_frame at the golden config (tests/test_golden.py:36-40,
four frames) and against tests/goldens/cornell_nee.npy, PSNR > 40 dB on
ldr (the bar of test_golden.py:80); the G-buffer within 1e-4; the JAX
state carried into the port through convert; and the configurations
left out raising. The frame on a card is held to the CPU in
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
    scene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    mats = convert.mats_from_numpy({k: np.asarray(v) for k, v in jmats.items()},
                                   device="cpu")
    state = RenderState.create(cfg, device="cpu")

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
    state = convert.state_from_numpy(frames["jstates"][1], device="cpu")
    assert int(state.frame_count) == 2
    _, ldr, _ = render_frame(frames["scene"], frames["cfg"], state,
                             frames["mats"])
    p = psnr(n(ldr), frames["jax"][2][0])
    assert p > PSNR_MIN, f"PSNR vs JAX frame 3 = {p:.2f} dB"


UNCOVERED = {
    # The configurations check_supported refuses: the TPU history-gather
    # workaround and an unknown lighting mode.
    "history_gather_force": dict(lighting="restir",
                                 history_gather_force=True),
    "unknown_lighting": dict(lighting="path"),
    # The shadow-boundary term needs the scene's edge topology
    # (render/boundary.with_edge_topology); the JAX frame asserts it.
    "boundary_without_topology": dict(differentiable=True,
                                      shadow_boundary_grads=True),
}
RAISES = {"boundary_without_topology": ValueError}


def _gltf_with_jpeg(path):
    """A glTF whose first image has a JPEG's magic bytes and no JPEG
    stream behind them: the port's JPEG reader (utils/jpeg.py) refuses it
    as corrupt."""
    import base64
    import json

    from tools.synth_gltf import build_document

    doc, data = build_document(seed=0, tex=4, subdiv=0, spheres=2)
    doc["images"][0] = {"uri": "data:image/jpeg;base64," + base64.b64encode(
        b"\xff\xd8\xff\xe0" + bytes(64)).decode()}
    doc["buffers"] = [{"byteLength": len(data), "uri": (
        "data:application/octet-stream;base64,"
        + base64.b64encode(data).decode())}]
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("name", sorted(UNCOVERED) + ["gltf_jpeg_image"])
def test_uncovered_configs_raise(name, frames, tmp_path):
    if name == "gltf_jpeg_image":
        from sunray_tpu_torch.scene.gltf import load_gltf

        with pytest.raises(ValueError, match="JPEG"):
            load_gltf(_gltf_with_jpeg(tmp_path / "jpeg.gltf"), device="cpu")
        return
    cfg = dataclasses.replace(RenderConfig(**GOLDEN_KW),
                              **UNCOVERED.get(name, {}))
    scene = frames["scene"]
    with pytest.raises(RAISES.get(name, NotImplementedError)):
        render_frame(scene, cfg, RenderState.create(cfg, device="cpu"), frames["mats"])


@pytest.mark.parametrize("kernel", ["auto", "pallas", "jnp", "unknown"])
def test_denoise_kernel_reaches_atrous_denoise(kernel, frames, monkeypatch):
    """render_frame hands cfg.denoise_kernel to atrous_denoise, as the JAX
    frame does (sunray_tpu/render/pipeline.py:135); an unknown name
    raises. On the CPU every known name takes the plain passes, so the
    frame is the one the default config renders."""
    from sunray_tpu_torch.render import pipeline

    seen, original = [], pipeline.atrous_denoise

    def recording(*args, kernel="auto"):
        seen.append(kernel)
        return original(*args, kernel=kernel)

    monkeypatch.setattr(pipeline, "atrous_denoise", recording)
    cfg = dataclasses.replace(frames["cfg"], denoise_kernel=kernel)
    state = RenderState.create(cfg, device="cpu")
    if kernel == "unknown":
        with pytest.raises(ValueError):
            render_frame(frames["scene"], cfg, state, frames["mats"])
        assert seen == ["unknown"]
        return
    _, ldr, _ = render_frame(frames["scene"], cfg, state, frames["mats"])
    assert seen == [kernel]
    assert torch.equal(ldr, torch.from_numpy(frames["port"][0][0]))
