"""PyTorch port, the Renderer facade's host side on the small synthetic
GLB (tests/torch_renderer_cases.py), against the JAX Renderer:
render_to_host_memory's RGBA8 image above 40 dB PSNR; the frame
callbacks (start / end once, resize every time) firing as JAX's do; a
frame after resize() above 40 dB; render_frame_with_camera equal to
render_frame with the camera's matrices."""

import numpy as np
import pytest

from sunray_tpu_torch.camera import camera_matrices
from sunray_tpu_torch.render.pipeline import (
    RenderState,
    render_frame,
    render_frame_with_camera,
)
from torch_parity import n, psnr
from torch_renderer_cases import PSNR_MIN, cameras, frames, glb, renderers


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    path = glb(tmp_path_factory, seed=4)
    jr, pr = renderers(tracer="auto")
    jr.load_gltf(path)
    pr.load_gltf(path)
    return jr, pr


def test_render_to_host_memory_and_callbacks(loaded):
    jr, pr = loaded
    events = {"jax": [], "port": []}
    for name, r in (("jax", jr), ("port", pr)):
        ev = events[name]
        r.add_start_of_frame_callback(lambda ev=ev: ev.append("start"))
        r.add_end_of_frame_callback(lambda rr, ev=ev, r=r: ev.append(
            ("end", rr is r)))
        r.add_resize_callback(lambda wh, ev=ev: ev.append(("resize", wh)))
    jc, pc = cameras()
    jimg = jr.render_to_host_memory(jc, warmup=1)
    pimg = pr.render_to_host_memory(pc, warmup=1)
    assert pimg.dtype == np.uint8 and pimg.shape == jimg.shape == (32, 48, 4)
    assert (pimg[..., 3] == 255).all()
    p = psnr(pimg / 255.0, jimg / 255.0)
    assert p > PSNR_MIN, f"render_to_host_memory PSNR {p:.2f} dB"
    for r in (jr, pr):
        r.resize(40, 24)
    (jl, pl), = frames(jr, pr, 1)
    assert pl.shape == jl.shape == (24, 40, 3)
    assert psnr(pl, jl) > PSNR_MIN
    for r in (jr, pr):
        r.resize(48, 32)
    assert events["port"] == events["jax"] == [
        "start", ("end", True), ("resize", (40, 24)), ("resize", (48, 32))]


def test_render_frame_with_camera(loaded):
    _, pr = loaded
    _, cam = cameras()
    cfg, scene = pr.config, pr.scene
    accel = pr._scene_accel()
    mats = camera_matrices(cam, cfg.width, cfg.height, device="cpu")
    _, want, _ = render_frame(scene, cfg, RenderState.create(cfg, "cpu"),
                              mats, accel)
    _, got, _ = render_frame_with_camera(scene, cfg,
                                         RenderState.create(cfg, "cpu"), cam,
                                         accel)
    np.testing.assert_array_equal(n(got), n(want))
