"""PyTorch port, examples/torch_render_png.py on the CPU: the Cornell PNG
at --size 32x24 --warmup 2 is bit-equal to a fresh Renderer's
render_to_host_memory (read back through the port's PNG decoder) and
above 40 dB PSNR (tests/test_golden.py:80) against the PNG of the JAX
examples/render_png.py at the same flags; --scene room and --scene glb on
a small tools/synth_gltf.py file run on the port alone.
"""

import sys

import numpy as np
import pytest

from examples import render_png as jax_example
from examples import torch_render_png as ex
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render.renderer import Renderer
from sunray_tpu_torch.utils.png import read_png
from tools.synth_gltf import write_scene
from torch_parity import psnr

FLAGS = ["--size", "32x24", "--warmup", "2", "--cpu"]
PSNR_MIN = 40.0


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("render_png") / "render.png")
    got = ex.main(FLAGS + ["--out", out])
    return got, read_png(out)


def test_png_is_the_renderers_image(cornell):
    got, png = cornell
    scene, camera = ex.scene_and_camera("cornell", "cpu")
    r = Renderer(RenderConfig(width=32, height=24), scene, device="cpu")
    want = r.render_to_host_memory(camera, warmup=2)
    assert png.dtype == np.uint8 and png.shape == (24, 32, 4)
    np.testing.assert_array_equal(png, want)
    np.testing.assert_array_equal(got["image"], want)
    assert got["size"] == [32, 24] and got["frames"] == 3


def test_png_matches_the_jax_example(cornell, tmp_path, monkeypatch):
    _, png = cornell
    out = str(tmp_path / "jax.png")
    monkeypatch.setattr(sys, "argv", ["render_png.py", *FLAGS, "--out", out])
    jax_example.main()
    want = read_png(out)
    assert want.shape == png.shape
    p = psnr(png[..., :3] / 255.0, want[..., :3] / 255.0)
    assert p > PSNR_MIN, f"PSNR {p:.2f} dB against the JAX example"


@pytest.mark.parametrize("scene", ["room", "glb"])
def test_other_scenes_render(scene, tmp_path):
    args = ["--scene", scene, "--out", str(tmp_path / "out.png"), *FLAGS]
    if scene == "glb":
        args += ["--gltf", write_scene(str(tmp_path / "s.glb"), seed=3,
                                       tex=8, subdiv=0, spheres=2)]
    got = ex.main(args)
    png = read_png(str(tmp_path / "out.png"))
    np.testing.assert_array_equal(png, got["image"])
    assert png.shape == (24, 32, 4) and (png[..., 3] == 255).all()
    assert png[..., :3].std() > 0.0


def test_glb_needs_a_file():
    with pytest.raises(SystemExit):
        ex.main(["--scene", "glb", "--cpu"])
    with pytest.raises(ValueError, match="--gltf"):
        ex.run(scene="glb", device="cpu")
