"""Shared set-up of the Renderer tests of the PyTorch port
(tests/test_torch_renderer*.py): a small synthetic textured GLB
(tools/synth_gltf.py: 8 textures of 16x16, 8 icosphere instances of 80
triangles, 708 triangles padded to 1,024, so "auto" above the CPU's
brute limit of 512 takes the two-level tracer), the frame config, and one
run of both packages' Renderers frame by frame."""

import numpy as np

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.render.renderer import Renderer as JRenderer
from sunray_tpu_torch.camera import Camera
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render.renderer import Renderer
from tools.synth_gltf import CAMERA, write_scene
from torch_parity import n

FRAME_KW = dict(width=48, height=32, bounces=2, virtual_bounces=2,
                ris_candidates=4, di_spatial_samples=2, gi_spatial_samples=1,
                denoise_passes=1)
FRAMES = 3
PSNR_MIN = 40.0     # tests/test_golden.py:80


def glb(tmp_path_factory, seed=0, spheres=8):
    path = tmp_path_factory.mktemp("glb") / f"scene{seed}.glb"
    return write_scene(str(path), seed=seed, tex=16, subdiv=1,
                       spheres=spheres)


def renderers(**cfg):
    kw = dict(FRAME_KW, **cfg)
    return JRenderer(JConfig(**kw)), Renderer(RenderConfig(**kw), device="cpu")


def cameras():
    return JCamera(**CAMERA), Camera(**CAMERA)


def frames(jr, pr, count=FRAMES):
    """count frames of both Renderers: [(JAX ldr, port ldr)] as numpy."""
    jc, pc = cameras()
    return [(np.asarray(jr.render(jc)), n(pr.render(pc)))
            for _ in range(count)]
