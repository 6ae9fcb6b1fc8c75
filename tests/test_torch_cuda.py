"""PyTorch port on the card: every CUDA kernel (K1, K2, K7, K8) against its
plain PyTorch version, and the golden NEE frame on the card against the
CPU. Skipped where there is no CUDA device. This file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.camera import Camera, camera_matrices, generate_rays
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_build, cuda_gather, cuda_image, cuda_trace
from sunray_tpu_torch.ops import intersect
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene import cornell_box
from torch_parity import CAMERA, GOLDEN_KW, cuda_device, n, psnr  # noqa: F401

pytestmark = pytest.mark.gpu


def _trace_case(name, dev):
    rng = np.random.default_rng(0)
    if name == "cornell":
        scene = cornell_box(device=dev)
        tris = tuple(x.contiguous() for x in scene.world_triangle_vertices())
        mats = camera_matrices(Camera(**CAMERA), 320, 240, device=dev)
        o, d = (x.reshape(-1, 3).contiguous() for x in generate_rays(mats, 320, 240))
        k = o.shape[0]
        ex = scene.light_world_tri[torch.from_numpy(
            rng.integers(0, 2, size=k)).to(dev)].contiguous()
    else:
        nt, k = 4096, 16384
        v0 = rng.normal(size=(nt, 3)).astype(np.float32)
        tris = tuple(torch.from_numpy(x).to(dev).contiguous() for x in (
            v0, v0 + rng.normal(size=(nt, 3)).astype(np.float32) * 0.3,
            v0 + rng.normal(size=(nt, 3)).astype(np.float32) * 0.3))
        o = torch.from_numpy((rng.normal(size=(k, 3)) * 3).astype(np.float32)).to(dev)
        dn = rng.normal(size=(k, 3)).astype(np.float32)
        d = torch.from_numpy(dn / np.linalg.norm(dn, axis=-1, keepdims=True)).to(dev)
        ex = torch.from_numpy(rng.integers(-1, nt, size=k).astype(np.int32)).to(dev)
    tmax = torch.from_numpy(rng.uniform(0.1, 5.0, size=k).astype(np.float32)).to(dev)
    return tris, o, d, tmax, ex


@pytest.mark.parametrize("case", ["cornell", "random"])
def test_trace_kernels_match_plain(case, cuda_device):
    tris, o, d, tmax, ex = _trace_case(case, cuda_device)
    k = cuda_trace.trace_closest(tris, o, d)
    p = intersect.trace_closest_brute(tris, o, d)
    torch.cuda.synchronize()
    assert k.hit.any()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    for exclude in (None, ex):
        ko = cuda_trace.trace_occluded(tris, o, d, tmax, exclude=exclude)
        po = intersect.trace_occluded_brute(tris, o, d, tmax, exclude=exclude)
        torch.cuda.synchronize()
        assert torch.equal(ko, po)


@pytest.mark.parametrize("k,c,g", [(72, 6, 3), (36, 4, 1), (300, 11, 2)])
def test_gather_kernel_matches_plain(k, c, g, cuda_device):
    rng = np.random.default_rng(k)
    idx = torch.from_numpy(rng.integers(-5, k + 5, size=(g, 100_003))
                           .astype(np.int32)).to(cuda_device)
    tables = (rng.standard_normal((k, c)).astype(np.float32),
              rng.integers(-1000, 10**6, size=(k, c)).astype(np.int32))
    for table in tables:
        tab = torch.from_numpy(table).to(cuda_device)
        got = cuda_gather.gather_rows(tab, idx)
        torch.cuda.synchronize()
        assert got.dtype == tab.dtype
        assert torch.equal(got, cuda_gather.gather_rows_plain(tab, idx))


@pytest.mark.parametrize("passes", [1, 4])
def test_atrous_kernel_matches_plain(passes, cuda_device):
    rng = np.random.default_rng(passes)
    h, w = 270, 480
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.uniform(size=s).astype(np.float32)).to(cuda_device)
    depth = 1.0 + 3.0 * f(h, w)
    depth[:10] = 100000.0
    normal = torch.nn.functional.normalize(f(h, w, 3) - 0.5, dim=-1)
    args = (2.0 * f(h, w, 3), depth, normal.contiguous(), f(h, w), f(h, w, 3))
    got = cuda_image.atrous_denoise(*args, passes)
    want = cuda_image.atrous_denoise_plain(*args, passes)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


def test_kernel_rejects_bad_input(cuda_device):
    tris, o, d, _, _ = _trace_case("cornell", cuda_device)
    with pytest.raises(cuda_build.KernelError):
        cuda_trace.trace_closest(tris, o.double(), d)
    with pytest.raises(cuda_build.KernelError):
        cuda_trace.trace_closest(tris, o.cpu(), d)
    with pytest.raises(cuda_build.KernelError):
        cuda_gather.gather_rows(torch.zeros((4, 3), device=cuda_device),
                                torch.zeros((1, 5), dtype=torch.int64,
                                            device=cuda_device))


def test_frame_on_card_matches_cpu(cuda_device):
    cfg = RenderConfig(**GOLDEN_KW)
    ldrs = {}
    for dev in ("cpu", cuda_device):
        scene = cornell_box(device=dev)
        mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                               device=dev)
        state = RenderState.create(cfg, dev)
        cuda_build.launches.clear()
        for _ in range(4):
            state, ldr, _ = render_frame(scene, cfg, state, mats)
        assert ldr.device == torch.device(dev)
        ldrs[str(dev)] = n(ldr)
    p = psnr(ldrs["cpu"], ldrs[str(cuda_device)])
    assert p > 40.0, f"PSNR card vs CPU = {p:.2f} dB"
    for name in ("trace_closest", "trace_occluded", "gather_rows",
                 "atrous_pass"):
        assert cuda_build.launches[name] > 0, name
