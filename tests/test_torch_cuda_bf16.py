"""PyTorch port on the card: the configurations of the bf16-shading,
per-pixel-tap and several-samples frames. K3-K6's bf16 instantiations
against their plain versions (on the bf16 golden ReSTIR frame's own
inputs, on seeded light tables for K3, bit for bit on seeded K5 frames),
and those frames on the card against the CPU. Skipped where there is no
CUDA device; imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_bf16.py -q
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_build, cuda_restir
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene import cornell_box
from torch_di_spatial_cases import FIELDS as DI_FIELDS
from torch_di_spatial_cases import di_spatial_args
from torch_parity import CAMERA, GOLDEN_KW, cuda_device, n, psnr  # noqa: F401

pytestmark = pytest.mark.gpu

BF16_KW = dict(GOLDEN_KW, lighting="restir", shading_dtype="bf16")
# K3-K6: kernel -> plain version, what each is held to (the take-flip
# scheme of tests/test_restir_math.py, as test_torch_cuda.py holds the
# fp32 kernels): (winner id, exact fields, fields on agreeing lanes).
RESTIR = {
    "ris_audition": ("ris_audition_plain", "light_idx", ("M",),
                     ("w_sum", "light_pos", "W")),
    "di_temporal": ("di_temporal_plain", "light_idx", ("M",),
                    ("w_sum", "light_pos", "W")),
    "di_spatial": ("di_spatial_plain", "light_idx", ("M", "has"),
                   ("w_sum", "light_pos", "w_spatial", "f_y_w")),
    "gi_spatial": ("gi_spatial_plain", "sample_tri", ("try_gi",),
                   ("gdir", "gdist", "contrib_pre")),
}


def _bf16(*xs):
    return [x.to(torch.bfloat16).contiguous() for x in xs]


def _check(name, args, kwargs):
    plain, win, exact, close = RESTIR[name]
    before = cuda_build.launches[f"{name}_bf16"]
    seed_k, out_k = getattr(cuda_restir, name)(*args, **kwargs)
    assert cuda_build.launches[f"{name}_bf16"] == before + 1
    seed_p, out_p = getattr(cuda_restir, plain)(*args, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(seed_k, seed_p)
    for key in exact:
        assert torch.equal(out_k[key], out_p[key]), key
    same = out_k[win] == out_p[win]
    assert same.float().mean().item() > 0.995
    for key in close:
        torch.testing.assert_close(out_k[key][same], out_p[key][same],
                                   rtol=3e-4, atol=1e-5)


def _frame_inputs(dev, frame=2):
    """The (args, kwargs) each K3-K6 wrapper got in frame `frame` of the
    bf16 golden ReSTIR config on the card."""
    cfg = RenderConfig(**BF16_KW)
    scene = cornell_box(device=dev)
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height, device=dev)
    state = RenderState.create(cfg, dev)
    for _ in range(frame):
        state, _, _ = render_frame(scene, cfg, state, mats)
    captured = {}
    saved = {name: getattr(cuda_restir, name) for name in RESTIR}

    def recorder(name):
        def call(*args, **kwargs):
            captured.setdefault(name, (args, kwargs))
            return saved[name](*args, **kwargs)
        return call

    try:
        for name in RESTIR:
            setattr(cuda_restir, name, recorder(name))
        render_frame(scene, cfg, state, mats)
    finally:
        for name, fn in saved.items():
            setattr(cuda_restir, name, fn)
    return captured


@pytest.mark.parametrize("name", sorted(RESTIR))
def test_bf16_kernels_match_plain_on_the_frame(name, cuda_device):
    args, kwargs = _frame_inputs(cuda_device)[name]
    _check(name, args, kwargs)


@pytest.mark.parametrize("n_lights", [2, 600, cuda_restir.RIS_SMEM_LIGHTS + 1,
                                      1500])
def test_ris_audition_bf16_light_tables(n_lights, cuda_device):
    """K3's bf16 instantiation on both table paths (shared memory, up to
    RIS_SMEM_LIGHTS; the read-only cache above)."""
    rng = np.random.default_rng(n_lights)
    p = 20_000

    def f(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)
                                ).to(cuda_device)

    def unit():
        v = rng.normal(size=(p, 3))
        return torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True)
                                 ).astype(np.float32)).to(cuda_device)

    v0 = f(n_lights, 3, hi=2.0)
    table = cuda_restir.LightTable(v0, v0 + f(n_lights, 3, lo=-0.3, hi=0.3),
                                   v0 + f(n_lights, 3, lo=-0.3, hi=0.3),
                                   f(n_lights, 3, hi=20.0))
    seed = torch.from_numpy(rng.integers(0, 2**32, p)).to(cuda_device)
    attrs = _bf16(unit(), unit(), f(p, 3), f(p, lo=0.05), f(p))
    _check("ris_audition", (table, seed, f(p, 3, hi=2.0), *attrs, 16,
                            f(p) > 0.2), {})


@pytest.mark.parametrize("n_taps", [1, 5, cuda_restir.MAX_TAPS])
def test_di_spatial_bf16_bit_equal(n_taps, cuda_device):
    """K5's bf16 instantiation on seeded 333x187 frames: seeds and every
    output bit-equal to plain, as the fp32 instantiation is."""
    rng = np.random.default_rng(n_taps)
    taps = [tuple(int(v) for v in rng.integers(-40, 41, 2))
            for _ in range(n_taps)]
    args = list(di_spatial_args(taps, 190 + n_taps, 333, 187, cuda_device))
    normal = args[9]
    args[9:14] = _bf16(*args[9:14])
    seed_k, got = cuda_restir.di_spatial(*args, test_normal=normal)
    seed_p, want = cuda_restir.di_spatial_plain(*args, test_normal=normal)
    torch.cuda.synchronize()
    assert torch.equal(seed_k, seed_p)
    for key in DI_FIELDS:
        a, b = got[key], want[key]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


@pytest.mark.parametrize("name,kw,frames", [
    ("bf16", dict(shading_dtype="bf16"), 4),
    ("perpixel", dict(spatial_taps="perpixel"), 4),
    ("samples", dict(samples=2), 3),
    ("nee_samples", dict(lighting="nee", samples=2), 3)])
def test_config_frame_on_card_matches_cpu(name, kw, frames, cuda_device):
    cfg = RenderConfig(**dict(GOLDEN_KW, **dict(dict(lighting="restir"),
                                                **kw)))
    ldrs = {}
    for dev in ("cpu", cuda_device):
        scene = cornell_box(device=dev)
        mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                               device=dev)
        state = RenderState.create(cfg, dev)
        cuda_build.launches.clear()
        for _ in range(frames):
            state, ldr, _ = render_frame(scene, cfg, state, mats)
        ldrs[str(dev)] = n(ldr)
    p = psnr(ldrs["cpu"], ldrs[str(cuda_device)])
    assert p > 40.0, f"{name}: PSNR card vs CPU = {p:.2f} dB"
    if name == "bf16":
        for k in RESTIR:
            assert cuda_build.launches[f"{k}_bf16"] == frames, k
            assert cuda_build.launches[k] == 0, k
