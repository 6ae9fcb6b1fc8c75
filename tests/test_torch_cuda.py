"""PyTorch port on the card: every CUDA kernel (K1-K14) against its plain
PyTorch version, the golden NEE and ReSTIR frames, the golden ReSTIR frame
with the kernel switches and the small big-mesh frame on the card against
the CPU, and the entry points' default device. Skipped where there is no CUDA device. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.camera import Camera, camera_matrices, generate_rays
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_build, cuda_gather, cuda_image, cuda_trace
from sunray_tpu_torch.ops import cuda_history
from sunray_tpu_torch.ops import binned_trace, cuda_binned, cuda_restir, intersect
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene import cornell_box
from torch_big_scene import big_scene_args, icosphere
from torch_di_spatial_cases import FIELDS as DI_FIELDS
from torch_di_spatial_cases import di_spatial_args
from torch_parity import (CAMERA, GOLDEN_KW, cuda_device, n, psnr,  # noqa: F401
                          tie_cluster_set)

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


def _atrous_guides(h, w, seed, dev, bypass="mixed"):
    """Guides with a sky band, ~10% rough-bypass pixels and albedo zeros;
    bypass="all": every pixel bypassed (depth >= 1e4 or roughness < 0.1)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    color, depth, rough, diffuse = 2.0 * f(h, w, 3), 1.0 + 3.0 * f(h, w), f(h, w), f(h, w, 3)
    depth[: max(1, h // 9)] = 100000.0
    diffuse[::7, ::5] = 0.0
    if bypass == "all":
        depth[h // 2:] = 100000.0
        rough[: h // 2] = 0.05
    normal = rng.normal(size=(h, w, 3)).astype(np.float32) * 0.1
    normal[..., 2] += 1.0
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (color, depth, normal, rough, diffuse))


@pytest.mark.parametrize("size", [(37, 53), (27, 48), (270, 480)])
def test_atrous_kernel_steps_match_plain(size, cuda_device):
    """K7's lattice tiles at every step 1-8 (ragged at the image's right
    and bottom edges), one pass each, and the four-pass denoise."""
    args = _atrous_guides(*size, seed=size[0], dev=cuda_device)
    for step in range(1, 9):
        got = cuda_image.atrous_pass(*args, step)
        want = cuda_image.atrous_denoise_pass(*args, step)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-5, step
        sky = args[1] >= 10000.0
        assert torch.equal(got[sky], args[0][sky])
    got = cuda_image.atrous_denoise(*args, 4)
    want = cuda_image.atrous_denoise_plain(*args, 4)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


def test_atrous_kernel_all_bypass(cuda_device):
    args = _atrous_guides(45, 70, seed=3, dev=cuda_device, bypass="all")
    got = cuda_image.atrous_denoise(*args, 4)
    torch.cuda.synchronize()
    assert torch.equal(got, args[0])


def _woop_rays(n, n_tris, seed, dev):
    """n rays against n_tris random triangles (every 17th degenerate),
    tmax per ray and exclude ids."""
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    tris = [v0, (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32),
            (v0 + rng.normal(size=(n_tris, 3)) * 0.6).astype(np.float32)]
    tris[2][::17] = tris[0][::17]
    o = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    dn = rng.normal(size=(n, 3))
    d = (dn / np.linalg.norm(dn, axis=-1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.1, 6.0, size=n).astype(np.float32)
    ex = rng.integers(-1, n_tris, size=n).astype(np.int32)
    to = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return tuple(to(x) for x in tris), to(o), to(d), to(tmax), to(ex)


@pytest.mark.parametrize("extra", [-1, 0, 1])
@pytest.mark.parametrize("n_tris", [1, 129, 300])
def test_woop_kernel_ragged_bit_equal(n_tris, extra, cuda_device):
    """K14 at rays-a-block +- 1 rays (a ragged last block) and triangle
    counts off the 128-triangle chunk, with and without exclude ids."""
    n = cuda_trace.WOOP_RAYS * cuda_trace.WOOP_THREADS * 3 + extra
    tris, o, d, tmax, ex = _woop_rays(n, n_tris, n_tris + extra, cuda_device)
    woop = intersect.woop_matrices(tris)
    for exclude in (None, ex):
        got = cuda_trace.trace_occluded_woop(woop, o, d, tmax, exclude=exclude)
        want = intersect.trace_occluded_woop(woop, o, d, tmax, exclude=exclude)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if n_tris > 1:
            assert 0.0 < want.float().mean().item() < 1.0


@pytest.mark.parametrize("extra", [-1, 0, 1])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n_tris", [1, 36, 129, 300])
def test_occluded_kernel_ragged_bit_equal(n_tris, wide, extra, cuda_device):
    """K2 at rays-a-block +- 1 rays (a ragged last block), on the wide
    launch (OCC_RAYS rays a thread) and the narrow one (one ray a thread),
    at triangle counts off the 128-triangle chunk, with and without exclude
    ids, with per-ray and scalar bounds."""
    n = (cuda_trace.OCC_WIDE_MIN + cuda_trace.OCC_RAYS * cuda_trace.OCC_THREADS
         if wide else cuda_trace.OCC_THREADS * 5) + extra
    tris, o, d, tmax, ex = _woop_rays(n, n_tris, 50 + n_tris + extra, cuda_device)
    for exclude in (None, ex):
        for bound in (tmax, 2.5):
            got = cuda_trace.trace_occluded(tris, o, d, bound, exclude=exclude)
            want = intersect.trace_occluded_brute(tris, o, d, bound,
                                                  exclude=exclude)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            if n_tris > 1:
                assert 0.0 < want.float().mean().item() < 1.0


def _closest_case(n, n_tris, seed, dev):
    """_woop_rays's rays and triangles, the last fifth of the triangles
    exact copies of the first (hits tied at equal t: the lower id wins),
    with per-ray tmin."""
    tris, o, d, tmax, _ = _woop_rays(n, n_tris, seed, dev)
    dup = n_tris // 5
    tris = tuple(torch.cat([x[:n_tris - dup], x[:dup]]).contiguous() for x in tris)
    rng = np.random.default_rng(seed)
    tmin = torch.from_numpy(rng.uniform(1e-4, 0.3, n).astype(np.float32)).to(dev)
    return tris, o, d, tmin, tmax


def _same_bits(got, want):
    for a, b in zip(got, want):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            return False
    return True


@pytest.mark.parametrize("extra", [-1, 0, 1])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n_tris", [1, 36, 129, 300])
def test_closest_kernel_ragged_bit_equal(n_tris, wide, extra, cuda_device):
    """K1 at rays-a-block +- 1 rays (a ragged last block), on the wide
    launch (CLOSEST_RAYS rays a thread) and the narrow one (one ray a
    thread), at triangle counts off the 128-triangle chunk, with
    degenerate triangles and exact duplicates, per-ray and scalar bounds;
    every field bit-equal to plain."""
    n = (cuda_trace.CLOSEST_WIDE_MIN
         + cuda_trace.CLOSEST_RAYS * cuda_trace.CLOSEST_THREADS
         if wide else cuda_trace.CLOSEST_THREADS * 5) + extra
    tris, o, d, tmin, tmax = _closest_case(n, n_tris, 70 + n_tris + extra,
                                           cuda_device)
    for bounds in ((tmin, tmax), (intersect.T_MIN, 2.5)):
        got = cuda_trace.trace_closest(tris, o, d, *bounds)
        want = intersect.trace_closest_brute(tris, o, d, *bounds)
        torch.cuda.synchronize()
        assert _same_bits(got, want)
        if n_tris > 1:
            assert 0.0 < want.hit.float().mean().item() < 1.0
        if n_tris >= 5:
            assert (want.tri < n_tris - n_tris // 5).all()


def _inv_det(x):
    """K1's and K2's reciprocal of each determinant (csrc/trace.cu
    inv_det, through sunray_inv_det) and IEEE 1 / x, each 0 where |x| <=
    1e-9 or x is NaN."""
    out = torch.empty_like(x)
    err = cuda_build.library().sunray_inv_det(x.data_ptr(), out.data_ptr(),
                                              x.numel(), cuda_build.stream_ptr())
    cuda_build.check_launch("sunray_inv_det", err)
    return out, torch.where(x.abs() > 1e-9, 1.0 / x, torch.zeros_like(x))


def test_branch_free_reciprocal_is_ieee_on_every_input(cuda_device):
    """The reciprocal without the IEEE one's slow-path branch gives its
    bits on all 2^32 float32 inputs (denormals, +-1e-9, huge, inf, NaN, +-0
    among them) and on 2^26 random determinants spread over the whole
    float32 range."""
    step = 1 << 28
    for start in range(0, 1 << 32, step):
        bits = torch.arange(start, start + step, dtype=torch.int64,
                            device=cuda_device)
        x = (bits - (bits >= 1 << 31).long() * (1 << 32)).to(torch.int32)
        got, want = _inv_det(x.view(torch.float32))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), start
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(1 << 26, generator=gen, device=cuda_device) * torch.exp(
        torch.randn(1 << 26, generator=gen, device=cuda_device) * 20.0)
    got, want = _inv_det(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_closest_launch_shape_is_the_hosts(cuda_device):
    """The library's K1 and K2 launch shapes are the host's copies (the
    load-time check, read once more here)."""
    lib = cuda_build.library()
    assert cuda_build.launch_shape(lib, "sunray_closest_launch_shape", 3) == (
        cuda_trace.CLOSEST_RAYS, cuda_trace.CLOSEST_THREADS,
        cuda_trace.CLOSEST_WIDE_MIN)
    assert cuda_build.launch_shape(lib, "sunray_occluded_launch_shape", 3) == (
        cuda_trace.OCC_RAYS, cuda_trace.OCC_THREADS, cuda_trace.OCC_WIDE_MIN)


@pytest.mark.parametrize("n_taps", range(1, cuda_restir.MAX_TAPS + 1))
def test_di_spatial_kernel_bit_equal(n_taps, cuda_device):
    """K5 on seeded 333x187 frames (a ragged last block) with 1-8 shared
    taps, off every image edge and near: seeds and every output bit-equal
    to plain."""
    rng = np.random.default_rng(n_taps)
    taps = [tuple(int(v) for v in rng.integers(-40, 41, 2)) for _ in range(n_taps)]
    args = di_spatial_args(taps, 90 + n_taps, 333, 187, cuda_device)
    seed_k, got = cuda_restir.di_spatial(*args)
    seed_p, want = cuda_restir.di_spatial_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(seed_k, seed_p)
    assert _same_bits([got[k] for k in DI_FIELDS], [want[k] for k in DI_FIELDS])
    assert 0.0 < want["has"].float().mean().item() < 1.0


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


@pytest.mark.parametrize("lighting,frames", [("nee", 4), ("restir", 8)])
def test_frame_on_card_matches_cpu(lighting, frames, cuda_device):
    cfg = RenderConfig(**dict(GOLDEN_KW, lighting=lighting))
    ldrs = {}
    for dev in ("cpu", cuda_device):
        scene = cornell_box(device=dev)
        mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                               device=dev)
        state = RenderState.create(cfg, dev)
        cuda_build.launches.clear()
        for _ in range(frames):
            state, ldr, _ = render_frame(scene, cfg, state, mats)
        assert ldr.device == torch.device(dev)
        ldrs[str(dev)] = n(ldr)
    p = psnr(ldrs["cpu"], ldrs[str(cuda_device)])
    assert p > 40.0, f"PSNR card vs CPU = {p:.2f} dB"
    names = ["trace_closest", "trace_occluded", "gather_rows",
             "gather_rows_multi", "atrous_pass"]
    if lighting == "restir":
        names += list(RESTIR)
    for name in names:
        assert cuda_build.launches[name] > 0, name


# K3-K6: kernel -> plain version, and what each is held to: (winner id,
# exact fields, fields compared on lanes whose winner agrees).
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


def _restir_frame_inputs(dev, frame=2):
    """The arguments each K3-K6 wrapper got in frame `frame` of the golden
    ReSTIR config on the card (live history)."""
    cfg = RenderConfig(**dict(GOLDEN_KW, lighting="restir"))
    scene = cornell_box(device=dev)
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                           device=dev)
    state = RenderState.create(cfg, dev)
    for _ in range(frame):
        state, _, _ = render_frame(scene, cfg, state, mats)
    captured = {}
    saved = {name: getattr(cuda_restir, name) for name in RESTIR}

    def recorder(name):
        def call(*args):
            captured.setdefault(name, args)
            return saved[name](*args)
        return call

    try:
        for name in RESTIR:
            setattr(cuda_restir, name, recorder(name))
        render_frame(scene, cfg, state, mats)
    finally:
        for name, fn in saved.items():
            setattr(cuda_restir, name, fn)
    return captured


def _check_restir(name, args):
    plain, win, exact, close = RESTIR[name]
    seed_k, out_k = getattr(cuda_restir, name)(*args)
    seed_p, out_p = getattr(cuda_restir, plain)(*args)
    torch.cuda.synchronize()
    assert torch.equal(seed_k, seed_p)
    for key in exact:
        assert torch.equal(out_k[key], out_p[key]), key
    same = out_k[win] == out_p[win]
    assert same.float().mean().item() > 0.995
    for key in close:
        torch.testing.assert_close(out_k[key][same], out_p[key][same],
                                   rtol=3e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(RESTIR))
def test_restir_kernels_match_plain(name, cuda_device):
    captured = _restir_frame_inputs(cuda_device)
    _check_restir(name, captured[name])


@pytest.mark.parametrize("n_lights", [1, 2, 600, cuda_restir.RIS_SMEM_LIGHTS,
                                      cuda_restir.RIS_SMEM_LIGHTS + 1, 1500])
def test_ris_audition_kernel_light_tables(n_lights, cuda_device):
    """K3 with the light records in shared memory (up to RIS_SMEM_LIGHTS
    lights, 48 KB) and read through the read-only cache (one light more,
    and 1,500 lights)."""
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
    args = (table, seed, f(p, 3, hi=2.0), unit(), unit(), f(p, 3),
            f(p, lo=0.05), f(p), 16, f(p) > 0.2)
    _check_restir("ris_audition", args)


# K10-K12: the binned tracer. Rays agree (tri and hit, or occluded) on
# >= 99.99% of lanes and t/u/v within 1e-5 where they do, the bar
# chip_smoke.py holds them to; K11 bit for bit.
AGREE, UVT_ATOL = 0.9999, 1e-5


def _binned_case(dev, kind, k=128):
    """A ClusterSet over a subdivided icosphere plus random triangles, and
    rays: "camera" a fan, "random" anywhere, "center" from the middle
    (many superclusters per ray: the overflow case at k=32)."""
    rng = np.random.default_rng(7)
    verts, faces = icosphere(4)
    v0 = rng.normal(size=(3000, 3)).astype(np.float32) * 2.0
    tris = [np.concatenate([verts[faces[:, c]], v0 + (
        rng.normal(size=v0.shape) * 0.2).astype(np.float32) * (c > 0)])
        for c in range(3)]
    cs = binned_trace.build_cluster_set(
        tuple(torch.from_numpy(x).to(dev) for x in tris), k=k)
    m = 60_000
    if kind == "camera":
        o = np.broadcast_to(np.float32([0.0, 0.0, 6.0]), (m, 3)).copy()
        d = np.concatenate([rng.uniform(-0.5, 0.5, (m, 2)),
                            -np.ones((m, 1))], axis=1)
    else:
        o = rng.normal(size=(m, 3)) * (0.1 if kind == "center" else 3.0)
        d = rng.normal(size=(m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.abs(rng.normal(size=m)) * 4.0 + 0.2
    ex = rng.integers(-1, tris[0].shape[0], size=m)
    f = lambda x, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x)).to(dev, dt)
    return cs, f(o), f(d), f(tmax), f(ex, torch.int32)


def _check_closest(k, p):
    torch.cuda.synchronize()
    agree = k[1] == p[1]
    assert agree.float().mean().item() >= AGREE
    both = agree & (p[1] >= 0)
    assert (p[1] >= 0).any()
    for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])):
        assert (a[both] - b[both]).abs().max().item() <= UVT_ATOL


def _check_occ(k, p):
    torch.cuda.synchronize()
    assert (k == p).float().mean().item() >= AGREE
    assert 0.0 < p.float().mean().item() < 1.0


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_binned_round_kernel_matches_plain(kind, cuda_device):
    cs, o, d, tmax, ex = _binned_case(cuda_device, kind)
    o, d, tmax, ex, _ = binned_trace._reorder_rays(cs, o, d, tmax, ex)
    o_t, d_t, tn, tx, ex, _, nb = binned_trace._prep(o, d, 1e-3, tmax, ex)
    hit, entry = binned_trace._interval_cull(o_t, d_t, tn, tx, cs.aabb_lo,
                                             cs.aabb_hi, nb)
    order, ents, count = binned_trace._work_list(hit, entry)
    args = (order, ents, count, o_t, d_t, tn, tx, ex, cs)
    cuda_build.launches.clear()
    _check_closest(cuda_binned.binned_round(*args),
                   cuda_binned.binned_round_plain(*args))
    _check_occ(cuda_binned.binned_round(*args, closest=False),
               cuda_binned.binned_round_plain(*args, closest=False))
    assert cuda_build.launches["binned_round"] == 2


def _big_small_rays(dev, kind, k=None):
    """(ClusterSet, o, d, tmax, exclude) on the small big-mesh scene
    (subdiv 3; cluster_k 32, 8 for "fallback", or k), from 320x240 camera
    rays: "camera" the rays themselves; "fallback" bounce
    rays off the visible surfaces, those that cross more than L_SLOTS
    superclusters kept and the others masked to tmax = -inf (dead blocks);
    "visibility" bounce rays on short segments with exclude ids; "dead"
    half the rays masked and 123 padding lanes; "grazing" rays from near
    the box's walls nearly parallel to them, and "corners" rays aimed at
    cluster box corners and the box's corners (the per-warp cull's hardest
    cases, tests/test_torch_binned_cull.py)."""
    from sunray_tpu_torch.ops.brdf import normalize
    from sunray_tpu_torch.scene.types import MaterialTable, build_scene

    args = big_scene_args(3)
    scene = build_scene(**dict(args, device=dev, materials=MaterialTable.build(
        args["materials"], dev)))
    tris = tuple(x.contiguous() for x in scene.world_triangle_vertices())
    cs = binned_trace.build_cluster_set(
        tris, k=k or (8 if kind == "fallback" else 32))
    mats = camera_matrices(Camera(**CAMERA), 320, 240, device=dev)
    o, d = (x.reshape(-1, 3).contiguous() for x in generate_rays(mats, 320, 240))
    m = o.shape[0] - (123 if kind == "dead" else 0)
    o, d = o[:m], d[:m]
    gen = torch.Generator(device=dev).manual_seed(5)
    tmax = torch.full((m,), intersect.T_MAX, device=dev)
    ex = None
    if kind in ("grazing", "corners"):
        u = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
        axis = torch.randint(0, 3, (m,), generator=gen, device=dev)
        lanes = torch.arange(m, device=dev)
        if kind == "grazing":
            o = u(m, 3) * 2.0
            o[lanes, axis] = (u(m) < 0.5) * 2.0 + (u(m) - 0.5) * 0.1
            d = torch.randn((m, 3), generator=gen, device=dev)
            d[lanes, axis] *= torch.tensor([1e-2, 1e-4, 1e-6], device=dev)[
                torch.randint(0, 3, (m,), generator=gen, device=dev)]
        else:
            c = torch.randint(0, cs.num_clusters, (m,), generator=gen, device=dev)
            pick = u(m, 3) < 0.5
            target = torch.where(pick, cs.aabb_lo[c], cs.aabb_hi[c])
            target[: m // 4] = pick[: m // 4] * 2.0
            o = u(m, 3) * 3.0 - 0.5
            d = target - o
        d = normalize(d).contiguous()
        o = o.contiguous()
    elif kind != "camera":
        hit = cuda_trace.trace_closest(tris, o, d)
        p = o + d * torch.where(hit.hit, hit.t, 1.0)[:, None]
        d = normalize(torch.randn((m, 3), generator=gen, device=dev)).contiguous()
        o = (p + d * 1e-3).contiguous()
        ex = torch.randint(-1, tris[0].shape[0], (m,), generator=gen, device=dev,
                           dtype=torch.int32)
    if kind == "visibility":
        tmax = torch.rand((m,), generator=gen, device=dev) * 2.0 + 0.05
    elif kind == "fallback":
        o_t, d_t, tn, tx, _, _, _ = binned_trace._prep(o, d, intersect.T_MIN, tmax,
                                                       None)
        _, cnt = binned_trace._cluster_scan(cs, o_t, d_t, tn, tx)
        tmax = torch.where(cnt[:m] > cuda_binned.L_SLOTS, tmax, -torch.inf)
    elif kind == "dead":
        tmax[torch.rand((m,), generator=gen, device=dev) < 0.5] = -torch.inf
    return cs, o, d, tmax, ex


def _big_small_args(dev, kind):
    """K10's inputs for _big_small_rays(dev, kind), as
    trace_*_binned(reorder=True) makes them."""
    cs, o, d, tmax, ex = _big_small_rays(dev, kind)
    o, d, tmax, ex, _ = binned_trace._reorder_rays(cs, o, d, tmax, ex)
    o_t, d_t, tn, tx, ex, _, nb = binned_trace._prep(o, d, intersect.T_MIN, tmax, ex)
    hit, entry = binned_trace._interval_cull(o_t, d_t, tn, tx, cs.aabb_lo,
                                             cs.aabb_hi, nb)
    return (*binned_trace._work_list(hit, entry), o_t, d_t, tn, tx, ex, cs)


@pytest.mark.parametrize("kind", ["camera", "fallback", "visibility", "dead",
                                  "grazing", "corners"])
def test_binned_round_kernel_bit_equal(kind, cuda_device):
    """K10 (the per-warp cull, the staged walk) against binned_round_plain
    on every lane, closest and any-hit, and against the plain model of its
    walk; one launch a call."""
    args = _big_small_args(cuda_device, kind)
    count, tx = args[2], args[6]
    if kind == "fallback":
        assert (count == 0).any() and (tx > -torch.inf).any()
    for closest in (True, False):
        cuda_build.launches.clear()
        got = cuda_binned.binned_round(*args, closest=closest)
        want = cuda_binned.binned_round_plain(*args, closest=closest)
        model, _ = cuda_binned.binned_round_warp(*args, closest=closest)
        torch.cuda.synchronize()
        assert cuda_build.launches["binned_round"] == 1
        if closest:
            assert (want[1] >= 0).any()
            for a, b, c in zip(got, want, model):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
                assert torch.equal(c.view(torch.int32), b.view(torch.int32))
        else:
            assert want.any()
            assert torch.equal(got, want) and torch.equal(model, want)


@pytest.mark.parametrize("k", [128, 32, 30])
def test_scan_and_pair_kernels_match_plain(k, cuda_device):
    """K11 and K12 against their plain versions; k = 30 takes K12's
    one-slot-a-load path and 4-byte copies (k not a multiple of 4)."""
    cs, o, d, tmax, ex = _binned_case(cuda_device, "center", k)
    o_t, d_t, tn, tx, ex, _, _ = binned_trace._prep(o, d, 1e-3, tmax, ex)
    box = binned_trace.supercluster_boxes(cs)
    got = cuda_binned.cluster_scan(o_t, d_t, tn, tx, box)
    want = cuda_binned.cluster_scan_plain(o_t, d_t, tn, tx, box)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if k == 32:
        assert (want[1] > cuda_binned.L_SLOTS).any()     # the overflow case
    cid_s, pos_s, runs, n_sc, _ = binned_trace._pair_stream_prep(
        cs, o_t, d_t, tn, tx)
    args = (cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc)
    _check_closest(cuda_binned.pair_round(*args),
                   cuda_binned.pair_round_plain(*args))
    _check_occ(cuda_binned.pair_round(*args, closest=False),
               cuda_binned.pair_round_plain(*args, closest=False))


def _pair_args(dev, kind):
    """K12's inputs, as trace_*_pairs makes them, on the small big-mesh
    scene at cluster_k 8 (so that blocks of 512 pair lanes hold several
    superclusters' runs): _big_small_rays's "camera", "visibility",
    "grazing" and "corners" rays; "ties" the camera rays on a ClusterSet
    whose second cluster of each supercluster repeats the first's
    triangles under other ids (exact ties across clusters); "dead" a launch
    in which no lane holds a pair."""
    cs, o, d, tmax, ex = _big_small_rays(dev, "camera" if kind in ("ties", "dead")
                                         else kind, k=8)
    if kind == "ties":
        cs = tie_cluster_set(cs)
    o_t, d_t, tn, tx, ex, _, _ = binned_trace._prep(o, d, intersect.T_MIN, tmax, ex)
    cid_s, pos_s, runs, n_sc, _ = binned_trace._pair_stream_prep(cs, o_t, d_t, tn,
                                                                 tx)
    if kind == "dead":
        cid_s = torch.full_like(cid_s, n_sc)
        runs = torch.zeros_like(runs)
    return cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc


@pytest.mark.parametrize("kind", ["camera", "visibility", "grazing", "corners",
                                  "ties", "dead"])
def test_pair_round_kernel_bit_equal(kind, cuda_device):
    """K12 (the per-warp cull, the staged walk) against pair_round_plain at
    every pair position, closest and any-hit, and against the plain model
    of its walk; one launch a call."""
    args = _pair_args(cuda_device, kind)
    cid_s, runs, n_sc = args[0], args[2], args[9]
    if kind == "dead":
        assert not (cid_s < n_sc).any()
    else:
        assert (runs > 1).any()          # CTAs that straddle superclusters
    for closest in (True, False):
        cuda_build.launches.clear()
        got = cuda_binned.pair_round(*args, closest=closest)
        want = cuda_binned.pair_round_plain(*args, closest=closest)
        model, _ = cuda_binned.pair_round_warp(*args, closest=closest)
        torch.cuda.synchronize()
        assert cuda_build.launches["pair_round"] == 1
        if closest:
            assert (want[1] >= 0).any() == (kind != "dead")
            for a, b, c in zip(got, want, model):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
                assert torch.equal(c.view(torch.int32), b.view(torch.int32))
        else:
            assert want.any() == (kind != "dead")
            assert torch.equal(got, want) and torch.equal(model, want)


@pytest.mark.parametrize("case", ["tiles", "one", "axis", "overflow"])
def test_cluster_scan_kernel_bit_exact(case, cuda_device):
    """K11 against cluster_scan_plain, slots and counts bit for bit: 600
    boxes (three shared-memory tiles of 256, the last one partial), one
    box, rays parallel to the axes (zero direction components), and rays
    inside most of 40 nested boxes (counts above L_SLOTS); 1,536 lanes, not
    a whole number of the kernel's 1,024-ray blocks."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    u = lambda *shape: torch.rand(shape, generator=gen, device=cuda_device)  # noqa: E731
    nl = 3 * cuda_binned.BLOCK_RAYS
    s = {"tiles": 600, "one": 1, "axis": 200, "overflow": 40}[case]
    lo = u(s, 3) * 4.0 - 2.0
    box = torch.cat([lo, lo + u(s, 3)], dim=1)
    if case == "overflow":
        r = torch.linspace(0.2, 2.0, s, device=cuda_device)[:, None]
        box = torch.cat([-r.expand(s, 3), r.expand(s, 3)], dim=1)
    o = u(nl, 3) * 6.0 - 3.0
    d = torch.randn((nl, 3), generator=gen, device=cuda_device)
    if case == "axis":
        axis = torch.randint(0, 3, (nl,), generator=gen, device=cuda_device)
        d = torch.nn.functional.one_hot(axis, 3).float() * torch.sign(
            torch.randn((nl, 1), generator=gen, device=cuda_device))
    elif case == "overflow":
        o = o * 0.05
    d = d / d.norm(dim=1, keepdim=True)
    tn = torch.full((nl,), 1e-3, device=cuda_device)
    tx = u(nl) * 8.0
    args = (o.T.contiguous(), d.T.contiguous(), tn, tx, box.contiguous())
    cuda_build.launches.clear()
    got = cuda_binned.cluster_scan(*args)
    want = cuda_binned.cluster_scan_plain(*args)
    torch.cuda.synchronize()
    assert cuda_build.launches["cluster_scan"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] > 0).any()
    if case == "overflow":
        assert (want[1] > cuda_binned.L_SLOTS).any()


@pytest.mark.parametrize("path", ["block", "pairs"])
def test_binned_traces_card_match_cpu(path, cuda_device):
    """The whole binned trace (sorts, cull, kernels, overflow fallback) on
    the card against the same on the CPU (plain versions)."""
    outs = []
    for dev in (cuda_device, "cpu"):
        cs, o, d, tmax, ex = _binned_case(dev, "center", 32)
        if path == "block":
            h = binned_trace.trace_closest_binned(cs, o, d, tmax=tmax,
                                                  exclude=ex, reorder=True)
            occ = binned_trace.trace_occluded_binned(cs, o, d, tmax,
                                                     exclude=ex, reorder=True)
        else:
            h = binned_trace.trace_closest_pairs(cs, o, d, tmax=tmax)
            occ = binned_trace.trace_occluded_pairs(cs, o, d, tmax, exclude=ex)
        outs.append((tuple(x.cpu() for x in h), occ.cpu()))
    (kh, ko), (ph, po) = outs
    _check_closest((kh[0], torch.where(kh[4], kh[1], -1), kh[2], kh[3]),
                   (ph[0], torch.where(ph[4], ph[1], -1), ph[2], ph[3]))
    assert (ko == po).float().mean().item() >= AGREE


def test_big_mesh_frame_on_card_matches_cpu(cuda_device):
    """The small big-mesh config (mirror sphere at subdiv 3, cluster_k 32)
    on the card against the CPU; K10-K12 launch."""
    from sunray_tpu_torch.scene.types import MaterialTable, build_scene

    cfg = RenderConfig(**dict(GOLDEN_KW, lighting="restir", width=48,
                              height=32, cluster_k=32))
    ldrs = {}
    for dev in ("cpu", cuda_device):
        args = big_scene_args(3)
        scene = build_scene(**dict(args, device=dev, materials=MaterialTable.build(
            args["materials"], dev)))
        accel = binned_trace.build_cluster_set(scene.world_triangle_vertices(),
                                               k=cfg.cluster_k)
        mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                               device=dev)
        state = RenderState.create(cfg, dev)
        cuda_build.launches.clear()
        for _ in range(3):
            state, ldr, _ = render_frame(scene, cfg, state, mats, accel)
        ldrs[str(dev)] = n(ldr)
    p = psnr(ldrs["cpu"], ldrs[str(cuda_device)])
    assert p > 40.0, f"PSNR card vs CPU = {p:.2f} dB"
    for name in ("binned_round", "cluster_scan", "pair_round"):
        assert cuda_build.launches[name] > 0, name


def test_entry_points_default_to_cuda(cuda_device):
    from sunray_tpu_torch import convert

    cfg = RenderConfig(width=8, height=8)
    assert cornell_box().positions.is_cuda
    assert camera_matrices(Camera(**CAMERA), 8, 8)["view_proj"].is_cuda
    assert RenderState.create(cfg).accum.is_cuda
    assert convert.mats_from_numpy({"m": np.eye(4)})["m"].is_cuda


# K9, K13, K14: the Cornell frame's kernel switches.

@pytest.mark.parametrize("size", [(270, 480), (37, 53)])
def test_taa_kernel_matches_plain(size, cuda_device):
    rng = np.random.default_rng(size[0])
    h, w = size
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.uniform(size=s).astype(np.float32)).to(cuda_device)
    raw = 3.0 * f(h, w, 3)
    raw[h // 3:h // 2, w // 4:w // 2] *= 20.0
    hist = 3.0 * f(h, w, 3)
    use = f(h, w) > 0.3
    use[0], use[:, -1] = False, False
    got = cuda_image.taa_clamp_blend(raw, hist, use, 0.14)
    want = cuda_image.taa_clamp_blend_plain(raw, hist, use, 0.14)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[~use], raw[~use])


@pytest.mark.parametrize("size", [(270, 480), (37, 53)])
def test_taa_window_kernel_matches_plain(size, cuda_device):
    """K9's window form on a band of rows [r0, r0 + h) of a frame: bit-equal
    to its plain twin and to the whole-frame K9's band, on the first and
    last band too (edge-replicated rows above and below)."""
    rng = np.random.default_rng(size[1])
    h, w = size
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.uniform(size=s).astype(np.float32)).to(cuda_device)
    raw = 3.0 * f(3 * h, w, 3)
    raw[h // 3:2 * h, w // 4:w // 2] *= 20.0
    hist = 3.0 * f(3 * h, w, 3)
    use = f(3 * h, w) > 0.3
    whole = cuda_image.taa_clamp_blend(raw, hist, use, 0.14)
    padded = torch.cat([raw[:1], raw, raw[-1:]])
    cuda_build.launches.clear()
    for r0 in (0, h, 2 * h):
        band = (raw[r0:r0 + h], hist[r0:r0 + h].contiguous(),
                use[r0:r0 + h].contiguous(), 0.14)
        raw_x = padded[r0:r0 + h + 2].contiguous()
        got = cuda_image.taa_clamp_blend(*band, raw_x=raw_x)
        want = cuda_image.taa_clamp_blend_plain(*band, raw_x=raw_x)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, whole[r0:r0 + h])
    assert cuda_build.launches["taa_clamp_blend_window"] == 3
    assert cuda_build.launches["taa_clamp_blend"] == 0


def test_history_gather_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    p, m = 300_000, 1_200_000
    fields = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device)
              for s in ((p, 3), (p,), (p, 3), (p,), (p, 3), (p,))]
    ids = rng.integers(-2**31, 2**31 - 1, size=p, dtype=np.int64).astype(np.int32)
    fields += [torch.from_numpy(ids).to(cuda_device),
               torch.from_numpy(ids.view(np.float32).copy()).to(cuda_device)]
    idx = torch.from_numpy(rng.integers(-3, p + 3, size=m)).to(cuda_device)
    cuda_build.launches.clear()
    got = cuda_history.history_gather(fields, idx)
    want = cuda_history.history_gather_plain(fields, idx)
    torch.cuda.synchronize()
    assert cuda_build.launches["history_gather"] == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(cuda_build.KernelError):
        cuda_history.history_gather(fields, idx.int())


def _history_fields(rng, p, widths, dev):
    """Fields of the given widths, float32 and int32 in turn, of random
    bits with quiet-NaN payloads and denormals in every fourth word."""
    fields = []
    for c, w in enumerate(widths):
        bits = rng.integers(-2**31, 2**31, size=(p, w) if w > 1 else (p,),
                            dtype=np.int64).astype(np.int32)
        flat = bits.reshape(-1)
        flat[::4] = (0x7FC00000 | rng.integers(1, 1 << 22, flat[::4].shape)
                     ).astype(np.int32)
        flat[1::4] = rng.integers(1, 1 << 23, flat[1::4].shape).astype(np.int32)
        x = torch.from_numpy(bits).to(dev)
        fields.append(x.view(torch.float32) if c % 2 == 0 else x)
    return fields


@pytest.mark.parametrize("widths", [(1,), (3,), (1, 2, 3, 4) * 4, (3, 7, 1, 4)],
                         ids=["one_field", "width3", "sixteen_fields", "wide"])
def test_history_gather_bit_exact(widths, cuda_device):
    """K13 on mixed float32 / int32 fields of widths 1-4 (7: the generic
    path), NaN payloads and denormal bit patterns, with indices below 0
    and at or above P, and M != P (neither a whole number of tiles)."""
    rng = np.random.default_rng(len(widths))
    p, m = 70_001, 123_457
    fields = _history_fields(rng, p, widths, cuda_device)
    idx_np = rng.integers(-5, p + 5, size=m)
    idx_np[:4] = [-1, p, p + 1000, -(2**40)]
    idx = torch.from_numpy(idx_np).to(cuda_device)
    cuda_build.launches.clear()
    got = cuda_history.history_gather(fields, idx)
    want = cuda_history.history_gather_plain(fields, idx)
    torch.cuda.synchronize()
    assert cuda_build.launches["history_gather"] == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(cuda_build.KernelError):
        cuda_history.history_gather(fields * (17 // len(fields) + 1), idx)


def test_window_select_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(2)
    c, p, pad = 8, 40_000, 1024
    table = torch.from_numpy(rng.normal(size=(c, p + 2 * pad)).astype(np.float32))
    key = torch.from_numpy(rng.integers(-1, 4, size=p).astype(np.int32))
    taps, g = [0, -1, -200, -201], 333
    want = cuda_history.window_select(table, key, g, taps, pad_l=pad)
    got = cuda_history.window_select(table.to(cuda_device), key.to(cuda_device),
                                     g, taps, pad_l=pad)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["cornell", "random"])
def test_woop_kernel_matches_plain(case, cuda_device):
    """K14 with and without exclude ids; "random" has 4,096 triangles, 32
    shared-memory chunks."""
    tris, o, d, tmax, ex = _trace_case(case, cuda_device)
    woop = intersect.woop_matrices(tris)
    for exclude in (None, ex):
        got = cuda_trace.trace_occluded_woop(woop, o, d, tmax, exclude=exclude)
        want = intersect.trace_occluded_woop(woop, o, d, tmax, exclude=exclude)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert 0.0 < want.float().mean().item() < 1.0
        mt = intersect.trace_occluded_brute(tris, o, d, tmax, exclude=exclude)
        assert (got == mt).float().mean().item() >= 0.9995


SWITCHES = dict(taa_kernel="pallas", history_select_kernel="auto",
                history_joint_gather=True, trace_impl="woop")


def test_switches_frame_on_card_matches_cpu(cuda_device):
    """The golden ReSTIR config with the four switches, 4 frames, card
    against CPU; K9, K13 and K14 launch and K2 does not."""
    cfg = RenderConfig(**dict(GOLDEN_KW, lighting="restir", **SWITCHES))
    ldrs = {}
    for dev in ("cpu", cuda_device):
        scene = cornell_box(device=dev)
        mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                               device=dev)
        state = RenderState.create(cfg, dev)
        cuda_build.launches.clear()
        for _ in range(4):
            state, ldr, _ = render_frame(scene, cfg, state, mats)
        ldrs[str(dev)] = n(ldr)
    p = psnr(ldrs["cpu"], ldrs[str(cuda_device)])
    assert p > 40.0, f"PSNR card vs CPU = {p:.2f} dB"
    for name in ("taa_clamp_blend", "history_gather", "trace_occluded_woop",
                 "trace_closest", "di_temporal"):
        assert cuda_build.launches[name] > 0, name
    assert cuda_build.launches["trace_occluded"] == 0
