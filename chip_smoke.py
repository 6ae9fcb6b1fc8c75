#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sunray_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure raises and exits non-zero with no result:
  1. require a CUDA device; print the card's name and power limit
     (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
  2. build the kernels from csrc/ (nvcc, sm_90a);
  3. hold every kernel of the main path to its plain PyTorch version on
     the card at the main path's shapes, and time both (CUDA events,
     median of 10 runs):
       K1/K2 trace: 2,073,600 Cornell camera and bounce rays x 36 tris,
                    65,536 random rays x 4,096 random tris;
       K8 gather:   72x6 and 36x4 tables, 3 x 2,073,600 indices with
                    out-of-range ones;
       K7 a-trous:  1080x1920, 4 passes;
  4. render the golden NEE config (tests/test_golden.py:36-40, 96x64,
     4 frames) on the card and on the CPU: PSNR > 40 dB between them and
     against tests/goldens/cornell_nee.npy;
  5. the main path: render_frame at 1920x1080, lighting="nee", Cornell
     camera (1,1,3.4) -> (1,1,0), fov 45; 5 warm-up and 20 timed frames.
     The launch counters are zeroed just before and read just after; every
     kernel must have launched. Prints frame ms, rays per frame (the trace
     wrappers' batch sizes, full-batch as bench.py:7-13 counts them) and
     peak device memory.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_KW = dict(width=96, height=64, bounces=4, virtual_bounces=3,
                 ris_candidates=8, di_spatial_samples=3, gi_spatial_samples=2,
                 denoise_passes=2, lighting="nee")
CAMERA = dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
TRACE_AGREE = 0.9999      # tri / hit / occluded agreement on the card
UVT_ATOL = 1e-5           # t, u, v where tri agrees
ATROUS_ATOL = 1e-5
PSNR_MIN = 40.0           # tests/test_golden.py:80
REPS = 10


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=REPS):
    """Median of `reps` CUDA-event timings of fn() after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


# -- phase 3: kernels against their plain versions ---------------------------

def compare_closest(tris, o, d, label):
    from sunray_tpu_torch.ops import cuda_trace, intersect

    k = cuda_trace.trace_closest(tris, o, d)
    p = intersect.trace_closest_brute(tris, o, d)
    torch.cuda.synchronize()
    agree = (k.tri == p.tri) & (k.hit == p.hit)
    frac = agree.float().mean().item()
    both = agree & p.hit
    err = max((a[both] - b[both]).abs().max().item() if both.any() else 0.0
              for a, b in ((k.t, p.t), (k.u, p.u), (k.v, p.v)))
    log(f"  K1 closest {label}: {o.shape[0]} rays x {tris[0].shape[0]} tris, "
        f"tri/hit agree {frac:.7f}, max |t,u,v| err {err:.3g}, "
        f"hit rate {p.hit.float().mean().item():.4f}")
    check(frac >= TRACE_AGREE, f"K1 {label}: agreement {frac} < {TRACE_AGREE}")
    check(err <= UVT_ATOL, f"K1 {label}: t/u/v error {err} > {UVT_ATOL}")
    return frac, err, k


def compare_occluded(tris, o, d, tmax, exclude, label):
    from sunray_tpu_torch.ops import cuda_trace, intersect

    k = cuda_trace.trace_occluded(tris, o, d, tmax, exclude=exclude)
    p = intersect.trace_occluded_brute(tris, o, d, tmax, exclude=exclude)
    torch.cuda.synchronize()
    frac = (k == p).float().mean().item()
    err = (k.float() - p.float()).abs().max().item()
    log(f"  K2 occluded {label}: {o.shape[0]} rays x {tris[0].shape[0]} tris, "
        f"agree {frac:.7f}, occluded rate {p.float().mean().item():.4f}")
    check(frac >= TRACE_AGREE, f"K2 {label}: agreement {frac} < {TRACE_AGREE}")
    return frac, err


def phase_kernels(dev, width=1920, height=1080, n_random=(65536, 4096)):
    from sunray_tpu_torch.camera import Camera, camera_matrices, generate_rays
    from sunray_tpu_torch.ops import cuda_gather, cuda_image, cuda_trace, intersect
    from sunray_tpu_torch.ops.brdf import normalize
    from sunray_tpu_torch.render import restir
    from sunray_tpu_torch.scene import cornell_box

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    results = {}
    scene = cornell_box(device=dev)
    tris = tuple(t.contiguous() for t in scene.world_triangle_vertices())
    mats = camera_matrices(Camera(**CAMERA), width, height, device=dev)
    o, d = generate_rays(mats, width, height)
    o = o.reshape(-1, 3).contiguous()
    d = d.reshape(-1, 3).contiguous()
    n = o.shape[0]

    log("phase 3: kernels against their plain versions")
    f_cam, e_cam, hit = compare_closest(tris, o, d, "camera")
    # Bounce rays: from the camera hits, uniform random directions.
    pos = (o + d * torch.where(hit.hit, hit.t, 1.0)[:, None]).contiguous()
    bd = normalize(randn(n, 3)).contiguous()
    f_b, e_b, _ = compare_closest(tris, pos + bd * 1e-3, bd, "bounce")
    # Shadow rays to random points on the light, excluding its triangle.
    lights = restir.Lights(scene)
    lidx = torch.randint(0, lights.num, (n,), generator=gen, device=dev)
    lpos, _, _, _ = lights.sample_point(lidx, rand(n), rand(n))
    sv = lpos - pos
    dist = sv.norm(dim=-1)
    sdir = (sv / dist[:, None]).contiguous()
    ex = lights.world_tri[lidx].contiguous()
    f_s, e_s = compare_occluded(tris, pos, sdir, (dist - 1e-3).contiguous(), ex,
                                "shadow")
    # Random rays against random triangles (brute_force_max_tris = 4096).
    nr, nt = n_random
    v0 = randn(nt, 3)
    rtris = (v0.contiguous(), (v0 + randn(nt, 3) * 0.3).contiguous(),
             (v0 + randn(nt, 3) * 0.3).contiguous())
    ro = (randn(nr, 3) * 3.0).contiguous()
    rd = normalize(randn(nr, 3)).contiguous()
    f_r, e_r, _ = compare_closest(rtris, ro, rd, "random")
    rex = torch.randint(-1, nt, (nr,), generator=gen, device=dev,
                        dtype=torch.int32)
    rtmax = (rand(nr) * 6.0).contiguous()
    f_ro, e_ro = compare_occluded(rtris, ro, rd, rtmax, rex, "random")

    results["trace_closest"] = dict(
        agree=min(f_cam, f_b, f_r), max_abs_err=max(e_cam, e_b, e_r),
        ms=time_ms(lambda: cuda_trace.trace_closest(tris, o, d)),
        plain_ms=time_ms(lambda: intersect.trace_closest_brute(tris, o, d)),
    )
    results["trace_occluded"] = dict(
        agree=min(f_s, f_ro), max_abs_err=max(e_s, e_ro),
        ms=time_ms(lambda: cuda_trace.trace_occluded(
            tris, pos, sdir, dist - 1e-3, exclude=ex)),
        plain_ms=time_ms(lambda: intersect.trace_occluded_brute(
            tris, pos, sdir, dist - 1e-3, exclude=ex)),
    )

    # K8: the shade pass's two fetches, with out-of-range indices.
    vgeo = torch.cat([scene.positions, scene.normals], dim=1).contiguous()
    tpack = torch.cat([scene.tri_vidx, scene.tri_inst[:, None]], dim=1).contiguous()
    check(tuple(vgeo.shape) == (72, 6) and tuple(tpack.shape) == (36, 4),
          f"unexpected table shapes {tuple(vgeo.shape)} {tuple(tpack.shape)}")
    vidx = torch.randint(-8, 80, (3, n), generator=gen, device=dev,
                         dtype=torch.int32)
    tidx = torch.randint(-8, 44, (1, n), generator=gen, device=dev,
                         dtype=torch.int32)
    exact = True
    for table, idx in ((vgeo, vidx), (tpack, tidx)):
        k = cuda_gather.gather_rows(table, idx)
        p = cuda_gather.gather_rows_plain(table, idx)
        exact &= bool(torch.equal(k, p))
    log(f"  K8 gather_rows: 72x6 @ 3x{n} and 36x4 @ 1x{n}, bit-exact {exact}")
    check(exact, "K8 gather_rows differs from its plain version")
    results["gather_rows"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: cuda_gather.gather_rows(vgeo, vidx)),
        plain_ms=time_ms(lambda: cuda_gather.gather_rows_plain(vgeo, vidx)),
    )

    # K7: 1080p guides shaped like a G-buffer (sky band, smooth patches).
    h, w = height, width
    color = (rand(h, w, 3) * 2.0).contiguous()
    depth = (1.0 + 3.0 * rand(h, w)).contiguous()
    depth[: h // 27] = 100000.0
    normal = normalize(randn(h, w, 3) * 0.1
                       + torch.tensor([0.0, 0.0, 1.0], device=dev)).contiguous()
    rough = rand(h, w).contiguous()
    diffuse = rand(h, w, 3).contiguous()
    args = (color, depth, normal, rough, diffuse, 4)
    k = cuda_image.atrous_denoise(*args)
    p = cuda_image.atrous_denoise_plain(*args)
    err = (k - p).abs().max().item()
    log(f"  K7 atrous: {h}x{w}, 4 passes, max abs err {err:.3g}")
    check(err <= ATROUS_ATOL, f"K7 error {err} > {ATROUS_ATOL}")
    results["atrous_pass"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: cuda_image.atrous_denoise(*args)) / 4.0,
        plain_ms=time_ms(lambda: cuda_image.atrous_denoise_plain(*args)) / 4.0,
    )
    for name, r in results.items():
        log(f"  time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            + (" (per pass)" if name == "atrous_pass" else ""))
    return results


# -- phases 4 and 5: frames --------------------------------------------------

def render(cfg, device, frames):
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    scene = cornell_box(device=device)
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height, device=device)
    state = RenderState.create(cfg, device)
    ldr = None
    for _ in range(frames):
        state, ldr, _ = render_frame(scene, cfg, state, mats)
    return ldr


def phase_golden(dev):
    from sunray_tpu_torch.config import RenderConfig

    log("phase 4: golden NEE config, card vs CPU")
    cfg = RenderConfig(**GOLDEN_KW)
    gpu = render(cfg, dev, 4).cpu().numpy()
    cpu = render(cfg, "cpu", 4).numpy()
    p_cc = psnr(gpu, cpu)
    golden = np.load(os.path.join(REPO, "tests", "goldens", "cornell_nee.npy"))
    p_g = psnr(gpu, golden)
    log(f"  PSNR card vs CPU {p_cc:.2f} dB, card vs golden {p_g:.2f} dB")
    check(p_cc > PSNR_MIN, f"card vs CPU PSNR {p_cc:.2f} dB")
    check(p_g > PSNR_MIN, f"card vs golden PSNR {p_g:.2f} dB")
    return p_cc, p_g


def phase_main(dev, width=1920, height=1080, n_warm=5, n_timed=20):
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build, cuda_trace
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    log(f"phase 5: main path, {width}x{height} Cornell NEE frame")
    cfg = RenderConfig(width=width, height=height, lighting="nee")
    scene = cornell_box(device=dev)
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height, device=dev)
    state = RenderState.create(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cuda_build.launches.clear()
    cuda_trace.rays.clear()
    t0 = time.perf_counter()
    for _ in range(n_warm):
        state, ldr, aux = render_frame(scene, cfg, state, mats)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rays0 = sum(cuda_trace.rays.values())
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, ldr, aux = render_frame(scene, cfg, state, mats)
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / n_timed
    launches = dict(cuda_build.launches)
    rays_per_frame = (sum(cuda_trace.rays.values()) - rays0) / n_timed

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ldr_np = ldr.cpu().numpy()
    mean = float(ldr_np.mean())
    log(f"  warm-up {n_warm} frames {warm_s:.3f} s; frame {frame_s * 1e3:.3f} ms "
        f"(mean of {n_timed}); rays/frame {rays_per_frame:.0f} "
        f"({rays_per_frame / frame_s / 1e6:.2f} Mray/s); walk rounds "
        f"ris {aux['ris_rounds']} final {aux['final_rounds']}; "
        f"peak memory {peak_gb:.3f} GB; ldr mean {mean:.4f}")
    log(f"  launches over {n_warm + n_timed} frames: {launches}")
    check(ldr_np.shape == (height, width, 3), f"ldr shape {ldr_np.shape}")
    check(bool(np.isfinite(ldr_np).all()), "non-finite ldr")
    check(0.05 < mean < 0.95, f"ldr mean {mean}")
    for name in ("trace_closest", "trace_occluded", "gather_rows", "atrous_pass"):
        check(launches.get(name, 0) > 0, f"kernel {name} never launched")
    stage_breakdown(scene, cfg, state, mats, frame_s)
    return launches


def stage_breakdown(scene, cfg, state, mats, frame_s, frames=3):
    """Host-clock ms per frame of each stage of render_frame, the device
    synchronised at each stage's start and end. render_frame's profiler
    ranges are swapped for synchronising timers for these frames only, so
    the stages measured are the ones the timed frames ran."""
    import collections
    import contextlib

    from sunray_tpu_torch.render import pipeline

    totals = collections.Counter()

    @contextlib.contextmanager
    def timed(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0

    profiler_range = pipeline.record_function
    pipeline.record_function = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        state, _, _ = pipeline.render_frame(scene, cfg, state, mats)
    torch.cuda.synchronize()
    total_s = (time.perf_counter() - t0) / frames
    pipeline.record_function = profiler_range
    parts = ", ".join(f"{k} {v / frames * 1e3:.3f}" for k, v in totals.items())
    other = total_s - sum(totals.values()) / frames
    log(f"  stages, synced, ms/frame (mean of {frames}): {parts}, "
        f"outside the stages {other * 1e3:.3f}; synced frame "
        f"{total_s * 1e3:.3f} vs unsynced {frame_s * 1e3:.3f}")


KERNELS = {
    "trace_closest": ("sunray_tpu_torch/csrc/trace.cu",
                      "sunray_tpu/ops/pallas_trace.py:288"),
    "trace_occluded": ("sunray_tpu_torch/csrc/trace.cu",
                       "sunray_tpu/ops/pallas_trace.py:380"),
    "gather_rows": ("sunray_tpu_torch/csrc/gather.cu",
                    "sunray_tpu/ops/pallas_gather.py:193"),
    "atrous_pass": ("sunray_tpu_torch/csrc/atrous.cu",
                    "sunray_tpu/ops/pallas_image.py:258"),
}


def main():
    check(torch.cuda.is_available(), "no CUDA device available")
    sys.path.insert(0, REPO)
    from sunray_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"phase 1: device {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    path, report = cuda_build.build()
    cuda_build.library()
    log(f"phase 2: built {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    kernels = phase_kernels(dev)
    phase_golden(dev)
    launches = phase_main(dev)

    out = []
    for name, (source, replaces) in KERNELS.items():
        r = kernels[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"]}
        if "agree" in r:
            entry["agree"] = r["agree"]
        out.append(entry)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
