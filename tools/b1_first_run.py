"""A short first run of B1 (boundary_candidates, csrc/boundary.cu) on one
card, and of the 720p differentiable step with both visibility terms.

    python3 tools/b1_first_run.py

Builds the kernels and prints B1's ptxas report (registers, spills);
holds B1 to its plain version on 1,000, 65,536 and 921,600 random points
in the Cornell box at K = 1, 8 and 16 (the lanes differing in each
output); runs four 720p steps of the differentiable ReSTIR frame
(loss mean(ldr), gradients w.r.t. base_color and positions) without the
terms and four with edge_antialias and shadow_boundary_grads (8
candidates), each step's host time (synced), peak memory and launches;
then holds B1 to its plain version on the calls it got in those steps
and times it (CUDA events around 10 calls). chip_smoke.py phase 9 is the
full check; this is the quick one for a changed kernel.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_boundary, cuda_build
    from sunray_tpu_torch.render import boundary, restir
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    if not torch.cuda.is_available():
        sys.exit("b1_first_run: no CUDA device")
    t0 = time.perf_counter()
    path, report = cuda_build.build()
    print(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "boundary_candidates" in line:
            print("\n".join(x.strip() for x in lines[i:i + 4]))
    cuda_build.library()
    dev = torch.device("cuda", 0)
    scene = boundary.with_edge_topology(cornell_box(device=dev))
    lights = restir.Lights(scene)
    _, _, table, _, _ = boundary._edge_geometry(
        scene.world_triangle_vertices(), scene.edge_tri, scene.edge_k)
    lt = cuda_boundary.light_table(lights.v0, lights.v1, lights.v2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for p in (1000, 65536, 921600):
        xs = torch.rand((p, 3), generator=gen, device=dev) * 2.0
        mask = torch.rand((p,), generator=gen, device=dev) > 0.2
        for k in (1, 8, 16):
            got = cuda_boundary.boundary_candidates(xs, mask, table, lt, k)
            want = cuda_boundary.boundary_candidates_plain(xs, mask, table,
                                                           lt, k)
            torch.cuda.synchronize()
            print(f"{p} points, K={k}: entries differing (idx, n_live, sil, "
                  f"face2) {[int((a != b).sum()) for a, b in zip(got, want)]}")

    calls, inner = [], cuda_boundary.boundary_candidates

    def recording(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return inner(*args)

    cuda_boundary.boundary_candidates = recording
    mats = camera_matrices(Camera(position=(1.0, 1.0, 3.4),
                                  target=(1.0, 1.0, 0.0), fov_y=45.0),
                           1280, 720, device=dev)
    for kw in ({}, dict(shadow_boundary_grads=True,
                        shadow_boundary_candidates=8, edge_antialias=True)):
        cfg = RenderConfig(width=1280, height=720, differentiable=True, **kw)
        bc = scene.materials.base_color.clone().requires_grad_()
        pos = scene.positions.clone().requires_grad_()
        sc = dataclasses.replace(scene, positions=pos, materials=dataclasses
                                 .replace(scene.materials, base_color=bc))
        state = RenderState.create(cfg, dev)
        for i in range(4):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_build.launches.clear()
            t0 = time.perf_counter()
            state, ldr, _ = render_frame(sc, cfg, state, mats)
            loss = ldr.mean()
            grads = torch.autograd.grad(loss, (bc, pos))
            torch.cuda.synchronize()
            print(f"{kw or 'no terms'}, step {i}: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss "
                  f"{float(loss):.6f}, positions gradient finite "
                  f"{bool(torch.isfinite(grads[1]).all())}, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        print(f"launches in the last step: {dict(cuda_build.launches)}")
    cuda_boundary.boundary_candidates = inner
    for args in calls[:2]:
        got = inner(*args)
        want = cuda_boundary.boundary_candidates_plain(*args)
        for _ in range(3):
            inner(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            inner(*args)
        end.record()
        torch.cuda.synchronize()
        print(f"step call, {args[0].shape[0]} pixels: entries differing "
              f"{[int((a != b).sum()) for a, b in zip(got, want)]}; "
              f"{start.elapsed_time(end) / 10:.4f} ms a call")


if __name__ == "__main__":
    main()
