"""chip_smoke.py's phase 11 alone: differentiable real scenes on one card,
for work on K8's backward above 512 rows (the runs path, csrc/gather.cu)
and the differentiable glTF and big-mesh steps.

    python3 tools/real_grads_run.py

Builds the port's kernels, then runs chip_smoke.phase_real_diff: the
small synthetic GLB's differentiable frames (NEE and ReSTIR, "bvh" and
"auto") on the card against the CPU, the 720p step on phase 10's GLB
with the runs path held against its plain version and the float64 sums
on the step's own cotangents and timed beside its bound, index_add_,
index_put_(accumulate=True), its own radix sort and torch.sort, and
broken into its device launches, the timed step with its peak
memory, and the big mesh's 720p step. It prints the card's name and
power limit, the phase's own log, and as its last line one JSON object
of the runs path's row and launches. It holds none of the other kernels
against their plain versions: chip_smoke.py does that.

    python3 tools/real_grads_run.py --profile

profiles one 720p step on phase 10's GLB instead (torch.profiler after
one warm-up step): device time busy against the step's wall time, the
ops that took the most device time and the most host time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def profile_step(dev, rows=15):
    """One 720p differentiable step on phase 10's GLB under torch.profiler:
    device time busy, wall time, the ops with the most device and host
    time."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from sunray_tpu_torch.render.pipeline import RenderState

    cfg, scene, leaves, mats, accel = chip_smoke.real_diff_setup(
        dev, chip_smoke.real_scene_path(), *chip_smoke.DIFF_SIZE,
        tracer="auto")
    state = RenderState.create(cfg, dev)
    state, _, _, _ = chip_smoke.real_diff_step(cfg, scene, leaves, mats,
                                               state, accel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.real_diff_step(cfg, scene, leaves, mats, state, accel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # The stages' profiler ranges span their kernels: not counted again.
    stages = ("ris_pass", "final_pass", "taa", "denoise", "postprocess")
    kernels = [e for e in events if dev_us(e) > 0 and e.key not in stages
               and "CUDA" in str(getattr(e, "device_type", ""))]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    print(f"profiled step: {busy:.1f} ms of device time in {wall_ms:.1f} ms "
          f"wall (idle {max(0.0, 1 - busy / wall_ms):.1%}, profiler on); "
          f"{sum(e.count for e in kernels)} device ops", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:rows]:
        print(f"  device {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)
    host = [e for e in events if "CUDA" not in str(getattr(e, "device_type",
                                                            ""))]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:rows]:
        print(f"  host {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one 720p step instead")
    args = ap.parse_args()
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build

    chip_smoke.check(torch.cuda.is_available(), "no CUDA device available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    cuda_build.library()
    if args.profile:
        profile_step(dev)
        return
    row, launches = chip_smoke.phase_real_diff(dev)
    print(json.dumps({"kernels": [dict(
        name=name, launches=launches.get(name, 0),
        **{k: v for k, v in row.items() if k != "bound"},
        bound_ms=row["bound"][0], bound_by=row["bound"][1])
        for name in chip_smoke.RUNS_ONLY]}), flush=True)


if __name__ == "__main__":
    main()
