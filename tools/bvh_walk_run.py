"""chip_smoke.py's phase 10 alone: the synthetic glTF scene through the
Renderer on one card, for work on B2 and B3 (csrc/bvh.cu).

    python3 tools/bvh_walk_run.py

Builds the port's kernels, then runs chip_smoke.phase_real_scene: tracer
"auto" (B3) and "bvh" (B2: SAH, UPDATE refits, a FAST_BUILD), each walk
held bit-equal to its plain twin on the frames' own queries and timed
beside its bound and issue floor, every fused alpha query of a frame
held to the batch rounds and its plain twin, and the card against the
CPU at 96x54. It prints the
card's name and power limit, the phase's own log, and as its last line
one JSON object of B2's and B3's rows and launches. It holds none of the
other kernels against their plain versions: chip_smoke.py does that.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build

    chip_smoke.check(torch.cuda.is_available(), "no CUDA device available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    path, _ = cuda_build.build()
    cuda_build.library()
    rows, launches = chip_smoke.phase_real_scene(dev,
                                                 chip_smoke.sass_counts(path))
    print(json.dumps({"kernels": [dict(name=k, launches=launches[k], **{
        key: v for key, v in r.items() if key != "bound"},
        bound_ms=r["bound"][0], bound_by=r["bound"][1])
        for k, r in rows.items()]}), flush=True)


if __name__ == "__main__":
    main()
