"""chip_smoke.py's phase 15 alone: multi-device rendering (parallel/) on the
card. (a) the row-sharded frame under NCCL at world size 1, bit-equal to
render_frame on the 1080p Cornell ReSTIR frame; (b) 4 gloo ranks sharing
the card on the 1080p frame, held to the single-device frame, with every
rank's launches, halo bytes and host-staged exchange ms, and
render_frame_sharded under fast motion; (c) training_step at (dp, sp) =
(2, 2) on the default ReSTIR and the NEE configs against the
single-device step; (d) the window forms of K5, K7 and K9, and K6 on a
band, against their plain twins.

    python3 tools/parallel_run.py

Builds the port's kernels, times 5 + 20 frames of phase 5's 1080p frame
for the frame ms that (a) is set beside, then runs
chip_smoke.phase_parallel. It prints the card's name and power limit,
the phase's own log, the rows of the three window instantiations, and as
its last line one JSON object, the phase's summary.
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
    cuda_build.build()
    cuda_build.library()
    phase5 = {}
    chip_smoke.phase_main(dev, "restir", chip_smoke.CORNELL_KERNELS,
                          n_warm=5, n_timed=20, record=phase5)
    summary, rows, launches = chip_smoke.phase_parallel(dev,
                                                        phase5["frame_ms"])
    for name in chip_smoke.PARALLEL_ONLY:
        row = dict(rows[name], bound_ms=rows[name]["bound"][0],
                   bound_by=rows[name]["bound"][1], launches=launches[name])
        del row["bound"]
        print(json.dumps({name: row}), flush=True)
    print(json.dumps({"parallel": summary}), flush=True)


if __name__ == "__main__":
    main()
