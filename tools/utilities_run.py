"""chip_smoke.py's phase 13 alone: the 720p differentiable step with bf16
shading (launch check, timed steps, card vs CPU at 32x24), the JPEG
decoder and a JPEG-textured glTF through the Renderer card vs CPU,
packing card vs CPU, a 1080p checkpoint round trip, exec_paths against
the launch counters, stage_timings, one profiled frame and the roofline.

    python3 tools/utilities_run.py

Builds the port's kernels, runs phase 5's 1080p ReSTIR frame (2 warm-up,
5 timed; the roofline's measured ms and exec_paths' default frame), then
chip_smoke.phase_utilities. The float32 step of phase 8 is not run, so
the bf16 step prints without it. It prints the card's name and power
limit, the phases' own log, and as its last line one JSON object, the
phase's summary. It holds no kernel against its plain version:
chip_smoke.py does that.
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
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.scene import cornell_box

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
    n_warm, n_timed = 2, 5
    launches = chip_smoke.phase_main(dev, "restir", chip_smoke.CORNELL_KERNELS,
                                     n_warm=n_warm, n_timed=n_timed,
                                     record=phase5)
    frames = {"default (phase 5)": (RenderConfig(width=1920, height=1080),
                                    cornell_box(device="cpu").num_lights,
                                    launches, n_warm + n_timed)}
    summary = chip_smoke.phase_utilities(dev, None, phase5, frames)
    print(json.dumps({"utilities": summary}), flush=True)


if __name__ == "__main__":
    main()
