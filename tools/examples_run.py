"""chip_smoke.py's phase 16 alone: the example programs on the card
(examples/torch_*.py through their run(...)): render_png, the material
and camera inverse-rendering loops, the orbit with runtime instance churn
(also its presented frames across the in-flight settings), the orbit over
phase 10's glTF, the terminal viewer and the parity report; each
program's kernels launched, no plain twin on the card, the loops' first
steps card vs CPU.

    python3 tools/examples_run.py

Builds the port's kernels, writes phase 10's glTF under build/ when it is
absent, then runs chip_smoke.phase_examples. It prints the card's name
and power limit, the phase's own log, and as its last line one JSON
object, the phase's summary.
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
    summary = chip_smoke.phase_examples(dev)
    print(json.dumps({"examples": summary}), flush=True)


if __name__ == "__main__":
    main()
