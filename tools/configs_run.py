"""chip_smoke.py's phase 12 alone: the frame configurations on one card
(samples=4, per-pixel spatial taps, bf16 shading with K3-K6's bf16
instantiations, the 578-light Cornell box, each card vs CPU, and the
quality cases against their converged truths).

    python3 tools/configs_run.py

Builds the port's kernels, then runs chip_smoke.phase_configs. It prints
the card's name and power limit, the phase's own log, and as its last
line one JSON object: the phase's summary and the K3-K6 rows' bf16 and
578-light numbers. It holds none of the other kernels against their
plain versions: chip_smoke.py does that.
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
    rows = {name: {} for name in chip_smoke.RESTIR_NAMES}
    summary = chip_smoke.phase_configs(dev, rows)
    print(json.dumps({"configs": summary, "kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
