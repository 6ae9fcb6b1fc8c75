"""chip_smoke.py's phase 14 alone: the interactive path on the card. R1
(the 2D overlay painter) against its plain twin on the 1080p HUD and the
stress set and on hud_overlay's path, the JPEG encoder on a rendered
1080p frame and the committed progressive JPEG, the LiveViewer at
1920x1080 and the ViewerServer at 640x360.

    python3 tools/viewer_run.py

Builds the port's kernels and the encoder, then runs
chip_smoke.phase_viewers. It prints the card's name and power limit, the
phase's own log, R1's row of the kernels line, and as its last line one
JSON object, the phase's summary.
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
    from sunray_tpu_torch import native
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
    native.jpeg_lib()
    summary, row, launches = chip_smoke.phase_viewers(dev)
    row = dict(row, bound_ms=row["bound"][0], bound_by=row["bound"][1],
               launches=launches["paint_meshes"])
    del row["bound"]
    print(json.dumps({"paint_meshes": row}), flush=True)
    print(json.dumps({"viewers": summary}), flush=True)


if __name__ == "__main__":
    main()
