"""What forward frames would pay if ops/fp took its autograd path always.

    python3 tools/fp_fork_cost.py

ops/fp.fma and fp.sqrt run an autograd Function, and fp.clip a
torch.maximum / torch.minimum pair, only when autograd records an op on
their arguments; a forward frame takes the plain expressions
(torch.clamp for clip). This renders the 1080p forward ReSTIR and NEE
Cornell frames (chip_smoke.py's phase 5 configurations) on one card with
the code as it is ("forked") and with fp._records patched to answer True
("always"), in turns (forked, always, always, forked, forked, always),
each turn a fresh state: warm-up frames, then timed frames, synced, host
wall time a frame. It also counts the fp calls a frame and says whether
the two variants' last frames are bit-equal. The last line is one JSON
object of those numbers.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after  # noqa: E402

FRAMES = {"restir": (3, 10), "nee": (2, 5)}    # warm-up, timed
TURNS = ("forked", "always", "always", "forked", "forked", "always")


def main():
    if not torch.cuda.is_available():
        sys.exit("fp_fork_cost: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import fp
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    dev = torch.device("cuda", 0)
    out = {"card": before_after.card()}
    forked_records = fp._records

    scene = cornell_box(device=dev)
    for lighting, (n_warm, n_timed) in FRAMES.items():
        cfg = RenderConfig(width=1920, height=1080, lighting=lighting)
        mats = camera_matrices(Camera(**chip_smoke.CAMERA), cfg.width,
                               cfg.height, device=dev)
        times, last = {"forked": [], "always": []}, {}
        for turn in TURNS:
            fp._records = (forked_records if turn == "forked"
                           else (lambda *xs: True))
            try:
                state = RenderState.create(cfg, dev)
                for _ in range(n_warm):
                    state, ldr, _ = render_frame(scene, cfg, state, mats)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n_timed):
                    state, ldr, _ = render_frame(scene, cfg, state, mats)
                torch.cuda.synchronize()
            finally:
                fp._records = forked_records
            ms = (time.perf_counter() - t0) / n_timed * 1e3
            times[turn].append(ms)
            last[turn] = ldr
            print(f"{lighting} {turn}: {ms:.3f} ms a frame (mean of "
                  f"{n_timed} after {n_warm})", flush=True)
        # The fp calls of one frame, on the forked path: each of fma, sqrt
        # and clip asks _records once.
        calls = [0]

        def counting(*xs):
            calls[0] += 1
            return forked_records(*xs)

        fp._records = counting
        try:
            render_frame(scene, cfg, RenderState.create(cfg, dev), mats)
        finally:
            fp._records = forked_records
        same = bool(torch.equal(last["forked"], last["always"]))
        f, a = (statistics.median(times[k]) for k in ("forked", "always"))
        print(f"{lighting}: forked {f:.3f} ms, always {a:.3f} ms "
              f"({a - f:+.3f}); fp calls a frame {calls[0]}; last "
              f"frames bit-equal {same}", flush=True)
        out[lighting] = {"forked_ms": times["forked"],
                         "always_ms": times["always"],
                         "forked_median_ms": f, "always_median_ms": a,
                         "fp_calls_a_frame": calls[0],
                         "bit_equal": same}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
