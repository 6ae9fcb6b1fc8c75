"""The port's Python code timed against another checkout of the repo on
one card, with the same inputs: chip_smoke.py phase 8's 1280x720
differentiable Cornell ReSTIR step (mean(ldr), gradients w.r.t.
base_color and positions) and phase 5's 1920x1080 Cornell ReSTIR forward
frame.

    python3 tools/step_before_after.py --before DIR

DIR holds another checkout (e.g. a commit unpacked with git archive into
a directory that .gitignore lists, such as build/). Both trees build
their kernels, the two builds started together; then one process a turn
times one tree's package, in the order DIR, this tree, this tree, DIR.
This tree's turns also time the step with ops/loops._scan_carry made the
identity, so that the carry skips _ScanCarry at the loops' round
boundaries, in turns with the step as it is: the difference is what
_ScanCarry costs. Each turn: STEP_WARM warm-up and STEP_TIMED timed
steps, then FRAME_WARM and FRAME_TIMED forward frames, synced, timed on
the host's clock. Prints the card's name and power limit, one line a
turn, and as its last line one JSON object of every turn's numbers and
the mean of each version's two turns.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
STEP_WARM, STEP_TIMED = 3, 10
FRAME_WARM, FRAME_TIMED = 5, 20
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from sunray_tpu_torch.ops import cuda_build; cuda_build.build()")


def turn(root: Path, variants: list[str]) -> dict:
    """One tree's package: the step of each variant ("tree" as it is,
    "no_scan_carry" with _scan_carry the identity), then the frame."""
    sys.path.insert(0, str(root))
    import importlib.util

    import torch

    # This tree's chip_smoke (its set-up and step), the package from root.
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(
        spec)
    spec.loader.exec_module(chip_smoke)
    import sunray_tpu_torch
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build, loops
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    here = Path(sunray_tpu_torch.__file__).resolve().parent.parent
    chip_smoke.check(here == root.resolve(), f"package from {here}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.library()
    out = {}
    scan_carry = getattr(loops, "_scan_carry", None)
    for variant in variants:
        if variant == "no_scan_carry":
            chip_smoke.check(scan_carry is not None, "no _scan_carry here")
            loops._scan_carry = lambda carry: carry
        cfg, scene, leaves, mats = chip_smoke.diff_setup(
            dev, *chip_smoke.DIFF_SIZE)
        state = RenderState.create(cfg, dev)
        for _ in range(STEP_WARM):
            state, loss, _, _ = chip_smoke.diff_step(cfg, scene, leaves, mats,
                                                     state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_TIMED):
            state, loss, grads, _ = chip_smoke.diff_step(cfg, scene, leaves,
                                                         mats, state)
        torch.cuda.synchronize()
        out[f"{variant}_step_ms"] = (time.perf_counter() - t0) / STEP_TIMED * 1e3
        out[f"{variant}_step_loss"] = float(loss)
        out[f"{variant}_step_grad_norms"] = [float(g.norm()) for g in grads]
        if scan_carry is not None:
            loops._scan_carry = scan_carry
    cfg = RenderConfig(width=1920, height=1080, lighting="restir")
    scene = cornell_box(device=dev)
    mats = camera_matrices(Camera(**chip_smoke.CAMERA), cfg.width, cfg.height,
                           device=dev)
    state = RenderState.create(cfg, dev)
    for _ in range(FRAME_WARM):
        state, ldr, _ = render_frame(scene, cfg, state, mats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FRAME_TIMED):
        state, ldr, _ = render_frame(scene, cfg, state, mats)
    torch.cuda.synchronize()
    out["frame_ms"] = (time.perf_counter() - t0) / FRAME_TIMED * 1e3
    out["frame_ldr_mean"] = float(ldr.mean())
    return out


def run_turn(root: Path, variants: list[str]) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--turn", str(root), "--variants",
         *variants], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.exit(f"turn {root} {variants} exited {proc.returncode}:\n"
                 f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, help="another checkout's root")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--variants", nargs="+", default=["tree"],
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print(json.dumps(turn(args.turn, args.variants)), flush=True)
        return
    import torch

    if args.before is None or not torch.cuda.is_available():
        sys.exit("step_before_after: needs --before DIR and a CUDA device")
    sys.path.insert(0, str(REPO))
    from tools import before_after

    before = args.before.resolve()
    out = {"card": before_after.card()}
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, str(root)])
              for root in (before, REPO)]
    for root, proc in zip((before, REPO), builds):
        if proc.wait(timeout=900) != 0:
            sys.exit(f"build of {root} exited {proc.returncode}")
    print(f"built both trees in {time.perf_counter() - t0:.1f} s", flush=True)
    order = [(before, "before", ["tree"]),
             (REPO, "after", ["tree", "no_scan_carry"]),
             (REPO, "after", ["no_scan_carry", "tree"]),
             (before, "before", ["tree"])]
    turns = []
    for root, name, variants in order:
        got = run_turn(root, variants)
        print(f"{name} {variants}: {got}", flush=True)
        turns.append({"version": name, **got})
    out["turns"] = turns
    for key in ("tree_step_ms", "no_scan_carry_step_ms", "frame_ms"):
        for name in ("before", "after"):
            vals = [t[key] for t in turns if t["version"] == name and key in t]
            if vals:
                out[f"{name}_{key}"] = statistics.mean(vals)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
