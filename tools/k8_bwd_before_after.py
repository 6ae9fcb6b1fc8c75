"""K8's backward (gather_rows_bwd, csrc/gather.cu) against another version
of its source, on one card, with the same inputs and the same host path.

    python3 tools/k8_bwd_before_after.py --before path/to/other/gather.cu

Both sources are built alone (nvcc, the port's flags) into
build/k8_bwd_before_after/ and launched through gather_rows_bwd's own
launch code (cuda_gather._launch_bwd) given the build's library. Inputs:
every cotangent the backward of one 1280x720 differentiable ReSTIR step
hands it (chip_smoke.py phase 8: the vertex corners, 3 x 921,600 indices
into 72 x 6, and the material rows, 921,600 into 4 x 12, three of each),
and 3 x 2,073,600 random indices with out-of-range ones. Each build is
held within chip_smoke.K8_BWD_TOL of each row's sum of |ct| of the plain
version's float64 sums, two runs bit-equal; then the builds are timed in
turns (before, after, after, before) on the step's first corner call,
its first material call and the random set. The last line is one JSON
object of those times.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path,
                    help="the other gather.cu to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k8_bwd_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_gather
    from sunray_tpu_torch.render.pipeline import RenderState

    card = before_after.card()
    dev = torch.device("cuda", 0)
    libs = before_after.build(
        {"before": args.before,
         "after": REPO / "sunray_tpu_torch" / "csrc" / "gather.cu"},
        REPO / "build" / "k8_bwd_before_after")
    names = ["sunray_gather_rows_bwd", "sunray_gather_rows_bwd_shape"]
    libs = {name: cuda_build.declare(lib, names)
            for name, (lib, _) in libs.items()}
    cfg, scene, leaves, mats = chip_smoke.diff_setup(dev, *chip_smoke.DIFF_SIZE)
    state = RenderState.create(cfg, dev)
    _, calls = chip_smoke.capture_bwd_calls(
        lambda: chip_smoke.diff_step(cfg, scene, leaves, mats, state))
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    n = 1920 * 1080
    sets = {"corners": next(c for c in calls if c[1].shape[0] == 3),
            "materials": next(c for c in calls if c[1].shape[0] == 1),
            "random": (torch.randn((3, 6, n), generator=gen, device=dev),
                       torch.randint(-8, 80, (3, n), generator=gen,
                                     device=dev, dtype=torch.int32), 72)}
    out = {"card": card}
    for name, lib in libs.items():
        for label, (ct, idx, k) in [*((f"step call {i}", c)
                                      for i, c in enumerate(calls)),
                                    ("random", sets["random"])]:
            got = cuda_gather._launch_bwd(ct, idx, k, lib=lib)
            again = cuda_gather._launch_bwd(ct, idx, k, lib=lib)
            exact = cuda_gather.gather_rows_bwd_plain(ct.double(), idx, k)
            scale = cuda_gather.gather_rows_bwd_plain(
                ct.abs().double(), idx, k).clamp(min=1e-30)
            torch.cuda.synchronize()
            err = float(((got - exact).abs() / scale).max())
            chip_smoke.check(err <= chip_smoke.K8_BWD_TOL,
                             f"{name} {label}: error {err}")
            chip_smoke.check(torch.equal(got, again),
                             f"{name} {label}: two runs differ")
            print(f"{name} {label}: {tuple(idx.shape)} into {k} x "
                  f"{ct.shape[1]}, err / row sum |ct| {err:.2e}, two runs "
                  "bit-equal", flush=True)
    before_after.time_in_turns(
        ["before"], "after",
        lambda name: {label: ((lambda c=c: cuda_gather._launch_bwd(
            *c, lib=libs[name])), 1) for label, c in sets.items()}, out)
    for label, (ct, idx, k) in sets.items():
        out[f"{label}_bound_ms"] = chip_smoke.bound(
            chip_smoke.nbytes(ct, idx) + k * ct.shape[1] * 4, 0)[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
