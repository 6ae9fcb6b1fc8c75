"""K13 (csrc/history.cu) against another version of its source, on one card,
with the same inputs, the same host path and the same clocks.

    python3 tools/k13_before_after.py --before path/to/other/history.cu

Both sources are built alone (nvcc, the port's flags) into
build/k13_before_after/ and launched through history_gather's own launch
code (cuda_history._launch_gather) given the build's library, so the two
differ in their kernel only. Inputs are the ones
chip_smoke.py holds K13 to: the joint DI+GI history read (15 fields, 29
words a lane) and the TAA corners (8,294,400 lanes x 3 words) of frame 3
of the 1080p Cornell frame with the kernel switches. Each build's outputs
are held bit-equal to history_gather_plain; then the builds are timed in
turns (before, after, after, before) as chip_smoke.py times kernels
(device_ms) and by CUDA events around one call (time_ms), with
index_select on the packed (P, 29) table beside them. The last line is
one JSON object of those times.
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


def gather(lib, fields, idx):
    """K13 from `lib`, through history_gather's launch code."""
    from sunray_tpu_torch.ops import cuda_history

    return cuda_history._launch_gather(fields, idx, lib=lib)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path,
                    help="the other history.cu to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k13_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_history

    card = before_after.card()
    dev = torch.device("cuda", 0)
    libs = before_after.build(
        {"before": args.before,
         "after": REPO / "sunray_tpu_torch" / "csrc" / "history.cu"},
        REPO / "build" / "k13_before_after")
    libs = {name: cuda_build.declare(lib, ["sunray_history_gather"])
            for name, (lib, _) in libs.items()}
    calls = chip_smoke.capture_switch_inputs(dev)["history_gather"]
    (fields, idx), _ = calls[0]
    (table, corners), _ = calls[1]
    words = sum(f[0].numel() for f in fields)
    packed = torch.cat([f.view(torch.float32).reshape(f.shape[0], -1)
                        for f in fields], dim=1).contiguous()
    reads = {"joint": (fields, idx), "corners": (table, corners)}
    print(f"joint read: {idx.shape[0]} lanes x {words} words in {len(fields)} "
          f"fields; TAA corners: {corners.shape[0]} lanes x 3 words", flush=True)
    out = {"card": card, "words": words, "fields": len(fields)}
    for name, lib in libs.items():
        for read, (fs, ix) in reads.items():
            got = gather(lib, fs, ix)
            want = cuda_history.history_gather_plain(fs, ix)
            torch.cuda.synchronize()
            chip_smoke.check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                 for a, b in zip(got, want)),
                             f"{name} {read}: not bit-equal to the plain version")
            print(f"{name} {read}: bit-equal", flush=True)
    before_after.time_in_turns(
        ["before"], "after",
        lambda name: {read: ((lambda fs=fs, ix=ix: gather(libs[name], fs, ix)), 1)
                      for read, (fs, ix) in reads.items()}, out)
    out["index_select_device_ms"] = chip_smoke.device_ms(
        lambda: packed.index_select(0, idx))
    out["index_select_events_ms"] = chip_smoke.time_ms(
        lambda: packed.index_select(0, idx))
    out["joint_bound_ms"] = chip_smoke.bound(
        chip_smoke.nbytes(idx) + 2 * idx.shape[0] * words * 4, 0)[0]
    print(f"index_select on the packed table: device "
          f"{out['index_select_device_ms']:.4f} ms, events "
          f"{out['index_select_events_ms']:.4f} ms; joint read bound "
          f"{out['joint_bound_ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
