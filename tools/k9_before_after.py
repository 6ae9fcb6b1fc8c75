"""K9 (csrc/taa.cu) against another version of its source, on one card,
with the same inputs, the same host path and the same clocks.

    python3 tools/k9_before_after.py --before path/to/other/taa.cu

Both sources are built alone (nvcc, the port's flags) into
build/k9_before_after/ and launched through taa_clamp_blend's own launch
code (cuda_image._taa_kernel) given the build's library, so the two
differ in their kernel only. Inputs are the ones chip_smoke.py holds K9
to: frame 3 of the 1080p Cornell frame with the kernel switches (raw,
history and mask), and for the current source's window form the 1080p/4
band of rows 270-539 of those inputs with the rows above and below.
Each build's whole-frame output is held bit-equal to
taa_clamp_blend_plain and to the other build's, the window form to its
plain twin and to the whole frame's band; then the builds are timed in
turns (before, after, after, before) as chip_smoke.py times kernels
(device_ms) and by CUDA events around one call (time_ms). The last line
is one JSON object of those times.
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

BAND = (270, 540)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path,
                    help="the other taa.cu to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k9_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_image

    card = before_after.card()
    dev = torch.device("cuda", 0)
    libs = before_after.build(
        {"before": args.before,
         "after": REPO / "sunray_tpu_torch" / "csrc" / "taa.cu"},
        REPO / "build" / "k9_before_after")
    libs = {"before": cuda_build.declare(libs["before"][0],
                                         ["sunray_taa_clamp_blend"]),
            "after": cuda_build.declare(libs["after"][0],
                                        ["sunray_taa_clamp_blend",
                                         "sunray_taa_clamp_blend_window"])}
    (taa_args, _), = chip_smoke.capture_switch_inputs(dev)["taa_clamp_blend"]
    raw, hist, use, factor = taa_args
    r0, r1 = BAND
    band = (raw[r0:r1], hist[r0:r1].contiguous(), use[r0:r1].contiguous(),
            factor)
    raw_x = raw[r0 - 1:r1 + 1].contiguous()
    want = cuda_image.taa_clamp_blend_plain(*taa_args)
    want_band = cuda_image.taa_clamp_blend_plain(*band, raw_x=raw_x)
    outs = {}
    for name, lib in libs.items():
        outs[name] = cuda_image._taa_kernel(raw, hist, use, factor, lib=lib)
        torch.cuda.synchronize()
        chip_smoke.check(torch.equal(outs[name].view(torch.int32),
                                     want.view(torch.int32)),
                         f"{name}: whole frame not bit-equal to plain")
        print(f"{name} whole frame: bit-equal to plain", flush=True)
    chip_smoke.check(torch.equal(outs["before"].view(torch.int32),
                                 outs["after"].view(torch.int32)),
                     "the two builds' whole frames differ")
    win = cuda_image._taa_kernel(raw_x, *band[1:], window=True,
                                 lib=libs["after"])
    torch.cuda.synchronize()
    chip_smoke.check(torch.equal(win.view(torch.int32),
                                 want_band.view(torch.int32))
                     and torch.equal(win, outs["after"][r0:r1]),
                     "window form not bit-equal to its twin and the band")
    print("after window form: bit-equal to its plain twin and to the whole "
          "frame's band; the two builds' whole frames bit-equal", flush=True)
    out = {"card": card, "shape": list(raw.shape), "band": list(BAND),
           "use_share": use.float().mean().item()}
    before_after.time_in_turns(
        ["before"], "after",
        lambda name: {"whole": ((lambda lib=libs[name]: cuda_image._taa_kernel(
            raw, hist, use, factor, lib=lib)), 1)}, out)
    out["after_window_device_ms"] = chip_smoke.device_ms(
        lambda: cuda_image._taa_kernel(raw_x, *band[1:], window=True,
                                       lib=libs["after"]))
    out["whole_bound_ms"] = chip_smoke.bound(
        chip_smoke.nbytes(raw, hist, use) + chip_smoke.nbytes(raw),
        use.numel() * 120)[0]
    out["window_bound_ms"] = chip_smoke.bound(
        chip_smoke.nbytes(raw_x, *band[1:3]) + chip_smoke.nbytes(win),
        band[2].numel() * 120)[0]
    print(f"window form: device {out['after_window_device_ms']:.4f} ms, "
          f"bound {out['window_bound_ms']:.4f} ms; whole frame bound "
          f"{out['whole_bound_ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
