"""K14 (csrc/trace.cu) and K7 (csrc/atrous.cu) against other versions of
their sources, on one card, with the same inputs, the same host path and
the same clocks.

    python3 tools/k14_k7_before_after.py --before DIR

DIR holds the other trace.cu and atrous.cu (e.g. a commit's
sunray_tpu_torch/csrc/ unpacked with git archive). Each source is built
alone (nvcc, the port's flags) into build/k14_k7_before_after/, and every
build is launched through the wrappers' own launch code
(cuda_trace._launch_woop, cuda_image._launch_pass) given the build's
library, so the builds differ in their kernel only.

Inputs: for K14 the GI-tap visibility query (the largest shadow query,
with its exclude ids) of frame 3 of the 1080p Cornell frame with the
kernel switches, the query chip_smoke.py times; for K7 chip_smoke.py's
synthetic 1080p guides and the guides the live 1080p ReSTIR frame passes
to atrous_denoise (frame 2), 4 passes. Every build's K14 is held bit-equal
to the plain intersect.trace_occluded_woop, and every K7 build bit-equal
to the others and within chip_smoke.ATROUS_ATOL of the plain passes. The
builds are timed in turns (before, after, after, before) as chip_smoke.py
times kernels (device_ms) and by CUDA events around one call (time_ms);
beside each, K14's tests run as chip_smoke.warp_rule_tests models them at
the build's launch shape, and the instruction-issue floors from the
build's SASS. The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after, sass  # noqa: E402

CSRC = REPO / "sunray_tpu_torch" / "csrc"
OUT = REPO / "build" / "k14_k7_before_after"
# The launch shape of a K14 source that does not report its own through
# sunray_woop_launch_shape: the one-ray-a-thread kernel on blocks of 128
# that the multi-ray kernel replaced.
ONE_RAY_SHAPE = (1, 128)


def woop(lib, table, o, d, tmax, exclude):
    """K14 from `lib` on a scalar tmin, per-ray tmax."""
    from sunray_tpu_torch.ops import cuda_trace
    from sunray_tpu_torch.ops.intersect import T_MIN

    a, eps = table
    return cuda_trace._launch_woop(a, eps, o, d, None, T_MIN, tmax, 0.0,
                                   exclude, lib=lib)


def atrous(lib, guides, passes=4):
    """atrous_denoise's passes, K7 from `lib`."""
    from sunray_tpu_torch.ops import cuda_image

    color = guides[0]
    bufs = [torch.empty_like(color) for _ in range(2)]
    src = color
    for i in range(passes):
        cuda_image._launch_pass(src, *guides[1:], 1 << i, bufs[i % 2], lib=lib)
        src = bufs[i % 2]
    return src


def sass_of(lib_path, kind, card):
    """chip_smoke's SASS counts of one build (kind trace or atrous), with
    the card's SM count and clock from `card` (chip_smoke.sass_counts of
    the package's library)."""
    from sunray_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    funcs = sass.functions(sass.disassemble(lib_path, cuobjdump))
    out = {}
    try:
        if kind == "trace":
            out["woop_loop"], _ = sass.loop_iteration(
                sass.find(funcs, "occluded_woop_kernel"), "LDS")
        else:
            code = sass.find(funcs, "atrous_kernel")
            barrier = any(c.op.startswith("BAR.SYNC") for c in code)
            out["atrous_taps"], _ = sass.straight_after(
                code, "BAR.SYNC" if barrier else None, "MUFU.EX2", 24)
            out["atrous_stage"] = (sass.loop_iteration(code, "STS")[0]
                                   if barrier else 0)
    except (ValueError, KeyError) as e:
        print(f"  {kind}: SASS count failed ({e})", flush=True)
    if not card:
        return {}
    return dict(out, clock_mhz=card["clock_mhz"], n_sm=card["n_sm"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path,
                    help="directory holding the other trace.cu and atrous.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k14_k7_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_image, intersect

    card = before_after.card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = before_after.build(
        {"trace_before": args.before / "trace.cu", "trace_after": CSRC / "trace.cu",
         "atrous_before": args.before / "atrous.cu",
         "atrous_after": CSRC / "atrous.cu"}, OUT)
    libs = {name: (cuda_build.declare(
        lib, ["sunray_trace_occluded_woop" if name.startswith("trace")
              else "sunray_atrous_pass"]), report)
        for name, (lib, report) in libs.items()}
    path, _ = cuda_build.build()          # the package's own, for the plain
    cuda_build.library()                  # paths' helpers and SASS clock
    card_counts = chip_smoke.sass_counts(path)

    calls = chip_smoke.capture_switch_inputs(dev)["trace_occluded_woop"]
    (table, o, d, tmax, tmin), kw = max(calls, key=lambda c: c[0][1].shape[0])
    chip_smoke.check(tmin == intersect.T_MIN and torch.is_tensor(tmax),
                     "K14 query: expected a scalar tmin and per-ray tmax")
    exclude = kw.get("exclude")
    if exclude is None:
        exclude = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    guides = {"synthetic": chip_smoke.synthetic_guides(gen, 1080, 1920),
              "live": chip_smoke.capture_denoise_inputs(dev)}
    first = chip_smoke.woop_first(table, o, d, tmax, exclude)
    want = intersect.trace_occluded_woop(table, o, d, tmax, tmin, exclude=exclude)
    out = {"card": card, "woop_rays": o.shape[0], "woop_tris": table[0].shape[1],
           "woop_needed_tests": int(first.sum())}
    print(f"K14 query: {o.shape[0]} rays x {table[0].shape[1]} tris, needed "
          f"tests {out['woop_needed_tests']}", flush=True)

    ref = {}
    for name, (lib, _) in libs.items():
        counts = sass_of(OUT / f"{name}.so", name.split("_")[0], card_counts)
        if name.startswith("trace"):
            got = woop(lib, table, o, d, tmax, exclude)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            chip_smoke.check(differ == 0, f"{name}: K14 differs from plain on "
                             f"{differ} rays")
            shape = (cuda_build.launch_shape(lib, "sunray_woop_launch_shape", 2)
                     if hasattr(lib, "sunray_woop_launch_shape")
                     else ONE_RAY_SHAPE)
            rule = chip_smoke.warp_rule_tests(first, *shape)
            out[f"{name}_launch_shape"] = shape
            out[f"{name}_rule_tests"] = rule
            out[f"{name}_floor_ms"] = chip_smoke.issue_floor(
                counts, "woop_loop", rule / (32 * shape[0]))
            out[f"{name}_sass_loop"] = counts.get("woop_loop")
            print(f"{name}: bit-equal to plain; {shape[0]} rays a thread, "
                  f"{shape[1]} threads a block; tests run (model) {rule} "
                  f"({rule / out['woop_needed_tests']:.4f}x needed); SASS "
                  f"{counts.get('woop_loop')} a triangle iteration, floor "
                  f"{out[f'{name}_floor_ms']} ms", flush=True)
        else:
            for label, g in guides.items():
                got = atrous(lib, g)
                plain = cuda_image.atrous_denoise_plain(*g, 4)
                torch.cuda.synchronize()
                err = (got - plain).abs().max().item()
                chip_smoke.check(err <= chip_smoke.ATROUS_ATOL,
                                 f"{name} {label}: error {err}")
                if label in ref:
                    chip_smoke.check(torch.equal(got, ref[label]),
                                     f"{name} {label}: not bit-equal to "
                                     "atrous_before")
                else:
                    ref[label] = got
                out[f"{name}_{label}_err"] = err
                out[f"{name}_{label}_floor_ms"] = (
                    None if name == "atrous_before" else
                    chip_smoke.atrous_issue_floor(counts, g))
            out[f"{name}_sass_taps"] = counts.get("atrous_taps")
            print(f"{name}: within {chip_smoke.ATROUS_ATOL} of plain "
                  f"(synthetic {out[f'{name}_synthetic_err']:.3g}, live "
                  f"{out[f'{name}_live_err']:.3g}), bit-equal to atrous_before; "
                  f"SASS {counts.get('atrous_taps')} through 24 taps", flush=True)
    for label, g in guides.items():
        out[f"{label}_bypass_share"] = chip_smoke.bypass_share(g)

    def timers(name):
        lib = libs[name][0]
        if name.startswith("trace"):
            return {"k14": (lambda: woop(lib, table, o, d, tmax, exclude), 1)}
        return {f"k7_{label}": ((lambda g=g: atrous(lib, g)), 4)
                for label, g in guides.items()}

    for kind in ("trace", "atrous"):
        before_after.time_in_turns([f"{kind}_before"], f"{kind}_after", timers,
                                   out)
    # K7 one pass at each step of the denoise, synthetic guides.
    g = guides["synthetic"]
    dst = torch.empty_like(g[0])
    for name in ("atrous_before", "atrous_after"):
        lib = libs[name][0]
        for step in (1, 2, 4, 8):
            key = f"{name}_step{step}_device_ms"
            out[key] = chip_smoke.device_ms(
                lambda step=step: cuda_image._launch_pass(*g, step, dst, lib=lib))
            print(f"{name} step {step}: device {out[key]:.4f} ms (synthetic)",
                  flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
