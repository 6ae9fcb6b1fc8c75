"""K1 (csrc/trace.cu) and K5 (csrc/restir.cu) against other versions of
their sources, on one card, with the same inputs, the same host path and
the same clocks.

    python3 tools/k1_k5_before_after.py --before DIR [DIR ...]

Each DIR holds another trace.cu, restir.cu or both (e.g. a commit's
sunray_tpu_torch/csrc/ unpacked with git archive), its builds named by
the directory's name (trace_<name>, restir_<name>). Each source is built
alone (nvcc, the port's flags) into build/k1_k5_before_after/, and every
build is launched through the wrappers' own launch code
(cuda_trace._launch_closest, cuda_restir._launch_di_spatial) given the
build's library, so the builds differ in their kernel only. A K1 build
whose library has no sunray_closest_launch_shape traces one ray a thread
on blocks of 128.

Inputs: for K1 chip_smoke.py's synthetic sets (2,073,600 camera and
bounce rays x the Cornell box's 36 triangles, 65,536 random rays x 4,096
random triangles) and the frames' own closest-hit queries: the two of
frame 2 of the default 1080p ReSTIR frame and every call of frame 2 of
the 1080p NEE frame (timed: the first, the second and the last); for K5
its arguments in frames 2-5 of the ReSTIR frame. Every K1 build is
bit-equal to trace_closest_brute on every field of every ray of every
query and set; every K5 build has seeds, M and `has` equal to plain and
is bit-equal to the first DIR's K5 build on every output of every lane.
The builds are timed in turns (the DIRs' in order, the current one twice,
the DIRs' in reverse) as chip_smoke.py times kernels (device_ms) and by
CUDA events around one call (time_ms); beside each, its registers
(-Xptxas=-v), its SASS count a ray-triangle test (K1) or a used tap and
around the tap loop (K5), and its issue floor. The last line is one JSON
object of those numbers.
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
OUT = REPO / "build" / "k1_k5_before_after"
# The launch shape of a K1 source that does not report its own through
# sunray_closest_launch_shape: one ray a thread on blocks of 128.
ONE_RAY_SHAPE = (1, 128, 0)
# The NEE frame's calls that are timed (all are checked).
NEE_TIMED = (0, 1, -1)


def load(name, lib):
    """A build's library with the entry points the tool calls declared."""
    from sunray_tpu_torch.ops import cuda_build

    if name.startswith("trace"):
        names = ["sunray_trace_closest"]
        if hasattr(lib, "sunray_closest_launch_shape"):
            names.append("sunray_closest_launch_shape")
        return cuda_build.declare(lib, names)
    return cuda_build.declare(lib, ["sunray_di_spatial"])


def closest(lib, tris, o, d, tmin, tmax):
    """K1 from `lib` on scalar or per-ray bounds."""
    from sunray_tpu_torch.ops import cuda_trace

    def split(x):
        return (x, 0.0) if torch.is_tensor(x) and x.dim() else (None, float(x))

    return cuda_trace._launch_closest(tris, o, d, *split(tmin), *split(tmax),
                                      lib=lib)


def di_spatial(lib, args):
    from sunray_tpu_torch.ops import cuda_restir

    return cuda_restir._launch_di_spatial(*args, lib=lib)


def counts_of(so, kind, card):
    """chip_smoke's SASS counts of one build (K1's loop or K5's tap and
    fixed paths), with the card's SM count and clock from `card`
    (chip_smoke.sass_counts of the package's library)."""
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    funcs = sass.functions(sass.disassemble(so, cuobjdump))
    out = (chip_smoke.loop_unit_counts(funcs, keys=("k1_test",))
           if kind == "trace" else chip_smoke.di_spatial_counts(funcs))
    return dict(out, clock_mhz=card["clock_mhz"], n_sm=card["n_sm"]) if card else {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path, nargs="+",
                    help="directories holding other trace.cu and/or restir.cu")
    args = ap.parse_args()
    tags = [d.name for d in args.before]
    if len(set(tags)) != len(tags) or "after" in tags:
        sys.exit("k1_k5_before_after: give each --before directory its own "
                 "name, not 'after'")
    if not torch.cuda.is_available():
        sys.exit("k1_k5_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_restir, intersect

    card = before_after.card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sources = {f"{kind}_{tag}": d / f"{kind}.cu"
               for kind in ("trace", "restir")
               for tag, d in zip(tags, args.before) if (d / f"{kind}.cu").exists()}
    sources.update(trace_after=CSRC / "trace.cu", restir_after=CSRC / "restir.cu")
    built = before_after.build(sources, OUT)
    libs = {name: load(name, lib) for name, (lib, _) in built.items()}
    path, _ = cuda_build.build()          # the package's own, for the plain
    cuda_build.library()                  # paths' helpers and SASS clock
    card_counts = chip_smoke.sass_counts(path)
    out = {"card": card}
    for name, (_, report) in built.items():
        kernel = "closest_kernel" if name.startswith("trace") else "di_spatial_kernel"
        out[f"{name}_registers"] = {
            k: v for k, v in chip_smoke.ptxas_registers("\n".join(report)).items()
            if k.startswith(kernel)}

    cap = chip_smoke.capture_restir_inputs(dev)
    nee = chip_smoke.capture_calls(dev, {"trace_closest": "cuda_trace"}, 2,
                                   lighting="nee")["trace_closest"]
    sets = chip_smoke.trace_sets(dev)
    bounds = (intersect.T_MIN, intersect.T_MAX)
    k1_inputs = {"synthetic camera": (sets["tris"], *sets["camera"], *bounds),
                 "synthetic bounce": (sets["tris"], *sets["bounce"], *bounds),
                 "random 4096 tris": (sets["random_tris"], *sets["random"],
                                      *bounds)}
    for label, (a, kw) in zip(chip_smoke.RESTIR_CLOSEST, cap["closest"]):
        chip_smoke.check(not kw, f"K1 {label}: keyword arguments {kw}")
        k1_inputs[f"ReSTIR {label}"] = a
    for i, (a, kw) in enumerate(nee):
        chip_smoke.check(not kw, f"K1 NEE call {i}: keyword arguments {kw}")
        k1_inputs[f"NEE call {i}"] = a
    timed_k1 = [*list(k1_inputs)[:len(k1_inputs) - len(nee)],
                *(f"NEE call {range(len(nee))[i]}" for i in NEE_TIMED)]
    k5_inputs = {f"frame {f}": a for f, a in enumerate(cap["di_spatial"], start=2)}

    for name in [f"trace_{tag}" for tag in tags if f"trace_{tag}" in libs] + [
            "trace_after"]:
        lib = libs[name]
        counts = counts_of(OUT / f"{name}.so", "trace", card_counts)
        shape = (cuda_build.launch_shape(lib, "sunray_closest_launch_shape", 3)
                 if hasattr(lib, "sunray_closest_launch_shape") else ONE_RAY_SHAPE)
        out[f"{name}_launch_shape"] = shape
        out[f"{name}_sass_test"] = {k: v for k, v in counts.items()
                                    if k.startswith("k1_test")}
        for label, q in k1_inputs.items():
            got = closest(lib, *q)
            want = intersect.trace_closest_brute(*q)
            torch.cuda.synchronize()
            differ = chip_smoke.lanes_differing(got, want)
            chip_smoke.check(differ == 0, f"{name} {label}: K1 differs from plain "
                             f"on {differ} rays")
            if label in timed_k1:
                out[f"{name}_{label}_floor_ms"] = chip_smoke.closest_floor(
                    counts, q[1].shape[0], q[0][0].shape[0], shape)
        print(f"{name}: bit-equal to plain on every ray of {len(k1_inputs)} "
              f"queries; {shape[0]} rays a thread from {shape[2]} rays a "
              f"launch on, else 1, {shape[1]} threads a block; registers "
              f"{out[f'{name}_registers']}; SASS {out[f'{name}_sass_test']} a "
              f"ray-triangle test; floor (camera set) "
              f"{out[f'{name}_synthetic camera_floor_ms']} ms", flush=True)

    ref = {}
    restirs = [f"restir_{tag}" for tag in tags if f"restir_{tag}" in libs]
    for name in restirs + ["restir_after"]:
        lib = libs[name]
        counts = counts_of(OUT / f"{name}.so", "restir", card_counts)
        out[f"{name}_sass"] = {k: v for k, v in counts.items()
                               if k.startswith("k5_")}
        for label, a in k5_inputs.items():
            seed_k, got = di_spatial(lib, a)
            seed_p, want = cuda_restir.di_spatial_plain(*a)
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(seed_k, seed_p)
                             and torch.equal(got["M"], want["M"])
                             and torch.equal(got["has"], want["has"]),
                             f"{name} {label}: seeds, M or has differ from plain")
            fields = chip_smoke.reservoir_fields((seed_k, got))
            out[f"{name}_{label}_lanes_differing_from_plain"] = \
                chip_smoke.lanes_differing(
                    fields, chip_smoke.reservoir_fields((seed_p, want)))
            if label in ref:
                chip_smoke.check(chip_smoke.lanes_differing(fields, ref[label]) == 0,
                                 f"{name} {label}: not bit-equal to "
                                 f"{restirs[0] if restirs else name}")
            else:
                ref[label] = fields
            out[f"{name}_{label}_floor_ms"] = chip_smoke.di_spatial_floor(counts, a)
        differing = [out[f"{name}_{lb}_lanes_differing_from_plain"]
                     for lb in k5_inputs]
        print(f"{name}: seeds, M and has equal to plain; lanes differing from "
              f"plain in any bit {differing}; bit-equal to "
              f"{restirs[0] if restirs else name} on every output of every "
              f"lane; registers {out[f'{name}_registers']}; SASS "
              f"{out[f'{name}_sass']}; floor (frame 2) "
              f"{out[f'{name}_frame 2_floor_ms']} ms", flush=True)

    def timers(name):
        lib = libs[name]
        if name.startswith("restir"):
            return {f"k5_{label}": ((lambda a=a: di_spatial(lib, a)), 1)
                    for label, a in k5_inputs.items()}
        return {f"k1_{label}": ((lambda q=k1_inputs[label]: closest(lib, *q)), 1)
                for label in timed_k1}

    before_after.time_in_turns([f"trace_{tag}" for tag in tags
                                if f"trace_{tag}" in libs], "trace_after",
                               timers, out)
    before_after.time_in_turns(restirs, "restir_after", timers, out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
