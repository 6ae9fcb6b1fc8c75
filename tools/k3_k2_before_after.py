"""K3 (csrc/restir.cu) and K2 (csrc/trace.cu) against other versions of
their sources, on one card, with the same inputs, the same host path and
the same clocks.

    python3 tools/k3_k2_before_after.py --before DIR [DIR ...]

Each DIR holds another restir.cu and trace.cu (e.g. a commit's
sunray_tpu_torch/csrc/ unpacked with git archive), its builds named by
the directory's name (restir_<name>, trace_<name>). Each source is built
alone (nvcc, the port's flags) into build/k3_k2_before_after/, and every
build is launched through the wrappers' own launch code
(cuda_restir._launch_audition, cuda_trace._launch_occluded) given the
build's library, so the builds differ in their kernel only. A K3 build
whose library has no sunray_ris_launch_shape predates the per-light
records: its entry point takes no record buffer, and RecordlessAudition
drops that argument for it.

Inputs: for K3 the arguments ris_audition got in frame 2 of the default
1080p ReSTIR frame (K = 16 on the box's 2 lights) and chip_smoke.py's
random 600-light table (shared memory) and a 1,500-light one (the
read-only path); for K2 the three shadow queries of that frame, the NEE
frame's first bounce round, chip_smoke.py's synthetic shadow set and its
random 4,096-triangle set. Every K3 build is held to the plain version
(seeds bit-equal, M exact, winners on more than 99.5% of lanes) and to
the first DIR's build bit for bit on every output of every lane; every
K2 build differs from plain on no ray. The builds are timed in turns
(the DIRs' in order, the current one twice, the DIRs' in reverse) as
chip_smoke.py times kernels
(device_ms) and by CUDA events around one call (time_ms); beside each,
its SASS count a candidate or a ray-triangle test, its issue floor, and
for K2 the tests its warp rule runs at the build's launch shape. The last
line is one JSON object of those numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after, sass  # noqa: E402

CSRC = REPO / "sunray_tpu_torch" / "csrc"
OUT = REPO / "build" / "k3_k2_before_after"
# The launch shape of a K2 source that does not report its own through
# sunray_occluded_launch_shape: one ray a thread on blocks of 128.
ONE_RAY_SHAPE = (1, 128, 0)


class RecordlessAudition:
    """A K3 build from before the per-light records behind the current
    entry point's signature: the record buffer is dropped."""

    def __init__(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        self._fn = lib.sunray_ris_audition
        self._fn.argtypes = [p, i] + [p] * 8 + [i, i] + [p] * 8
        self._fn.restype = ctypes.c_int

    def sunray_ris_audition(self, tab, n_lights, rec, *rest):
        return self._fn(tab, n_lights, *rest)


def load(name, lib):
    """A build's library with the entry points the tool calls declared."""
    from sunray_tpu_torch.ops import cuda_build

    if name.startswith("trace"):
        names = ["sunray_trace_occluded"]
        if hasattr(lib, "sunray_occluded_launch_shape"):
            names.append("sunray_occluded_launch_shape")
        return cuda_build.declare(lib, names)
    if not hasattr(lib, "sunray_ris_launch_shape"):
        return RecordlessAudition(lib)
    return cuda_build.declare(lib, ["sunray_ris_audition",
                                    "sunray_ris_launch_shape"])


def audition(lib, args):
    from sunray_tpu_torch.ops import cuda_restir

    return cuda_restir._launch_audition(*args, lib=lib)


def occluded(lib, tris, o, d, tmax, exclude):
    """K2 from `lib` on a scalar tmin, per-ray tmax."""
    from sunray_tpu_torch.ops import cuda_trace
    from sunray_tpu_torch.ops.intersect import T_MIN

    return cuda_trace._launch_occluded(tris, o, d, None, T_MIN, tmax, 0.0,
                                       exclude, lib=lib)


def counts_of(so, key, card):
    """chip_smoke's SASS count `key` of one build, with the card's SM count
    and clock from `card` (chip_smoke.sass_counts of the package's
    library)."""
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    funcs = sass.functions(sass.disassemble(so, cuobjdump))
    out = chip_smoke.loop_unit_counts(funcs, keys=(key,))
    return dict(out, clock_mhz=card["clock_mhz"], n_sm=card["n_sm"]) if card else {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path, nargs="+",
                    help="directories holding other restir.cu and trace.cu")
    args = ap.parse_args()
    tags = [d.name for d in args.before]
    if len(set(tags)) != len(tags) or "after" in tags:
        sys.exit("k3_k2_before_after: give each --before directory its own "
                 "name, not 'after'")
    if not torch.cuda.is_available():
        sys.exit("k3_k2_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_restir, cuda_trace, intersect

    card = before_after.card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sources = {f"{kind}_{tag}": d / f"{kind}.cu"
               for kind in ("restir", "trace")
               for tag, d in zip(tags, args.before)}
    sources.update(restir_after=CSRC / "restir.cu", trace_after=CSRC / "trace.cu")
    built = before_after.build(sources, OUT)
    libs = {name: load(name, lib) for name, (lib, _) in built.items()}
    path, _ = cuda_build.build()          # the package's own, for the plain
    cuda_build.library()                  # paths' helpers and SASS clock
    card_counts = chip_smoke.sass_counts(path)

    cap = chip_smoke.capture_restir_inputs(dev, frames=1)
    k3_in, restir_k2 = cap["args"], cap["occluded"]
    k3_inputs = {"live": k3_in["ris_audition"],
                 "lights600": chip_smoke.random_audition_args(dev, 600),
                 "lights1500": chip_smoke.random_audition_args(dev, 1500)}
    nee = chip_smoke.capture_calls(dev, {"trace_occluded": "cuda_trace"}, 2,
                                   lighting="nee")["trace_occluded"]
    sets = chip_smoke.trace_sets(dev)
    k2_inputs = {}
    for label, (a, kw) in [*zip(chip_smoke.RESTIR_OCCLUDED, restir_k2),
                           ("NEE bounce round 0", nee[0])]:
        tris, o, d, tmax, tmin = a
        chip_smoke.check(tmin == intersect.T_MIN, f"{label}: tmin {tmin}")
        k2_inputs[label] = (tris, o, d, tmax, kw["exclude"])
    k2_inputs["synthetic shadow"] = (sets["tris"], *sets["shadow"])
    k2_inputs["random 4096 tris"] = (sets["random_tris"], *sets["random_occ"])

    out = {"card": card}
    ref = {}
    for name in [f"restir_{tag}" for tag in tags] + ["restir_after"]:
        lib = libs[name]
        counts = counts_of(OUT / f"{name}.so", "k3_candidate", card_counts)
        out[f"{name}_sass_candidate"] = counts.get("k3_candidate")
        for label, a in k3_inputs.items():
            seed_k, got = audition(lib, a)
            seed_p, want = cuda_restir.ris_audition_plain(*a)
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(seed_k, seed_p)
                             and torch.equal(got["M"], want["M"]),
                             f"{name} {label}: seeds or M differ from plain")
            agree = (got["light_idx"] == want["light_idx"]).float().mean().item()
            chip_smoke.check(agree > chip_smoke.WINNER_AGREE,
                             f"{name} {label}: winners agree on {agree}")
            fields = chip_smoke.reservoir_fields((seed_k, got))
            if label in ref:
                chip_smoke.check(chip_smoke.lanes_differing(fields, ref[label]) == 0,
                                 f"{name} {label}: not bit-equal to "
                                 f"restir_{tags[0]}")
            else:
                ref[label] = fields
            warps = chip_smoke.warps_any(a[9])
            out[f"{name}_{label}_agree"] = agree
            out[f"{name}_{label}_floor_ms"] = chip_smoke.issue_floor(
                counts, "k3_candidate", warps * a[8])
        agrees = ", ".join(f"{lb} {out[name + '_' + lb + '_agree']:.7f}"
                           for lb in k3_inputs)
        print(f"{name}: seeds and M equal to plain, winners agree ({agrees}); "
              f"bit-equal to restir_{tags[0]} on every output of every lane; SASS "
              f"{out[name + '_sass_candidate']} a candidate, floor "
              f"{out[name + '_live_floor_ms']} ms (live)", flush=True)
    firsts = {label: chip_smoke.occluded_first(*q)
              for label, q in k2_inputs.items()}
    for label, q in k2_inputs.items():
        out[f"k2_{label}_rays"] = q[1].shape[0]
        out[f"k2_{label}_needed_tests"] = int(firsts[label].sum())
    for name in [f"trace_{tag}" for tag in tags] + ["trace_after"]:
        lib = libs[name]
        counts = counts_of(OUT / f"{name}.so", "k2_test", card_counts)
        shape = (cuda_build.launch_shape(lib, "sunray_occluded_launch_shape", 3)
                 if hasattr(lib, "sunray_occluded_launch_shape") else ONE_RAY_SHAPE)
        out[f"{name}_launch_shape"] = shape
        out[f"{name}_sass_test"] = counts.get("k2_test")
        for label, q in k2_inputs.items():
            got = occluded(lib, *q)
            want = intersect.trace_occluded_brute(*q[:4], exclude=q[4])
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            chip_smoke.check(differ == 0, f"{name} {label}: K2 differs from "
                             f"plain on {differ} rays")
            rays = cuda_trace.rays_a_thread(q[1].shape[0], shape)
            rule = chip_smoke.warp_rule_tests(firsts[label], rays, shape[1])
            out[f"{name}_{label}_rule_tests"] = rule
            out[f"{name}_{label}_floor_ms"] = chip_smoke.issue_floor(
                counts, f"k2_test_r{rays}", rule / 32)
        print(f"{name}: 0 rays differ from plain on every query; {shape[0]} "
              f"rays a thread from {shape[2]} rays a launch on, else 1, "
              f"{shape[1]} threads a block; SASS {out[f'{name}_sass_test']} "
              "a ray-triangle test", flush=True)
    for label in k2_inputs:
        runs = ", ".join(
            f"{tag} {out[f'trace_{tag}_{label}_rule_tests']} (floor "
            f"{out[f'trace_{tag}_{label}_floor_ms']} ms)"
            for tag in [*tags, "after"])
        print(f"K2 {label}: {out[f'k2_{label}_rays']} rays, needed tests "
              f"{out[f'k2_{label}_needed_tests']}; run (model): {runs}",
              flush=True)

    def timers(name):
        lib = libs[name]
        if name.startswith("restir"):
            return {f"k3_{label}": ((lambda a=a: audition(lib, a)), 1)
                    for label, a in k3_inputs.items()}
        return {f"k2_{label}": ((lambda q=q: occluded(lib, *q)), 1)
                for label, q in k2_inputs.items()}

    for kind in ("restir", "trace"):
        before_after.time_in_turns([f"{kind}_{tag}" for tag in tags],
                                   f"{kind}_after", timers, out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
