"""B2 and B3 (csrc/bvh.cu) against other versions of their source, on one
card, on the 1080p real-scene frame's own queries.

    python3 tools/bvh_before_after.py --before DIR [DIR ...]

Each DIR holds another bvh.cu (e.g. a commit's sunray_tpu_torch/csrc/
unpacked with git archive, or a copy of the current source with one
constant changed) and names its build. Each source is built alone (nvcc,
the port's flags) into build/bvh_before_after/. A build of the current
interface (it has sunray_bvh_walk_alpha) launches through the wrapper's
own launch code (cuda_bvh._launch) given the build's library; an older
build (one ray a thread, the stacks in local memory, corner rows, no
fused alpha walk) through legacy_launch, its C interface.

Inputs: chip_smoke.py phase 10's scene (tools/synth_gltf.py, 256,068
triangles, 1080p default ReSTIR), one frame of tracer "auto" (B3) and
one of tracer "bvh" (B2) captured query by query. Each build's walk
without alpha runs the camera, GI-bounce and first shadow (any hit, with
its exclude ids) queries: bit-equal to the plain twin (ops/bvh.walk_plain:
t, tri, u, v, hit and the test counts) on 65,536 lanes spread over each
and to the current build on every lane. The builds are then timed in
turns (the DIRs in order, the current source twice, the DIRs in reverse)
as chip_smoke.py times kernels. Beside each: its registers (-Xptxas=-v), the SASS of a pop of an
internal node and of a triangle test (chip_smoke.walk_counts), the issue
floor they give for the query's own test counts, and the bound.

The frame's alpha queries (every trace query of the frame: alpha cutout
is on) both ways: the route the fused walk replaced, the batch rounds
over each older build's walk (render/trace.closest_alpha_rounds /
occluded_alpha_rounds, a host sync a round), against the current
source's fused walk, one launch; equal on every lane; each query and the frame's sum timed (CUDA
events around one call; the fused walk also as chip_smoke.device_ms).
The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after  # noqa: E402

CSRC = REPO / "sunray_tpu_torch" / "csrc"
OUT = REPO / "build" / "bvh_before_after"
WARM = 2                 # frames rendered before the captured one
PICK = ("camera", "GI bounce", "shadow")
# The walk instantiations of a build before the redesign (bvh_walk_kernel<
# any hit, two levels>), for chip_smoke.walk_counts.
LEGACY_SASS = (("b2", "15bvh_walk_kernelILb0ELb0EE"),
               ("b2_any", "15bvh_walk_kernelILb1ELb0EE"),
               ("b3", "15bvh_walk_kernelILb0ELb1EE"),
               ("b3_any", "15bvh_walk_kernelILb1ELb1EE"))


def is_legacy(lib):
    return not hasattr(lib, "sunray_bvh_walk_alpha")


def load(lib):
    """A build's library with its entry points declared."""
    from sunray_tpu_torch.ops import cuda_build

    if not is_legacy(lib):
        return cuda_build.declare(lib, ["sunray_bvh_walk",
                                        "sunray_bvh_walk_alpha"])
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sunray_bvh_walk.argtypes = [p, p, i, p, p, i, i, p, p, p, i, i, p, p,
                                    p, p, p, i64, p, p, p, p, p, p, p]
    lib.sunray_bvh_walk.restype = ctypes.c_int
    return lib


def legacy_launch(lib, tables, o, d, tmin, tmax, exclude, any_hit,
                  tests=None, **_):
    """One launch of a build before the redesign: its C interface took
    the corner rows (leaf_v) and a two_level flag."""
    from sunray_tpu_torch.ops import cuda_build

    n, dev = o.shape[0], o.device
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    if any_hit:
        t = tri = u = v = None
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        tri = torch.empty((n,), dtype=torch.int32, device=dev)
        u, v = torch.empty_like(t), torch.empty_like(t)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = lib.sunray_bvh_walk(
        ptr(tables.node_ids), ptr(tables.node_box), tables.node_ids.shape[0],
        ptr(tables.leaf_v), ptr(tables.leaf_ids), tables.num_leaves,
        tables.leaf_ids.shape[1], ptr(tables.root), ptr(tables.inst_inv),
        ptr(tables.inst_off), int(tables.two_level), int(any_hit), ptr(o),
        ptr(d), ptr(tmin), ptr(tmax), ptr(exclude), n, ptr(t), ptr(tri),
        ptr(u), ptr(v), ptr(hit), ptr(tests), cuda_build.stream_ptr())
    cuda_build.check_launch("legacy bvh_walk", err)
    return t, tri, u, v, hit


def walker(lib):
    """launch(tables, o, d, tmin, tmax, exclude, any_hit, tests=None,
    alpha=None, rounds=0) of a build."""
    from sunray_tpu_torch.ops import cuda_bvh

    if is_legacy(lib):
        return lambda *a, **kw: legacy_launch(lib, *a, **kw)
    launch = cuda_bvh._launch     # bound now: walk_through replaces it
    return lambda *a, **kw: launch(*a, lib=lib, **kw)


@contextlib.contextmanager
def walk_through(launch):
    """render/trace.py's rounds with each walk launched by `launch`."""
    from sunray_tpu_torch.ops import cuda_bvh

    saved = cuda_bvh._launch
    cuda_bvh._launch = launch
    try:
        yield
    finally:
        cuda_bvh._launch = saved


def capture(dev, tracer, scene_path):
    """(all queries, the picked three) of one 1080p frame of tracer."""
    import chip_smoke
    from sunray_tpu_torch.camera import Camera
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.renderer import Renderer
    from tools.synth_gltf import CAMERA

    r = Renderer(RenderConfig(width=1920, height=1080, tracer=tracer),
                 device=dev)
    r.load_gltf(scene_path)
    cam = Camera(**CAMERA)
    for _ in range(WARM):
        r.render(cam)
    queries = chip_smoke.capture_traces(lambda: r.render(cam))
    pick = [[q for q in queries if q[1] == "camera"][0],
            [q for q in queries if q[1] == "GI bounce"][0],
            [q for q in queries if q[0] == "occluded" and q[4] is not None][0]]
    return [q for q in queries if q[3][0].shape[0] > 0], pick


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path, nargs="+",
                    help="directories holding other bvh.cu")
    args = ap.parse_args()
    tags = before_after.tags_of(args.before, "bvh_before_after")
    if not torch.cuda.is_available():
        sys.exit("bvh_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import bvh, cuda_build
    from sunray_tpu_torch.ops.intersect import Hit
    from sunray_tpu_torch.render import trace

    card = before_after.card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    built = before_after.build({**{t: d / "bvh.cu" for t, d in zip(tags, args.before)},
                                "after": CSRC / "bvh.cu"}, OUT)
    libs = {name: load(lib) for name, (lib, _) in built.items()}
    path, _ = cuda_build.build()          # the frame's other kernels
    cuda_build.library()
    n_sm, clock = before_after.sm_clock()
    out = {"card": card}
    sass = {}
    for name, (_, report) in built.items():
        out[f"{name}_registers"] = {
            k: v for k, v in chip_smoke.ptxas_registers("\n".join(report)).items()
            if k.startswith("bvh_walk_kernel")}
        funcs = before_after.functions(OUT / f"{name}.so")
        sass[name] = dict(chip_smoke.walk_counts(
            funcs, LEGACY_SASS if is_legacy(libs[name])
            else chip_smoke.WALK_SASS), n_sm=n_sm, clock_mhz=clock)
        out[f"{name}_sass"] = {k: v for k, v in sass[name].items()
                               if k not in ("n_sm", "clock_mhz")}
        print(f"{name}: registers {out[f'{name}_registers']}; SASS "
              f"{out[f'{name}_sass']}", flush=True)

    timed = {}
    alpha = {}
    scene_path = chip_smoke.real_scene_path()
    for tracer in ("auto", "bvh"):
        queries, pick = capture(dev, tracer, scene_path)
        kernel = "B3" if tracer == "auto" else "B2"
        for (kind, label, ctx, rays, ex), short in zip(pick, PICK):
            closest = kind == "closest"
            ex = None if closest else ex
            key = f"{kernel} {short}"
            n = rays[0].shape[0]
            tests = torch.empty((n, 2), dtype=torch.int32, device=dev)
            ref = walker(libs["after"])(ctx.walk, *rays, ex, not closest,
                                        tests=tests)
            sel = chip_smoke.spread(n, dev)
            plain = bvh.walk_plain(ctx.walk, *(x[sel] for x in rays),
                                   any_hit=not closest,
                                   exclude=None if ex is None else ex[sel])
            chip_smoke.check(torch.equal(tests[sel], torch.stack(
                [plain.box_tests, plain.tri_tests], 1).to(torch.int32)),
                f"{key}: test counts differ from the plain twin")
            for name, lib in libs.items():
                got = walker(lib)(ctx.walk, *rays, ex, not closest)
                if closest:
                    want = Hit(torch.where(plain.found, plain.t, torch.inf),
                               plain.tri, plain.u, plain.v, plain.found)
                    differ = chip_smoke.hits_differing(
                        Hit(*(x[sel] for x in got)), want)
                    every = chip_smoke.hits_differing(Hit(*got), Hit(*ref))
                else:
                    differ = int((got[4][sel] != plain.found).sum())
                    every = int((got[4] != ref[4]).sum())
                chip_smoke.check(differ == 0 and every == 0,
                                 f"{name} {key}: {differ} lanes differ from "
                                 f"the plain twin, {every} from the current "
                                 "build")
            b_ms, b_by = chip_smoke.walk_bound(rays, tests.long(), closest, ex)
            skey = chip_smoke.walk_key(ctx.walk, closest)
            out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = b_ms, b_by
            out[f"{key}_rays"] = n
            out[f"{key}_tests_a_ray"] = (tests.float().mean(0)).tolist()
            for name in libs:
                out[f"{name}_{key}_floor_ms"] = chip_smoke.walk_floor(
                    sass[name], skey, tests)
            timed[key] = (ctx.walk, rays, ex, closest)
            print(f"{key}: {n} rays, every build bit-equal to the plain twin "
                  f"on {sel.numel()} lanes and to the current build on every "
                  f"lane; bound {b_ms:.4f} ms ({b_by}); floors "
                  + ", ".join(f"{name} {out[f'{name}_{key}_floor_ms']}"
                              for name in libs), flush=True)

        # The alpha queries: the rounds over each older build, the fused walk.
        sums = {}
        for kind, label, ctx, rays, ex in queries:
            closest = kind == "closest"
            o, d, tn, tx = rays

            def rounds(name=None):
                with walk_through(walker(libs[name])):
                    if closest:
                        return trace.closest_alpha_rounds(ctx, o, d, tn, tx)
                    return trace.occluded_alpha_rounds(ctx, o, d, tx, tn, ex)

            def fused():
                return walker(libs["after"])(ctx.walk, o, d, tn, tx, ex,
                                             not closest, alpha=ctx.alpha,
                                             rounds=ctx.alpha_rounds)

            got = fused()
            for name in tags:
                want = rounds(name)
                every = (chip_smoke.hits_differing(Hit(*got), want) if closest
                         else int((got[4] != want).sum()))
                chip_smoke.check(every == 0, f"{kernel} {label}: the fused walk "
                                 f"differs from {name}'s rounds on {every} lanes")
            row = {"fused_events_ms": chip_smoke.time_ms(fused),
                   "fused_device_ms": chip_smoke.device_ms(fused)}
            for name in tags:
                row[f"{name}_rounds_ms"] = chip_smoke.time_ms(
                    lambda name=name: rounds(name))
            for k, v in row.items():
                sums[k] = sums.get(k, 0.0) + v
            alpha[f"{kernel} {label} ({kind}, {o.shape[0]} rays)"] = row
            print(f"{kernel} {label} ({kind}): fused equal to the rounds of "
                  f"{tags} on every lane; " + ", ".join(
                      f"{k} {v:.4f}" for k, v in row.items()), flush=True)
        alpha[f"{kernel} frame sum ({len(queries)} queries)"] = sums
        print(f"{kernel}: the frame's {len(queries)} alpha queries, summed: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in sums.items()),
              flush=True)
    out["alpha"] = alpha

    def timers(name):
        launch = walker(libs[name])
        return {key: ((lambda w=w, r=r, e=e, c=c: launch(w, *r, e, not c)), 1)
                for key, (w, r, e, c) in timed.items()}

    before_after.time_in_turns(tags, "after", timers, out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
