"""B1 (boundary_candidates, csrc/boundary.cu) against other versions of
its source, on one card, with the same inputs; and the 720p step with
both visibility terms with each other version's B1 and K8 backward.

    python3 tools/b1_before_after.py --before DIR [DIR ...]

Each DIR holds another boundary.cu and, for the step, another gather.cu
(e.g. a commit's sunray_tpu_torch/csrc/ unpacked with git archive, or a
copy of the current source with one change), and names its builds. Each
source is built alone (nvcc, the port's flags) into
build/b1_before_after/. A B1 build of the current interface launches
through the wrapper's own launch code (cuda_boundary._launch) given the
build's library (its C interface did not change in the redesign; a build
without sunray_boundary_launch_shape, one (pixel, light) a thread,
predates it).

Inputs: B1's two calls in one 1280x720 differentiable ReSTIR step with
both visibility terms (chip_smoke.py phase 9: 921,600 first-rough hits x
2 lights x 64 edges, K = 8) and 921,600 random points in the box. Each
build is held to boundary_candidates_plain on every (light, pixel) lane;
then the builds are timed in turns (the DIRs in order, the current source
twice, the DIRs in reverse) on the step's first call and on the random
set. Beside each: its registers (-Xptxas=-v), the SASS of its edge loop
through no division and through one (loop_counts), the issue floor they
give on these inputs (issue_floor), and the bound (operations,
chip_smoke.b1_needed_ops). For the DIRs that hold gather.cu, the step
itself (3 warm-up, 10 timed, synced; peak memory) runs in the same turns
with each DIR's B1 and K8 backward swapped in and with the current ones.
The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after, k8_bwd_before_after, sass  # noqa: E402

CSRC = REPO / "sunray_tpu_torch" / "csrc"
OUT = REPO / "build" / "b1_before_after"
STEP_WARM, STEP_TIMED = 3, 10


def is_legacy(lib):
    """A build from before the redesign: no sunray_boundary_launch_shape
    (its C interface is the current one)."""
    return not hasattr(lib, "sunray_boundary_launch_shape")


def load(lib):
    """A B1 build's library with its entry point declared."""
    from sunray_tpu_torch.ops import cuda_build

    return cuda_build.declare(lib, ["sunray_boundary_candidates"])


def launch(lib, xs, mask, edges, lights, k):
    from sunray_tpu_torch.ops import cuda_boundary

    return cuda_boundary._launch(xs, mask, edges, lights, k, lib=lib)


def loop_kernel(legacy):
    """The edge loop's kernel: the current source's K = 8 instantiation,
    or the one kernel of a source before its redesign."""
    return ("26boundary_candidates_kernelEPKf" if legacy
            else "26boundary_candidates_kernelILi8EE")


def warp_work(xs, mask, edges, lights, k, step=1 << 16):
    """B1's edge-loop iterations a warp of 32 pixels runs on these inputs,
    for issue floors: {"old": a (pixel, light) a thread, every warp walks
    every edge once a light; "new": LIGHT_GROUP lights a thread, every
    warp walks every edge once a light group, a warp with no pixel in the
    mask edges 0..K-1 alone; "div_light": the (warp, edge) pairs in which
    a lane divides for the light (a silhouette edge of a pixel in the
    mask with a point heading toward the light), summed over the lights;
    "div_any": those in which a lane divides for any light}."""
    from sunray_tpu_torch.ops import cuda_boundary as cb
    from sunray_tpu_torch.ops import fp

    p, e_n, l_n = xs.shape[0], edges.shape[0], lights.shape[0]
    groups = -(-l_n // cb.LIGHT_GROUP)
    step = step // 32 * 32
    out = dict(old=0, new=0, div_light=0, div_any=0)
    for s in range(0, p, step):
        x, m = xs[s:s + step], mask[s:s + step]
        pad = -x.shape[0] % 32
        x = torch.cat([x, x.new_zeros((pad, 3))])
        m = torch.cat([m, m.new_zeros((pad,))])
        warps = x.shape[0] // 32
        sil, _ = cb.silhouette(x, edges)
        todo = sil & m[:, None]
        any_div = torch.zeros((warps, e_n), dtype=torch.bool, device=x.device)
        for light in lights:
            p0, nl = light[0:3], light[3:6]
            cnum = fp.dot(p0 - x, nl)[:, None]
            heads = torch.zeros_like(todo)
            for pt in (edges[:, 0:3], edges[:, 3:6], edges[:, 6:9]):
                heads |= fp.dot(pt - x[:, None, :], nl) * cnum > 0.0
            div = (todo & heads).reshape(warps, 32, e_n).any(dim=1)
            out["div_light"] += int(div.sum())
            any_div |= div
        out["div_any"] += int(any_div.sum())
        scoring = m.reshape(warps, 32).any(dim=1)
        out["old"] += l_n * warps * e_n
        out["new"] += groups * int(torch.where(scoring, e_n,
                                               min(e_n, k)).sum())
    return out


def loop_counts(funcs, kernel):
    """SASS instructions of one iteration of B1's edge loop (the innermost
    loop holding the score's MUFU.RSQ) in `kernel` of a build's
    sass.functions: through no division (an edge no lane projects) and
    through one MUFU.RCP (a projection)."""
    code = sass.find(funcs, kernel)

    def rcp(ins):
        return ins.op.startswith("MUFU.RCP")

    return tuple(sass.loop_through(code, "MUFU.RSQ", rcp, need)[0]
                 for need in (0, 1))


def issue_floor(counts, work, kind, n_sm, clock_mhz):
    """B1's instruction-issue floor, ms: every warp's edge iterations at
    the count through no division, and the (warp, edge) pairs in which a
    lane divides at the count through one (for the kernel of a (pixel,
    light) a thread, once a light; for LIGHT_GROUP lights a thread, once
    for any)."""
    c0, c1 = counts
    divs = work["div_light"] if kind == "old" else work["div_any"]
    return sass.issue_floor_ms(work[kind] * c0 + divs * (c1 - c0), n_sm,
                               clock_mhz)


def step_sets(dev):
    """B1's calls in one 720p step with both visibility terms, and the
    sets timed: the step's first call and 921,600 random points in the
    box with the step's tables."""
    import chip_smoke
    from sunray_tpu_torch.render.pipeline import RenderState

    cfg, scene, leaves, mats = chip_smoke.diff_setup(dev, *chip_smoke.DIFF_SIZE,
                                                     **chip_smoke.VIS_KW)
    state = RenderState.create(cfg, dev)
    _, calls = chip_smoke.capture_b1_calls(
        lambda: chip_smoke.diff_step(cfg, scene, leaves, mats, state))
    xs0, _, edges, lights, k = calls[0]
    n = xs0.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rand = (torch.rand((n, 3), generator=gen, device=dev) * 2.2 - 0.1,
            torch.rand((n,), generator=gen, device=dev) > 0.1,
            edges, lights, k)
    return calls, {"step call 0": calls[0], "random": rand}


def time_step(tags, libs, gather_libs, out):
    """The 720p step with both terms in turns (tags in order, "after"
    twice, tags in reverse): mean of STEP_TIMED synced steps after
    STEP_WARM, with each turn's B1 and K8 backward; peak memory a turn."""
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_boundary, cuda_gather
    from sunray_tpu_torch.render.pipeline import RenderState

    dev = torch.device("cuda", 0)
    own_b1, own_bwd = cuda_boundary._launch, cuda_gather._launch_bwd

    def swapped(tag):
        b1_lib, bwd_lib = libs[tag], gather_libs[tag]

        def b1(xs, m, e, li, k, lib=None):
            return own_b1(xs, m, e, li, k, lib=b1_lib)

        def bwd(ct, idx, k, lib=None):
            if k8_bwd_before_after.is_legacy(bwd_lib):
                return k8_bwd_before_after.legacy_launch(bwd_lib, ct, idx, k)
            return own_bwd(ct, idx, k, lib=bwd_lib)

        return b1, bwd

    for turn, name in enumerate([*tags, "after", "after", *tags[::-1]]):
        if name != "after":
            cuda_boundary._launch, cuda_gather._launch_bwd = swapped(name)
        try:
            cfg, scene, leaves, mats = chip_smoke.diff_setup(
                dev, *chip_smoke.DIFF_SIZE, **chip_smoke.VIS_KW)
            state = RenderState.create(cfg, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(STEP_WARM):
                state, loss, _, _ = chip_smoke.diff_step(cfg, scene, leaves,
                                                         mats, state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEP_TIMED):
                state, loss, _, _ = chip_smoke.diff_step(cfg, scene, leaves,
                                                         mats, state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / STEP_TIMED * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
        finally:
            cuda_boundary._launch, cuda_gather._launch_bwd = own_b1, own_bwd
        out.setdefault(f"{name}_step_ms", []).append(ms)
        out.setdefault(f"{name}_step_peak_gb", []).append(peak)
        print(f"step with both terms, {name} (turn {turn}): {ms:.3f} ms, loss "
              f"{float(loss):.9f}, peak {peak:.3f} GB", flush=True)
        del cfg, scene, leaves, mats, state


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path, nargs="+",
                    help="directories holding other boundary.cu (and, for "
                    "the step, gather.cu)")
    args = ap.parse_args()
    tags = before_after.tags_of(args.before, "b1_before_after")
    if not torch.cuda.is_available():
        sys.exit("b1_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_boundary

    card = before_after.card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    specs = {tag: d / "boundary.cu" for tag, d in zip(tags, args.before)}
    specs["after"] = CSRC / "boundary.cu"
    step_tags = [tag for tag, d in zip(tags, args.before)
                 if (d / "gather.cu").exists()]
    specs.update({f"gather_{tag}": d / "gather.cu"
                  for tag, d in zip(tags, args.before) if tag in step_tags})
    if step_tags:
        specs["gather_after"] = CSRC / "gather.cu"
    built = before_after.build(specs, OUT)
    libs = {name: load(built[name][0]) for name in [*tags, "after"]}
    gather_libs = {name[len("gather_"):]: k8_bwd_before_after.load(lib)
                   for name, (lib, _) in built.items()
                   if name.startswith("gather_")}
    sms, clock = before_after.sm_clock()
    calls, sets = step_sets(dev)
    n = calls[0][0].shape[0]
    lights, k = calls[0][3:]
    out = {"card": card}
    work = {label: warp_work(*a) for label, a in sets.items()}
    for label, a in sets.items():
        ops = chip_smoke.b1_needed_ops(*a[:4])
        out_bytes = lights.shape[0] * n * (4 + k * 6)
        out[f"{label}_bound_ms"], _ = chip_smoke.bound(
            chip_smoke.nbytes(*a[:4]) + out_bytes, ops)
        out[f"{label}_needed_ops"] = ops
        out[f"{label}_warp_work"] = work[label]
        print(f"{label}: {a[0].shape[0]} pixels, {int(a[1].sum())} in the "
              f"mask; bound {out[f'{label}_bound_ms']:.4f} ms ({ops} "
              f"operations); edge-loop warp iterations {work[label]}",
              flush=True)
    for name, lib in libs.items():
        legacy = is_legacy(lib)
        out[f"{name}_registers"] = {
            kk: v for kk, v in chip_smoke.ptxas_registers(
                "\n".join(built[name][1])).items()
            if kk.startswith("boundary_candidates_kernel")}
        for label, a in [*((f"step call {i}", c) for i, c in enumerate(calls)),
                         ("random", sets["random"])]:
            got = launch(lib, *a)
            want = cuda_boundary.boundary_candidates_plain(*a)
            torch.cuda.synchronize()
            bad = chip_smoke.b1_lanes_differing(got, want)
            chip_smoke.check(bad == 0, f"{name} {label}: {bad} lanes differ "
                             "from plain")
        try:
            counts = loop_counts(
                before_after.functions(OUT / f"{name}.so"), loop_kernel(legacy))
            out[f"{name}_sass_edge"] = counts
            for label in sets:
                out[f"{name}_{label}_floor_ms"] = issue_floor(
                    counts, work[label], "old" if legacy else "new", sms, clock)
        except (OSError, ValueError, KeyError) as e:
            print(f"{name}: SASS not measured ({type(e).__name__}: {e})",
                  flush=True)
        print(f"{name}: 0 lanes differing from plain on the step's "
              f"{len(calls)} calls and the random set; registers "
              f"{out[f'{name}_registers']}; SASS an edge iteration (no "
              f"division, one) {out.get(f'{name}_sass_edge')}; floors "
              f"{ {lb: out.get(f'{name}_{lb}_floor_ms') for lb in sets} }",
              flush=True)
    before_after.time_in_turns(
        tags, "after",
        lambda name: {label: ((lambda a=a: launch(libs[name], *a)), 1)
                      for label, a in sets.items()}, out)
    del calls, sets
    if step_tags:
        time_step(step_tags, libs, gather_libs, out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
