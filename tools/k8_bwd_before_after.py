"""K8's backward (gather_rows_bwd, csrc/gather.cu) against other versions
of its source, on one card, with the same inputs.

    python3 tools/k8_bwd_before_after.py --before DIR [DIR ...]

Each DIR holds another gather.cu (e.g. a commit's sunray_tpu_torch/csrc/
unpacked with git archive, or a copy of the current source with one
change) and names its build. Each source is built alone (nvcc, the
port's flags) into build/k8_bwd_before_after/. A build of the current
interface launches
through gather_rows_bwd's own launch code (cuda_gather._launch_bwd) given
the build's library; a build with sunray_gather_rows_bwd_shape (the
kernel of one 32-index step a warp and a second summing launch, before
its redesign) through legacy_launch. Inputs: every cotangent the backward
of one 1280x720 differentiable ReSTIR step with both visibility terms
hands it (chip_smoke.py phase 9: the vertex corners, 3 x 921,600 indices
into 72 x 6, and the material rows, 921,600 into 4 x 12, three of each;
the visibility terms' three calls: edge antialiasing's vertices and the
boundary term's edge endpoints, one a light), and 3 x 2,073,600 random
indices with out-of-range ones. Each build is held within
chip_smoke.K8_BWD_TOL of each row's sum of |ct| of the plain version's
float64 sums, two runs bit-equal; then the builds are timed in turns
(the DIRs in order, the current source twice, the DIRs in reverse) on the
step's first corner call, its first
material call, each visibility call and the random set. Beside each
build: its registers (-Xptxas=-v) and the SASS of its step loop (the new
kernel's through no combine, the old one's through one row's
butterflies) with the issue floors they give. The last line is one JSON
object of those numbers.

The runs path (tables above 512 rows, gather_rows_bwd_runs) is timed on
the cotangents of one 1280x720 differentiable step on chip_smoke.py's
phase-10 GLB (phase 11: "auto", ReSTIR, gradients w.r.t. positions,
base_color, inst_transform and the atlas) and of one with edge
antialiasing: its first vertex-corner call (3 x 921,600 indices into
2,698 x 20), its first texel call (5 x 921,600 into 8,388,608 x 4) and
edge AA's triangle call (921,600 into 262,144 x 9), each held against
the float64 sums, beside its bound, its plain version, index_add_,
index_put_(accumulate=True), its own hand sort and torch.sort
(chip_smoke.runs_timing), with what its runs look like (rows, short and
long runs, the longest). With --before, each DIR's gather.cu that has a
runs path (the earlier interface, commit e55d5c6's: a keys kernel,
torch.sort and its sums kernels, launched here as that commit launched
them; or the current interface) is held
bit-equal to the current source's on every runs-path call of both steps
and timed against it in turns on those three calls. Without --before
the tool runs the runs-path part alone; --profile adds each call's
launches by one torch.profiler session (chip_smoke.runs_breakdown):

    python3 tools/k8_bwd_before_after.py [--profile]
    python3 tools/k8_bwd_before_after.py --before build/e55d5c6 --profile

(build/e55d5c6 holding `git show e55d5c6:sunray_tpu_torch/csrc/gather.cu`.)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after, sass  # noqa: E402

OUT = REPO / "build" / "k8_bwd_before_after"
# The kernel before its redesign: 4 warps a block, 4 blocks an SM, each
# warp 32 indices a step.
LEGACY_THREADS, LEGACY_BLOCKS_SM = 128, 4


def load(lib):
    """A build's library with its backward's entry points declared."""
    from sunray_tpu_torch.ops import cuda_build

    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if is_legacy(lib):
        lib.sunray_gather_rows_bwd_shape.argtypes = [i64, i, i,
                                                     ctypes.POINTER(i64)]
        lib.sunray_gather_rows_bwd.argtypes = [p, p, i, i, i64, i64, i64, i64,
                                               p, p, p]
        for fn in (lib.sunray_gather_rows_bwd_shape, lib.sunray_gather_rows_bwd):
            fn.restype = ctypes.c_int
        return lib
    return cuda_build.declare(lib, ["sunray_gather_rows_bwd",
                                    "sunray_gather_bwd_launch_shape"])


def is_legacy(lib):
    return hasattr(lib, "sunray_gather_rows_bwd_shape")


def legacy_launch(lib, ct, idx, k):
    """The backward of a build before its redesign: its own shape query,
    then the kernel and its summing launch."""
    from sunray_tpu_torch.ops import cuda_build

    g, c, n = ct.shape
    shape = (ctypes.c_int64 * 3)()
    cuda_build.check_launch("gather_rows_bwd", lib.sunray_gather_rows_bwd_shape(
        g * n, k, c, shape))
    blocks, chunk, _ = shape
    partial = torch.empty((max(blocks, 1), k, c), dtype=torch.float32,
                          device=ct.device)
    dtab = torch.empty((k, c), dtype=torch.float32, device=ct.device)
    cuda_build.check_launch("gather_rows_bwd", lib.sunray_gather_rows_bwd(
        ct.data_ptr(), idx.data_ptr(), k, c, g, n, blocks, chunk,
        partial.data_ptr(), dtab.data_ptr(), cuda_build.stream_ptr()))
    return dtab


def runs_kind(lib):
    """A build's runs path: "current" (the hand radix sort,
    sunray_gather_runs_sort), "sorted" (commit e55d5c6's: a keys kernel,
    then torch.sort, then the sums kernels) or None (no runs path)."""
    if hasattr(lib, "sunray_gather_runs_sort"):
        return "current"
    if hasattr(lib, "sunray_gather_runs_keys"):
        return "sorted"
    return None


def declare_runs(lib):
    """Declare a build's runs-path entry points (runs_kind)."""
    from sunray_tpu_torch.ops import cuda_build

    kind = runs_kind(lib)
    if kind == "current":
        cuda_build.declare(lib, ["sunray_gather_rows_bwd_runs",
                                 "sunray_gather_runs_scratch",
                                 "sunray_gather_runs_sort"])
    elif kind == "sorted":
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sunray_gather_runs_keys.argtypes = [p, i64, i, p, p]
        lib.sunray_gather_rows_bwd_runs.argtypes = [
            p, i64, i64, i64, i64, i64, p, p, i, i, p, i64, p, i, p, p]
        for fn in (lib.sunray_gather_runs_keys,
                   lib.sunray_gather_rows_bwd_runs):
            fn.restype = ctypes.c_int
    return kind


def sorted_runs_launch(lib, ct, idx, k):
    """The runs path of a build of commit e55d5c6's interface: its keys
    kernel, torch.sort(stable=True) of the keys, its sums kernels (run
    bounds over 2 K words, a thread a row, the long runs' chunks, the
    finish)."""
    from sunray_tpu_torch.ops import cuda_build, cuda_gather

    g, c, n = ct.shape
    total = g * n
    stream = cuda_build.stream_ptr()
    keys = torch.empty((total,), dtype=torch.int32, device=ct.device)
    name = "gather_rows_bwd_runs"
    cuda_build.check_launch(name, lib.sunray_gather_runs_keys(
        idx.data_ptr(), total, k, keys.data_ptr(), stream))
    srow, perm = torch.sort(keys, stable=True)
    item_cap = 2 * total // (cuda_gather.RUN_SHORT + 1) + 1
    scratch = torch.empty((2 * k + 3 * item_cap + 1,), dtype=torch.int32,
                          device=ct.device)
    partial = torch.empty((item_cap, c), dtype=torch.float64,
                          device=ct.device)
    dtab = torch.empty((k, c), dtype=torch.float32, device=ct.device)
    sg, sc, sn = ct.stride()
    cuda_build.check_launch(name, lib.sunray_gather_rows_bwd_runs(
        ct.data_ptr(), sg, sc, sn, n, total, srow.data_ptr(), perm.data_ptr(),
        k, c, scratch.data_ptr(), item_cap, partial.data_ptr(),
        8 * cuda_gather._sm_count(ct.device), dtab.data_ptr(), stream))
    return dtab


def runs_launch(lib, kind, ct, idx, k):
    from sunray_tpu_torch.ops import cuda_gather

    if kind == "sorted":
        return sorted_runs_launch(lib, ct, idx, k)
    return cuda_gather._launch_bwd_runs(ct, idx, k, lib=lib)


def runs_before_after(built, sets, step_calls, out):
    """The runs path of each build that has one against the current
    source's, on the 720p real-scene steps' runs-path calls: every call
    bit-equal to the current build's (as int32 words), then the builds
    timed in turns on the first corner, texel and edge-AA calls."""
    import chip_smoke

    kinds = {name: declare_runs(lib) for name, (lib, _) in built.items()}
    names = [name for name, kind in kinds.items() if kind is not None]
    ref = built["after"][0]
    differing = {name: 0 for name in names if name != "after"}
    for ct, idx, k in step_calls:
        want = runs_launch(ref, "current", ct, idx, k).view(torch.int32)
        for name in differing:
            got = runs_launch(built[name][0], kinds[name], ct, idx, k)
            differing[name] += int(not torch.equal(got.view(torch.int32),
                                                   want))
    torch.cuda.synchronize()
    for name, bad in differing.items():
        print(f"runs path, {name} against this source: {bad} of "
              f"{len(step_calls)} calls differ", flush=True)
        chip_smoke.check(bad == 0, f"runs path: {name} differs on {bad} "
                         "calls")
    out["runs_calls_compared"] = len(step_calls)
    out["runs_calls_differing"] = differing
    others = [name for name in names if name != "after"]
    before_after.time_in_turns(
        others, "after",
        lambda name: {f"runs {label}": ((lambda c=c: runs_launch(
            built[name][0], kinds[name], *c)), 1)
            for label, c in sets.items()}, out)


def launch(lib, ct, idx, k):
    """The shared-memory kernel of a build on (ct, idx, k), ct made
    contiguous as gather_rows_bwd makes it (a captured cotangent keeps
    its strides: the boundary term's are not contiguous)."""
    from sunray_tpu_torch.ops import cuda_gather

    ct = ct.contiguous()
    if is_legacy(lib):
        return legacy_launch(lib, ct, idx, k)
    return cuda_gather._launch_bwd(ct, idx, k, lib=lib)


def step_counts(funcs, legacy, c):
    """SASS instructions of one iteration of the step loop of the kernel
    that a (k, c) table takes: the new kernel's (c columns a pass, 16-byte
    loads) through no MATCH (no lane hands its sums on), the old one's
    (32 indices) through one row's butterflies (5 c SHFL.BFLY)."""
    if legacy:
        code = sass.find(funcs, "22gather_rows_bwd_kernelEPKf")
        return sass.loop_through(code, "MATCH", lambda ins: ins.op.startswith(
            "SHFL.BFLY"), 5 * c)[0]
    code = sass.find(funcs, f"22gather_rows_bwd_kernelILi{min(c, 16)}ELi4EE")
    return sass.loop_through(code, "LDG.E.128", lambda ins: ins.op.startswith(
        "MATCH"), 0)[0]


def warp_steps(legacy, total, k, c, sms):
    """Step-loop iterations of all warps: the new kernel's from its launch
    shape (BWD_STEP indices a step), the old one's (32 indices a step,
    LEGACY_BLOCKS_SM blocks an SM)."""
    from sunray_tpu_torch.ops import cuda_gather

    if legacy:
        blocks = sms * LEGACY_BLOCKS_SM
        chunk = -(-total // blocks)
        chunk = max(-(-chunk // LEGACY_THREADS) * LEGACY_THREADS, LEGACY_THREADS)
        steps = 0
        for b in range(-(-total // chunk)):
            size = min(chunk, total - b * chunk)
            steps += sum(-(-(size - 32 * w) // LEGACY_THREADS)
                         for w in range(LEGACY_THREADS // 32) if size > 32 * w)
        return steps
    shape = cuda_gather.bwd_launch_shape(total, k, c, sms)
    q = shape["blocks"] * shape["warps"]
    chunk = shape["warp_chunk"]
    return sum(-(-min(chunk, total - w * chunk) // cuda_gather.BWD_STEP)
               for w in range(q) if total > w * chunk)


def step_sets(dev):
    """K8's backward's calls in one 720p step with both visibility terms,
    and the sets timed: the step's first corner and first material call,
    each visibility call, and 3 x 2,073,600 random indices with
    out-of-range ones."""
    import chip_smoke
    from sunray_tpu_torch.render.pipeline import RenderState

    cfg, scene, leaves, mats = chip_smoke.diff_setup(dev, *chip_smoke.DIFF_SIZE,
                                                     **chip_smoke.VIS_KW)
    state = RenderState.create(cfg, dev)
    _, calls = chip_smoke.capture_bwd_calls(
        lambda: chip_smoke.diff_step(cfg, scene, leaves, mats, state))
    kinds = [chip_smoke.bwd_call_kind(c) for c in calls]
    sets = {"corners": calls[kinds.index("corners")],
            "materials": calls[kinds.index("materials")]}
    for i, c in enumerate(c for c, kind in zip(calls, kinds)
                          if kind == "visibility"):
        sets[f"visibility {i}"] = c
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    n = 1920 * 1080
    sets["random"] = (torch.randn((3, 6, n), generator=gen, device=dev),
                      torch.randint(-8, 80, (3, n), generator=gen, device=dev,
                                    dtype=torch.int32), 72)
    return calls, sets


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, nargs="*", default=[],
                    help="directories holding other gather.cu (none: the "
                         "runs path alone)")
    ap.add_argument("--profile", action="store_true",
                    help="also break each runs-path call into its device "
                         "launches (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k8_bwd_before_after: no CUDA device")
    card = before_after.card()
    dev = torch.device("cuda", 0)
    out = {"card": card}
    built = {}
    if args.before:
        built = before_and_after(args.before, dev, out)
    sets, step_calls = runs_sets(dev)
    if built:
        runs_before_after(built, sets, step_calls, out)
    out["runs"] = runs_path(dev, sets)
    out["run_stats"] = {label: run_stats(*c) for label, c in sets.items()}
    if args.profile:
        import chip_smoke

        out["profile"] = chip_smoke.runs_breakdown(sets)
    print(json.dumps(out), flush=True)


def runs_sets(dev):
    """The runs-path calls of one 720p differentiable step on the phase-10
    GLB, and of one with edge antialiasing: ({"corners", "texels",
    "edge AA"}: the first call of each kind, [every call above MAX_ROWS
    rows of both steps])."""
    import dataclasses

    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_gather
    from sunray_tpu_torch.render.pipeline import RenderState

    cuda_build.library()
    cfg, scene, leaves, mats, accel = chip_smoke.real_diff_setup(
        dev, chip_smoke.real_scene_path(), *chip_smoke.DIFF_SIZE,
        tracer="auto")
    aa_cfg = dataclasses.replace(cfg, edge_antialias=True)
    calls = []
    for c in (cfg, aa_cfg):
        _, got = chip_smoke.capture_bwd_calls(
            lambda c=c: chip_smoke.real_diff_step(
                c, scene, leaves, mats, RenderState.create(cfg, dev), accel))
        calls += [x for x in got if x[2] > cuda_gather.MAX_ROWS]
    texel_rows = int(torch.tensor(scene.textures.data.shape[:3]).prod())
    rows = {"corners": scene.positions.shape[0], "texels": texel_rows,
            "edge AA": scene.num_tris}
    sets = {label: next(c for c in calls if c[2] == k)
            for label, k in rows.items()}
    return sets, calls


def run_stats(ct, idx, k):
    """What the call's runs look like: its cotangent's strides, the rows
    present, runs of at most RUN_SHORT and longer, the positions in long
    runs, the longest run, and the 32-byte sectors a column's load of 32
    consecutive sorted positions touches."""
    from sunray_tpu_torch.ops import cuda_gather

    keys = idx.long().clamp(0, k - 1).reshape(-1)
    counts = torch.bincount(keys, minlength=k)
    counts = counts[counts > 0]
    long = counts > cuda_gather.RUN_SHORT
    # 32-byte sectors one column's load touches for 32 consecutive sorted
    # positions (a warp's load in a long run; 4 if they were consecutive
    # words, 32 if all apart).
    g, c, n = ct.shape
    _, perm = torch.sort(keys, stable=True)
    sg, _, sn = ct.stride()
    word = (perm // n) * sg + (perm % n) * sn
    word = word[:word.numel() // 32 * 32].reshape(-1, 32).sort(dim=1).values
    sectors = 1 + ((word[:, 1:] // 8) != (word[:, :-1] // 8)).sum(1)
    out = dict(shape=[list(idx.shape), k, ct.shape[1]],
               strides=list(ct.stride()), rows_present=int(counts.numel()),
               short_runs=int((~long).sum()), long_runs=int(long.sum()),
               long_positions=int(counts[long].sum()),
               longest=int(counts.max()) if counts.numel() else 0,
               sectors_a_32=float(sectors.double().mean())
               if sectors.numel() else 0.0)
    print(f"runs of {out['shape']}: {out}", flush=True)
    return out


def runs_path(dev, sets):
    """The runs path on the step's first corner, texel and edge-AA calls,
    held and timed."""
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_gather

    assert min(c[2] for c in sets.values()) > cuda_gather.MAX_ROWS
    chip_smoke.k8_bwd_hold(list(sets.items()))
    out = {}
    for label, c in sets.items():
        t = chip_smoke.runs_timing(label, c, dev)
        bound_ms, bound_by = t.pop("bound")
        out[label] = dict(t, bound_ms=bound_ms, bound_by=bound_by)
    return out


def before_and_after(before, dev, out):
    """The shared-memory kernel of each --before build and the current one
    on phase 9's step, held and timed in turns (the module docstring)."""
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_gather

    tags = before_after.tags_of(before, "k8_bwd_before_after")
    built = before_after.build(
        {**{tag: d / "gather.cu" for tag, d in zip(tags, before)},
         "after": REPO / "sunray_tpu_torch" / "csrc" / "gather.cu"}, OUT)
    libs = {name: load(lib) for name, (lib, _) in built.items()}
    sms, clock = before_after.sm_clock()
    calls, sets = step_sets(dev)
    kinds = [chip_smoke.bwd_call_kind(c) for c in calls]
    shapes = [(kind, tuple(c[1].shape), c[2], c[0].shape[1])
              for kind, c in zip(kinds, calls)]
    print(f"the step's calls: {shapes}", flush=True)
    out["step_calls"] = [list(x) for x in shapes]
    for name, lib in libs.items():
        legacy = is_legacy(lib)
        out[f"{name}_registers"] = {
            k: v for k, v in chip_smoke.ptxas_registers(
                "\n".join(built[name][1])).items()
            if k.startswith("gather_rows_bwd_kernel")
            and (legacy or k.endswith("ELi4EE"))}
        for label, (ct, idx, k) in [*((f"step call {i}", c)
                                      for i, c in enumerate(calls)),
                                    ("random", sets["random"])]:
            got = launch(lib, ct, idx, k)
            again = launch(lib, ct, idx, k)
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
        try:
            funcs = before_after.functions(OUT / f"{name}.so")
            for label, (ct, idx, k) in sets.items():
                c = ct.shape[1]
                count = step_counts(funcs, legacy, c)
                steps = warp_steps(legacy, idx.numel(), k, c, sms)
                out[f"{name}_{label}_sass_step"] = count
                out[f"{name}_{label}_floor_ms"] = sass.issue_floor_ms(
                    count * steps, sms, clock)
        except (OSError, ValueError, KeyError) as e:
            print(f"{name}: SASS not measured ({type(e).__name__}: {e})",
                  flush=True)
        floors = {k: v for k, v in out.items()
                  if k.startswith(name) and ("sass" in k or "floor" in k)}
        print(f"{name}: registers {out[f'{name}_registers']}; SASS a step "
              f"and floors: {floors}", flush=True)
    before_after.time_in_turns(
        tags, "after",
        lambda name: {label: ((lambda c=c: launch(libs[name], *c)), 1)
                      for label, c in sets.items()}, out)
    for label, (ct, idx, k) in sets.items():
        out[f"{label}_shape"] = [list(idx.shape), k, ct.shape[1]]
        out[f"{label}_bound_ms"] = chip_smoke.bound(
            chip_smoke.nbytes(ct, idx) + k * ct.shape[1] * 4, 0)[0]
    return built


if __name__ == "__main__":
    main()
