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
base_color, inst_transform and the atlas): its first vertex-corner call
(3 x 921,600 indices into 2,698 x 20) and its first texel call (5 x
921,600 into 8,388,608 x 4), each held against the float64 sums, beside
its bound, its plain version, index_add_, index_put_(accumulate=True)
and the stable sort inside it (chip_smoke.runs_timing). Without
--before the tool runs that part alone:

    python3 tools/k8_bwd_before_after.py
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


def launch(lib, ct, idx, k):
    from sunray_tpu_torch.ops import cuda_gather

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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k8_bwd_before_after: no CUDA device")
    card = before_after.card()
    dev = torch.device("cuda", 0)
    out = {"card": card}
    if args.before:
        before_and_after(args.before, dev, out)
    out["runs"] = runs_path(dev)
    print(json.dumps(out), flush=True)


def runs_path(dev):
    """The runs path on the first corner and texel calls of one 720p
    differentiable step on the phase-10 GLB, held and timed."""
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_gather
    from sunray_tpu_torch.render.pipeline import RenderState

    cuda_build.library()
    cfg, scene, leaves, mats, accel = chip_smoke.real_diff_setup(
        dev, chip_smoke.real_scene_path(), *chip_smoke.DIFF_SIZE,
        tracer="auto")
    _, calls = chip_smoke.capture_bwd_calls(lambda: chip_smoke.real_diff_step(
        cfg, scene, leaves, mats, RenderState.create(cfg, dev), accel))
    texel_rows = int(torch.tensor(scene.textures.data.shape[:3]).prod())
    sets = {"corners": next(c for c in calls
                            if c[2] == scene.positions.shape[0]),
            "texels": next(c for c in calls if c[2] == texel_rows)}
    del calls
    assert max(c[2] for c in sets.values()) > cuda_gather.MAX_ROWS
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


if __name__ == "__main__":
    main()
