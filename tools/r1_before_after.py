"""R1 (csrc/overlay.cu, the 2D overlay painter) against the first version
of its source, on one card, with the same inputs and the same clocks.

    mkdir -p build/r1_before
    git show 2be567b:sunray_tpu_torch/csrc/overlay.cu > build/r1_before/overlay.cu
    python3 tools/r1_before_after.py --before build/r1_before/overlay.cu \
        [--variant path/to/other.cu ...] [--parent build/parent]

The --before source has the first version's entry point
(sunray_paint_meshes(img, out, h, w, tris, meta, clip, pool, n_meshes,
stream): every pixel tests every triangle). Both sources are built alone
(nvcc, the port's flags, -Xptxas=-v: registers and shared memory printed)
into build/r1_before_after/ and given the same packed inputs
(ops/cuda_overlay.pack_meshes; the first version reads its triangle
records, metadata, clip rects and texels). Inputs are chip_smoke.py
phase 14's: the 1080p HUD of hud_overlay and the 2,000-triangle stress
set. Each --variant (a source with the current entry point, e.g. one
constant changed) is built and held beside them. Each build is held
bit-equal to the plain twin on both; then the builds are timed in turns
(before, variants, after, after, variants reversed, before) as chip_smoke.py
times kernels (device_ms), beside each input's bound
(chip_smoke.r1_needed_ops), and the current build on variants that show
where its time goes (`probe`). With --parent (a checkout of the parent
commit, e.g. `git archive 2be567b | tar -x -C build/parent`), the wall of
a hud_overlay and a paint_meshes call on the HUD, host work included,
there and here, each tree in processes of its own in turns. The last
line is one JSON object of those times.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after  # noqa: E402

# The first version's entry point: no boxes, union boxes or uncovered words.
_P, _I = ctypes.c_void_p, ctypes.c_int
BEFORE_ARGS = [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P]


def paint(name, lib, img, packed):
    """One launch of `lib`'s R1 on the packed inputs."""
    from sunray_tpu_torch.ops import cuda_build, cuda_overlay

    if name != "before":
        return cuda_overlay._launch_paint(img, packed, lib=lib)
    h, w = img.shape[:2]
    out = torch.empty_like(img)
    p = packed
    err = lib.sunray_paint_meshes(
        img.data_ptr(), out.data_ptr(), h, w, p.tris.data_ptr(),
        p.meta.data_ptr(), p.clip.data_ptr(), p.pool.data_ptr(),
        p.meta.shape[0], cuda_build.stream_ptr())
    cuda_build.check_launch("paint_meshes (before)", err)
    return out


def probe(lib, inputs, out):
    """Where the current build's time goes, on variants of the inputs (times
    only; the variants' images are not checked): "pass", the launch with no
    mesh (the image read and written); "hud_off", the HUD's meshes moved off
    the image (every tile adds every mesh's uncovered words); "stress_no_thin",
    the stress set with its thin triangles' boxes emptied (those that reach
    every tile); and a clone of the image (one PyTorch copy of the same
    bytes)."""
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_overlay

    img, hud = inputs["hud"]
    _, stress = inputs["stress"]
    h, w = img.shape[:2]
    none = hud._replace(meta=hud.meta[:0])
    off = hud._replace(ubox=torch.tensor([[w, h, -1, -1]], dtype=torch.int32,
                                         device=img.device).repeat(
                                             hud.meta.shape[0], 1))
    b = stress.boxes
    thin = (b == torch.tensor([0, 0, w - 1, h - 1], dtype=b.dtype,
                              device=b.device)).all(1)
    no_thin = stress._replace(boxes=torch.where(
        thin[:, None], torch.tensor([w, h, -1, -1], dtype=b.dtype,
                                    device=b.device), b).contiguous())
    out["stress_thin_triangles"] = int(thin.sum())
    variants = {"pass": (img, none), "hud_off": (img, off),
                "stress_no_thin": (img, no_thin)}
    for label, (i, p) in variants.items():
        ms = chip_smoke.device_ms(
            lambda i=i, p=p: cuda_overlay._launch_paint(i, p, lib=lib))
        out[f"after_{label}_device_ms"] = ms
        print(f"after {label}: device {ms:.4f} ms", flush=True)
    out["clone_device_ms"] = chip_smoke.device_ms(lambda: img.clone())
    print(f"clone of the image: device {out['clone_device_ms']:.4f} ms "
          f"({out['stress_thin_triangles']} thin triangles in the stress set)",
          flush=True)


def wall_ms(root):
    """The wall of a call of `root`'s port on the 1080p HUD, host work
    included: chip_smoke.r1_host_ms (hud_overlay; paint_meshes on the
    meshes as hud_meshes builds them on the host) and the parts of those
    calls, hud_meshes (the tessellation) and pack_meshes. Run in a process
    of its own per tree (--wall-of)."""
    import chip_smoke        # this tree's (it imports no port module)

    sys.path.insert(0, str(root))
    sys.path.insert(1, str(REPO / "tests"))
    from sunray_tpu_torch.ops import cuda_build, cuda_overlay
    from sunray_tpu_torch.render import overlay2d
    from torch_overlay_cases import HUD_LINES, frame_times

    chip_smoke.check(Path(overlay2d.__file__).is_relative_to(root),
                     f"--wall-of {root}: imported {overlay2d.__file__}")
    dev = torch.device("cuda", 0)
    cuda_build.library()
    out = chip_smoke.r1_host_ms(dev)
    ms = frame_times(120, 14)
    meshes = overlay2d.hud_meshes(HUD_LINES, frame_ms=ms, scale=2.0)
    # The first version packs with (meshes, device), this one with (meshes,
    # h, w, device).
    pack_args = ((meshes, dev) if len(inspect.signature(
        cuda_overlay.pack_meshes).parameters) == 2 else (meshes, 1080, 1920, dev))
    out["hud_meshes"] = chip_smoke.wall_ms_a_call(
        lambda: overlay2d.hud_meshes(HUD_LINES, frame_ms=ms, scale=2.0))
    out["pack_meshes"] = chip_smoke.wall_ms_a_call(
        lambda: cuda_overlay.pack_meshes(*pack_args))
    print(json.dumps(out), flush=True)


def wall_in_turns(parent, out):
    """wall_ms of the parent checkout and of this tree, each in a fresh
    process, in turns (parent, this, this, parent)."""
    for turn, (name, root) in enumerate([("parent", parent), ("after", REPO),
                                         ("after", REPO), ("parent", parent)]):
        line = subprocess.run(
            [sys.executable, __file__, "--wall-of", str(root)], check=True,
            capture_output=True, text=True, timeout=900).stdout.splitlines()[-1]
        for call, ms in json.loads(line).items():
            out.setdefault(f"{name}_{call}_wall_ms", []).append(ms)
            print(f"{name} {call} (turn {turn}): wall {ms:.4f} ms a call",
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path,
                    help="the first version's overlay.cu to build and time")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="another overlay.cu with the current entry point, "
                    "held to the plain twin and timed in the same turns "
                    "(its name is its file's stem)")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of the parent commit: time the wall of "
                    "a hud_overlay / paint_meshes call there and here")
    ap.add_argument("--wall-of", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("r1_before_after: no CUDA device")
    if args.wall_of is not None:
        return wall_ms(args.wall_of.resolve())
    if args.before is None:
        sys.exit("r1_before_after: give --before")
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build, cuda_overlay
    from sunray_tpu_torch.render.overlay2d import paint_meshes_plain

    card = before_after.card()
    dev = torch.device("cuda", 0)
    variants = {v.stem: v for v in args.variant}
    before_after.tags_of([Path("before"), *map(Path, variants)],
                         "r1_before_after")
    built = before_after.build(
        {"before": args.before, **variants,
         "after": REPO / "sunray_tpu_torch" / "csrc" / "overlay.cu"},
        REPO / "build" / "r1_before_after")
    libs = {}
    for name, (lib, _) in built.items():
        if name != "before":
            cuda_build.declare(lib, ["sunray_paint_meshes"])
        else:
            lib.sunray_paint_meshes.argtypes = BEFORE_ARGS
            lib.sunray_paint_meshes.restype = ctypes.c_int
        libs[name] = lib
    out = {"card": card, "ptxas": {k: v[1] for k, v in built.items()}}
    inputs = {}
    for label, (img, meshes) in chip_smoke.r1_sets(dev).items():
        h, w = img.shape[:2]
        packed = cuda_overlay.pack_meshes(meshes, h, w, dev)
        want = paint_meshes_plain(img, meshes)
        for name, lib in libs.items():
            got = paint(name, lib, img, packed)
            torch.cuda.synchronize()
            diff = chip_smoke.r1_words_differ(got, want)
            chip_smoke.check(diff == 0, f"{name} {label}: {diff} words differ "
                             "from the plain twin")
            print(f"{name} {label}: bit-equal to the plain twin", flush=True)
        ops = chip_smoke.r1_needed_ops(meshes, h, w)
        b = chip_smoke.bound(2 * chip_smoke.nbytes(img)
                             + chip_smoke.nbytes(*packed), ops)
        out[f"{label}_bound_ms"], out[f"{label}_bound_by"] = b
        print(f"{label}: {len(meshes)} meshes, {int(packed.tris.shape[0])} "
              f"triangles, {w}x{h}; bound {b[0]:.4f} ms ({b[1]})", flush=True)
        inputs[label] = (img, packed)
    before_after.time_in_turns(
        ["before", *variants], "after",
        lambda name: {label: ((lambda i=i, p=p: paint(name, libs[name], i, p)),
                              1) for label, (i, p) in inputs.items()},
        out, events=False)
    probe(libs["after"], inputs, out)
    if args.parent is not None:
        wall_in_turns(args.parent.resolve(), out)
    for label in inputs:
        old = statistics.median(out[f"before_{label}_device_ms"])
        new = statistics.median(out[f"after_{label}_device_ms"])
        out[f"{label}_speedup"] = old / new
        out[f"{label}_share_of_bound"] = out[f"{label}_bound_ms"] / new
        print(f"{label}: before {old:.4f} ms, after {new:.4f} ms: "
              f"{old / new:.1f}x; after at {100 * out[f'{label}_share_of_bound']:.1f}% "
              "of its bound", flush=True)
        for v in variants:
            ms = statistics.median(out[f"{v}_{label}_device_ms"])
            print(f"{label}: {v} {ms:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
