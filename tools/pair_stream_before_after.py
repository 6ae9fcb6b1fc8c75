"""K11 and K12 (csrc/binned.cu) against another version of that source, on
one card, with the same inputs, the same host path and the same clocks.

    python3 tools/pair_stream_before_after.py --before path/to/other/binned.cu [...]

Each source is built alone (nvcc, the port's flags) into
build/pair_stream_before_after/ and called through one copy of the
cluster_scan and pair_round wrappers' host code, so the builds differ in
their kernels only; each source's own declaration of sunray_pair_closest
says whether its K12 takes the ClusterSet's walk boxes, and so writes
only the live pair positions after its wrapper has filled the misses. Inputs are the
ones chip_smoke.py holds K11 and K12 to: frame 2's GI bounce rays (K11,
K12 closest) and GI-tap visibility rays with their exclude ids (K12
any-hit) of the 1080p big-mesh frame. Each build's outputs are held to the
plain versions (K11 bit-exact; K12 at every live pair position: differing
lanes are counted, and the current source must have none); then the
builds are timed in turns (the others in order, the current source twice,
the others in reverse order) as chip_smoke.py times kernels (device_ms),
K12 also on the same launch with every lane dead and on its blocks that
hold a pair alone (the full launch less this is what the dead tail
costs). Each build is named by its file's stem, the current source
"after". The last line is one JSON object of those times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after  # noqa: E402


def declare(lib, src: Path):
    """(library, whether its K12 takes walk boxes), its K11 and K12 entry
    points declared as the source declares them."""
    decl = re.search(r"int sunray_pair_closest\(([^)]*)\)", src.read_text())
    boxes = "const float* box" in decl.group(1)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sunray_cluster_scan.argtypes = [p, p, p, p, i, p, i, p, p, p]
    pairs = [p, p, p, i, i, p, p, p, p, p, i, p] + ([p] if boxes else []) + [i, i]
    lib.sunray_pair_closest.argtypes = pairs + [p, p, p, p, p]
    lib.sunray_pair_occluded.argtypes = pairs + [p, p]
    for f in (lib.sunray_cluster_scan, lib.sunray_pair_closest,
              lib.sunray_pair_occluded):
        f.restype = i
    return lib, boxes


def scan(lib, o_t, d_t, tn, tx, box):
    """ops/cuda_binned.cluster_scan's host code, on `lib`."""
    from sunray_tpu_torch.ops import cuda_binned as cb
    from sunray_tpu_torch.ops import cuda_build

    nl = tn.shape[0]
    slots = torch.empty((cb.L_SLOTS, nl), dtype=torch.int32, device=tn.device)
    cnt = torch.empty((nl,), dtype=torch.int32, device=tn.device)
    err = lib.sunray_cluster_scan(o_t.data_ptr(), d_t.data_ptr(), tn.data_ptr(),
                                  tx.data_ptr(), nl, box.data_ptr(), box.shape[0],
                                  slots.data_ptr(), cnt.data_ptr(),
                                  cuda_build.stream_ptr())
    cuda_build.check_launch("cluster_scan", err)
    return slots, cnt


def pairs(lib, boxes, args, closest):
    """ops/cuda_binned.pair_round's host code, on `lib`."""
    from sunray_tpu_torch.ops import cuda_binned as cb
    from sunray_tpu_torch.ops import cuda_build

    cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc = args
    n_p, nl = cid_s.shape[0], tn.shape[0]
    size = cb.L_SLOTS * nl          # every pair position, whatever lanes run
    c, k = cs.edges.shape[0], cs.edges.shape[2]
    head = [cid_s.data_ptr(), pos_s.data_ptr(), runs.data_ptr(), n_p, n_sc,
            o_t.data_ptr(), d_t.data_ptr(), tn.data_ptr(), tx.data_ptr(),
            ex.data_ptr(), nl, cs.edges.data_ptr()]
    head += ([cs.walk_box.data_ptr()] if boxes else []) + [c, k]
    stream = cuda_build.stream_ptr()

    def new(fill, **kw):
        """An output plane: a kernel that takes the walk boxes writes live
        pair positions only, its wrapper the misses; the older one writes
        every position."""
        return (torch.full((size,), fill, device=tn.device, **kw) if boxes
                else torch.empty((size,), device=tn.device, **kw))

    if closest:
        out = (new(torch.inf), new(-1, dtype=torch.int32), new(0.0), new(0.0))
        err = lib.sunray_pair_closest(*head, *(x.data_ptr() for x in out), stream)
    else:
        out = new(False, dtype=torch.bool)
        err = lib.sunray_pair_occluded(*head, out.data_ptr(), stream)
    cuda_build.check_launch("pair_round", err)
    return out


def differing_live_lanes(got, want, args, closest):
    """Live pair positions whose outputs differ in any bit."""
    cid_s, pos_s, n_sc = args[0], args[1], args[9]
    live = pos_s[cid_s < n_sc].long()
    if not closest:
        return int((got[live] != want[live]).sum())
    bad = torch.zeros_like(live, dtype=torch.bool)
    for a, b in zip(got, want):
        bad |= a[live].view(torch.int32) != b[live].view(torch.int32)
    return int(bad.sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path, nargs="+",
                    help="the other binned.cu sources to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pair_stream_before_after: no CUDA device")
    import chip_smoke
    from sunray_tpu_torch.ops import binned_trace as bt
    from sunray_tpu_torch.ops import cuda_binned as cb
    from sunray_tpu_torch.ops.intersect import T_MAX, T_MIN

    card = before_after.card()
    dev = torch.device("cuda", 0)
    srcs = {src.stem: src for src in args.before}
    chip_smoke.check("after" not in srcs and len(srcs) == len(args.before),
                     "--before sources need distinct stems other than 'after'")
    srcs["after"] = REPO / "sunray_tpu_torch" / "csrc" / "binned.cu"
    libs = {name: declare(lib, srcs[name]) for name, (lib, _) in
            before_after.build(srcs, REPO / "build" / "pair_stream_before_after"
                               ).items()}
    cs, _, (go, gd), (vo, vd, vmax, vex) = chip_smoke.capture_binned_rays(dev)
    seg = torch.as_tensor(vmax, dtype=torch.float32, device=dev) - 1e-3
    box = bt.supercluster_boxes(cs)
    launches = {}
    for label, (o, d, tmax, ex), closest in (
            ("bounce", (go, gd, T_MAX, None), True),
            ("visibility", (vo, vd, seg, vex), False)):
        o_t, d_t, tn, tx, ex, _, _ = bt._prep(o, d, T_MIN, tmax, ex)
        cid_s, pos_s, runs, n_sc, _ = bt._pair_stream_prep(cs, o_t, d_t, tn, tx)
        pair_args = (cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc)
        dead = (torch.full_like(cid_s, n_sc), pos_s, torch.zeros_like(runs),
                *pair_args[3:])
        lanes = int((runs > 0).sum()) * cb.BLOCK_RAYS
        live = (cid_s[:lanes], pos_s[:lanes], runs[runs > 0], *pair_args[3:])
        launches[label] = ((o_t, d_t, tn, tx, box), pair_args, dead, live, closest)
        print(f"{label}: {o_t.shape[1]} rays x {box.shape[0]} superclusters; "
              f"{cid_s.numel()} pair lanes, {int((cid_s < n_sc).sum())} live",
              flush=True)

    out = {"card": card}
    for name, (lib, boxes) in libs.items():
        for label, (scan_in, pair_args, _, _, closest) in launches.items():
            got = scan(lib, *scan_in)
            want = cb.cluster_scan_plain(*scan_in)
            exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            differ = differing_live_lanes(
                pairs(lib, boxes, pair_args, closest),
                cb.pair_round_plain(*pair_args, closest=closest), pair_args,
                closest)
            print(f"{name} {label}: K11 bit-exact {exact}; K12 differs from "
                  f"plain on {differ} live pair lanes", flush=True)
            out[f"{name}_{label}_k11_exact"] = exact
            out[f"{name}_{label}_k12_differing_lanes"] = differ
            chip_smoke.check(exact or name != "after",
                             f"{label}: K11 differs from its plain version")
            chip_smoke.check(differ == 0 or name != "after",
                             f"{label}: K12 differs from its plain version")

    def timers(name):
        lib, boxes = libs[name]
        fns = {}
        for label, (scan_in, pair_args, dead, live, closest) in launches.items():
            fns.update({
                f"{label}_k11": ((lambda s=scan_in: scan(lib, *s)), 1),
                f"{label}_k12": ((lambda a=pair_args, c=closest:
                                  pairs(lib, boxes, a, c)), 1),
                f"{label}_k12_dead": ((lambda a=dead, c=closest:
                                       pairs(lib, boxes, a, c)), 1),
                f"{label}_k12_live_blocks": ((lambda a=live, c=closest:
                                              pairs(lib, boxes, a, c)), 1)})
        return fns

    before_after.time_in_turns([name for name in libs if name != "after"],
                               "after", timers, out, events=False)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
