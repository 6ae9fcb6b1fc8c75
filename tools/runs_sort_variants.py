"""The runs path's radix sort (csrc/gather.cu, sunray_gather_runs_sort)
against copies of its source with one change each, on one card, in turns.

    python3 tools/runs_sort_variants.py

Each variant is a text substitution of the current gather.cu (the tool
stops if one no longer applies), built alone with the port's flags into
build/runs_sort_variants/. Inputs, shaped like the 720p real-scene step's
runs-path calls and made from a seed: 5 x 921,600 texel ids into
8,388,608 rows (three in ten on 4 rows, the rest uniform), 3 x 921,600
corner ids into 2,698 rows and 921,600 triangle ids into 262,144. Each
variant's permutation is compared with torch.sort(stable=True)'s (a
variant may break it: it then only times), then the builds are timed in
turns (chip_smoke.device_ms, the sort alone). The last line is one JSON
object: {variant: {input: [ms a turn]}} and the card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import before_after  # noqa: E402

OUT = REPO / "build" / "runs_sort_variants"

_RANK_OR = """    if (d >= 0) atomicOr(&sh.lanes_of[warp][d], 1u << lane);
    __syncwarp();
    const unsigned peers = d >= 0 ? sh.lanes_of[warp][d] : 0u;"""
_PASS = "__global__ void __launch_bounds__(kSortThreads)\nsort_pass_kernel"
# name: [(text of gather.cu, its replacement)]
VARIANTS = {
    "current": [],
    # each key stored straight to its slot, no staging in shared memory
    "unstaged": [
        ("    sh.stage[0][slot] = key[i];\n    sh.stage[1][slot] = pos[i];",
         "    keys_out[offset[d] + warp_cnt[warp][d] + rank[i]] = key[i];\n"
         "    pos_out[offset[d] + warp_cnt[warp][d] + rank[i]] = pos[i];"),
        ("  for (int slot = tid; slot < live; slot += kSortThreads) {",
         "  for (int slot = tid; slot < 0; slot += kSortThreads) {")],
    # an item's lanes of one digit by __match_any_sync
    "match_any": [(_RANK_OR, """\
    const unsigned any = __match_any_sync(0xffffffffu, d);
    const unsigned peers = d >= 0 ? any : 0u;""")],
    "window_8": [("constexpr int kLookWindow = 4;",
                  "constexpr int kLookWindow = 8;")],
    "items_12": [("constexpr int kSortItems = 16;",
                  "constexpr int kSortItems = 12;")],
    # positions loaded at staging, not with the keys (64 registers)
    "late_positions": [
        ("      pos[i] = static_cast<int>(e);\n", ""),
        ("      pos[i] = live ? __ldg(pos_in + e) : 0;\n", ""),
        ("int key[kSortItems], pos[kSortItems], rank[kSortItems];",
         "int key[kSortItems], rank[kSortItems];"),
        ("    sh.stage[1][slot] = pos[i];",
         "    const int64_t e = seg + i * 32 + lane;\n"
         "    sh.stage[1][slot] = pos_in == nullptr ? static_cast<int>(e)"
         " : __ldg(pos_in + e);")],
    "4_blocks_an_sm": [(_PASS, _PASS.replace("(kSortThreads)",
                                             "(kSortThreads, 4)"))],
}


def inputs(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    n = 921_600

    def ids(shape, k):
        return torch.randint(0, k, shape, generator=g, device=dev,
                             dtype=torch.int32)

    tex = ids((5, n), 8_388_608)
    hot = torch.rand((5, n), generator=g, device=dev) < 0.3
    tex = torch.where(hot, ids((5, n), 4), tex)
    return {"texels": (tex, 8_388_608), "corners": (ids((3, n), 2698), 2698),
            "edge AA": (ids((1, n), 262_144), 262_144)}


def sort(lib, idx, k):
    """One build's sort of idx's ids below k: (keys, positions)."""
    from sunray_tpu_torch.ops import cuda_build, cuda_gather

    plan = cuda_gather.plan_code(cuda_gather.runs_digit_plan(k))
    total = idx.numel()
    words = ctypes.c_int64()
    cuda_build.check_launch("sort", lib.sunray_gather_runs_scratch(
        total, plan, k, 0, ctypes.byref(words)))
    scratch = torch.empty((words.value,), dtype=torch.int32,
                          device=idx.device)
    keys = torch.empty((total,), dtype=torch.int32, device=idx.device)
    pos = torch.empty_like(keys)
    cuda_build.check_launch("sort", lib.sunray_gather_runs_sort(
        idx.data_ptr(), total, k, plan, scratch.data_ptr(), keys.data_ptr(),
        pos.data_ptr(), cuda_build.stream_ptr()))
    return keys, pos


def main():
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        sys.exit("runs_sort_variants: no CUDA device")
    card = before_after.card()
    src = (REPO / "sunray_tpu_torch" / "csrc" / "gather.cu").read_text()
    specs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                sys.exit(f"runs_sort_variants: {name}: {old!r} not in "
                         "gather.cu")
            text = text.replace(old, new)
        path = OUT / name / "gather.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        specs[name] = path
    built = before_after.build(specs, OUT / "libs")
    libs = {name: cuda_build.declare(lib, ["sunray_gather_runs_scratch",
                                           "sunray_gather_runs_sort"])
            for name, (lib, _) in built.items()}
    dev = torch.device("cuda", 0)
    sets = inputs(dev)
    for name, lib in libs.items():
        for label, (idx, k) in sets.items():
            _, pos = sort(lib, idx, k)
            want = torch.sort(idx.reshape(-1).long(), stable=True).indices
            print(f"{name} {label}: torch.sort's permutation "
                  f"{torch.equal(pos.long(), want)}", flush=True)
    out = {}
    for turn in range(2):
        for name, lib in libs.items():
            for label, (idx, k) in sets.items():
                ms = chip_smoke.device_ms(lambda: sort(lib, idx, k))
                out.setdefault(name, {}).setdefault(label, []).append(ms)
                print(f"{name} {label} (turn {turn}): {ms:.4f} ms",
                      flush=True)
    print(json.dumps({"card": card, "sort_ms": out}), flush=True)


if __name__ == "__main__":
    main()
