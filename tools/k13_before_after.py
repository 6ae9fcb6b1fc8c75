"""K13 (csrc/history.cu) against another version of its source, on one card,
with the same inputs, the same host path and the same clocks.

    python3 tools/k13_before_after.py --before path/to/other/history.cu

Both sources are built alone (nvcc, the port's flags) into
build/k13_before_after/ and called through one copy of history_gather's
host code, so the two differ in their kernel only. Inputs are the ones
chip_smoke.py holds K13 to: the joint DI+GI history read (15 fields, 29
words a lane) and the TAA corners (8,294,400 lanes x 3 words) of frame 3
of the 1080p Cornell frame with the kernel switches. Each build's outputs
are held bit-equal to history_gather_plain; then each read is timed as
chip_smoke.py times kernels (device_ms) and by CUDA events around one
call (time_ms), with index_select on the packed (P, 29) table beside
them. The last line is one JSON object of those times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def build(src: Path, name: str) -> ctypes.CDLL:
    from sunray_tpu_torch.ops import cuda_build

    out_dir = REPO / "build" / "k13_before_after"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{name}.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared",
                    "-o", str(out), str(src)], check=True, capture_output=True,
                   text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sunray_history_gather.argtypes = [p, p, p, i, p, i64, i64, p]
    lib.sunray_history_gather.restype = i
    return lib


def gather(lib, fields, idx):
    """ops/cuda_history.history_gather's host code, on `lib`."""
    from sunray_tpu_torch.ops import cuda_build

    m, k = idx.shape[0], len(fields)
    outs = [torch.empty((m, *f.shape[1:]), dtype=f.dtype, device=idx.device)
            for f in fields]
    srcs = (ctypes.c_void_p * k)(*(f.data_ptr() for f in fields))
    dsts = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    widths = (ctypes.c_int * k)(*(1 if f.dim() == 1 else f.shape[1]
                                  for f in fields))
    err = lib.sunray_history_gather(srcs, dsts, widths, k, idx.data_ptr(), m,
                                    fields[0].shape[0], cuda_build.stream_ptr())
    cuda_build.check_launch("history_gather", err)
    return outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", required=True, type=Path,
                    help="the other history.cu to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k13_before_after: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from sunray_tpu_torch.ops import cuda_history

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    libs = {"before": build(args.before, "before"),
            "after": build(REPO / "sunray_tpu_torch" / "csrc" / "history.cu",
                           "after")}
    calls = chip_smoke.capture_switch_inputs(dev)["history_gather"]
    (fields, idx), _ = calls[0]
    (table, corners), _ = calls[1]
    words = sum(f[0].numel() for f in fields)
    packed = torch.cat([f.view(torch.float32).reshape(f.shape[0], -1)
                        for f in fields], dim=1).contiguous()
    reads = {"joint": (fields, idx), "corners": (table, corners)}
    print(f"joint read: {idx.shape[0]} lanes x {words} words in {len(fields)} "
          f"fields; TAA corners: {corners.shape[0]} lanes x 3 words", flush=True)
    out = {"card": smi.splitlines()[0], "words": words, "fields": len(fields)}
    for name, lib in libs.items():
        for read, (fs, ix) in reads.items():
            got = gather(lib, fs, ix)
            want = cuda_history.history_gather_plain(fs, ix)
            torch.cuda.synchronize()
            chip_smoke.check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                 for a, b in zip(got, want)),
                             f"{name} {read}: not bit-equal to the plain version")
            key = f"{name}_{read}"
            out[f"{key}_device_ms"] = chip_smoke.device_ms(lambda: gather(lib, fs, ix))
            out[f"{key}_events_ms"] = chip_smoke.time_ms(lambda: gather(lib, fs, ix))
            print(f"{key}: bit-equal; device {out[f'{key}_device_ms']:.4f} ms, "
                  f"events around one call {out[f'{key}_events_ms']:.4f} ms",
                  flush=True)
    out["index_select_device_ms"] = chip_smoke.device_ms(
        lambda: packed.index_select(0, idx))
    out["index_select_events_ms"] = chip_smoke.time_ms(
        lambda: packed.index_select(0, idx))
    out["joint_bound_ms"] = chip_smoke.bound(
        chip_smoke.nbytes(idx) + 2 * idx.shape[0] * words * 4, 0)[0]
    print(f"index_select on the packed table: device "
          f"{out['index_select_device_ms']:.4f} ms, events "
          f"{out['index_select_events_ms']:.4f} ms; joint read bound "
          f"{out['joint_bound_ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
