"""What the before/after tools share: each builds one CUDA source of the
port alone, with the port's flags, beside other versions of it, and times
the builds on one card in turns, so that a drift of the card's clocks
over the run falls on both sides.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def tags_of(dirs: list[Path], tool: str) -> list[str]:
    """The names of the other versions' builds: their directories' names,
    each its own and none "after" (the current source's)."""
    tags = [d.name for d in dirs]
    if len(set(tags)) != len(tags) or "after" in tags:
        sys.exit(f"{tool}: give each --before directory its own name, not "
                 "'after'")
    return tags


def card() -> str:
    """The card's name and power limit (nvidia-smi), printed."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    return line


def sm_clock() -> tuple[int, float]:
    """(SMs, top SM clock in MHz) of card 0, for issue floors."""
    import torch

    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, clock


def functions(so: Path) -> dict:
    """sass.functions of a build's shared library (cuobjdump -sass)."""
    from sunray_tpu_torch.ops import cuda_build
    from tools import sass

    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    return sass.functions(sass.disassemble(so, str(cuobjdump)))


def build(specs: dict[str, Path], out_dir: Path) -> dict:
    """specs: {name: source} -> {name: (library, ptxas register and spill
    lines)}: one nvcc per source, all started together, each into
    out_dir/<name>.so. The caller declares the entry points it calls."""
    from sunray_tpu_torch.ops import cuda_build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
         str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in specs.items()}
    out = {}
    for name, proc in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc exited {proc.returncode}:\n{text}")
        report = [ln.strip() for ln in text.splitlines()
                  if "Compiling entry" in ln or "registers" in ln
                  or "spill" in ln]
        for ln in report:
            print(f"  ptxas {name}: {ln}", flush=True)
        out[name] = (ctypes.CDLL(str(out_dir / f"{name}.so")), report)
    return out


def time_in_turns(others, current, timers, out, events=True):
    """Time the builds in turns: `others` in order, `current` twice, then
    `others` in reverse. timers(name) -> {key: (fn, units)}; each fn() is
    timed as chip_smoke.py times kernels (device_ms) and, with `events`, by
    CUDA events around one call (time_ms), both divided by `units` (e.g.
    the passes a call makes). Appends each turn's times to the lists
    out[f"{name}_{key}_device_ms"] and out[f"{name}_{key}_events_ms"]."""
    import chip_smoke

    for turn, name in enumerate([*others, current, current, *others[::-1]]):
        for key, (fn, units) in timers(name).items():
            label = f"{name}_{key}"
            dev = chip_smoke.device_ms(fn) / units
            out.setdefault(f"{label}_device_ms", []).append(dev)
            line = f"{label} (turn {turn}): device {dev:.4f} ms"
            if events:
                ev = chip_smoke.time_ms(fn) / units
                out.setdefault(f"{label}_events_ms", []).append(ev)
                line += f", events around one call {ev:.4f} ms"
            print(line + (f" (a call / {units})" if units != 1 else ""),
                  flush=True)
