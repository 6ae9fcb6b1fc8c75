"""Observability: per-stage timing and device profiler traces — port of
sunray_tpu/utils/profiling.py.

  - stage_timings(): a wall-clock breakdown of one frame by running
    growing prefixes of render_frame (render/pipeline.render_prefix), as
    the JAX package measures it; each prefix ends with
    torch.cuda.synchronize() on the card;
  - device_trace(): a torch.profiler Chrome trace of the block it wraps;
  - summarize_trace(): that trace's device kernels as a per-kernel cost
    table, and device_busy(): its device's busy and idle time; a trace
    recorded with the card's activity is read from its device events
    only (raising where there are none), a CPU trace from its top-level
    operators.

The JAX module's dump_hlo, hlo_source_map, attribute_rows and the
SUNRAY_TPU_DUMP_DIR dump read XLA's compiled HLO; eager PyTorch compiles
no program, so they have no counterpart here. The frame's stages run
under torch.profiler ranges named as the JAX named scopes
(render/pipeline.py), which a trace shows as user annotations.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import torch

# Chrome-trace categories of work that ran on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_timings(scene, cfg, state, mats, accel=None, repeats: int = 3):
    """Wall-clock per-stage breakdown of one frame, by timing growing
    prefixes of render_frame (render/pipeline.render_prefix: the frame's
    own code, cut after a stage) and taking differences, the JAX package's
    method. Each prefix is run once untimed, then `repeats` times. Returns
    {stage: seconds}: ris_pass, final_pass (with edge antialiasing),
    post_pipeline (TAA, denoise and tonemap) and frame_total. A difference
    is reported as measured: a stage shorter than the prefixes' spread can
    come out negative."""
    from sunray_tpu_torch.render.pipeline import FRAME_STAGES, render_prefix

    device = scene.positions.device

    def timed(last):
        with torch.no_grad():
            render_prefix(scene, cfg, state, mats, accel, last=last)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(repeats):
                render_prefix(scene, cfg, state, mats, accel, last=last)
            _sync(device)
        return (time.perf_counter() - t0) / repeats

    t_ris, t_final, t_post = (timed(last) for last in FRAME_STAGES)
    return {
        "ris_pass": t_ris,
        "final_pass": t_final - t_ris,
        "post_pipeline": t_post - t_final,
        "frame_total": t_post,
    }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the block (the CPU, and the card when there
    is one), written as a Chrome trace `trace_<ns>.json` under log_dir
    (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def _load_trace(log_dir):
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace *.json under {log_dir}")
    with open(paths[-1]) as f:
        return json.load(f)


def _top_level(ops):
    """The events of `ops` that no other event of theirs on the same
    thread contains (a CPU trace's operators nest)."""
    out = []
    for key in {(e.get("pid"), e.get("tid")) for e in ops}:
        end = -1.0
        lane = [e for e in ops if (e.get("pid"), e.get("tid")) == key]
        for e in sorted(lane, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def _device_events(log_dir, steady_frac):
    """The newest trace's device events in its steady tail (`steady_frac`
    of its span, from the end). A trace recorded with the card's activity
    (it lists deviceProperties, or holds a device event) is a "cuda" trace
    and gives the card's complete events (kernels, copies and memsets);
    one without device events raises: the profiler lost the card's
    activity, and its CPU operators are not the card's time. A CPU run's
    trace is a "cpu" trace and gives its top-level CPU operators. Returns
    (events, cut, end, device), times in microseconds."""
    trace = _load_trace(log_dir)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("dur")]
    dev_xs = [e for e in events if e.get("cat") in DEVICE_CATS]
    device = "cuda" if trace.get("deviceProperties") or dev_xs else "cpu"
    if device == "cuda":
        xs = dev_xs
        if not xs:
            raise ValueError(
                f"the CUDA trace under {log_dir} holds no device events "
                f"({', '.join(DEVICE_CATS)}): the card's activity was lost")
    else:
        xs = _top_level([e for e in events if e.get("cat") == "cpu_op"])
        if not xs:
            raise ValueError(f"the trace under {log_dir} holds no CPU "
                             "operators")
    t0 = min(e["ts"] for e in xs)
    t1 = max(e["ts"] + e["dur"] for e in xs)
    cut = t1 - (t1 - t0) * steady_frac
    return [e for e in xs if e["ts"] >= cut], cut, t1, device


def summarize_trace(log_dir: str, top: int = 25, steady_frac: float = 0.5):
    """Parse the newest trace under a device_trace() log dir into a
    per-kernel cost table. Groups the device's complete events by name
    (as _device_events reads them), keeping only the steady tail of
    the trace (`steady_frac` of its span: skips warm-up work at the
    front). Returns a list of {"name", "total_ms", "count", "pct"} sorted
    by total time desc; prints the top `top` rows."""
    xs, _, _, _ = _device_events(log_dir, steady_frac)
    agg: dict = {}
    for e in xs:
        tot, cnt = agg.get(e["name"], (0.0, 0))
        agg[e["name"]] = (tot + e["dur"], cnt + 1)
    total = sum(t for t, _ in agg.values())
    rows = [
        {"name": n, "total_ms": t / 1e3, "count": c,
         "pct": 100.0 * t / total}
        for n, (t, c) in agg.items()
    ]
    rows.sort(key=lambda r: -r["total_ms"])
    for r in rows[:top]:
        print(f"{r['total_ms']:9.3f} ms {r['pct']:5.1f}% x{r['count']:<5d} "
              f"{r['name'][:110]}")
    return rows


def device_busy(log_dir: str, steady_frac: float = 1.0) -> dict:
    """The device's busy time in the newest trace's steady tail: the union
    of its events' intervals. Returns {"span_ms", "busy_ms", "idle_share",
    "device", "categories"}: span runs from the tail's cut (or its first
    event) to its last event's end; device is the trace's ("cuda" or
    "cpu", as _device_events reads it) and categories the trace
    categories of the events counted."""
    xs, cut, end, device = _device_events(log_dir, steady_frac)
    busy, reach = 0.0, -float("inf")
    for e in sorted(xs, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], reach), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
        reach = max(reach, hi)
    start = max(cut, min(e["ts"] for e in xs))
    span = end - start
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span if span > 0 else 0.0,
            "device": device,
            "categories": sorted({e.get("cat") for e in xs})}
