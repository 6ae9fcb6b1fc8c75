"""PyTorch port, the utilities (sunray_tpu_torch/utils/checkpoint.py,
provenance.py, profiling.py, roofline.py) against the JAX package's
(sunray_tpu/utils/) and the port's own dispatch:

  - checkpoint: a resumed frame bit-equal to the uninterrupted one; an
    npz written by JAX's save_state loads into the port with equal values
    and the other way round; a shape mismatch raises ValueError;
    AsyncCheckpointManager keeps max_to_keep files;
  - exec_paths: for each configuration, the routes it names are the ones
    a frame on the CPU takes through the wrappers (spied), read for a
    CUDA backend (a kernel wrapper launches on CUDA tensors) and for the
    CPU (it takes the plain version);
  - stage_timings' keys and its prefix differences, unclamped;
    render_prefix as the frame; summarize_trace and device_busy on a CPU
    profiler trace, on a written CUDA trace (device events only), and a
    CUDA trace without device events refused;
  - roofline bytes stage by stage equal to sunray_tpu.utils.roofline's,
    and the floors at 3,350 GB/s."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.utils import checkpoint as jckpt
from sunray_tpu.utils import roofline as jroof
from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render import pipeline
from sunray_tpu_torch.render.pipeline import (
    RenderState,
    render_frame,
    render_prefix,
)
from sunray_tpu_torch.scene import cornell_box
from sunray_tpu_torch.utils import checkpoint, profiling, provenance, roofline
from torch_parity import CAMERA, n, to_numpy

SMALL = dict(width=16, height=12, bounces=2, virtual_bounces=2,
             ris_candidates=4, di_spatial_samples=2, gi_spatial_samples=1,
             denoise_passes=1)


def setup(**kw):
    cfg = RenderConfig(**{**SMALL, **kw})
    scene = cornell_box(device="cpu")
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                           device="cpu")
    return cfg, scene, mats


def leaves(state):
    """numpy leaves of a (nested) dict from to_numpy, in field order."""
    if isinstance(state, dict):
        return [x for v in state.values() for x in leaves(v)]
    return [state]


def port_leaves(state):
    return [n(x) for x in checkpoint._leaves(state)]


def random_jax_state(cfg, seed):
    """A JAX RenderState with seeded values in every field."""
    g = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return jnp.asarray(g.integers(-5, 1000, x.shape, dtype=np.int32))
        return jnp.asarray(g.standard_normal(x.shape).astype(np.float32))
    import jax
    return jax.tree_util.tree_map(fill, JState.create(cfg))


# -- checkpoint -------------------------------------------------------------

def test_resume_bit_equal(tmp_path):
    cfg, scene, mats = setup()
    state = RenderState.create(cfg, device="cpu")
    for _ in range(2):
        state, _, _ = render_frame(scene, cfg, state, mats)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(state, path)
    loaded = checkpoint.load_state(path, RenderState.create(cfg, device="cpu"))
    for a, b in zip(port_leaves(state), port_leaves(loaded)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    s1, ldr1, _ = render_frame(scene, cfg, state, mats)
    s2, ldr2, _ = render_frame(scene, cfg, loaded, mats)
    np.testing.assert_array_equal(n(ldr1), n(ldr2))
    for a, b in zip(port_leaves(s1), port_leaves(s2)):
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_loads_into_port(tmp_path):
    jcfg = JConfig(**SMALL)
    jstate = random_jax_state(jcfg, 1)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(jstate, path)
    cfg = RenderConfig(**SMALL)
    state = checkpoint.load_state(path, RenderState.create(cfg, device="cpu"))
    want = leaves(to_numpy(jstate))
    got = port_leaves(state)
    assert len(got) == len(want) == 20
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_loads_into_jax(tmp_path):
    jcfg = JConfig(**SMALL)
    jstate = random_jax_state(jcfg, 2)
    from sunray_tpu_torch import convert
    state = convert.state_from_numpy(to_numpy(jstate), device="cpu")
    path = str(tmp_path / "port.npz")
    checkpoint.save_state(state, path)
    back = jckpt.load_state(path, JState.create(jcfg))
    for a, b in zip(leaves(to_numpy(back)), port_leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_shape_mismatch_raises(tmp_path):
    cfg = RenderConfig(**SMALL)
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(RenderState.create(cfg, device="cpu"), path)
    other = dataclasses.replace(cfg, width=cfg.width + 1)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(path, RenderState.create(other, device="cpu"))


def test_async_manager_keeps_max_to_keep(tmp_path):
    cfg = RenderConfig(**SMALL)
    mgr = checkpoint.AsyncCheckpointManager(str(tmp_path / "ck"),
                                            max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(RenderState.create(cfg, device="cpu"))
    for step in (0, 5, 10, 15):
        st = RenderState.create(cfg, device="cpu")
        st.accum.fill_(float(step))
        st.frame_count.fill_(step)
        mgr.save(step, st)
        st.accum.fill_(-1.0)     # the save holds its own snapshot
    mgr.wait()
    files = sorted(os.listdir(tmp_path / "ck"))
    assert files == ["state_000000000010.npz", "state_000000000015.npz"]
    assert mgr.latest_step() == 15
    got = mgr.restore(RenderState.create(cfg, device="cpu"))
    assert int(got.frame_count) == 15 and float(got.accum.max()) == 15.0
    got = mgr.restore(RenderState.create(cfg, device="cpu"), step=10)
    assert int(got.frame_count) == 10
    mgr.close()


# -- provenance -------------------------------------------------------------

PROVENANCE_CASES = {
    "default": {},
    "differentiable": dict(differentiable=True, enable_taa=False,
                           denoise_passes=0),
    "switches": dict(taa_kernel="pallas", history_select_kernel="auto",
                     history_joint_gather=True),
    "taa_auto_denoise_jnp": dict(taa_kernel="auto", denoise_kernel="jnp"),
    "perpixel_bf16": dict(spatial_taps="perpixel", shading_dtype="bf16"),
    "nee_no_post": dict(lighting="nee", enable_taa=False, denoise_passes=0),
    "diff_history_auto": dict(differentiable=True,
                              history_select_kernel="auto"),
}


def spied_routes(monkeypatch, cfg, scene, mats):
    """Render two frames on the CPU with the wrappers of K3-K7, K9 and K13
    spied; returns {stage: True (kernel wrapper called) / False (plain
    only) / None (not run)} as a CUDA frame would route them."""
    from sunray_tpu_torch.ops import cuda_history, cuda_restir

    seen = {}

    def spy(mod, name, stage, kernel=True):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            seen[stage] = seen.get(stage, False) or kernel
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for stage in ("ris_audition", "di_temporal", "di_spatial", "gi_spatial"):
        spy(cuda_restir, stage, stage)
        spy(cuda_restir, f"{stage}_plain", stage, kernel=False)
    # Per-pixel DI taps: plain merges from the centre's (pathtrace.py).
    spy(cuda_restir, "di_centre_merge", "di_spatial", kernel=False)
    spy(cuda_history, "history_gather", "history")
    spy(cuda_history, "history_gather_plain", "history", kernel=False)
    taa, den = pipeline.temporal_accumulate, pipeline.atrous_denoise

    def taa_spy(*a, kernel="jnp", history_select_kernel=False, **k):
        seen["taa"] = kernel in ("pallas", "auto")
        seen["history"] = seen.get("history", False) or history_select_kernel
        return taa(*a, kernel=kernel,
                   history_select_kernel=history_select_kernel, **k)

    def den_spy(*a, kernel="auto", **k):
        seen["denoise"] = kernel != "jnp"
        return den(*a, kernel=kernel, **k)
    monkeypatch.setattr(pipeline, "temporal_accumulate", taa_spy)
    monkeypatch.setattr(pipeline, "atrous_denoise", den_spy)
    state = RenderState.create(cfg, device="cpu")
    for _ in range(2):
        state, _, _ = render_frame(scene, cfg, state, mats)
    return seen


@pytest.mark.parametrize("case", sorted(PROVENANCE_CASES))
def test_exec_paths_mirror_dispatch(monkeypatch, case):
    cfg, scene, mats = setup(**PROVENANCE_CASES[case])
    seen = spied_routes(monkeypatch, cfg, scene, mats)
    cuda = provenance.exec_paths(cfg, scene.num_lights)
    cpu = provenance.exec_paths(cfg, scene.num_lights, backend="cpu")
    assert cuda["backend"] == "cuda" and cpu["backend"] == "cpu"
    for stage in ("ris_audition", "di_temporal", "di_spatial", "gi_spatial",
                  "denoise", "taa", "history"):
        want = {None: "off", True: "cuda", False: "plain"}[seen.get(stage)]
        assert cuda[stage] == want, (stage, seen)
        assert cpu[stage] == ("plain" if want == "cuda" else want), stage
    assert cuda["tracer"] == cfg.tracer
    assert cuda["differentiable"] == cfg.differentiable
    assert cuda["num_lights"] == scene.num_lights


def test_exec_paths_keys_are_jax():
    from sunray_tpu.utils.provenance import exec_paths as jexec_paths

    want = jexec_paths(JConfig(), 1, backend="cpu")
    got = provenance.exec_paths(RenderConfig(), 1)
    assert list(got) == list(want)
    assert got["ris_fetch"] == "shared"
    assert provenance.exec_paths(RenderConfig(), 1000)["ris_fetch"] == "global"


# -- profiling --------------------------------------------------------------

def test_stage_timings_keys():
    cfg, scene, mats = setup()
    state = RenderState.create(cfg, device="cpu")
    t = profiling.stage_timings(scene, cfg, state, mats, repeats=1)
    assert list(t) == ["ris_pass", "final_pass", "post_pipeline",
                       "frame_total"]
    assert t["ris_pass"] > 0.0 and t["frame_total"] > 0.0
    # Differences of the prefixes, reported as measured (not clamped).
    parts = t["ris_pass"] + t["final_pass"] + t["post_pipeline"]
    assert abs(parts - t["frame_total"]) <= 1e-9 * t["frame_total"]


def test_render_prefix_is_the_frame():
    cfg, scene, mats = setup()
    state = RenderState.create(cfg, device="cpu")
    _, ldr, _ = render_frame(scene, cfg, state, mats)
    _, ldr2, _ = render_prefix(scene, cfg, state, mats,
                               last="post_pipeline")
    assert torch.equal(ldr, ldr2)
    for last in ("ris_pass", "final_pass"):
        assert render_prefix(scene, cfg, state, mats, last=last) is None
    with pytest.raises(ValueError, match="not one of"):
        render_prefix(scene, cfg, state, mats, last="taa")


def test_summarize_cpu_trace(tmp_path):
    cfg, scene, mats = setup()
    state = RenderState.create(cfg, device="cpu")
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        render_frame(scene, cfg, state, mats)
    rows = profiling.summarize_trace(log_dir, top=5, steady_frac=1.0)
    assert rows and set(rows[0]) == {"name", "total_ms", "count", "pct"}
    assert abs(sum(r["pct"] for r in rows) - 100.0) < 1e-6
    assert rows == sorted(rows, key=lambda r: -r["total_ms"])
    # Top-level operators only: the frame's named stages are annotations,
    # and no operator is counted inside another.
    assert not any(r["name"] in ("ris_pass", "final_pass") for r in rows)
    busy = profiling.device_busy(log_dir)
    assert busy["device"] == "cpu" and busy["categories"] == ["cpu_op"]
    assert 0.0 <= busy["idle_share"] < 1.0
    assert busy["busy_ms"] <= busy["span_ms"] + 1e-9
    total = sum(r["total_ms"] for r in
                profiling.summarize_trace(log_dir, top=0, steady_frac=1.0))
    assert abs(total - busy["busy_ms"]) < 1e-6 * max(total, 1.0)


def test_summarize_trace_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path))


def _write_trace(tmp_path, events, device_properties):
    log_dir = tmp_path / "trace"
    log_dir.mkdir()
    (log_dir / "trace_1.json").write_text(json.dumps(
        {"deviceProperties": device_properties, "traceEvents": events}))
    return str(log_dir)


CPU_OP = {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
          "dur": 50.0, "pid": 1, "tid": 1}
H100 = [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}]


def test_cuda_trace_counts_device_events_only(tmp_path):
    events = [CPU_OP,
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0,
               "dur": 20.0, "pid": 0, "tid": 7},
              {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 40.0,
               "dur": 10.0, "pid": 0, "tid": 8},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 60.0,
               "dur": 20.0, "pid": 0, "tid": 7}]
    log_dir = _write_trace(tmp_path, events, H100)
    rows = profiling.summarize_trace(log_dir, top=0, steady_frac=1.0)
    assert [(r["name"], r["count"]) for r in rows] == [("k1", 2),
                                                        ("copy", 1)]
    busy = profiling.device_busy(log_dir)
    assert busy["device"] == "cuda"
    assert busy["categories"] == ["gpu_memcpy", "kernel"]
    assert busy["busy_ms"] == pytest.approx(0.05)
    assert busy["span_ms"] == pytest.approx(0.07)


def test_cuda_trace_without_device_events_raises(tmp_path):
    """A trace recorded with the card's activity whose device events were
    lost is refused, not read from its CPU operators."""
    log_dir = _write_trace(tmp_path, [CPU_OP], H100)
    with pytest.raises(ValueError, match="no device events"):
        profiling.summarize_trace(log_dir)
    with pytest.raises(ValueError, match="no device events"):
        profiling.device_busy(log_dir)


# -- roofline ---------------------------------------------------------------

ROOFLINE_CASES = [
    {},
    dict(width=1920, height=1080),
    dict(width=1280, height=720, enable_taa=False, denoise_passes=0),
    dict(width=640, height=480, history_gather_band=0, di_spatial_samples=3,
         gi_spatial_samples=2, denoise_passes=2),
    dict(width=333, height=217, history_gather_band=8, history_gather_halo=4),
]


@pytest.mark.parametrize("kw", ROOFLINE_CASES,
                         ids=[str(i) for i in range(len(ROOFLINE_CASES))])
@pytest.mark.parametrize("rounds", [(2, 2), (3, 5), (1, 1)])
def test_roofline_bytes_equal_jax(kw, rounds):
    want = jroof.frame_traffic_lower_bound(JConfig(**kw), *rounds)
    got = roofline.frame_traffic_lower_bound(RenderConfig(**kw), *rounds)
    assert [(s.name, s.bytes, s.note) for s in got] == \
        [(s.name, s.bytes, s.note) for s in want]
    total = sum(s.bytes for s in got)
    assert roofline.total_floor_ms(got) == pytest.approx(
        total / 3.35e12 * 1e3, rel=1e-12)
    for s in got:
        assert s.floor_ms() == pytest.approx(s.bytes / 3.35e12 * 1e3,
                                             rel=1e-12)


def test_roofline_report():
    cfg = RenderConfig(width=1920, height=1080)
    rep = roofline.roofline_report(cfg, measured_ms=10.0)
    jrep = jroof.roofline_report(JConfig(width=1920, height=1080),
                                 measured_ms=10.0)
    assert list(rep) == list(jrep)
    assert rep["hbm_peak_gbps"] == roofline.H100_HBM_GBPS == 3350.0
    assert rep["total_mbytes"] == jrep["total_mbytes"]
    assert [s["mbytes"] for s in rep["stages"]] == \
        [s["mbytes"] for s in jrep["stages"]]
    assert rep["floor_fraction"] == round(rep["floor_ms"] / 10.0, 3)
    assert not hasattr(roofline, "V5E_HBM_GBPS")
