"""PyTorch port, the Cornell frame's kernel switches: K9 (TAA clamp and
blend), K13 (the history gather) and K14 (Woop occlusion), each plain
version held to the JAX package on seeded numpy inputs, and the frame with
all four switches on (taa_kernel="pallas", history_select_kernel="auto",
history_joint_gather=True, trace_impl="woop") held to the JAX frame with
the same switches.

Tolerances. K9's plain version within 1e-6 of the JAX Pallas kernel in
interpret mode, and bit-equal to raw where there is no history. K13 and
the joint gather move words: bit-equal. woop_matrices is bit-equal to
jax.jit(woop_matrices) (degenerate triangles' zero rows up to the sign
of zero). The plain Woop test agrees with the JAX Pallas
kernel in interpret mode on at least 0.9995 of rays (the bar of
tests/test_intersect.py:160; the measured agreement is printed). The
frame: PSNR > 40 dB on each of 4 frames.

On the CPU the JAX frame takes Moller-Trumbore and plain gathers whatever
the switches say, because render/trace._use_pallas() and
restir._history_kernel_ok gate on a TPU backend. The decisive comparison
therefore patches sunray_tpu.render.trace._use_pallas to True, so that
the JAX frame traces through trace_closest_pallas and trace_occluded_woop
in interpret mode (no JAX file is edited). The kernels on the card are
held to these plain versions in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops import pallas_trace as jpt
from sunray_tpu.ops.pallas_image import taa_clamp_blend_tpu
from sunray_tpu.ops.pallas_window import build_table, pads, window_select_t
from sunray_tpu.render import postprocess as jpost
from sunray_tpu.render import restir as jr
from sunray_tpu.render import trace as jtrace
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_history, cuda_image, cuda_trace, intersect
from sunray_tpu_torch.ops import binned_trace
from sunray_tpu_torch.render import postprocess as ppost
from sunray_tpu_torch.render import restir as pr
from sunray_tpu_torch.render import trace as ptrace
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from test_torch_restir import _history, _on_wall, _temporal_case
from torch_parity import CAMERA, GOLDEN_KW, n, psnr, t, to_numpy

SWITCHES = dict(taa_kernel="pallas", history_select_kernel="auto",
                history_joint_gather=True, trace_impl="woop")
KW = dict(GOLDEN_KW, lighting="restir", **SWITCHES)
FRAMES = 4
PSNR_MIN = 40.0
WOOP_AGREE = 0.9995       # tests/test_intersect.py:160


# -- K9: TAA clamp and blend ---------------------------------------------------

def _taa_inputs(h, w, mask, seed):
    rng = np.random.default_rng(seed)
    raw = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    raw[h // 3:h // 2, w // 4:w // 2] *= 20.0       # a bright patch: gated taps
    hist = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    if mask == "edges":
        use = np.ones((h, w), bool)
        use[0], use[-1], use[:, 0], use[:, -1] = False, False, False, False
    elif mask == "random":
        use = rng.random((h, w)) > 0.3
    else:
        use = np.zeros((h, w), bool)
        use[1:-1, 1:-1] = True
        use = ~use                                    # only the border
    return raw, hist, use


@pytest.mark.parametrize("mask", ["edges", "random", "border_only"])
@pytest.mark.parametrize("size", [(48, 64), (37, 53)])
def test_taa_plain_matches_pallas_interpret(size, mask):
    """Sizes off the TPU kernel's 32-row and 128-lane blocks."""
    raw, hist, use = _taa_inputs(*size, mask, seed=size[0])
    want = taa_clamp_blend_tpu(jnp.asarray(raw), jnp.asarray(hist),
                               jnp.asarray(use, jnp.float32), 0.14)
    got = n(cuda_image.taa_clamp_blend(t(raw), t(hist), t(use), 0.14))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(got[~use].view(np.uint32),
                                  raw[~use].view(np.uint32))
    # The plain version itself: the same function (the CPU wrapper is it).
    np.testing.assert_array_equal(
        got, n(cuda_image.taa_clamp_blend_plain(t(raw), t(hist), t(use), 0.14)))


@pytest.mark.parametrize("select", [False, True])
def test_temporal_accumulate_kernel_switches(select):
    """temporal_accumulate(kernel="pallas", history_select_kernel=...)
    against the JAX function with kernel="pallas" (interpret mode)."""
    rng = np.random.default_rng(7)
    h, w = 40, 56
    raw = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    hist = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    motion = (rng.normal(size=(h, w, 2)) * 0.02).astype(np.float32)
    motion[:3] = 2.5
    want = jax.jit(lambda *a: jpost.temporal_accumulate(*a, kernel="pallas"))(
        jnp.asarray(raw), jnp.asarray(motion), jnp.asarray(hist), jnp.int32(5))
    got = ppost.temporal_accumulate(t(raw), t(motion), t(hist),
                                    torch.tensor(5, dtype=torch.int32),
                                    kernel="pallas", history_select_kernel=select)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)
    plain = ppost.temporal_accumulate(t(raw), t(motion), t(hist),
                                      torch.tensor(5, dtype=torch.int32))
    np.testing.assert_array_equal(n(got), n(plain))


# -- K13: the history gather ---------------------------------------------------

def test_window_select_matches_pallas_interpret():
    """tests/test_banded.py::TestWindowSelectKernel's sizes: bit-equal on
    the selected in-range lanes."""
    w, h, c = 128, 300, 5
    p = w * h
    rng = np.random.default_rng(1)
    tbl = np.random.default_rng(0).normal(size=(c, p)).astype(np.float32)
    padded = build_table([jnp.asarray(tbl)], p)
    taps = [0, -1, -w, -w - 1]
    g = 3 * w + 2
    key = rng.integers(-1, len(taps), size=p).astype(np.int32)
    want = np.asarray(window_select_t(padded, jnp.asarray(key), jnp.int32(g),
                                      taps, p))[:c]
    got = n(cuda_history.window_select(t(np.asarray(padded)), t(key), g, taps,
                                       pad_l=pads(p)[0]))[:c]
    src = np.arange(p) + g + np.array(taps + [0])[key]
    sel = (key >= 0) & (src >= 0) & (src < p)
    assert sel.mean() > 0.7
    np.testing.assert_array_equal(got[:, sel].view(np.uint32),
                                  want[:, sel].view(np.uint32))
    np.testing.assert_array_equal(got[:, sel], tbl[:, src[sel]])


def test_history_gather_moves_words():
    """int32 ids, NaN payloads and subnormal bit patterns come back as
    they went in; (P,) and (P, k) fields; indices clamp."""
    rng = np.random.default_rng(3)
    p, m = 500, 777
    f1 = rng.normal(size=(p, 3)).astype(np.float32)
    f1[::7, 1] = np.float32(1e-40)                   # subnormal
    ids = rng.integers(-2**31, 2**31 - 1, size=p, dtype=np.int64).astype(np.int32)
    f2 = ids.view(np.float32).copy()                 # NaN and subnormal patterns
    idx = rng.integers(-3, p + 3, size=m)
    got = cuda_history.history_gather([t(f1), t(ids), t(f2)], t(idx))
    src = np.clip(idx, 0, p - 1)
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.float32]
    np.testing.assert_array_equal(n(got[0]).view(np.uint32), f1[src].view(np.uint32))
    np.testing.assert_array_equal(n(got[1]), ids[src])
    np.testing.assert_array_equal(n(got[2]).view(np.uint32), f2[src].view(np.uint32))


def test_gather_temporal_histories_matches_jax():
    """The joint DI+GI read: the same seed out, bit-equal fields (w_sum
    zeroed) and base_ok."""
    c = _temporal_case(seed=40)
    p = c["w"] * c["h"]
    h_di = _on_wall(_history("di", p, 41), c, 42)
    h_gi = _on_wall(_history("gi", p, 43), c, 44)
    h_gi["sample_tri"][::5] = -1

    def jrun(sd, hd, hg):
        return jr.gather_temporal_histories(
            JConfig(history_joint_gather=True), sd, hd, hg, c["prev_uv"],
            c["prev_valid"], jnp.int32(3), jnp.asarray(c["enable"]), c["w"],
            c["h"])

    js, jd, jg, jok = jax.jit(jrun)(c["seed"], jr.ReservoirDI(**h_di),
                                    jr.ReservoirGI(**h_gi))
    for switch in ("auto", "off"):
        cfg = RenderConfig(history_joint_gather=True,
                           history_select_kernel=switch)
        ps, pd, pg, pok = pr.gather_temporal_histories(
            cfg, t(c["seed"].astype(np.int64)),
            pr.ReservoirDI(**{k: t(v) for k, v in h_di.items()}),
            pr.ReservoirGI(**{k: t(v) for k, v in h_gi.items()}),
            t(c["prev_uv"]), t(c["prev_valid"]),
            torch.tensor(3, dtype=torch.int32), c["w"], c["h"])
        np.testing.assert_array_equal(n(ps), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(n(pok), np.asarray(jok))
        assert 0.3 < n(pok).mean() < 1.0
        for mine, want in ((pd, jd), (pg, jg)):
            for f in dataclasses.fields(mine):
                a, b = n(getattr(mine, f.name)), np.asarray(getattr(want, f.name))
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32), err_msg=f.name)
        assert not n(pd.w_sum).any() and not n(pg.w_sum).any()


def test_history_kernel_gate():
    assert pr.history_kernel_ok(RenderConfig(history_select_kernel="auto"))
    assert not pr.history_kernel_ok(RenderConfig())
    assert not pr.history_kernel_ok(RenderConfig(history_select_kernel="auto",
                                                 differentiable=True))


# -- K14: Woop occlusion ------------------------------------------------------

def _random_tris(nt, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(nt, 3)).astype(np.float32)
    tris = (v0, (v0 + rng.normal(size=(nt, 3)) * 0.5).astype(np.float32),
            (v0 + rng.normal(size=(nt, 3)) * 0.5).astype(np.float32))
    tris[2][::17] = tris[0][::17]                   # degenerate: eps = inf
    return tris


def test_woop_matrices_bit_equal_to_jax():
    tris = _random_tris(300, 0)
    ja, jeps = jax.jit(jpt.woop_matrices)(tuple(jnp.asarray(x) for x in tris))
    a, eps = intersect.woop_matrices(tuple(t(x) for x in tris))
    assert a.shape == (6, 300, 8) and eps.shape == (300, 1)
    # Bit-equal, but for the sign of zero in the all-zero rows of the
    # degenerate triangles (eps = inf: never hit).
    live = np.isfinite(n(eps)[:, 0])
    assert live.sum() == 300 - len(range(0, 300, 17))
    np.testing.assert_array_equal(n(a)[:, live].view(np.uint32),
                                  np.asarray(ja)[:, live].view(np.uint32))
    np.testing.assert_array_equal(n(a), np.asarray(ja))
    np.testing.assert_array_equal(n(eps), np.asarray(jeps))


def _woop_case(name):
    rng = np.random.default_rng(5)
    if name == "cornell":
        jscene = jcornell_box()
        tris = tuple(np.asarray(x) for x in jscene.world_triangle_vertices())
        k = 8192
        o = rng.uniform(0.05, 1.95, size=(k, 3)).astype(np.float32)
        ex = rng.integers(-1, tris[0].shape[0], size=k).astype(np.int32)
    else:
        tris = _random_tris(200, 6)
        k = 6000
        o = (rng.normal(size=(k, 3)) * 3).astype(np.float32)
        ex = rng.integers(-1, 200, size=k).astype(np.int32)
    dn = rng.normal(size=(k, 3))
    d = (dn / np.linalg.norm(dn, axis=-1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.1, 5.0, size=k).astype(np.float32)
    return tris, o, d, tmax, ex


@pytest.mark.parametrize("use_exclude", [False, True])
@pytest.mark.parametrize("case", ["cornell", "random"])
def test_woop_occluded_matches_pallas_interpret(case, use_exclude):
    tris, o, d, tmax, ex = _woop_case(case)
    ex = ex if use_exclude else None
    want = np.asarray(jpt.trace_occluded_woop(
        tuple(jnp.asarray(x) for x in tris), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), exclude=None if ex is None else jnp.asarray(ex)))
    woop = intersect.woop_matrices(tuple(t(x) for x in tris))
    got = n(cuda_trace.trace_occluded_woop(woop, t(o), t(d), t(tmax),
                                           exclude=None if ex is None else t(ex)))
    agree = (got == want).mean()
    print(f"woop {case} exclude={use_exclude}: agreement {agree:.6f} on "
          f"{got.size} rays, occluded {want.mean():.3f}")
    assert 0.05 < want.mean() < 0.95
    assert agree >= WOOP_AGREE
    # Against the port's Moller-Trumbore: the same predicate up to rounding.
    mt = n(intersect.trace_occluded_brute(tuple(t(x) for x in tris), t(o), t(d),
                                          t(tmax), exclude=None if ex is None
                                          else t(ex)))
    assert (got == mt).mean() >= WOOP_AGREE


def _cornell_scene():
    return convert.scene_from_numpy(to_numpy(jcornell_box()), device="cpu")


def test_make_tracer_builds_woop_once():
    scene = _cornell_scene()
    ctx = ptrace.make_tracer(scene, RenderConfig(trace_impl="woop"))
    assert ctx.woop is not None and ctx.woop[0].shape == (6, 36, 8)
    assert ptrace.make_tracer(scene, RenderConfig()).woop is None
    _, o, d, tmax, ex = _woop_case("cornell")
    got = ptrace.trace_occluded(ctx, t(o), t(d), t(tmax), exclude=t(ex))
    want = cuda_trace.trace_occluded_woop(ctx.woop, t(o), t(d),
                                          t(tmax) - 1e-3, exclude=t(ex))
    np.testing.assert_array_equal(n(got), n(want) & (tmax - 1e-3 > 1e-3))


def test_make_tracer_cluster_set_ignores_woop():
    """With a ClusterSet accel the binned tracer serves every query and
    trace_impl="woop" is ignored, as the JAX make_tracer returns before its
    Woop check (trace.py:79-92)."""
    scene = _cornell_scene()
    tris = scene.world_triangle_vertices()
    accel = binned_trace.build_cluster_set(tris, k=8)
    ctx = ptrace.make_tracer(scene, RenderConfig(trace_impl="woop"), accel)
    assert ctx.binned is not None and ctx.woop is None
    _, o, d, tmax, ex = _woop_case("cornell")
    got = ptrace.trace_occluded(ctx, t(o), t(d), t(tmax), exclude=t(ex))
    mt = ptrace.trace_occluded(ptrace.make_tracer(scene, RenderConfig()),
                               t(o), t(d), t(tmax), exclude=t(ex))
    assert (n(got) == n(mt)).mean() >= WOOP_AGREE


# -- the slice: the Cornell frame with the four switches ------------------------

def _port_frames(cfg, frames=FRAMES):
    from sunray_tpu_torch.ops import cuda_trace as ct

    scene = _cornell_scene()
    mats = _port_mats(cfg)
    state = RenderState.create(cfg, device="cpu")
    out = []
    for _ in range(frames):
        before = sum(ct.rays.values())
        state, ldr, aux = render_frame(scene, cfg, state, mats)
        out.append((n(ldr), aux, sum(ct.rays.values()) - before))
    return out


def _port_mats(cfg):
    jmats = jcamera_matrices(JCamera(**CAMERA), cfg.width, cfg.height)
    return convert.mats_from_numpy({k: np.asarray(v) for k, v in jmats.items()},
                                   device="cpu")


@pytest.fixture(scope="module")
def frames():
    """Four frames of the JAX package with the switches, with
    _use_pallas patched (woop, K1 and K9 in interpret mode) and as the CPU
    runs it (Moller-Trumbore); the port's frames with the switches, and
    with history_select_kernel="off"."""
    jcfg = JConfig(**KW)
    jscene = jcornell_box()
    jmats = jcamera_matrices(JCamera(**CAMERA), jcfg.width, jcfg.height)
    out = {}
    for name, patched in (("jax", True), ("jax_mt", False)):
        with pytest.MonkeyPatch.context() as mp:
            if patched:
                mp.setattr(jtrace, "_use_pallas", lambda: True)
            step = jax.jit(lambda st: jrender_frame(jscene, jcfg, st, jmats))
            jstate = JState.create(jcfg)
            out[name] = []
            for _ in range(FRAMES):
                jstate, jldr, _ = step(jstate)
                out[name].append(np.asarray(jldr))
    cfg = RenderConfig(**KW)
    out["cfg"] = cfg
    out["port"] = _port_frames(cfg)
    out["port_off"] = _port_frames(dataclasses.replace(
        cfg, history_select_kernel="off"))
    return out


def test_switches_frame_matches_jax(frames):
    for i, (jl, (pl, _, _)) in enumerate(zip(frames["jax"], frames["port"])):
        assert pl.shape == jl.shape == (64, 96, 3)
        assert np.isfinite(pl).all()
        p = psnr(pl, jl)
        print(f"frame {i}: PSNR vs the JAX frame (woop, K1, K9 interpret) "
              f"{p:.2f} dB")
        assert p > PSNR_MIN, f"frame {i}: PSNR vs JAX = {p:.2f} dB"


def test_switches_frame_vs_jax_mt_reported(frames):
    """The unpatched JAX frame traces occlusion with Moller-Trumbore: the
    PSNR is printed, not asserted (woop against MT)."""
    for i, (jl, (pl, _, _)) in enumerate(zip(frames["jax_mt"], frames["port"])):
        assert np.isfinite(jl).all() and np.isfinite(pl).all()
        print(f"frame {i}: PSNR vs the JAX frame on the CPU path (MT) "
              f"{psnr(pl, jl):.2f} dB")


def test_history_select_off_is_bit_equal(frames):
    """K13 only moves words: the frame with history_select_kernel="off"
    is the same frame."""
    for (a, _, _), (b, _, _) in zip(frames["port"], frames["port_off"]):
        np.testing.assert_array_equal(a, b)


def test_switches_rays_per_frame_as_bench_counts(frames):
    """bench.py:7-13: P * (ris_rounds + 3 + final_rounds - 1 + 2 + T_gi)."""
    cfg = frames["cfg"]
    p = cfg.width * cfg.height
    for _, aux, rays in frames["port"]:
        assert rays == p * (aux["ris_rounds"] + 3 + aux["final_rounds"] - 1
                            + 2 + cfg.gi_spatial_samples)


def test_switches_dispatch(monkeypatch):
    """The frame with the switches calls each switch's wrapper: the K9,
    K13 and K14 wrappers (plain versions on the CPU), and not K2's."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, call)

    spy(cuda_image, "taa_clamp_blend")
    spy(cuda_history, "history_gather")
    spy(cuda_trace, "trace_occluded_woop")
    spy(cuda_trace, "trace_occluded")
    cfg = RenderConfig(**dict(KW, width=24, height=16))
    _port_frames(cfg, frames=2)
    assert calls.get("taa_clamp_blend") == 2
    # Per frame: the joint DI+GI read and the TAA corners.
    assert calls.get("history_gather") == 4
    assert calls.get("trace_occluded_woop", 0) >= 2
    assert "trace_occluded" not in calls
