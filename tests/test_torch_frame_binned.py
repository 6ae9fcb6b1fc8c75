"""PyTorch port, the big-mesh frame: render_frame with a binned ClusterSet
accel against the JAX render_frame(..., accel=build_cluster_set(...)), its
Pallas kernels in interpret mode.

The scene is tests/torch_big_scene.py at subdiv=3 (1,316 triangles, the
mirror sphere on the short box) with cluster_k=32 (42 clusters, 11
superclusters); the golden settings of tests/test_golden.py:36-40 other
than the size, lighting="restir", 48x32, three frames. Held: PSNR > 40 dB
on ldr on every frame (the bar of test_golden.py:80), the G-buffer within
1e-4, the walk rounds and bench.py's ray count exactly, and the binned
frame against the port's own brute-force frame > 40 dB. The JAX side
takes ~45 s on an 8-core CPU, most of it compiling the interpret-mode
kernels.
"""

import jax
import numpy as np
import pytest

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops import binned_trace as jbt
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu.scene.types import MaterialTable as JMaterialTable
from sunray_tpu.scene.types import build_scene as jbuild_scene
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import binned_trace, cuda_binned, cuda_trace
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.render.trace import make_tracer
from torch_big_scene import big_scene_args
from torch_parity import CAMERA, GOLDEN_KW, n, psnr, to_numpy

KW = dict(GOLDEN_KW, lighting="restir", width=48, height=32, cluster_k=32)
FRAMES = 3
PSNR_MIN = 40.0
KERNELS = ("binned_round", "cluster_scan", "pair_round")


@pytest.fixture(scope="module")
def frames(request):
    args = big_scene_args(3)
    jscene = jbuild_scene(**dict(args, materials=JMaterialTable.build(
        args["materials"])))
    jcfg = JConfig(**KW)
    jmats = jcamera_matrices(JCamera(**CAMERA), jcfg.width, jcfg.height)
    jaccel = jbt.build_cluster_set(
        tuple(np.asarray(v) for v in jscene.world_triangle_vertices()),
        k=jcfg.cluster_k)
    step = jax.jit(lambda st, acc: jrender_frame(jscene, jcfg, st, jmats, acc))

    cfg = RenderConfig(**KW)
    scene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    mats = convert.mats_from_numpy({k: np.asarray(v) for k, v in jmats.items()},
                                   device="cpu")
    accel = binned_trace.build_cluster_set(scene.world_triangle_vertices(),
                                           k=cfg.cluster_k)
    calls = {name: 0 for name in KERNELS}
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    for name in KERNELS:
        def counted(*a, _fn=getattr(cuda_binned, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        mp.setattr(cuda_binned, name, counted)

    out = dict(jax=[], port=[], rays=[], calls=calls, scene=scene, cfg=cfg,
               mats=mats, accel=accel, jaccel=jaccel)
    jstate = JState.create(jcfg)
    state = RenderState.create(cfg, device="cpu")
    for _ in range(FRAMES):
        jstate, jldr, jaux = step(jstate, jaccel)
        before = sum(cuda_trace.rays.values())
        state, ldr, aux = render_frame(scene, cfg, state, mats, accel)
        out["rays"].append(sum(cuda_trace.rays.values()) - before)
        out["jax"].append((np.asarray(jldr), {k: np.asarray(v)
                                              for k, v in jaux.items()}))
        out["port"].append((n(ldr), aux))
    return out


def test_scene_and_accel(frames):
    scene, accel = frames["scene"], frames["accel"]
    assert scene.num_tris == 1316
    assert accel.num_clusters == 42
    np.testing.assert_array_equal(n(accel.tri_ids),
                                  np.asarray(frames["jaccel"].tri_ids))
    ctx = make_tracer(scene, RenderConfig(**dict(KW, tracer="brute")), accel)
    assert ctx.binned is not None   # an accel serves every query


def test_frame_matches_jax(frames):
    for i, ((jl, _), (pl, _)) in enumerate(zip(frames["jax"], frames["port"])):
        assert pl.shape == jl.shape == (32, 48, 3)
        assert np.isfinite(pl).all()
        p = psnr(pl, jl)
        assert p > PSNR_MIN, f"frame {i}: PSNR vs JAX = {p:.2f} dB"


def test_gbuffer_and_rounds_match_jax(frames):
    for (_, ja), (_, pa) in zip(frames["jax"], frames["port"]):
        for k in ("depth", "normal", "diffuse", "motion"):
            np.testing.assert_allclose(n(pa[k]), ja[k], atol=1e-4, err_msg=k)
        assert pa["ris_rounds"] == int(ja["ris_rounds"]) > 1    # the mirror
        assert pa["final_rounds"] == int(ja["final_rounds"])


def test_frame_runs_the_binned_kernels(frames):
    """Every query went through the binned tracer: the block path (K10,
    also the overflow fallback) and the pair stream (K11, K12)."""
    for name, count in frames["calls"].items():
        assert count > 0, name


def test_rays_per_frame_as_bench_counts(frames):
    """bench.py:7-13: P * (ris_rounds + 3 + final_rounds - 1 + 2 + T_gi)."""
    cfg = frames["cfg"]
    p = cfg.width * cfg.height
    for rays, (_, aux) in zip(frames["rays"], frames["port"]):
        assert rays == p * (aux["ris_rounds"] + 3 + aux["final_rounds"] - 1
                            + 2 + cfg.gi_spatial_samples)


def test_binned_frame_matches_brute_frame(frames):
    """The same frame through the brute-force tracer (no accel)."""
    cfg = RenderConfig(**dict(KW, tracer="brute"))
    state = RenderState.create(cfg, device="cpu")
    for _ in range(FRAMES):
        state, ldr, _ = render_frame(frames["scene"], cfg, state, frames["mats"])
    p = psnr(n(ldr), frames["port"][-1][0])
    assert p > PSNR_MIN, f"binned vs brute: {p:.2f} dB"
