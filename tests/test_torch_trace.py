"""PyTorch port, K1/K2: the plain brute-force trace against the JAX brute
tracer (as XLA compiles it on the CPU) and against the Pallas kernels in
interpret mode. The CUDA kernels are held to the plain version in
tests/test_torch_cuda.py.

Tolerance: hit / tri / occluded agree on >= 99.9% of rays, t/u/v within
1e-5 where tri agrees. Rays through the shared edge of two triangles can
flip with the last bit of a rounding, so agreement is not required to be
total (the plain version reproduces XLA's fused multiply-adds, and on an
FMA-capable CPU it agrees on every ray here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.camera import generate_rays as jgenerate_rays
from sunray_tpu.ops import intersect as jisect
from sunray_tpu.ops import pallas_trace
from sunray_tpu.render import trace as jtrace
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import config as pconfig
from sunray_tpu_torch import convert
from sunray_tpu_torch.ops import intersect as pisect
from sunray_tpu_torch.render import trace as ptrace
from torch_parity import CAMERA, n, t, to_numpy

AGREE = 0.999
ATOL = 1e-5


def _cornell_rays():
    """Camera rays of a 64x48 view of the box, bounce rays from their hits,
    and shadow rays to the light with its triangles excluded (3,072 each)."""
    scene = jcornell_box()
    tris = scene.world_triangle_vertices()
    mats = jcamera_matrices(JCamera(**CAMERA), 64, 48)
    o, d = jax.jit(lambda m: jgenerate_rays(m, 64, 48))(mats)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    hit = jisect.trace_closest_brute(tris, o, d)
    rng = np.random.default_rng(3)
    pos = o + d * np.where(np.asarray(hit.hit), np.asarray(hit.t), 1.0)[:, None]
    bd = rng.normal(size=pos.shape).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=-1, keepdims=True)
    lv, _ = scene.light_world_triangles()
    lv = np.asarray(lv)
    k = rng.integers(0, lv.shape[0], size=pos.shape[0])
    a, b = rng.uniform(size=(2, pos.shape[0], 1)).astype(np.float32)
    su = np.sqrt(a)
    lp = lv[k, 0] * (1 - su) + lv[k, 1] * (b * su) + lv[k, 2] * (su - b * su)
    sv = lp - pos
    dist = np.linalg.norm(sv, axis=-1).astype(np.float32)
    ex = np.asarray(scene.light_world_tri)[k].astype(np.int32)
    return (tuple(np.asarray(x) for x in tris), o, d,
            (pos + bd * 1e-3).astype(np.float32), bd,
            pos.astype(np.float32), (sv / dist[:, None]).astype(np.float32),
            dist - 1e-3, ex)


def _random_case(n_tris, n_rays, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    tris = (v0, v0 + rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.4,
            v0 + rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.4)
    o = (rng.normal(size=(n_rays, 3)) * 2.5).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.abs(rng.normal(size=n_rays)).astype(np.float32) * 4.0
    ex = rng.integers(-1, n_tris, size=n_rays).astype(np.int32)
    return tris, o, d, tmax, ex


def _cases():
    (tris, o, d, bo, bd, so, sd, smax, sex) = _cornell_rays()
    out = {
        "cornell_camera": (tris, o, d, None, None),
        "cornell_bounce": (tris, bo, bd, None, None),
        "cornell_shadow": (tris, so, sd, smax, sex),
    }
    for nt, nr, seed in ((36, 4096, 5), (300, 2048, 6)):
        rt, ro, rd, rmax, rex = _random_case(nt, nr, seed)
        out[f"random_{nt}"] = (rt, ro, rd, rmax, rex)
    return out


CASES = _cases()


def _closest_jax(tris, o, d, which):
    jt = tuple(jnp.asarray(x) for x in tris)
    if which == "brute":
        return jax.jit(lambda o, d: jisect.trace_closest_brute(jt, o, d))(o, d)
    return pallas_trace.trace_closest_pallas(jt, jnp.asarray(o), jnp.asarray(d))


def _check_closest(got, want):
    g_tri, g_hit = n(got.tri), n(got.hit)
    w_tri = np.asarray(want.tri)
    w_hit = np.asarray(want.hit)
    w_tri = np.where(w_hit, w_tri, 0)
    agree = (g_hit == w_hit) & (g_tri == w_tri)
    assert agree.mean() >= AGREE, agree.mean()
    both = agree & w_hit
    for g, w in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(n(g)[both], np.asarray(w)[both], atol=ATOL)
    assert np.all(np.isinf(n(got.t)[~g_hit]))


@pytest.mark.parametrize("which", ["brute", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_matches_reference(case, which):
    tris, o, d, _, _ = CASES[case]
    got = pisect.trace_closest_brute(tuple(t(x) for x in tris), t(o), t(d))
    want = _closest_jax(tris, o, d, which)
    _check_closest(got, want)
    assert 0.0 < n(got.hit).mean()


@pytest.mark.parametrize("which", ["brute", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("use_exclude", [False, True])
def test_occluded_matches_reference(case, which, use_exclude):
    tris, o, d, tmax, ex = CASES[case]
    if tmax is None:
        tmax = np.full(o.shape[0], 3.0, np.float32)
        ex = np.zeros(o.shape[0], np.int32)
    ex_j = jnp.asarray(ex) if use_exclude else None
    ex_p = t(ex) if use_exclude else None
    got = n(pisect.trace_occluded_brute(tuple(t(x) for x in tris), t(o), t(d),
                                        t(tmax), exclude=ex_p))
    jt = tuple(jnp.asarray(x) for x in tris)
    if which == "brute":
        want = jax.jit(lambda o, d, m, e: jisect.trace_occluded_brute(
            jt, o, d, m, exclude=e))(o, d, tmax, ex_j)
    else:
        want = pallas_trace.trace_occluded_pallas(jt, jnp.asarray(o),
                                                  jnp.asarray(d), tmax,
                                                  exclude=ex_j)
    agree = (got == np.asarray(want)).mean()
    assert agree >= AGREE, agree
    assert 0.0 < got.mean() < 1.0


def test_render_trace_matches_reference():
    """render/trace.py: brute tracer context, the tmax - 1e-3 shortening
    and the degenerate-segment mask (trace.py:270, :340-347)."""
    jscene = jcornell_box()
    jcfg_kw = dict(width=8, height=8, tracer="brute")
    from sunray_tpu.config import RenderConfig as JConfig

    jctx = jtrace.make_tracer(jscene, JConfig(**jcfg_kw))
    pscene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    pctx = ptrace.make_tracer(pscene, pconfig.RenderConfig(**jcfg_kw))
    tris, so, sd, smax, sex = (CASES["cornell_shadow"][i] for i in range(5))
    smax = smax.copy()
    smax[:64] = np.float32(1.5e-3)  # degenerate segments: always visible
    want = jtrace.trace_occluded(jctx, so, sd, smax, exclude=jnp.asarray(sex))
    got = ptrace.trace_occluded(pctx, t(so), t(sd), t(smax), exclude=t(sex))
    assert not n(got)[:64].any()
    assert (n(got) == np.asarray(want)).mean() >= AGREE
    wh = jtrace.trace_closest(jctx, so, sd)
    gh = ptrace.trace_closest(pctx, t(so), t(sd))
    _check_closest(gh, wh)


@pytest.mark.parametrize("kw", [dict(tracer="bvh"), dict(tracer="bvh2"),
                                dict(tracer="auto", brute_force_max_tris=16)])
def test_make_tracer_matches_jax(kw):
    """make_tracer without an accel builds what JAX's does (trace.py:
    113-127): an LBVH walk for tracer="bvh" and for "auto" above the brute
    limit, brute force for "bvh2"; their closest hits equal JAX's."""
    from sunray_tpu.config import RenderConfig as JConfig

    pscene = convert.scene_from_numpy(to_numpy(jcornell_box()), device="cpu")
    jctx = jtrace.make_tracer(jcornell_box(), JConfig(**kw))
    pctx = ptrace.make_tracer(pscene, pconfig.RenderConfig(**kw))
    assert (pctx.walk is not None) == (jctx.bvh is not None)
    _, o, d, _, _ = CASES["cornell_camera"]
    got = ptrace.trace_closest(pctx, t(o), t(d))
    want = jtrace.trace_closest(jctx, o, d)
    np.testing.assert_array_equal(n(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(n(got.tri)[n(got.hit)],
                                  np.asarray(want.tri)[np.asarray(want.hit)])
    np.testing.assert_allclose(n(got.t), np.asarray(want.t), atol=ATOL)


@pytest.mark.parametrize("kw,exc", [(dict(trace_impl="pallas"),
                                     NotImplementedError),
                                    (dict(tracer="kd"), ValueError)])
def test_make_tracer_uncovered_raises(kw, exc):
    """An unknown trace_impl or tracer still raises."""
    pscene = convert.scene_from_numpy(to_numpy(jcornell_box()), device="cpu")
    with pytest.raises(exc):
        ptrace.make_tracer(pscene, pconfig.RenderConfig(**kw))


def test_make_tracer_binned_without_accel_is_brute():
    """tracer="binned" with no ClusterSet resolves to brute force, as the
    JAX make_tracer does (trace.py:113-127)."""
    from sunray_tpu.config import RenderConfig as JConfig

    jscene = jcornell_box()
    jctx = jtrace.make_tracer(jscene, JConfig(tracer="binned"))
    assert jctx.binned is None and jctx.bvh is None
    pscene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    pctx = ptrace.make_tracer(pscene, pconfig.RenderConfig(tracer="binned"))
    assert pctx.binned is None
    _, o, d, _, _ = CASES["cornell_camera"]
    _check_closest(ptrace.trace_closest(pctx, t(o), t(d)),
                   jtrace.trace_closest(jctx, o, d))

