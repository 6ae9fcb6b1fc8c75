"""PyTorch port, the ReSTIR modules: each plain version held to the JAX
package on the same seeded numpy inputs.

Tolerances. The RNG, the shared tap offsets and the target functions are
bit-exact (the port rounds as XLA's CPU backend compiles the reference,
ops/brdf.py). The merge chains compare a uniform draw u against
weight / w_sum, so a last-bit difference in a p_hat can flip a take; the
reservoir comparisons therefore use the take-flip scheme of
tests/test_restir_math.py:199-216: seeds bit-equal, M exact, the winner
(light or triangle id) equal on more than 99.5% of lanes, w_sum within
rtol 5e-4, and positions within 1e-5 and W within 3e-4 on the lanes whose
winner agrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops import brdf as jb
from sunray_tpu.ops import rng as jrng
from sunray_tpu.ops.pallas_restir import ris_audition_pallas
from sunray_tpu.render import pathtrace as jpt
from sunray_tpu.render import restir as jr
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import brdf as pb
from sunray_tpu_torch.ops import cuda_restir as cr
from sunray_tpu_torch.ops import rng as prng
from sunray_tpu_torch.render import pathtrace as ppt
from sunray_tpu_torch.render import restir as pr
from torch_frame_cases import phase_b_case
from torch_parity import GOLDEN_KW, WINNER_AGREE, n, t, to_numpy
from torch_parity import check_reservoir as _check_reservoir


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _u32(x):
    return np.asarray(x).astype(np.uint32)


@pytest.fixture(scope="module")
def jlights():
    return jr.Lights(jcornell_box())


@pytest.fixture(scope="module")
def table(jlights):
    return cr.LightTable(*(t(np.asarray(x)) for x in (
        jlights.v0, jlights.v1, jlights.v2, jlights.emission)))


def _unit(rng, p):
    v = rng.normal(size=(p, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _surfaces(p, seed):
    """Seeded surface attributes as test_restir_math.py:119-131 draws them."""
    rng = np.random.default_rng(seed)
    return dict(
        pos=rng.uniform(0, 2, (p, 3)).astype(np.float32),
        normal=_unit(rng, p),
        view=_unit(rng, p),
        albedo=rng.uniform(0, 1, (p, 3)).astype(np.float32),
        rough=rng.uniform(0.05, 1, p).astype(np.float32),
        metal=rng.uniform(0, 1, p).astype(np.float32),
        seed=rng.integers(0, 2**32, p, dtype=np.uint32),
        enable=rng.random(p) > 0.2,
    )


# -- RNG and target functions: bit-exact ----------------------------------

@pytest.mark.parametrize("count", [1, 3, 5, 64])
def test_rnd_chain_bit_exact(count):
    s = np.random.default_rng(count).integers(0, 2**32, 50_000,
                                              dtype=np.uint32)
    s[:3] = [0, 0xFFFFFFFF, 1]
    ps, pd = prng.rnd_chain(t(s.astype(np.int64)), count)
    js, jd = jrng.rnd_chain(jnp.asarray(s), count)
    np.testing.assert_array_equal(_u32(n(ps)), np.asarray(js))
    np.testing.assert_array_equal(_bits(n(pd)), _bits(jd))
    # ... and with `count` sequential draws.
    seq = t(s.astype(np.int64))
    for i in range(count):
        seq, u = prng.rnd(seq)
        np.testing.assert_array_equal(_bits(n(u)), _bits(n(pd[:, i])))
    np.testing.assert_array_equal(n(seq), n(ps))


def _brdf_inputs(p=60_000):
    rng = np.random.default_rng(3)
    s = _surfaces(p, 4)
    view = np.where((s["view"] * s["normal"]).sum(-1, keepdims=True) < 0,
                    -s["view"], s["view"]).astype(np.float32)
    return dict(
        s, view=view,
        em=rng.uniform(0, 20, (p, 3)).astype(np.float32),
        lpos=(s["pos"] + _unit(rng, p) * rng.uniform(0.2, 2, (p, 1))
              ).astype(np.float32),
        lnrm=_unit(rng, p),
        ndv=rng.uniform(0, 1, p).astype(np.float32),
        ndl=rng.uniform(0, 1, p).astype(np.float32),
    )


def _planes_np(x, k):
    """(P, 3) -> three (K, P/K) planes; (P,) -> one (1, P/K) plane."""
    if x.ndim == 2:
        return [np.ascontiguousarray(x[:, a].reshape(k, -1)) for a in range(3)]
    return np.ascontiguousarray(x.reshape(k, -1))


def _surface_planes(x, k):
    """The first P/K surfaces as (1, P/K) planes, broadcast over K rows."""
    m = x.shape[0] // k
    if x.ndim == 2:
        return [np.ascontiguousarray(x[:m, a][None]) for a in range(3)]
    return np.ascontiguousarray(x[:m][None])


def _torch_tree(x):
    return [t(v) for v in x] if isinstance(x, list) else t(x)


BRDF_CASES = ["eval_unshadowed_light", "smith_v_ggx", "gi_target_pdf",
              "eval_p_hat_planar", "gi_target_pdf_planar"]


@pytest.mark.parametrize("name", BRDF_CASES)
def test_target_functions_bit_exact(name):
    """The ReSTIR target functions, bit for bit with jax.jit of the JAX
    function (brdf.py:72-270)."""
    d = _brdf_inputs()
    k = 4
    if name == "eval_unshadowed_light":
        args = [d[a] for a in ("pos", "normal", "view", "albedo", "rough",
                               "metal", "em", "lpos", "lnrm")]
    elif name == "smith_v_ggx":
        args = [d["ndv"], d["ndl"], d["rough"]]
    elif name == "gi_target_pdf":
        args = [d[a] for a in ("pos", "normal", "albedo", "metal", "lpos",
                               "em")]
    elif name == "eval_p_hat_planar":
        args = ([_surface_planes(d[a], k) for a in ("pos", "normal", "view",
                                                    "albedo", "rough",
                                                    "metal")]
                + [_planes_np(d[a], k) for a in ("em", "lpos", "lnrm")])
    else:
        args = ([_surface_planes(d[a], k) for a in ("pos", "normal",
                                                    "albedo", "metal")]
                + [_planes_np(d[a], k) for a in ("lpos", "em")])

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    want = jax.jit(lambda *a: first(getattr(jb, name)(*a)))(*args)
    got = first(getattr(pb, name)(*(_torch_tree(a) for a in args)))
    np.testing.assert_array_equal(_bits(n(got)), _bits(want))


def test_luminance_max_and_inv_pi():
    rgb = np.random.default_rng(5).uniform(0, 9, (1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(n(pb.luminance_max(t(rgb))),
                                  np.asarray(jb.luminance_max(rgb)))
    assert pb.INV_PI == float(np.float32(1.0) / np.float32(jb.PI))


# -- merge primitives -------------------------------------------------------

def _merge_inputs(p=20_000, seed=6):
    rng = np.random.default_rng(seed)
    return dict(
        w_sum=rng.uniform(0, 5, p).astype(np.float32),
        M=rng.uniform(0, 20, p).astype(np.float32),
        new_M=rng.uniform(0, 20, p).astype(np.float32),
        new_W=rng.uniform(0, 30, p).astype(np.float32),
        p_hat=rng.uniform(0, 3, p).astype(np.float32),
        jac=rng.uniform(0, 10, p).astype(np.float32),
        u=rng.uniform(0, 1, p).astype(np.float32),
        enable=rng.random(p) > 0.3,
        idx=rng.integers(0, 2, p).astype(np.int32),
        pos=rng.uniform(0, 2, (p, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("kind", ["di", "gi"])
def test_merge_matches_jax(kind):
    """merge_di / merge_gi (restir.py:94-124): w_sum and M bit-exact, the
    same takes. Candidate ids start at 5, so a take shows as the id."""
    d = _merge_inputs(seed=6 if kind == "di" else 7)
    p = d["M"].shape[0]
    ids = d["idx"] + 5
    weight = d["p_hat"] * d["new_W"] * d["new_M"]
    if kind == "di":
        r = jr.ReservoirDI.empty(p).replace(w_sum=d["w_sum"], M=d["M"])
        new = jr.ReservoirDI.empty(p).replace(
            M=d["new_M"], W=d["new_W"], light_idx=ids, light_pos=d["pos"])
        out = jax.jit(jr.merge_di)(r, new, d["p_hat"], d["u"], d["enable"])
        jtake = np.asarray(out.light_idx) == ids
    else:
        weight = weight * d["jac"]
        r = jr.ReservoirGI.empty(p).replace(w_sum=d["w_sum"], M=d["M"])
        new = jr.ReservoirGI.empty(p).replace(
            M=d["new_M"], W=d["new_W"], sample_tri=ids, sample_pos=d["pos"])
        out = jax.jit(jr.merge_gi)(r, new, d["p_hat"], d["jac"], d["u"],
                                   d["enable"])
        jtake = np.asarray(out.sample_tri) == ids
    w_sum, m, take = cr.merge(t(d["w_sum"]), t(d["M"]), t(d["new_M"]),
                              t(weight), t(d["u"]), t(d["enable"]))
    np.testing.assert_array_equal(n(w_sum), np.asarray(out.w_sum))
    np.testing.assert_array_equal(n(m), np.asarray(out.M))
    np.testing.assert_array_equal(n(take), jtake)
    assert 0.1 < jtake.mean() < 0.9


# -- K3: RIS audition --------------------------------------------------------

def _audition(jlights, table, k, p=4096, seed=10):
    s = _surfaces(p, seed)
    args = [s[a] for a in ("pos", "normal", "view", "albedo", "rough",
                           "metal")]
    js, jres = jax.jit(lambda sd, *a: jr.ris_audition(
        jlights, sd, *a, k, jnp.asarray(s["enable"]), kernel="jnp"))(
            s["seed"], *args)
    ps, pres = cr.ris_audition_plain(table, t(s["seed"].astype(np.int64)),
                                     *(t(a) for a in args), k,
                                     t(s["enable"]))
    return s, (ps, pres), (js, dataclasses.asdict(jres))


@pytest.mark.parametrize("k", [1, 4, 16])
def test_ris_audition_matches_jnp(jlights, table, k):
    _, (ps, pres), (js, jres) = _audition(jlights, table, k)
    _check_reservoir(ps, pres, js, jres, pos_keys=("light_pos",
                                                   "light_normal"))


def test_ris_audition_matches_sequential_oracle(jlights, table):
    """The K-round sequential form (restir.py:313-364) is the oracle the
    JAX package keeps for its plane form."""
    s, (ps, pres), _ = _audition(jlights, table, 8, seed=11)
    args = [s[a] for a in ("pos", "normal", "view", "albedo", "rough",
                           "metal")]
    js, jres = jax.jit(lambda sd, *a: jr._ris_audition_sequential(
        jlights, sd, *a, 8, jnp.asarray(s["enable"])))(s["seed"], *args)
    _check_reservoir(ps, pres, js, dataclasses.asdict(jres))


def test_ris_audition_matches_pallas_interpret(jlights, table):
    """ris_audition_pallas in interpret mode, 4,096 lanes, K = 16
    (test_restir_math.py:171-216). Its draws are exact only to one ulp
    (pallas_restir.py:14-16), so its winners are held to the same
    take-flip scheme."""
    s = _surfaces(4096, 12)
    args = [s[a] for a in ("pos", "normal", "view", "albedo", "rough",
                           "metal")]
    js, jf = ris_audition_pallas(jlights.v0, jlights.v1, jlights.v2,
                                 jlights.emission, jnp.asarray(s["seed"]),
                                 *(jnp.asarray(a) for a in args), 16,
                                 jnp.asarray(s["enable"]))
    ps, pres = cr.ris_audition_plain(table, t(s["seed"].astype(np.int64)),
                                     *(t(a) for a in args), 16,
                                     t(s["enable"]))
    _check_reservoir(ps, pres, js, jf)


def test_ris_audition_many_lights_samples_every_light():
    """600 lights: sampled exactly and uniformly (no presampled tiles),
    bit-exact in its draws with the jnp path."""
    rng = np.random.default_rng(13)
    n_l = 600
    v0 = rng.uniform(0, 2, (n_l, 3)).astype(np.float32)
    tab = [v0, (v0 + rng.uniform(-0.3, 0.3, (n_l, 3))).astype(np.float32),
           (v0 + rng.uniform(-0.3, 0.3, (n_l, 3))).astype(np.float32),
           rng.uniform(0, 20, (n_l, 3)).astype(np.float32)]

    class Tab:
        pass

    jl = Tab()
    jl.v0, jl.v1, jl.v2, jl.emission = (jnp.asarray(x) for x in tab)
    jl.num = n_l
    jl.gather = lambda idx: jr.Lights.gather(jl, idx)
    jl.eval_p_hat = lambda *a: jr.Lights.eval_p_hat(jl, *a)
    s = _surfaces(8192, 14)
    args = [s[a] for a in ("pos", "normal", "view", "albedo", "rough",
                           "metal")]
    js, jres = jax.jit(lambda sd, *a: jr.ris_audition(
        jl, sd, *a, 16, jnp.asarray(s["enable"]), kernel="jnp"))(
            s["seed"], *args)
    ps, pres = cr.ris_audition_plain(cr.LightTable(*(t(x) for x in tab)),
                                     t(s["seed"].astype(np.int64)),
                                     *(t(a) for a in args), 16,
                                     t(s["enable"]))
    _check_reservoir(ps, pres, js, dataclasses.asdict(jres))
    won = np.unique(n(pres["light_idx"])[s["enable"]])
    assert won.size > 500


# -- temporal reuse ----------------------------------------------------------

def _history(kind, p, seed):
    rng = np.random.default_rng(seed)
    base = dict(
        w_sum=rng.uniform(0, 5, p).astype(np.float32),
        M=rng.uniform(0, 25, p).astype(np.float32),
        W=np.where(rng.random(p) > 0.2, rng.uniform(0, 30, p), 0.0
                   ).astype(np.float32),
        hit_normal=_unit(rng, p),
        depth=rng.uniform(1, 4, p).astype(np.float32),
    )
    if kind == "di":
        return dict(base, light_pos=rng.uniform(0.7, 1.3, (p, 3)).astype(
                        np.float32) + np.float32([0, 0.98, 0]),
                    light_normal=np.tile(np.float32([0, -1, 0]), (p, 1)),
                    light_idx=rng.integers(0, 2, p).astype(np.int32))
    return dict(base, sample_pos=rng.uniform(0, 2, (p, 3)).astype(np.float32),
                sample_normal=_unit(rng, p),
                sample_radiance=rng.uniform(0, 5, (p, 3)).astype(np.float32),
                sample_tri=rng.integers(-1, 36, p).astype(np.int32))


def _temporal_case(p_w=64, p_h=48, seed=20):
    """A slow pan over a wall: reprojection near each pixel (sometimes
    off screen), surface and history normals near one direction and
    depths near the history's, so the confidence takes all its values."""
    p = p_w * p_h
    rng = np.random.default_rng(seed)
    s = _surfaces(p, seed + 1)
    ys, xs = np.divmod(np.arange(p), p_w)
    uv = np.stack([(xs + 0.5 + rng.normal(0, 0.7, p)) / p_w,
                   (ys + 0.5 + rng.normal(0, 0.7, p)) / p_h], -1)
    wall = np.float32([0.0, 0.6, 0.8])
    near = wall + rng.normal(0, 0.04, (p, 3))
    near = near / np.linalg.norm(near, axis=1, keepdims=True)
    s["normal"] = np.where(rng.random((p, 1)) > 0.2, near,
                           s["normal"]).astype(np.float32)
    vd = rng.uniform(1, 4, p).astype(np.float32)
    return dict(s, w=p_w, h=p_h, prev_uv=uv.astype(np.float32),
                prev_valid=rng.random(p) > 0.1, vd=vd,
                wall=wall)


def _on_wall(hist, c, seed):
    """History normals near the wall and depths within ~15% of vd."""
    rng = np.random.default_rng(seed)
    p = c["vd"].shape[0]
    hn = c["wall"] + rng.normal(0, 0.04, (p, 3))
    hist["hit_normal"] = (hn / np.linalg.norm(hn, axis=1, keepdims=True)
                          ).astype(np.float32)
    hist["depth"] = (c["vd"] * rng.uniform(0.85, 1.15, p)).astype(np.float32)
    return hist


def test_di_temporal_reuse_matches_jax(jlights):
    c = _temporal_case()
    p = c["w"] * c["h"]
    cfg, jcfg = RenderConfig(), JConfig()
    attrs = [c[a] for a in ("pos", "normal", "view", "albedo", "rough",
                            "metal")]
    js0, jres = jax.jit(lambda sd, *a: jr.ris_audition(
        jlights, sd, *a, 4, jnp.asarray(c["enable"]), kernel="jnp"))(
            c["seed"], *attrs)
    hist = _on_wall(_history("di", p, 22), c, 23)

    def jrun(sd, r, h, *a):
        return jr.di_temporal_reuse(
            jlights, jcfg, sd, r, h, c["prev_uv"], c["prev_valid"],
            jnp.int32(3), *a, c["vd"], c["w"], c["h"],
            jnp.asarray(c["enable"]))

    js, jout = jax.jit(jrun)(js0, jres, jr.ReservoirDI(**hist), *attrs)
    r = pr.ReservoirDI(**{k: t(np.asarray(v))
                          for k, v in dataclasses.asdict(jres).items()})
    lights = pr.Lights(convert.scene_from_numpy(to_numpy(jcornell_box()), device="cpu"))
    ps, pout = pr.di_temporal_reuse(
        lights, cfg, t(_u32(js0).astype(np.int64)), r,
        pr.ReservoirDI(**{k: t(v) for k, v in hist.items()}),
        t(c["prev_uv"]), t(c["prev_valid"]), torch.tensor(3, dtype=torch.int32),
        *(t(a) for a in attrs), t(c["vd"]), c["w"], c["h"], t(c["enable"]))
    # M takes the normal/depth confidence. Compiled alone, XLA fuses the
    # depth test's division into the smoothstep (a multiply-add by a
    # reciprocal); inside the frame it does not, and the port rounds as
    # the frame does (M bit-equal there, test_torch_frame_restir.py). So
    # M is held to 1e-6 relative here.
    agree = _check_reservoir(ps, dataclasses.asdict(pout), js,
                             dataclasses.asdict(jout), m_rtol=1e-6)
    # The merge took history on a good share of lanes.
    assert (n(pout.M) > n(r.M)).mean() > 0.15
    assert agree > WINNER_AGREE


def test_gi_temporal_reuse_matches_jax():
    c = _temporal_case(seed=30)
    p = c["w"] * c["h"]
    cfg, jcfg = RenderConfig(), JConfig()
    cur = _history("gi", p, 31)
    cur["sample_tri"] = np.where(c["enable"], cur["sample_tri"], -1
                                 ).astype(np.int32)
    hist = _on_wall(_history("gi", p, 32), c, 33)
    attrs = [c[a] for a in ("pos", "normal", "albedo", "metal")]

    def jrun(sd, r, h, *a):
        return jr.gi_temporal_reuse(
            jcfg, sd, r, h, c["prev_uv"], c["prev_valid"], jnp.int32(5), *a,
            c["vd"], c["w"], c["h"], jnp.asarray(c["enable"]))

    js, jout = jax.jit(jrun)(c["seed"], jr.ReservoirGI(**cur),
                             jr.ReservoirGI(**hist), *attrs)
    ps, pout = pr.gi_temporal_reuse(
        cfg, t(c["seed"].astype(np.int64)),
        pr.ReservoirGI(**{k: t(v) for k, v in cur.items()}),
        pr.ReservoirGI(**{k: t(v) for k, v in hist.items()}),
        t(c["prev_uv"]), t(c["prev_valid"]), torch.tensor(5, dtype=torch.int32),
        *(t(a) for a in attrs), t(c["vd"]), c["w"], c["h"], t(c["enable"]))
    # M within 1e-6 relative, as in the DI test above.
    _check_reservoir(ps, dataclasses.asdict(pout), js,
                     dataclasses.asdict(jout), idx="sample_tri",
                     pos_keys=("sample_pos", "sample_radiance"),
                     m_rtol=1e-6)
    assert (n(pout.M) > cur["M"]).mean() > 0.15


# -- spatial reuse -------------------------------------------------------------

@pytest.mark.parametrize("count,radius,salt", [(5, 30.0, 0x51A7D1),
                                               (3, 20.0, 0x6E5B2F)])
def test_shared_taps_match_jax(count, radius, salt):
    """The shared tap offsets of frames 0..255 (pathtrace.py:438-460)."""
    jcfg = JConfig()
    taps = jax.jit(lambda fc: jpt._shared_taps(jcfg, fc, count, radius, salt))
    for fc in range(256):
        want = [(int(a), int(b)) for a, b in taps(jnp.int32(fc))]
        got = ppt._shared_taps(torch.tensor(fc, dtype=torch.int32), count,
                               radius, salt)
        assert got == want, fc


@pytest.fixture(scope="module")
def phase_b():
    """Phase B on live inputs: the arguments of the port's _spatial_reuse
    in frame 3 of the golden ReSTIR config, run through the JAX
    _spatial_reuse (its final radiance add intercepted to expose the DI and
    GI results) and through the port's (torch_frame_cases.phase_b_case)."""
    return phase_b_case(dict(GOLDEN_KW, lighting="restir"))


def test_di_spatial_matches_jax(phase_b):
    (cfg, _, lights, _, gbuf, r_di, _, seed, c, cam_origin,
     fc) = phase_b["args"]
    taps = ppt._shared_taps(fc, cfg.di_spatial_samples, cfg.di_spatial_radius,
                            0x51A7D1)
    pos = c["f_pos"]
    _, di = cr.di_spatial_plain(
        lights.table, seed,
        {k: getattr(r_di, k) for k in ("light_pos", "light_normal", "W", "M",
                                       "light_idx")},
        taps, c["pending"], gbuf.normal, gbuf.depth,
        pb.vec_norm(pos - cam_origin), pos, c["f_normal"], c["f_view"],
        c["f_albedo"], c["f_rough"], c["f_metal"], cfg.width, cfg.height,
        (cfg.di_temporal_w_clamp, cfg.di_temporal_m_clamp,
         cfg.di_spatial_w_clamp))
    jp = phase_b["jparts"]
    pend = n(c["pending"])
    assert pend.mean() > 0.5
    np.testing.assert_array_equal(n(di["has"]), jp["has"])
    same = n(lights.world_tri[di["light_idx"].long()]) == jp["di_exclude"]
    assert same[pend].mean() > WINNER_AGREE
    sp = same & pend
    np.testing.assert_allclose(n(di["w_spatial"])[sp], jp["w_spatial"][sp],
                               rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(n(di["f_y_w"])[sp], jp["f_y_w"][sp],
                               rtol=3e-4, atol=1e-5)


def test_gi_spatial_matches_jax(phase_b):
    """GI tap prep (Jacobian, neighbour x1, visibility) and K6's plain
    version against the JAX batched shared-tap branch."""
    cfg, tracer, _, mats, gbuf, _, r_gi, seed, c, cam_origin, fc = (
        phase_b["args"])
    pending, pos = c["pending"], c["f_pos"]
    taps = ppt._shared_taps(fc, cfg.gi_spatial_samples, cfg.gi_spatial_radius,
                            0x6E5B2F)
    planes = ppt._gi_tap_prep(cfg, tracer, mats, gbuf, r_gi, taps, pending,
                              pos, c["f_normal"], pb.vec_norm(pos - cam_origin),
                              cam_origin)
    # The DI draws come first in the stream: 1 + T_di.
    s, _ = prng.rnd_chain(seed, 1 + cfg.di_spatial_samples)
    _, gi = cr.gi_spatial_plain(
        s, {k: getattr(r_gi, k) for k in ("sample_pos", "sample_radiance",
                                          "sample_tri", "w_sum", "M")},
        planes, pending, pos, c["f_normal"], c["f_albedo"], c["f_metal"],
        cfg.gi_spatial_w_clamp)
    jp = phase_b["jparts"]
    pend = n(pending)
    same = n(gi["sample_tri"]) == jp["sample_tri"]
    assert same[pend].mean() > WINNER_AGREE
    sp = same & pend
    np.testing.assert_array_equal(n(gi["try_gi"])[sp], jp["try_gi"][sp])
    np.testing.assert_allclose(n(gi["gdir"])[sp], jp["gdir"][sp], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(gi["contrib_pre"])[sp], jp["contrib_pre"][sp],
                               rtol=3e-4, atol=1e-5)


def test_spatial_reuse_radiance_matches_jax(phase_b):
    """The whole of phase B: the radiance it adds, per pixel."""
    got, want = n(phase_b["out"]), np.asarray(phase_b["jout"])
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() > WINNER_AGREE, close.mean()
