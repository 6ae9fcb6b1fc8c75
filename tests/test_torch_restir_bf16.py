"""PyTorch port, the ReSTIR modules with bf16 shading attributes: the
target functions and the plain versions of K3 and K4 and GI temporal
reuse on bfloat16 normal, view, albedo, roughness and metallic planes,
held to the JAX package's jnp functions (restir.ris_audition
kernel="jnp", di_temporal_reuse, gi_temporal_reuse) on the same seeded
inputs.

The port rounds as XLA's CPU backend compiles the jnp code with bf16
operands (ops/brdf.py's module docstring: a bf16 operation takes its
operands rounded and computes in float32; its result is rounded where a
bf16 operation reads it and read unrounded where a float32 one does).
gi_target_pdf is bit-exact. eval_unshadowed_light, compiled alone,
rounds one ulp apart on ~1% of lanes (the
fused product XLA picks there moves with the fusion; inside the frame the
port's choice matches, tests/test_torch_frame_bf16.py), so it is held to
> 98% of lanes bit-equal and the rest within 1e-4 relative (an ulp of a
difference such as 1 - f can reach ~3e-5 of the result). The reservoirs take the
take-flip scheme of tests/test_restir_math.py (torch_parity.check_reservoir).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops import brdf as jb
from sunray_tpu.render import restir as jr
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import brdf as pb
from sunray_tpu_torch.ops import cuda_restir as cr
from sunray_tpu_torch.render import restir as pr
from torch_parity import check_reservoir, n, t, to_numpy

BF = jnp.bfloat16
ATTRS = ("normal", "view", "albedo", "rough", "metal")


def _unit(rng, *shape):
    v = rng.normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _surfaces(p, seed):
    rng = np.random.default_rng(seed)
    metal = rng.uniform(0, 1, p).astype(np.float32)
    metal[::7] = 0.0
    return dict(
        pos=rng.uniform(0, 2, (p, 3)).astype(np.float32),
        normal=_unit(rng, p), view=_unit(rng, p),
        albedo=rng.uniform(0, 1, (p, 3)).astype(np.float32),
        rough=rng.uniform(0.05, 1, p).astype(np.float32), metal=metal,
        seed=rng.integers(0, 2**32, p, dtype=np.uint32),
        enable=rng.random(p) > 0.2,
    )


def _jbf(x):
    return jnp.asarray(x).astype(BF)


def _tbf(x):
    return torch.from_numpy(np.asarray(x)).to(torch.bfloat16)


def _bits_equal(a, b):
    return np.asarray(a).view(np.int32) == np.asarray(b).view(np.int32)


def test_bf16_constants():
    """bf16(0.04), bf16(0.001), and x / PI on a bf16 x as XLA compiles it
    when a float32 operation reads the result: x * f32(1 / bf16(PI)),
    unrounded."""
    assert pb.BF_0P04 == float(jnp.asarray(0.04, BF))
    assert pb.BF_0P001 == float(jnp.asarray(0.001, BF))
    got = jax.jit(lambda x: (x.astype(BF) / jb.PI).astype(jnp.float32) * x)(
        jnp.ones((8,), jnp.float32))
    assert np.all(np.asarray(got) == np.float32(pb.INV_PI_BF16))


def test_eval_unshadowed_light_bf16():
    rng = np.random.default_rng(3)
    p = 20_000
    s = _surfaces(p, 2)
    em = rng.uniform(0, 20, (p, 3)).astype(np.float32)
    lp = rng.uniform(0, 2, (p, 3)).astype(np.float32)
    ln = _unit(rng, p)
    want = np.asarray(jax.jit(jb.eval_unshadowed_light)(
        s["pos"], *(_jbf(s[a]) for a in ATTRS), em, lp, ln))
    got = n(pb.eval_unshadowed_light(t(s["pos"]), *(_tbf(s[a]) for a in ATTRS),
                                     t(em), t(lp), t(ln)))
    assert _bits_equal(got, want).all(-1).mean() > 0.98
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.0)
    # bf16 rounding moves the result against the float32 attributes.
    f32 = n(pb.eval_unshadowed_light(*(t(s[a]) for a in ("pos",) + ATTRS),
                                     t(em), t(lp), t(ln)))
    assert not _bits_equal(got, f32).all()


def test_gi_target_pdf_bf16_bit_exact():
    rng = np.random.default_rng(4)
    p = 20_000
    s = _surfaces(p, 5)
    sp = rng.uniform(0, 2, (p, 3)).astype(np.float32)
    sr = rng.uniform(0, 5, (p, 3)).astype(np.float32)
    want = jax.jit(jb.gi_target_pdf)(s["pos"], _jbf(s["normal"]),
                                     _jbf(s["albedo"]), _jbf(s["metal"]), sp,
                                     sr)
    got = pb.gi_target_pdf(t(s["pos"]), _tbf(s["normal"]), _tbf(s["albedo"]),
                           _tbf(s["metal"]), t(sp), t(sr))
    assert _bits_equal(n(got), want).all()


@pytest.fixture(scope="module")
def jlights():
    return jr.Lights(jcornell_box())


@pytest.fixture(scope="module")
def lights():
    return pr.Lights(convert.scene_from_numpy(to_numpy(jcornell_box()),
                                              device="cpu"))


@pytest.mark.parametrize("k", [4, 16])
def test_ris_audition_bf16_matches_jnp(jlights, lights, k):
    """K3's plain version on bf16 planes against restir.ris_audition
    (kernel="jnp") on the same bf16 planes."""
    s = _surfaces(4096, 10 + k)
    js, jres = jax.jit(lambda sd, pos, *a: jr.ris_audition(
        jlights, sd, pos, *a, k, jnp.asarray(s["enable"]), kernel="jnp"))(
            s["seed"], s["pos"], *(_jbf(s[a]) for a in ATTRS))
    ps, pres = cr.ris_audition_plain(lights.table, t(s["seed"].astype(np.int64)),
                                     t(s["pos"]), *(_tbf(s[a]) for a in ATTRS),
                                     k, t(s["enable"]))
    check_reservoir(ps, pres, js, dataclasses.asdict(jres),
                    pos_keys=("light_pos", "light_normal"))


def _temporal_case(p_w=64, p_h=48, seed=20):
    """A slow pan over a wall (tests/test_torch_restir.py's case)."""
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
    hist = dict(
        w_sum=rng.uniform(0, 5, p).astype(np.float32),
        M=rng.uniform(0, 25, p).astype(np.float32),
        W=np.where(rng.random(p) > 0.2, rng.uniform(0, 30, p), 0.0
                   ).astype(np.float32),
        hit_normal=(lambda v: (v / np.linalg.norm(v, axis=1, keepdims=True))
                    .astype(np.float32))(wall + rng.normal(0, 0.04, (p, 3))),
        depth=(vd * rng.uniform(0.85, 1.15, p)).astype(np.float32),
    )
    return dict(s, w=p_w, h=p_h, prev_uv=uv.astype(np.float32),
                prev_valid=rng.random(p) > 0.1, vd=vd, hist=hist, rng=rng)


def test_di_temporal_bf16_matches_jax(jlights, lights):
    """restir.di_temporal_reuse (K4's plain version) on bf16 planes after
    a bf16 audition, against JAX's."""
    c = _temporal_case()
    p, rng = c["w"] * c["h"], c["rng"]
    hist = dict(c["hist"],
                light_pos=(rng.uniform(0.7, 1.3, (p, 3))
                           + np.float32([0, 0.98, 0])).astype(np.float32),
                light_normal=np.tile(np.float32([0, -1, 0]), (p, 1)),
                light_idx=rng.integers(0, 2, p).astype(np.int32))
    cfg, jcfg = RenderConfig(), JConfig()
    attrs_j = [_jbf(c[a]) for a in ATTRS]
    js0, jres = jax.jit(lambda sd, pos, *a: jr.ris_audition(
        jlights, sd, pos, *a, 4, jnp.asarray(c["enable"]), kernel="jnp"))(
            c["seed"], c["pos"], *attrs_j)

    def jrun(sd, r, h, pos, *a):
        return jr.di_temporal_reuse(
            jlights, jcfg, sd, r, h, c["prev_uv"], c["prev_valid"],
            jnp.int32(3), pos, *a, c["vd"], c["w"], c["h"],
            jnp.asarray(c["enable"]))

    js, jout = jax.jit(jrun)(js0, jres, jr.ReservoirDI(**hist), c["pos"],
                             *attrs_j)
    r = pr.ReservoirDI(**{k: t(np.asarray(v))
                          for k, v in dataclasses.asdict(jres).items()})
    ps, pout = pr.di_temporal_reuse(
        lights, cfg, t(np.asarray(js0).astype(np.int64)), r,
        pr.ReservoirDI(**{k: t(v) for k, v in hist.items()}),
        t(c["prev_uv"]), t(c["prev_valid"]), torch.tensor(3, dtype=torch.int32),
        t(c["pos"]), *(_tbf(c[a]) for a in ATTRS), t(c["vd"]), c["w"], c["h"],
        t(c["enable"]))
    # M within 1e-6 relative: compiled alone XLA fuses the depth test's
    # division (tests/test_torch_restir.py's temporal tests).
    check_reservoir(ps, dataclasses.asdict(pout), js,
                    dataclasses.asdict(jout), m_rtol=1e-6)
    assert (n(pout.M) > n(r.M)).mean() > 0.15


def test_gi_temporal_bf16_matches_jax():
    """restir.gi_temporal_reuse on bf16 normal, albedo and metallic."""
    c = _temporal_case(seed=30)
    p, rng = c["w"] * c["h"], c["rng"]

    def gi_res(seed):
        r = np.random.default_rng(seed)
        return dict(
            w_sum=r.uniform(0, 5, p).astype(np.float32),
            M=r.uniform(0, 25, p).astype(np.float32),
            W=np.where(r.random(p) > 0.2, r.uniform(0, 30, p), 0.0
                       ).astype(np.float32),
            hit_normal=_unit(r, p), depth=r.uniform(1, 4, p).astype(np.float32),
            sample_pos=r.uniform(0, 2, (p, 3)).astype(np.float32),
            sample_normal=_unit(r, p),
            sample_radiance=r.uniform(0, 5, (p, 3)).astype(np.float32),
            sample_tri=r.integers(-1, 36, p).astype(np.int32))

    cur = gi_res(31)
    hist = dict(gi_res(32), hit_normal=c["hist"]["hit_normal"],
                depth=c["hist"]["depth"])
    cfg, jcfg = RenderConfig(), JConfig()
    names = ("normal", "albedo", "metal")

    def jrun(sd, r, h, pos, *a):
        return jr.gi_temporal_reuse(
            jcfg, sd, r, h, c["prev_uv"], c["prev_valid"], jnp.int32(5), pos,
            *a, c["vd"], c["w"], c["h"], jnp.asarray(c["enable"]))

    js, jout = jax.jit(jrun)(c["seed"], jr.ReservoirGI(**cur),
                             jr.ReservoirGI(**hist), c["pos"],
                             *(_jbf(c[a]) for a in names))
    ps, pout = pr.gi_temporal_reuse(
        cfg, t(c["seed"].astype(np.int64)),
        pr.ReservoirGI(**{k: t(v) for k, v in cur.items()}),
        pr.ReservoirGI(**{k: t(v) for k, v in hist.items()}),
        t(c["prev_uv"]), t(c["prev_valid"]), torch.tensor(5, dtype=torch.int32),
        t(c["pos"]), *(_tbf(c[a]) for a in names), t(c["vd"]), c["w"], c["h"],
        t(c["enable"]))
    check_reservoir(ps, dataclasses.asdict(pout), js,
                    dataclasses.asdict(jout), idx="sample_tri",
                    pos_keys=("sample_pos", "sample_radiance"), m_rtol=1e-6)
