"""PyTorch port, the differentiable slice module by module: each function's
vector-Jacobian product (VJP) against jax.vjp / jax.grad of its JAX
counterpart on the same numpy inputs.

  - ops/fp: fma's float32 backward bit-equal to the backward of float32
    a * b + c; sqrt's to JAX's g * (0.5 / sqrt(x));
  - K8: the plain segment-sum backward and gather_rows' autograd Function
    against _onehot_gather_multi_bwd, clamped indices included;
  - K7, K9: the backward of the autograd Functions (the plain version's
    VJP, recomputed) against atrous_denoise_tpu and taa_clamp_blend_tpu,
    whose custom_vjps they port, in interpret mode;
  - the ReSTIR plain functions that a differentiable frame runs (the RIS
    audition, DI and GI temporal reuse, the spatial reuse and its final
    resolve) against JAX's jnp formulations, on inputs with exact channel
    ties (white albedo under the white light);
  - the tonemap at its clip bounds (jnp.clip passes half the gradient at a
    bound, as ops/fp.clip does; torch.clamp passed all of it).

Tolerances: elementwise rtol 1e-4 with a floor of 1e-6 of the largest
entry for functions whose forward agrees to a few ulps; the reservoir
functions on the lanes whose winner agrees (the take-flip scheme of
tests/test_restir_math.py, more than 99.5% of lanes), rtol 1e-3 there,
as a last-ulp difference in a p_hat moves W by up to ~3e-4
(torch_parity.check_reservoir). Each JAX gradient is its own compile:
one compile of several gradients can round a tied channel apart
(tests/torch_grad_cases.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops.pallas_gather import _onehot_gather_multi_bwd
from sunray_tpu.ops.pallas_image import atrous_denoise_tpu, taa_clamp_blend_tpu
from sunray_tpu.render import postprocess as jpost
from sunray_tpu.render import restir as jr
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_gather, cuda_image, fp
from sunray_tpu_torch.render import postprocess as ppost
from sunray_tpu_torch.render import restir as pr
from torch_parity import WINNER_AGREE, n, t, to_numpy


def _close(got, want, rtol=1e-4, floor=1e-6, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()),
                               err_msg=err_msg)


def _ct(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- ops/fp ------------------------------------------------------------------

FMA_CASES = {
    "same": ((64, 3), (64, 3), (64, 3)),
    "broadcast": ((64, 1), (64, 3), (3,)),
    "scalar_a": (None, (64, 3), (64, 3)),
    "scalar_b": ((64, 3), None, (64, 3)),
    "scalar_c": ((64,), (64,), None),
    "zero_dim": ((), (64,), (64,)),
}


@pytest.mark.parametrize("case", sorted(FMA_CASES))
def test_fma_backward_bit_equal_to_float32(case):
    """fma's gradients are those of float32 a * b + c bit for bit (the
    float64 product of two float32 values is exact), with scalars acting
    as float32 constants and broadcast operands summed to their shapes."""
    rng = np.random.default_rng(len(case))
    shapes = FMA_CASES[case]
    ops = [0.3 if s is None else torch.from_numpy(_ct(rng, s)) for s in shapes]
    leaves = [x.clone().requires_grad_() if torch.is_tensor(x) else x
              for x in ops]
    ref = [x.clone().requires_grad_() if torch.is_tensor(x) else
           float(np.float32(x)) for x in ops]
    out = fp.fma(*leaves)
    want = ref[0] * ref[1] + ref[2]
    ct = torch.from_numpy(_ct(rng, tuple(out.shape)))
    got = torch.autograd.grad(out, [x for x in leaves if torch.is_tensor(x)],
                              ct)
    exp = torch.autograd.grad(want, [x for x in ref if torch.is_tensor(x)], ct)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    # The forward is the plain float64 expression's, bit for bit.
    with torch.no_grad():
        assert torch.equal(out, fp.fma(*ops))


def test_sqrt_backward_matches_jax():
    """fp.sqrt's gradient is JAX's g * (0.5 / sqrt(x)), from the correctly
    rounded root; the CPU correction keeps no float64 copies."""
    rng = np.random.default_rng(3)
    x = rng.uniform(1e-6, 10.0, 4096).astype(np.float32)
    ct = _ct(rng, x.shape)
    xt = t(x).requires_grad_()
    got = n(torch.autograd.grad(fp.sqrt(xt), xt, t(ct))[0])
    _, vjp = jax.vjp(jnp.sqrt, jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(vjp(jnp.asarray(ct))[0]))


# -- K8 ----------------------------------------------------------------------

@pytest.mark.parametrize("k,c,g", [(72, 6, 3), (36, 4, 1), (300, 11, 2)])
def test_gather_backward_matches_segment_sum(k, c, g):
    """The plain backward and the autograd Function's against the custom
    VJP of onehot_gather_cols_multi, with indices below 0 and above K - 1
    (they clamp). Per row within 1e-6 of its sum of |ct|."""
    rng = np.random.default_rng(k)
    nidx = 5003
    idx = rng.integers(-5, k + 5, size=(g, nidx)).astype(np.int32)
    ct = _ct(rng, (g, c, nidx))
    table = _ct(rng, (k, c))
    want, _ = _onehot_gather_multi_bwd((jnp.asarray(idx), k), jnp.asarray(ct))
    want = np.asarray(want).T                                   # (K, C)
    plain = n(cuda_gather.gather_rows_bwd_plain(t(ct), t(idx), k))
    tab = t(table).requires_grad_()
    out = cuda_gather.gather_rows(tab, t(idx))
    fn = n(torch.autograd.grad(out, tab, t(ct))[0])
    scale = n(cuda_gather.gather_rows_bwd_plain(t(np.abs(ct)), t(idx), k))
    for got in (plain, fn):
        assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)
    assert np.abs(want).max() > 0.0


def test_gather_int_table_has_no_gradient():
    """An int32 table never gets a backward; a float table that requires
    grad gets the Function, one that does not the plain gather."""
    tab = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    idx = torch.tensor([[0, 3, 9]], dtype=torch.int32)
    assert not cuda_gather.gather_rows(tab, idx).requires_grad
    ft = torch.ones((4, 3), requires_grad=True)
    assert cuda_gather.gather_rows(ft, idx).grad_fn is not None
    with torch.no_grad():
        assert cuda_gather.gather_rows(ft, idx).grad_fn is None


# -- K7, K9 ------------------------------------------------------------------

class _Ctx:
    """The saved state of an autograd Function's forward, for calling its
    backward on the CPU (the forward is the kernel, card only)."""

    def __init__(self, saved, **attrs):
        self.saved_tensors = saved
        self.__dict__.update(attrs)


def _guides(h, w, seed):
    rng = np.random.default_rng(seed)
    color = (rng.uniform(size=(h, w, 3)) * 2.0).astype(np.float32)
    depth = (1.0 + 3.0 * rng.uniform(size=(h, w))).astype(np.float32)
    depth[: h // 8] = 100000.0
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    normal[:, w // 2:] = (0.0, 1.0, 0.0)
    normal += rng.normal(size=normal.shape).astype(np.float32) * 0.05
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    rough = rng.uniform(size=(h, w)).astype(np.float32)
    diffuse = rng.uniform(size=(h, w, 3)).astype(np.float32)
    diffuse[::7, ::5] = 0.0
    return color, depth, normal, rough, diffuse


@pytest.mark.parametrize("passes", [1, 3])
def test_atrous_function_backward_matches_custom_vjp(passes):
    guides = _guides(24, 40, seed=passes)
    ct = _ct(np.random.default_rng(passes), (24, 40, 3))
    _, vjp = jax.vjp(lambda *g: atrous_denoise_tpu(*g, passes),
                     *(jnp.asarray(a) for a in guides))
    want = vjp(jnp.asarray(ct))
    got = cuda_image._Atrous.backward(
        _Ctx(tuple(t(a) for a in guides), passes=passes), t(ct))
    assert got[-1] is None
    for name, g, w in zip(("color", "depth", "normal", "roughness",
                           "diffuse"), got, want):
        # roughness only selects the bypass: no gradient (None) in the port.
        g = np.zeros(w.shape, np.float32) if g is None else n(g)
        # A floor of 1e-3 of the largest entry: the diffuse gradient is a
        # cancellation (the illumination is color / diffuse, multiplied
        # back by the diffuse), and JAX's own custom VJP and jitted jnp VJP
        # differ there by 2.5e-5, 7e-4 of the largest entry.
        _close(g, w, rtol=1e-3, floor=1e-3, err_msg=name)


@pytest.mark.parametrize("mask", ["random", "none"])
def test_taa_function_backward_matches_custom_vjp(mask):
    rng = np.random.default_rng(7)
    h, w = 32, 48
    raw = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    raw[h // 3:h // 2, w // 4:w // 2] *= 20.0
    hist = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    hist[::3] = raw[::3]                         # history equal to raw: ties
    use = rng.random((h, w)) > 0.3 if mask == "random" else np.ones((h, w),
                                                                   bool)
    ct = _ct(rng, (h, w, 3))
    _, vjp = jax.vjp(lambda r, hs: taa_clamp_blend_tpu(
        r, hs, jnp.asarray(use, jnp.float32), 0.14), jnp.asarray(raw),
        jnp.asarray(hist))
    want = vjp(jnp.asarray(ct))
    got = cuda_image._TaaClampBlend.backward(
        _Ctx((t(raw), t(hist), t(use)), factor=0.14), t(ct))
    assert got[2] is None and got[3] is None
    for name, g, wnt in zip(("raw", "hist"), got, want):
        _close(n(g), wnt, err_msg=name)


# -- ReSTIR ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jlights():
    return jr.Lights(jcornell_box())


@pytest.fixture(scope="module")
def lights():
    return pr.Lights(convert.scene_from_numpy(to_numpy(jcornell_box()),
                                              device="cpu"))


def _tie_surfaces(p, seed):
    """Lanes on the box's floor and back wall: two thirds white (0.73 in
    every channel, the Cornell white: exact ties in each max over the
    target function's channels under the white light), rough 1 and
    metallic 0 as on the box, the rest random."""
    rng = np.random.default_rng(seed)
    floor = rng.random(p) < 0.5
    pos = np.where(floor[:, None],
                   np.stack([rng.uniform(0.1, 1.9, p), np.zeros(p),
                             rng.uniform(0.1, 1.9, p)], 1),
                   np.stack([rng.uniform(0.1, 1.9, p),
                             rng.uniform(0.1, 1.9, p), np.zeros(p)], 1))
    normal = np.where(floor[:, None], np.float32([0, 1, 0]),
                      np.float32([0, 0, 1]))
    view = np.float32([1.0, 1.0, 3.4]) - pos
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    white = rng.random(p) < 2 / 3
    albedo = np.where(white[:, None], np.float32(0.73),
                      rng.uniform(0, 1, (p, 3)))
    rough = np.where(white, 1.0, rng.uniform(0.25, 1, p))
    metal = np.where(white, 0.0, rng.uniform(0, 1, p))
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return dict(pos=f32(pos), normal=f32(normal), view=f32(view),
                albedo=f32(albedo), rough=f32(rough), metal=f32(metal),
                seed=rng.integers(0, 2**32, p, dtype=np.uint32),
                enable=rng.random(p) > 0.1, white=white)


ATTRS = ("pos", "normal", "view", "albedo", "rough", "metal")
DIFF = ("pos", "normal", "albedo")      # the inputs differentiated


def _port_grads(fn, s, outs, cts):
    """Gradients of sum(out * ct) over `outs` w.r.t. DIFF, port side."""
    leaves = {k: t(s[k]).requires_grad_() for k in DIFF}
    args = [leaves[k] if k in leaves else t(s[k]) for k in ATTRS]
    res = fn(*args)
    total = sum((res[o] * t(c)).sum() for o, c in zip(outs, cts))
    return res, {k: n(g) for k, g in zip(
        DIFF, torch.autograd.grad(total, list(leaves.values())))}


def _jax_grads(fn, s, outs, cts):
    """The same with JAX, one compile for each input."""
    grads = {}
    for k in DIFF:
        def loss(x, k=k):
            args = [x if a == k else jnp.asarray(s[a]) for a in ATTRS]
            res = fn(*args)
            return sum(jnp.sum(res[o] * c) for o, c in zip(outs, cts))
        grads[k] = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(s[k])))
    return grads


def _check_reservoir_grads(pres, jres, pg, jg, idx="light_idx"):
    same = n(pres[idx]) == np.asarray(jres[idx])
    assert same.mean() > WINNER_AGREE, same.mean()
    for k in DIFF:
        _close(pg[k][same], jg[k][same], rtol=1e-3, floor=1e-5, err_msg=k)
    return same


def test_ris_audition_vjp_matches_jnp(jlights, lights):
    s = _tie_surfaces(4096, seed=11)
    rng = np.random.default_rng(12)
    outs = ("W", "w_sum", "light_pos")
    cts = [_ct(rng, (4096,)), _ct(rng, (4096,)), _ct(rng, (4096, 3))]
    en = s["enable"]

    def port(*a):
        _, res = pr.ris_audition(lights, t(s["seed"].astype(np.int64)), *a,
                                 8, t(en), kernel=False)
        return vars(res)

    def jfn(*a):
        _, res = jr.ris_audition(jlights, s["seed"], *a, 8, jnp.asarray(en),
                                 kernel="jnp")
        return dataclasses.asdict(res)

    pres, pg = _port_grads(port, s, outs, cts)
    jres = jax.jit(lambda: jfn(*(jnp.asarray(s[a]) for a in ATTRS)))()
    same = _check_reservoir_grads(pres, jres, pg, _jax_grads(jfn, s, outs,
                                                             cts))
    assert (same & s["white"] & en).sum() > 1000


def _temporal_case(p, seed):
    s = _tie_surfaces(p, seed)
    rng = np.random.default_rng(seed + 1)
    w, h = 64, p // 64
    ys, xs = np.divmod(np.arange(p), w)
    s["prev_uv"] = np.stack([(xs + 0.5 + rng.normal(0, 0.7, p)) / w,
                             (ys + 0.5 + rng.normal(0, 0.7, p)) / h],
                            -1).astype(np.float32)
    s["prev_valid"] = rng.random(p) > 0.1
    s["vd"] = rng.uniform(1, 4, p).astype(np.float32)
    s["w"], s["h"] = w, h
    return s


def _history_di(s, seed):
    """Last frame's DI reservoirs on the light, normals and depths near
    each lane's own (so the confidence gates pass on many lanes)."""
    rng = np.random.default_rng(seed)
    p = s["vd"].shape[0]
    hn = s["normal"] + rng.normal(0, 0.03, (p, 3))
    return dict(
        light_pos=(rng.uniform(0.75, 1.25, (p, 3))
                   * np.float32([1, 0, 1]) + np.float32([0, 1.98, 0])
                   ).astype(np.float32),
        w_sum=rng.uniform(0, 5, p).astype(np.float32),
        light_normal=np.tile(np.float32([0, -1, 0]), (p, 1)),
        M=rng.uniform(0, 25, p).astype(np.float32),
        light_idx=rng.integers(0, 2, p).astype(np.int32),
        W=np.where(rng.random(p) > 0.2, rng.uniform(0, 30, p), 0.0
                   ).astype(np.float32),
        hit_normal=(hn / np.linalg.norm(hn, axis=1, keepdims=True)
                    ).astype(np.float32),
        depth=(s["vd"] * rng.uniform(0.9, 1.1, p)).astype(np.float32),
    )


def test_di_temporal_vjp_matches_jnp(jlights, lights):
    p = 64 * 48
    s = _temporal_case(p, seed=21)
    rng = np.random.default_rng(22)
    cur = _history_di(s, 23)
    hist = _history_di(s, 24)
    cfg, jcfg = RenderConfig(differentiable=True), JConfig(differentiable=True)
    outs = ("W", "w_sum")
    cts = [_ct(rng, (p,)), _ct(rng, (p,))]
    en = s["enable"]
    common = (s["prev_uv"], s["prev_valid"])

    def port(pos, normal, view, albedo, rough, metal):
        _, res = pr.di_temporal_reuse(
            lights, cfg, t(s["seed"].astype(np.int64)),
            pr.ReservoirDI(**{k: t(v) for k, v in cur.items()}),
            pr.ReservoirDI(**{k: t(v) for k, v in hist.items()}),
            *(t(x) for x in common), torch.tensor(3, dtype=torch.int32),
            pos, normal, view, albedo, rough, metal, t(s["vd"]), s["w"],
            s["h"], t(en))
        return vars(res)

    def jfn(*a):
        _, res = jr.di_temporal_reuse(
            jlights, jcfg, s["seed"], jr.ReservoirDI(**cur),
            jr.ReservoirDI(**hist), *common, jnp.int32(3), *a, s["vd"],
            s["w"], s["h"], jnp.asarray(en))
        return dataclasses.asdict(res)

    pres, pg = _port_grads(port, s, outs, cts)
    jres = jax.jit(lambda: jfn(*(jnp.asarray(s[a]) for a in ATTRS)))()
    same = _check_reservoir_grads(pres, jres, pg, _jax_grads(jfn, s, outs,
                                                             cts))
    # The merge took the history on a good share of the tied lanes.
    took = n(pres["M"]) > cur["M"]
    assert (took & same & s["white"]).sum() > 300


def test_gi_temporal_vjp_matches_jnp():
    p = 64 * 48
    s = _temporal_case(p, seed=31)
    rng = np.random.default_rng(32)

    def gi_res(seed):
        r = np.random.default_rng(seed)
        d = _history_di(s, seed)
        return dict(
            sample_pos=r.uniform(0.1, 1.9, (p, 3)).astype(np.float32),
            w_sum=d["w_sum"], M=d["M"], W=d["W"], hit_normal=d["hit_normal"],
            depth=d["depth"],
            # White radiance at the clamp (5, 5, 5) on half the lanes.
            sample_radiance=np.where(r.random((p, 1)) < 0.5, np.float32(5.0),
                                     r.uniform(0, 5, (p, 3))
                                     ).astype(np.float32),
            sample_normal=np.tile(np.float32([0, 1, 0]), (p, 1)),
            sample_tri=r.integers(-1, 36, p).astype(np.int32))

    cur, hist = gi_res(33), gi_res(34)
    cfg, jcfg = RenderConfig(differentiable=True), JConfig(differentiable=True)
    outs = ("W", "w_sum", "sample_radiance")
    cts = [_ct(rng, (p,)), _ct(rng, (p,)), _ct(rng, (p, 3))]
    en = s["enable"]
    common = (s["prev_uv"], s["prev_valid"])

    def port(pos, normal, view, albedo, rough, metal):
        _, res = pr.gi_temporal_reuse(
            cfg, t(s["seed"].astype(np.int64)),
            pr.ReservoirGI(**{k: t(v) for k, v in cur.items()}),
            pr.ReservoirGI(**{k: t(v) for k, v in hist.items()}),
            *(t(x) for x in common), torch.tensor(5, dtype=torch.int32),
            pos, normal, albedo, metal, t(s["vd"]), s["w"], s["h"], t(en))
        return vars(res)

    def jfn(pos, normal, view, albedo, rough, metal):
        _, res = jr.gi_temporal_reuse(
            jcfg, s["seed"], jr.ReservoirGI(**cur), jr.ReservoirGI(**hist),
            *common, jnp.int32(5), pos, normal, albedo, metal, s["vd"],
            s["w"], s["h"], jnp.asarray(en))
        return dataclasses.asdict(res)

    pres, pg = _port_grads(port, s, outs, cts)
    jres = jax.jit(lambda: jfn(*(jnp.asarray(s[a]) for a in ATTRS)))()
    _check_reservoir_grads(pres, jres, pg, _jax_grads(jfn, s, outs, cts),
                           idx="sample_tri")


def test_spatial_reuse_vjp_matches_jax():
    """Phase B (DI and GI spatial reuse with their shared taps, and the
    final resolve) on the inputs of a differentiable frame of
    tests/torch_grad_cases.py: the radiance's VJP w.r.t. the frozen hits'
    albedo, throughput and position, on more than 99.5% of lanes within
    rtol 1e-3 (a lane whose winner differs by a take-flip differs)."""
    from sunray_tpu.camera import Camera as JCamera
    from sunray_tpu.camera import camera_matrices as jcm
    from sunray_tpu.render import pathtrace as jpt
    from sunray_tpu.render.gbuffer import GBuffer as JGBuffer
    from sunray_tpu.render.trace import make_tracer as jmake_tracer
    from sunray_tpu_torch.render import pathtrace as ppt
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from torch_grad_cases import GRAD_KW, H, W, port_mats
    from torch_parity import CAMERA

    kw = dict(GRAD_KW, lighting="restir")
    cfg, jcfg = RenderConfig(**kw), JConfig(**kw)
    jscene = jcornell_box()
    scene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    captured = {}
    orig = ppt._spatial_reuse

    def capture(*args):
        captured["args"] = args
        return orig(*args)

    ppt._spatial_reuse = capture
    try:
        with torch.no_grad():
            render_frame(scene, cfg, RenderState.create(cfg, "cpu"),
                         port_mats())
    finally:
        ppt._spatial_reuse = orig
    (_, tracer, plights, mats, gbuf, r_di, r_gi, seed, c, cam_origin,
     fc) = captured["args"]

    def j(x):
        return jnp.asarray(n(x))

    jargs = (jscene, jcfg, jmake_tracer(jscene, jcfg), jr.Lights(jscene),
             jcm(JCamera(**CAMERA), W, H), JGBuffer(*(j(x) for x in gbuf)),
             jr.ReservoirDI(**{k: j(v) for k, v in vars(r_di).items()}),
             jr.ReservoirGI(**{k: j(v) for k, v in vars(r_gi).items()}),
             jnp.asarray(n(seed).astype(np.uint32)))
    jc = {k: (j(v) if torch.is_tensor(v) else v) for k, v in c.items()}
    radiance = jc["radiance"]
    ct = _ct(np.random.default_rng(41), (W * H, 3))
    keys = ("f_albedo", "f_throughput", "f_pos")
    leaves = {k: c[k].clone().requires_grad_() for k in keys}
    out = orig(cfg, tracer, plights, mats, gbuf, r_di, r_gi, seed,
               dict(c, **leaves), cam_origin, fc)
    got = torch.autograd.grad((out * t(ct)).sum(), list(leaves.values()))
    for k, g in zip(keys, got):
        def loss(x, k=k):
            # JAX's _spatial_reuse returns the walk's radiance plus phase
            # B's; the walk's part is a constant here.
            res = jpt._spatial_reuse(*jargs, dict(jc, **{k: x}),
                                     j(cam_origin), jnp.int32(int(fc)))
            return jnp.sum((res - radiance) * ct)
        want = np.asarray(jax.jit(jax.grad(loss))(jc[k]))
        g = n(g)
        assert np.isfinite(g).all() == np.isfinite(want).all()
        live = np.isfinite(want).all(-1)
        atol = 1e-5 * np.abs(want[live]).max()
        close = np.isclose(g, want, rtol=1e-3, atol=atol).all(-1)
        assert close[live].mean() > WINNER_AGREE, (k, close[live].mean())
        assert np.abs(g[live]).max() > 0.0


# -- tonemap -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["aces", "aces_srgb", "none"])
def test_tonemap_vjp_at_clip_bounds(mode):
    """Values exactly at the clips' bounds (0, 1 and 100) beside random
    ones: the gradient there is jnp.clip's half."""
    rng = np.random.default_rng(5)
    color = (rng.uniform(size=(16, 16, 3)) * 2.0).astype(np.float32)
    color[::4] = 1.0
    color[1::4] = 0.0
    color[2::8] = 100.0
    ct = _ct(rng, color.shape)
    _, vjp = jax.vjp(lambda c: jpost.tonemap(c, 1.0, mode, 2.2),
                     jnp.asarray(color))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    x = t(color).requires_grad_()
    got = n(torch.autograd.grad(ppost.tonemap(x, 1.0, mode, 2.2), x,
                                t(ct))[0])
    _close(got, want, rtol=1e-5, floor=1e-7)
    if mode == "none":
        at_one = color == 1.0
        assert np.abs(got[at_one]).max() > 0.0
