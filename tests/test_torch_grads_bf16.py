"""PyTorch port, the differentiable ReSTIR frame with bf16 shading
attributes (shading_dtype="bf16", differentiable=True) against JAX's
value_and_grad on the CPU, and the VJPs of the four bf16 target functions
(ops/brdf.py: eval_unshadowed_light, gi_target_pdf, eval_p_hat_planar,
gi_target_pdf_planar) against jax.vjp.

The frame is tests/torch_grad_cases.py's 32x24 Cornell box (TAA and
denoise off) with lighting="restir"; the JAX gradients come from one
jax.jit of value_and_grad w.r.t. base_color, metallic and positions
together. Bars as in test_torch_grads_restir.py: loss 1e-5 relative,
gradients rtol 1e-4 with a floor of 1e-6 of the largest entry, NaN masks
equal. One row is held another way: the white material's base_color
(0.73, 0.73, 0.73 under the white light) ties its three channels in every
channel max of the target functions, and a joint compile with the
positions rounds one tied channel apart (tests/test_torch_grads_tie.py,
the float32 frame): the row moves by a * (1, 1, -2). Its channel sum,
which no split of the tie changes, is held to the bar, and the move to
that pattern.

The port's bf16 backwards (the _*Bf16 Functions of ops/brdf.py) round the
material cotangents where XLA's CPU compile of the JAX VJP rounds them;
a differentiable frame carries the attributes as ops/brdf.bf16_carrier
and passes bf16=True. On the seeded inputs here (a quarter of the lanes
white, a third with metallic 0), the albedo and metallic cotangents equal
JAX's rounded to bf16 on every lane (bit-equal to JAX's own where JAX
rounds: the planar forms, gi_target_pdf's metallic). The normal, view and
roughness cotangents run through bf16 chains (NdotV, the Smith and GGX
terms) whose backward roundings are autograd's, and agree bit for bit on
47-100% of lanes (printed with -s). Every lane is held within two bf16
ulps (2^-7 relative) and a floor of 1e-3 of the largest entry, plus an
eighth of the distance between JAX's bf16 cotangent and its float32 one
(the same function on float32 attributes): where the GGX D and Smith
terms' cotangents cancel, JAX's bf16 roughness cotangent is itself far
from the float32 one (42.5 against 231.6 on the worst lane here, the
port 46.25: one ulp of the cancelling terms); the largest share of that
distance used, measured, is 0.017. The float32 inputs' cotangents are
held within 2e-3. The forward values,
bit-equal to JAX's jitted forward on 89-100% of lanes here, are held
within 1e-4 relative, tests/test_torch_restir_bf16.py's bar for a target
function compiled alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops import brdf as jbrdf
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu_torch.ops import brdf
from torch_grad_cases import (
    GRAD_KW,
    H,
    LOSS_RTOL,
    PARAMS,
    W,
    assert_grads_close,
    jax_scene,
    port_value_and_grads,
)
from torch_parity import CAMERA

KW = dict(lighting="restir", shading_dtype="bf16")
WHITE = 0                  # scene/procedural.py's first material
TIE_FLOOR = 5e-4           # the joint compile's move, measured at 2.42e-3


@pytest.fixture(scope="module")
def grads():
    cfg = JConfig(**dict(GRAD_KW, **KW))
    scene = jax_scene()
    mats = jcamera_matrices(JCamera(**CAMERA), W, H)

    def loss(base_color, metallic, positions):
        sc = scene.replace(
            materials=scene.materials.replace(base_color=base_color,
                                              metallic=metallic),
            positions=positions)
        _, ldr, _ = jrender_frame(sc, cfg, JState.create(cfg), mats)
        return jnp.mean(ldr)

    value, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        scene.materials.base_color, scene.materials.metallic,
        scene.positions)
    jax_out = (float(value), {k: np.asarray(x) for k, x in zip(PARAMS, g)})
    return jax_out, port_value_and_grads(**KW)


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    (_, jg), (_, pg) = grads
    got, want = pg[param], jg[param]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if param == "base_color":
        rows = [r for r in range(got.shape[0]) if r != WHITE]
        atol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(got[rows], want[rows], rtol=1e-4,
                                   atol=atol, err_msg=param)
        return
    assert_grads_close(got, want, param)


def test_white_row_is_the_joint_compile_tie(grads):
    (_, jg), (_, pg) = grads
    got, want = pg["base_color"][WHITE], jg["base_color"][WHITE]
    atol = 1e-6 * float(np.abs(jg["base_color"]).max())
    np.testing.assert_allclose(got[:3].sum(), want[:3].sum(), rtol=1e-4,
                               atol=atol, err_msg="channel sum")
    d = want[:3] - got[:3]
    a = float(d[0] + d[1] - 2.0 * d[2]) / 6.0
    assert abs(a) > TIE_FLOOR, d
    np.testing.assert_allclose(d, a * np.array([1.0, 1.0, -2.0]), rtol=1e-2,
                               err_msg="not a tie split")


# -- the four bf16 target functions' VJPs ------------------------------------

P, K = 4096, 4
BF16_ULPS = 2.0 ** -7      # two bf16 ulps, relative
BF16_FLOOR = 1e-3          # times the largest |cotangent|
NOISE_SHARE = 1.0 / 8.0    # of |JAX bf16 - JAX float32|, measured 0.017
ATTRS = ("normal", "view", "albedo", "rough", "metal")
F32_INPUTS = ("pos", "emission", "light_pos", "light_normal")


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def vjp_inputs(seed=18):
    """Seeded surfaces and lights; a quarter of the lanes white (0.73) under
    white light 15, a third with metallic 0 (the Cornell box's ties)."""
    g = np.random.default_rng(seed)
    pos = g.uniform(-1, 1, (P, 3)).astype(np.float32)
    normal = _unit(g, P)
    normal[:, 2] = np.abs(normal[:, 2])
    view = _unit(g, P)
    view = np.where((view * normal).sum(-1, keepdims=True) < 0, -view, view)
    albedo = g.uniform(0, 1, (P, 3)).astype(np.float32)
    albedo[:P // 4] = 0.73
    rough = g.uniform(0.2, 1, (P,)).astype(np.float32)
    metal = g.uniform(0, 1, (P,)).astype(np.float32)
    metal[:P // 3] = 0.0
    light_pos = (pos + _unit(g, P) * g.uniform(0.5, 3, (P, 1))).astype(
        np.float32)
    ln = _unit(g, P)
    light_normal = np.where(((light_pos - pos) * ln).sum(-1, keepdims=True)
                            > 0, -ln, ln).astype(np.float32)
    emission = g.uniform(1, 20, (P, 3)).astype(np.float32)
    emission[:P // 4] = 15.0
    return dict(pos=pos, normal=normal, view=view, albedo=albedo,
                rough=rough, metal=metal, light_pos=light_pos,
                light_normal=light_normal, emission=emission)


def call(mod, kind, d, cast, arange, expand, **kw):
    """The target function `kind` of module `mod` on d, the attributes cast
    to bf16 by `cast`; planar forms get K samples a lane, offset along x.
    kw: the port's bf16=True, which its carriers need."""
    b = {k: (cast(v) if k in ATTRS else v) for k, v in d.items()}
    if kind == "unshadowed":
        return mod.eval_unshadowed_light(
            b["pos"], b["normal"], b["view"], b["albedo"], b["rough"],
            b["metal"], b["emission"], b["light_pos"], b["light_normal"], **kw)
    if kind == "gi":
        return mod.gi_target_pdf(b["pos"], b["normal"], b["albedo"],
                                 b["metal"], b["light_pos"], b["emission"],
                                 **kw)

    def col(x, c):
        return x[:, c:c + 1]

    def samples(x, shift=False):
        return [expand(col(x, c)) + (0.1 * arange if shift else 0.0)
                for c in range(3)]

    surf = {k: [col(b[k], c) for c in range(3)]
            for k in ("pos", "normal", "view", "albedo")}
    if kind == "planar":
        return mod.eval_p_hat_planar(
            surf["pos"], surf["normal"], surf["view"], surf["albedo"],
            b["rough"][:, None], b["metal"][:, None], samples(b["emission"]),
            samples(b["light_pos"], True), samples(b["light_normal"]),
            **kw)[0]
    return mod.gi_target_pdf_planar(
        surf["pos"], surf["normal"], surf["albedo"], b["metal"][:, None],
        samples(b["light_pos"], True), samples(b["emission"]), **kw)


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def rb(x):
    return torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("kind", ["unshadowed", "gi", "planar", "gi_planar"])
def test_bf16_target_function_vjp(kind):
    d = vjp_inputs()
    names = list(d)
    j_ar = jnp.arange(K, dtype=jnp.float32)[:, None]
    t_ar = torch.arange(K, dtype=torch.float32)[:, None]

    def jf(*a):
        return call(jbrdf, kind, dict(zip(names, a)),
                    lambda x: x.astype(jnp.bfloat16), j_ar.T,
                    lambda x: jnp.broadcast_to(x, (P, K)))

    def jf32(*a):
        return call(jbrdf, kind, dict(zip(names, a)), lambda x: x, j_ar.T,
                    lambda x: jnp.broadcast_to(x, (P, K)))

    args = [jnp.asarray(d[k]) for k in names]
    out = np.asarray(jax.jit(jf)(*args))
    ct = np.random.default_rng(7).uniform(0.5, 2.0, out.shape).astype(
        np.float32)
    want = jax.jit(lambda *a: jax.vjp(jf, *a)[1](jnp.asarray(ct)))(*args)
    want32 = jax.jit(lambda *a: jax.vjp(jf32, *a)[1](jnp.asarray(ct)))(*args)
    leaves = [torch.from_numpy(d[k].copy()).requires_grad_() for k in names]
    got_out = call(brdf, kind, dict(zip(names, leaves)), brdf.bf16_carrier,
                   t_ar.T, lambda x: x.expand(P, K), bf16=True)
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(ct),
                              allow_unused=True)
    fwd_share = (bits(got_out.detach().numpy()) == bits(out)).mean()
    print(f"\n{kind}: forward bit-equal on {fwd_share:.4f} of lanes")
    np.testing.assert_allclose(got_out.detach().numpy(), out, rtol=1e-4,
                               atol=1e-7, err_msg="forward")
    for name, w, w32, g in zip(names, want, want32, got):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        share = (bits(g) == bits(w)).mean()
        print(f"  {name:13s} cotangent bit-equal on {share:.4f} of lanes")
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        if name in ("albedo", "metal"):
            np.testing.assert_array_equal(bits(g), bits(rb(w)), err_msg=name)
        elif name in F32_INPUTS:
            np.testing.assert_allclose(g, w, rtol=2e-3,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
        else:
            assert share > 0.4, (name, share)
            bar = (BF16_ULPS * np.abs(w) + BF16_FLOOR * np.abs(w).max()
                   + NOISE_SHARE * np.abs(w - np.asarray(w32)))
            worst = np.argmax(np.abs(g - w) - bar)
            assert np.all(np.abs(g - w) <= bar), (
                name, worst, g[worst], w[worst], np.asarray(w32)[worst])
