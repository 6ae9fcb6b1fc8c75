"""Shared set-up of the frame parity tests of the configurations added
beside the default ones (tests/test_torch_frame_{samples,perpixel,bf16}.py,
tests/test_torch_many_lights.py): the JAX render_frame jitted and the
port's render_frame on the same scene and matrices, frame by frame."""

import jax
import numpy as np

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_trace
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from torch_parity import CAMERA, n, to_numpy


def run_frames(kw, frames, jscene=None):
    """`frames` frames of both packages with RenderConfig(**kw) on jscene
    (default: the Cornell box). Returns a dict of per-frame lists: "jax"
    (ldr, aux, state as numpy), "port" (ldr as numpy, aux, state) and
    "rays" (the port's traced rays a frame), and the config."""
    jscene = jcornell_box() if jscene is None else jscene
    jcfg = JConfig(**kw)
    jmats = jcamera_matrices(JCamera(**CAMERA), jcfg.width, jcfg.height)
    step = jax.jit(lambda st: jrender_frame(jscene, jcfg, st, jmats))
    jstate = JState.create(jcfg)
    cfg = RenderConfig(**kw)
    scene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    mats = convert.mats_from_numpy({k: np.asarray(v)
                                    for k, v in jmats.items()}, device="cpu")
    state = RenderState.create(cfg, device="cpu")
    out = dict(jax=[], port=[], rays=[], cfg=cfg, scene=scene, mats=mats)
    for _ in range(frames):
        jstate, jldr, jaux = step(jstate)
        before = sum(cuda_trace.rays.values())
        state, ldr, aux = render_frame(scene, cfg, state, mats)
        out["rays"].append(sum(cuda_trace.rays.values()) - before)
        out["jax"].append((np.asarray(jldr),
                           {k: np.asarray(v) for k, v in jaux.items()},
                           to_numpy(jstate)))
        out["port"].append((n(ldr), aux, state))
    return out


def port_frame(frames, **changes):
    """The port's first frame (ldr, aux) of run_frames' scene and matrices
    with the config changed by `changes`, from a fresh state."""
    import dataclasses

    cfg = dataclasses.replace(frames["cfg"], **changes)
    _, ldr, aux = render_frame(frames["scene"], cfg,
                               RenderState.create(cfg, device="cpu"),
                               frames["mats"])
    return n(ldr), aux


def reservoir_agreement(state, jstate, res, win, pos):
    """Share of lanes of the reservoir `res` that the port's state and the
    JAX state hold with the same winner, position within 1e-5 and W
    within 3e-4 (the take-flip scheme of tests/test_restir_math.py,
    counted over lanes as tests/test_torch_frame_restir.py counts it);
    M must be equal."""
    mine, want = getattr(state, res), jstate[res]
    np.testing.assert_array_equal(n(mine.M), want["M"], err_msg=f"{res}.M")
    same = ((n(getattr(mine, win)) == want[win])
            & np.isclose(n(getattr(mine, pos)), want[pos], rtol=1e-5,
                         atol=1e-6).all(-1)
            & np.isclose(n(mine.W), want["W"], rtol=3e-4, atol=1e-5))
    return same.mean()


def phase_b_case(kw, frames=3):
    """Phase B on live inputs: the arguments of the port's _spatial_reuse
    in frame `frames` of the Cornell box with RenderConfig(**kw), run
    through the JAX _spatial_reuse (its final radiance add intercepted to
    expose the DI and GI results) and through the port's. Returns a dict:
    "args" (the port's arguments), "out" / "jout" (the radiance each
    adds), "jparts" (JAX's DI and GI results), "cfg"."""
    import jax.numpy as jnp
    import torch

    from sunray_tpu.render import pathtrace as jpt
    from sunray_tpu.render import restir as jr
    from sunray_tpu.render.gbuffer import GBuffer as JGBuffer
    from sunray_tpu.render.trace import make_tracer as jmake_tracer
    from sunray_tpu_torch.render import pathtrace as ppt

    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jcornell_box()
    jmats = jcamera_matrices(JCamera(**CAMERA), jcfg.width, jcfg.height)
    scene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    mats = convert.mats_from_numpy({k: np.asarray(v) for k, v in jmats.items()},
                                   device="cpu")
    captured = {}
    orig = ppt._spatial_reuse

    def capture(*args):
        captured["args"] = args
        captured["out"] = orig(*args)
        return captured["out"]

    ppt._spatial_reuse = capture
    try:
        state = RenderState.create(cfg, device="cpu")
        for _ in range(frames):
            state, _, _ = render_frame(scene, cfg, state, mats)
    finally:
        ppt._spatial_reuse = orig
    (_, tracer, lights, _, gbuf, r_di, r_gi, seed, c, cam_origin,
     fc) = captured["args"]

    def j(x):
        return jnp.asarray(n(x))

    jl = jr.Lights(jscene)
    jtr = jmake_tracer(jscene, jcfg)
    jgbuf = JGBuffer(*(j(x) for x in gbuf))
    jrdi = jr.ReservoirDI(**{k: j(v) for k, v in vars(r_di).items()})
    jrgi = jr.ReservoirGI(**{k: j(v) for k, v in vars(r_gi).items()})
    jc = {k: (j(v) if torch.is_tensor(v) else v) for k, v in c.items()}
    stash = {}
    orig_add = jpt._gi_radiance_add

    def fake_add(radiance, tracer, pos, sdir, sdist, di_exclude, has, facing,
                 f_y_w, w_spatial, throughput, gdir, gdist, gi_tri, try_gi,
                 contrib_pre, p):
        stash.update(di_exclude=di_exclude, has=has, f_y_w=f_y_w,
                     w_spatial=w_spatial, gdir=gdir, gdist=gdist,
                     sample_tri=gi_tri, try_gi=try_gi,
                     contrib_pre=contrib_pre)
        return orig_add(radiance, tracer, pos, sdir, sdist, di_exclude, has,
                        facing, f_y_w, w_spatial, throughput, gdir, gdist,
                        gi_tri, try_gi, contrib_pre, p)

    def run(sd, cc):
        jpt._gi_radiance_add = fake_add
        try:
            out = jpt._spatial_reuse(jscene, jcfg, jtr, jl, jmats, jgbuf,
                                     jrdi, jrgi, sd, cc, j(cam_origin),
                                     jnp.int32(int(fc)))
        finally:
            jpt._gi_radiance_add = orig_add
        return out, dict(stash)

    seed_u32 = jnp.asarray(n(seed).astype(np.uint32))
    jout, jparts = jax.jit(run)(seed_u32, jc)
    return dict(args=captured["args"], out=captured["out"], jout=jout,
                jparts={k: np.asarray(v) for k, v in jparts.items()},
                cfg=cfg)
