"""PyTorch port, alpha cutout in render/trace.py: closest hits and
occlusion through a MASK material's texture alpha (any_hit.slang), equal
to JAX's trace_closest / trace_occluded on the masked two-quad scene of
tests/test_alpha_cutout.py and on a stack of cutout layers (more layers
than alpha_rounds), over the brute, unified BVH and two-level tracers,
with exclude ids; and the opaque path when the flag is off."""

import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops import bvh2 as jbvh2
from sunray_tpu.render import trace as jtrace
from sunray_tpu.scene import types as jtypes
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import bvh2
from sunray_tpu_torch.render import trace
from test_alpha_cutout import masked_scene
from torch_parity import n, t, to_numpy


def layered_scene(layers=6):
    """`layers` cutout quads (checker alpha, each shifted) in front of an
    opaque back quad: rays pass more cutouts than alpha_rounds allows."""
    pos, tris, prim, uvs = [], [], [], []
    for k in range(layers + 1):
        z = float(layers - k)
        s = 2.0 if k == layers else 1.0
        base = len(pos)
        pos += [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]
        tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        prim += [0 if k < layers else 1] * 2
        sh = 0.13 * k
        uvs += [[sh, 0], [1 + sh, 0], [1 + sh, 1], [sh, 1]]
    pos = np.asarray(pos, np.float32)
    uv = np.zeros((pos.shape[0], 5, 2), np.float32)
    uv[:, :, :] = np.asarray(uvs, np.float32)[:, None, :]
    tex = np.ones((1, 8, 8, 4), np.float32)
    tex[0, :, :, 3] = (np.add.outer(np.arange(8), np.arange(8)) % 2)
    atlas = jtypes.TextureAtlas(data=jnp.asarray(tex),
                                size=jnp.asarray([[8, 8]], jnp.int32),
                                wrap=jnp.zeros((1, 2), jnp.int32),
                                filt=jnp.zeros((1,), jnp.int32))
    mats = jtypes.MaterialTable.build([
        {"alpha_mode": jtypes.ALPHA_MASK, "alpha_cutoff": 0.5,
         "tex_index": [0, -1, -1, -1, -1]},
        {"base_color": (0.5, 0.5, 0.5, 1.0)}])
    return jtypes.build_scene(
        pos, np.tile(np.float32([[0, 0, 1]]), (pos.shape[0], 1)),
        np.asarray(tris, np.int32), np.asarray(prim, np.int32), mats,
        instances=[(0, jtypes.identity_transform()),
                   (1, jtypes.identity_transform())], uvs=uv, textures=atlas)


def rays(count=400, seed=0):
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(-1.2, 1.2, count), g.uniform(-1.2, 1.2, count),
                  np.full(count, 8.0)], 1).astype(np.float32)
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (count, 1))
    d[::3, 0] = 0.05
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, g.uniform(2.0, 9.5, count).astype(np.float32)


def tracers(jscene, tracer):
    """(JAX tracer ctx, port tracer ctx) of one backend."""
    pscene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    kw = dict(width=8, height=8, alpha_mask_tracing=True, tracer=tracer)
    jacc = pacc = None
    if tracer == "bvh2":
        jacc = jbvh2.build_blas_set(jscene, leaf_size=2)
        pacc = bvh2.build_blas_set(pscene, leaf_size=2)
    return (jtrace.make_tracer(jscene, JConfig(**kw, bvh_leaf_size=2), jacc),
            trace.make_tracer(pscene, RenderConfig(**kw, bvh_leaf_size=2), pacc))


@pytest.mark.parametrize("tracer", ["brute", "bvh", "bvh2"])
@pytest.mark.parametrize("which", ["masked", "layered"])
def test_alpha_matches_jax(which, tracer):
    jscene = masked_scene() if which == "masked" else layered_scene()
    jctx, pctx = tracers(jscene, tracer)
    assert (pctx.walk is not None) == (tracer != "brute")
    o, d, tmax = rays()
    jh = jtrace.trace_closest(jctx, jnp.asarray(o), jnp.asarray(d))
    ph = trace.trace_closest(pctx, t(o), t(d))
    np.testing.assert_array_equal(n(ph.hit), np.asarray(jh.hit))
    np.testing.assert_array_equal(n(ph.tri)[n(ph.hit)],
                                  np.asarray(jh.tri)[np.asarray(jh.hit)])
    np.testing.assert_allclose(n(ph.t), np.asarray(jh.t), atol=1e-5, rtol=0)
    ex = np.where(np.arange(o.shape[0]) % 2 == 0,
                  np.where(n(ph.hit), n(ph.tri), -1), -1).astype(np.int32)
    for exclude in (None, ex):
        jo = jtrace.trace_occluded(
            jctx, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
            exclude=None if exclude is None else jnp.asarray(exclude))
        po = trace.trace_occluded(pctx, t(o), t(d), t(tmax),
                                  exclude=None if exclude is None
                                  else t(exclude))
        np.testing.assert_array_equal(n(po), np.asarray(jo))


def test_opaque_without_flag():
    """With alpha_mask_tracing off the cutout quad is opaque, as in JAX."""
    pscene = convert.scene_from_numpy(to_numpy(masked_scene()), device="cpu")
    ctx = trace.make_tracer(pscene, RenderConfig(width=8, height=8,
                                                 tracer="brute"))
    assert ctx.alpha is None
    h = trace.trace_closest(ctx, t(np.float32([[-0.5, -0.2, 3.0]])),
                            t(np.float32([[0.0, 0.0, -1.0]])))
    np.testing.assert_allclose(n(h.t), [2.0], rtol=1e-4)
