"""PyTorch port, ops/texture.py and the atlas helpers of scene/types.py:
sample_texture within 1e-6 of JAX's (jitted) for each wrap mode (repeat,
clamp, mirror, mixed per axis) and filter (nearest, bilinear) at negative,
out-of-range and texel-boundary uv, textures smaller than the atlas, the
NULL fallback; the trivial atlas's short-circuit; apply_wrap equal to
JAX's _apply_wrap; merge_atlases and translate equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sunray_tpu.ops import texture as jtex
from sunray_tpu.scene import types as jtypes
from sunray_tpu_torch import convert
from sunray_tpu_torch.ops import texture
from sunray_tpu_torch.scene import types
from torch_parity import n, t, to_numpy

ATOL = 1e-6


def atlas(wrap, filt, seed=0):
    """Three textures of 5x7, 8x4 and 3x3 texels in a 8x8 atlas."""
    g = np.random.default_rng(seed)
    data = np.zeros((3, 8, 8, 4), np.float32)
    sizes = [(5, 7), (8, 4), (3, 3)]
    for i, (w, h) in enumerate(sizes):
        data[i, :h, :w] = g.random((h, w, 4))
    fields = dict(data=data, size=np.asarray(sizes, np.int32),
                  wrap=np.asarray([wrap] * 3, np.int32),
                  filt=np.full(3, filt, np.int32))
    return jtypes.TextureAtlas(**{k: jnp.asarray(v) for k, v in fields.items()}), \
        convert.atlas_from_numpy(fields, device="cpu")


def lookups(n_lanes=3000, seed=1):
    g = np.random.default_rng(seed)
    uv = g.uniform(-2.5, 3.5, (n_lanes, 2)).astype(np.float32)
    # texel centres and boundaries of every texture size
    grid = np.arange(-16, 33, dtype=np.float32)
    for s in (3, 4, 5, 7, 8):
        k = grid.shape[0]
        uv[:k, 0] = grid / s
        uv[k:2 * k, 1] = (grid + 0.5) / s
    tex = g.integers(-1, 3, n_lanes).astype(np.int32)      # -1 = NULL
    fallback = g.random((n_lanes, 4)).astype(np.float32)
    return tex, uv, fallback


W = jtypes.WRAP_REPEAT, jtypes.WRAP_CLAMP, jtypes.WRAP_MIRROR


@pytest.mark.parametrize("filt", [0, 1])
@pytest.mark.parametrize("wrap", [(W[0], W[0]), (W[1], W[1]), (W[2], W[2]),
                                  (W[0], W[2]), (W[2], W[1])])
def test_sample_matches_jax(wrap, filt):
    ja, pa = atlas(wrap, filt)
    tex, uv, fb = lookups()
    want = jax.jit(jtex.sample_texture)(ja, jnp.asarray(tex), jnp.asarray(uv),
                                        jnp.asarray(fb))
    got = texture.sample_texture(pa, t(tex), t(uv), t(fb))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL, rtol=0)
    null = tex == -1
    np.testing.assert_array_equal(n(got)[null], fb[null])


def test_trivial_atlas_short_circuit():
    pa = types.TextureAtlas.empty(device="cpu")
    tex, uv, fb = lookups(100)
    got = texture.sample_texture(pa, t(tex), None, t(fb))
    want = jtex.sample_texture(jtypes.TextureAtlas.empty(), jnp.asarray(tex),
                               jnp.asarray(uv), jnp.asarray(fb))
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_apply_wrap_matches_jax():
    coord = np.arange(-40, 41, dtype=np.int32)
    for size in (1, 2, 3, 8):
        for mode in W:
            want = jtex._apply_wrap(jnp.asarray(coord), jnp.int32(size),
                                    jnp.int32(mode))
            got = texture.apply_wrap(t(coord).long(), t(np.int64(size)),
                                     t(np.int32(mode)))
            np.testing.assert_array_equal(n(got), np.asarray(want))


def test_merge_atlases_and_translate():
    ja, pa = atlas((W[0], W[1]), 1)
    g = np.random.default_rng(4)
    small = dict(data=g.random((2, 4, 12, 4)).astype(np.float32),
                 size=np.asarray([[12, 4], [3, 2]], np.int32),
                 wrap=np.asarray([[2, 2], [1, 0]], np.int32),
                 filt=np.asarray([0, 1], np.int32))
    jb = jtypes.TextureAtlas(**{k: jnp.asarray(v) for k, v in small.items()})
    pb = convert.atlas_from_numpy(small, device="cpu")
    jm, joff = jtypes.merge_atlases(ja, jb)
    pm, poff = types.merge_atlases(pa, pb)
    assert joff == poff == 3
    for f, v in to_numpy(jm).items():
        np.testing.assert_array_equal(n(getattr(pm, f)), v, err_msg=f)
    assert types.merge_atlases(None, pb) == (pb, 0)
    assert types.merge_atlases(pa, None) == (pa, 0)
    np.testing.assert_array_equal(types.translate(1.5, -2, 3),
                                  jtypes.translate(1.5, -2, 3))
