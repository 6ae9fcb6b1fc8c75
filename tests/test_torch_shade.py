"""PyTorch port, K8 and the shade pass: the plain row gather against the
Pallas one-hot kernels in interpret mode (bit-exact, out-of-range indices
clamped) and shade_hits against the JAX shade_hits on the same hits
(1e-5). The CUDA gather is held to the plain version in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.camera import generate_rays as jgenerate_rays
from sunray_tpu.ops import intersect as jisect
from sunray_tpu.ops import pallas_gather
from sunray_tpu.render import shade as jshade
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.ops import cuda_gather
from sunray_tpu_torch.ops.intersect import Hit
from sunray_tpu_torch.render import shade as pshade
from sunray_tpu_torch.scene.types import TextureAtlas
from torch_parity import CAMERA, n, t, to_numpy


def _table(k, c, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 100000, size=(k, c)).astype(np.int32)
    return rng.standard_normal((k, c)).astype(np.float32)


def _idx(k, g, size, seed):
    # Includes indices below 0 and at or above K: both clamp.
    return np.random.default_rng(seed).integers(-5, k + 5, size=(g, size)
                                                ).astype(np.int32)


@pytest.mark.parametrize("k,c", [(72, 6), (36, 4), (16, 3), (300, 11)])
def test_gather_rows_matches_pallas_single(k, c):
    table = _table(k, c, k)
    idx = _idx(k, 1, 5000, c)
    got = n(cuda_gather.gather_rows(t(table), t(idx)))[0]       # (C, N)
    want = pallas_gather.onehot_gather_cols(jnp.asarray(table),
                                            jnp.asarray(idx[0]))
    for cc in range(c):
        np.testing.assert_array_equal(got[cc], np.asarray(want[cc]))


@pytest.mark.parametrize("k,c,g", [(72, 6, 3), (36, 4, 2), (128, 5, 3)])
def test_gather_rows_matches_pallas_multi(k, c, g):
    table = _table(k, c, k + 1)
    idx = _idx(k, g, 4099, g)
    got = n(cuda_gather.gather_rows(t(table), t(idx)))           # (G, C, N)
    want = pallas_gather.onehot_gather_cols_multi(
        jnp.asarray(table), [jnp.asarray(i) for i in idx])
    assert got.shape == (g, c, idx.shape[1])
    for gi in range(g):
        for cc in range(c):
            np.testing.assert_array_equal(got[gi, cc], np.asarray(want[gi][cc]))


def test_gather_rows_int_table_exact():
    table = _table(36, 4, 7, np.int32)
    idx = _idx(36, 1, 3000, 8)
    got = cuda_gather.gather_rows(t(table), t(idx))
    assert got.dtype == torch.int32
    want = table[np.clip(idx, 0, 35)].transpose(0, 2, 1)
    np.testing.assert_array_equal(n(got), want)


def _hits(scene, w=64, h=48, seed=0):
    """Camera hits plus random bounce hits on the box (JAX brute tracer)."""
    mats = jcamera_matrices(JCamera(**CAMERA), w, h)
    o, d = jax.jit(lambda m: jgenerate_rays(m, w, h))(mats)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    tris = scene.world_triangle_vertices()
    hit = jisect.trace_closest_brute(tris, o, d)
    rng = np.random.default_rng(seed)
    pos = o + d * np.where(np.asarray(hit.hit), np.asarray(hit.t), 1.0)[:, None]
    bd = rng.normal(size=pos.shape).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=-1, keepdims=True)
    bo = (pos + bd * 1e-3).astype(np.float32)
    bhit = jisect.trace_closest_brute(tris, bo, bd)
    return [(o, d, hit), (bo, bd, bhit)]


@pytest.mark.parametrize("face_forward", [False, True])
def test_shade_hits_matches_reference(face_forward):
    jscene = jcornell_box()
    pscene = convert.scene_from_numpy(to_numpy(jscene))
    for o, d, hit in _hits(jscene):
        want = jshade.shade_hits(jscene, jnp.asarray(o), jnp.asarray(d), hit,
                                 face_forward=face_forward)
        got = pshade.shade_hits(
            pscene, t(o), t(d),
            Hit(*(t(np.asarray(x)) for x in hit)), face_forward=face_forward)
        assert 0.0 < np.asarray(hit.hit).mean() <= 1.0
        for name in pshade.Surface._fields:
            g, w_ = n(getattr(got, name)), np.asarray(getattr(want, name))
            assert g.shape == w_.shape, name
            if g.dtype == bool:
                np.testing.assert_array_equal(g, w_, err_msg=name)
            else:
                np.testing.assert_allclose(g, w_, atol=1e-5, err_msg=name)


def test_shade_hits_textured_atlas_raises():
    pscene = convert.scene_from_numpy(to_numpy(jcornell_box()))
    atlas = TextureAtlas.empty()
    atlas.data = torch.ones((2, 4, 4, 4))
    pscene.textures = atlas
    z = torch.zeros(4)
    hit = Hit(z, torch.zeros(4, dtype=torch.int32), z, z, z.bool())
    with pytest.raises(NotImplementedError):
        pshade.shade_hits(pscene, torch.zeros(4, 3), torch.ones(4, 3), hit)



def test_world_triangles_match_reference():
    """World-space triangles and lights under non-identity instance
    transforms, against the JAX scene methods as the frame runs them."""
    jscene = jcornell_box()
    rng = np.random.default_rng(12)
    xf = np.asarray(jscene.inst_transform).copy()
    xf[:, :, :3] += rng.normal(size=xf[:, :, :3].shape).astype(np.float32) * 0.2
    xf[:, :, 3] += rng.normal(size=xf[:, :, 3].shape).astype(np.float32)
    jscene = jscene.replace(inst_transform=jnp.asarray(xf))
    pscene = convert.scene_from_numpy(to_numpy(jscene))
    want = jax.jit(lambda s: s.world_triangle_vertices())(jscene)
    for g, w_ in zip(pscene.world_triangle_vertices(), want):
        np.testing.assert_allclose(n(g), np.asarray(w_), atol=1e-6)
    wv, we = jax.jit(lambda s: s.light_world_triangles())(jscene)
    gv, ge = pscene.light_world_triangles()
    np.testing.assert_allclose(n(gv), np.asarray(wv), atol=1e-6)
    np.testing.assert_array_equal(n(ge), np.asarray(we))
