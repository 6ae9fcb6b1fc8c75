"""Shared cases of the visibility-gradient tests of the PyTorch port
(tests/test_torch_boundary*.py, tests/test_torch_antialias*.py).

- the floating-box scene of tests/test_grads.py:238-255 (the occluder
  floats above the floor so its shadow lies away from its base) and its
  camera, in both packages;
- the reference's candidate selection (sunray_tpu/render/boundary.py:
  141-231: face normals, silhouette, _candidate_score and K argmax
  extractions), jitted on the CPU, as the arrays B1 returns;
- TestCandidatePruning's 256 floor points (tests/test_boundary.py:
  254-266).
"""

import numpy as np

from sunray_tpu_torch import convert
from torch_parity import to_numpy

FLOAT_CAMERA = dict(position=(1.0, 1.7, 3.3), target=(1.0, 0.2, 0.7),
                    fov_y=45.0)                   # tests/test_grads.py:261
FLOAT_SIZE = (64, 48)


def floating_scene(mesh_cls):
    """The floating-box scene of tests/test_grads.py:238-255, built with
    either package's _MeshBuilder class."""
    b = mesh_cls()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0)
    light = b.add_material(base_color=(1.0, 1.0, 1.0, 1.0),
                           emissive_factor=(1.0, 1.0, 1.0, 15.0),
                           roughness=1.0)
    s = 2.0
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), white)
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), white)
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)
    ly = s - 0.01
    b.add_quad((0.95, ly, 0.65), (1.55, ly, 0.65),
               (1.55, ly, 1.35), (0.95, ly, 1.35), light)
    b.add_box((0.9, 1.2, 1.0), (0.5, 0.25, 0.5), white)
    return b


def jax_floating_scene():
    from sunray_tpu.scene.procedural import _MeshBuilder

    return floating_scene(_MeshBuilder).build()


def port_scene_of(jscene, device="cpu"):
    """The port's copy of a JAX scene, edge topology left out (the port
    builds its own)."""
    fields = to_numpy(jscene)
    fields["edge_tri"] = fields["edge_k"] = None
    return convert.scene_from_numpy(fields, device=device)


def floor_points(p=256, seed=0):
    """TestCandidatePruning's shading points: (x, normal, albedo, mask)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.2, 1.8, size=(p, 3)).astype(np.float32)
    x[:, 1] = 0.01
    nrm = np.tile(np.float32([0.0, 1.0, 0.0]), (p, 1))
    return x, nrm, np.full((p, 3), 0.7, np.float32), np.ones((p,), bool)


def jax_selection(scene, x, nee_mask, k):
    """The reference's top-k candidates of every light at the points x:
    [(idx (k, P), n_live (P,), sil (k, P), face2 (k, P))] a light, as
    numpy. face2: the side reference is the second face's opposite corner
    (boundary.py:191-195). The lines of nee_boundary_term up to its
    extraction loop, jitted."""
    import jax
    import jax.numpy as jnp

    from sunray_tpu.render import boundary, restir

    def select(x, nee_mask):
        lights = restir.Lights(scene)
        w0, w1, w2 = scene.world_triangle_vertices()
        e_t, e_k = scene.edge_tri, scene.edge_k
        a = boundary._tri_corner(w0, w1, w2, e_t[:, 0], e_k)
        b = boundary._tri_corner(w0, w1, w2, e_t[:, 0], (e_k + 1) % 3)

        def face_geom(tri):
            tric = jnp.maximum(tri, 0)
            v0, v1, v2 = (jnp.take(w, tric, axis=0) for w in (w0, w1, w2))
            n = jnp.cross(v1 - v0, v2 - v0)
            n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True),
                                1e-12)
            return n, v0

        n1, c1 = face_geom(e_t[:, 0])
        n2, c2 = face_geom(e_t[:, 1])
        has2 = e_t[:, 1] >= 0
        front1 = jnp.sum((x[:, None, :] - c1[None]) * n1[None], -1) > 0.0
        front2 = jnp.sum((x[:, None, :] - c2[None]) * n2[None], -1) > 0.0
        sil = jnp.where(has2[None, :], front1 ^ front2,
                        jnp.ones_like(front1))
        face2 = ~front1 & has2[None, :] & front2
        out = []
        for li in range(lights.num):
            light = (lights.v0[li], lights.v1[li], lights.v2[li],
                     lights.emission[li])
            score = boundary._candidate_score(x, a, b, sil, light, nee_mask)
            n_live = jnp.sum(score > 0.0, axis=1)
            idxs = []
            for _ in range(k):
                k_idx = jnp.argmax(score, axis=1)
                idxs.append(k_idx)
                score = jnp.where(jax.nn.one_hot(k_idx, a.shape[0],
                                                 dtype=bool), -1.0, score)
            idx = jnp.stack(idxs)                              # (k, P)
            out.append((idx, n_live,
                        jnp.take_along_axis(sil, idx.T, 1).T,
                        jnp.take_along_axis(face2, idx.T, 1).T))
        return out

    res = jax.jit(select)(jnp.asarray(x), jnp.asarray(nee_mask))
    return [tuple(np.asarray(a) for a in r) for r in res]


def gradient_compile_crossing(ax, ay, bx, by, ccx, ccy, horizontal, width,
                              height):
    """render/antialias._edge_crossing rounded as the reference's
    gradient compiles round it: the numerator's scale is fused too,
    fma(-pa_u, scale, c0) (its forward compile fuses only the
    denominator's, as the port renders). A crossing through a pixel
    centre (e exactly 0 or 1) decides on these roundings."""
    import torch

    from sunray_tpu_torch.ops.fp import fma
    from sunray_tpu_torch.render.antialias import _EPS

    if horizontal:
        pa_u, pb_u, qa_u, qb_u, c0, cq = ay, by, ax, bx, ccy, ccx
        p_scale, q_scale = height, width
    else:
        pa_u, pb_u, qa_u, qb_u, c0, cq = ax, bx, ay, by, ccx, ccy
        p_scale, q_scale = width, height
    pa, pb = pa_u * p_scale, pb_u * p_scale
    qa, qb = qa_u * q_scale, qb_u * q_scale
    crosses = (pa - c0) * (pb - c0) <= 0.0
    denom = fma(pb_u, p_scale, -pa)
    denom = torch.where(denom.abs() > _EPS, denom, _EPS)
    t = fma(-pa_u, p_scale, c0) / denom
    e = fma(qb - qa, t, qa) - cq
    valid = crosses & (e >= 0.0) & (e <= 1.0)
    return torch.where(valid, e, 0.5), valid
