"""PyTorch port, render/overlay.py and render/overlay2d.py against the JAX
package on seeded inputs (tests/torch_overlay_cases.py), on the CPU:

  - stats_overlay, draw_rect and draw_text (eager jnp in the reference)
    on a 64x48 image, bit-equal;
  - rasterize_mesh and paint_meshes on overlapping triangles of both
    windings with degenerate ones, a textured mesh and a clipped mesh:
    coverage equal at every pixel and colours bit-equal (the reference's
    scan body compiles with XLA's contractions, which the port's plain
    twin and R1 make with ops/fp.fma: area, the edge functions and the
    attribute sums);
  - hud_overlay with text and a frame-time plot, bit-equal;
  - the tessellators' arrays equal and the numpy helpers bit-equal;
  - paint_meshes on a CPU image is the plain twin.

R1 itself (csrc/overlay.cu) runs only on the card:
tests/test_torch_overlay_cuda.py holds it to the plain twin there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu.render import overlay as joverlay
from sunray_tpu.render import overlay2d as jo2d
from sunray_tpu_torch.render import overlay, overlay2d
from torch_overlay_cases import (HUD_LINES, frame_times, seeded_image,
                                 stress_meshes)
from torch_parity import n

H, W = 48, 64


def jmesh(m):
    return jo2d.Mesh2D(
        xy=jnp.asarray(m["xy"]), uv=jnp.asarray(m["uv"]),
        rgba=jnp.asarray(m["rgba"]), tris=jnp.asarray(m["tris"]),
        tex=None if m["tex"] is None else jnp.asarray(m["tex"]),
        clip=m["clip"])


def pmesh(m):
    return overlay2d.Mesh2D(
        xy=torch.from_numpy(m["xy"]), uv=torch.from_numpy(m["uv"]),
        rgba=torch.from_numpy(m["rgba"]), tris=torch.from_numpy(m["tris"]),
        tex=None if m["tex"] is None else torch.from_numpy(m["tex"]),
        clip=m["clip"])


def assert_bits(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                  err_msg=msg)


@pytest.fixture(scope="module")
def meshes():
    return stress_meshes(H, W, 120, seed=5)


def test_stats_overlay_and_text():
    img = seeded_image(H, W, 1)
    lines = ["FPS 61.25", "FRAME 00007", "ab:c/%"]
    for scale in (1, 2):
        assert_bits(n(overlay.stats_overlay(torch.from_numpy(img), lines,
                                            scale=scale)),
                    joverlay.stats_overlay(jnp.asarray(img), lines,
                                           scale=scale), f"scale {scale}")
    got = overlay.draw_text(torch.from_numpy(img), "HELLO 0.5", 3, 30,
                            color=(0.2, 0.9, 0.4))
    assert_bits(n(got), joverlay.draw_text(jnp.asarray(img), "HELLO 0.5", 3,
                                           30, color=(0.2, 0.9, 0.4)))
    got = overlay.draw_rect(torch.from_numpy(img), 50, 40, 30, 30,
                            color=(0.1, 0.2, 0.3), alpha=0.35)
    assert_bits(n(got), joverlay.draw_rect(jnp.asarray(img), 50, 40, 30, 30,
                                           color=(0.1, 0.2, 0.3), alpha=0.35))


@pytest.mark.parametrize("kind", [0, 1, 2, 3],
                         ids=["soup", "textured", "clipped", "panel"])
def test_rasterize_mesh_matches_jax(meshes, kind):
    m = meshes[kind]
    jrgb, ja = jo2d.rasterize_mesh(H, W, jmesh(m))
    prgb, pa = overlay2d.rasterize_mesh(H, W, pmesh(m))
    np.testing.assert_array_equal(n(pa) > 0, np.asarray(ja) > 0)
    assert_bits(n(pa), ja, "alpha")
    assert_bits(n(prgb), jrgb, "rgb")


def test_degenerate_and_windings_are_covered(meshes):
    """The soup holds both windings and every kind of degenerate triangle,
    and some of its pixels are covered."""
    m = meshes[0]
    v = m["xy"][m["tris"]].astype(np.float64)
    area = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
    assert (area > 1e-3).any() and (area < -1e-3).any()
    assert (np.abs(area) <= 1e-8).sum() >= 2     # repeated vertex, tiny
    _, a = overlay2d.rasterize_mesh(H, W, pmesh(m))
    assert 0.2 < (n(a) > 0).mean() < 1.0


def test_paint_meshes_matches_jax(meshes):
    img = seeded_image(H, W, 2)
    want = jo2d.paint_meshes(jnp.asarray(img), [jmesh(m) for m in meshes])
    got = overlay2d.paint_meshes(torch.from_numpy(img),
                                 [pmesh(m) for m in meshes])
    assert_bits(n(got), want)
    plain = overlay2d.paint_meshes_plain(torch.from_numpy(img),
                                         [pmesh(m) for m in meshes])
    assert_bits(n(got), n(plain))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_hud_overlay_matches_jax(scale):
    img = seeded_image(72, 160, 3)
    ms = frame_times(40, 4)
    want = jo2d.hud_overlay(jnp.asarray(img), HUD_LINES[:2], frame_ms=ms,
                            scale=scale)
    got = overlay2d.hud_overlay(torch.from_numpy(img), HUD_LINES[:2],
                                frame_ms=ms, scale=scale)
    assert_bits(n(got), want)


def assert_mesh_equal(p, j):
    for f in ("xy", "uv", "rgba", "tris"):
        np.testing.assert_array_equal(n(getattr(p, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (p.tex is None) == (j.tex is None)
    if p.tex is not None:
        np.testing.assert_array_equal(n(p.tex), np.asarray(j.tex))
    assert p.clip == j.clip


def test_tessellators_match_jax():
    cases = [
        ("tess_rect", (3.0, 4.0, 40.5, 22.25, (0.1, 0.2, 0.3, 0.4)), {}),
        ("tess_rect", (3.0, 4.0, 40.5, 22.25, (0.1, 0.2, 0.3, 0.4)),
         dict(rounding=5.0, segments=6, clip=(1, 2, 30, 20))),
        ("tess_polyline", ([(1.0, 2.0), (5.5, 9.0), (5.5, 9.0), (20.0, 3.0)],
                           2.5, (1.0, 0.5, 0.0, 1.0)), {}),
        ("tess_polyline", ([(1.0, 2.0)], 2.0, (1.0, 0.5, 0.0, 1.0)), {}),
        ("tess_line", ((0.0, 0.0), (10.0, 7.0), 1.5, (0.3, 0.9, 0.4, 1.0)),
         {}),
        ("tess_text", ("FPS 12.5 xyz?", 4.0, 6.0, (1.0, 1.0, 1.0, 1.0)),
         dict(scale=2.0)),
        ("tess_text", ("", 4.0, 6.0, (1.0, 1.0, 1.0, 1.0)), {}),
    ]
    for name, args, kw in cases:
        assert_mesh_equal(getattr(overlay2d, name)(*args, **kw),
                          getattr(jo2d, name)(*args, **kw))
    ms = frame_times(30, 6)
    for p, j in zip(overlay2d.plot_lines(ms, 5, 50, 125, 78),
                    jo2d.plot_lines(ms, 5, 50, 125, 78)):
        assert_mesh_equal(p, j)
    ps, pi = overlay2d.font_atlas()
    js, ji = jo2d.font_atlas()
    np.testing.assert_array_equal(ps, js)
    assert pi == ji


def test_numpy_helpers_bit_equal():
    ms = frame_times(50, 7)
    for lines, frames, scale in ((HUD_LINES, ms, 1), (HUD_LINES[:1], None, 2),
                                 ([], ms[:1], 1)):
        a = seeded_image(90, 200, 8)
        b = a.copy()
        overlay2d.hud_overlay_np(a, lines, frame_ms=frames, scale=scale)
        jo2d.hud_overlay_np(b, lines, frame_ms=frames, scale=scale)
        assert_bits(a, b)
    a = seeded_image(40, 50, 9)
    b = a.copy()
    for f, args in (("_np_blend_rect", (-3.0, 2.5, 60.7, 30.2,
                                        (0.1, 0.2, 0.3, 0.45))),
                    ("_np_text", ("SPAWN", 4, 30, (0.95, 0.95, 0.95, 1.0))),
                    ("_np_polyline", (np.linspace(0, 49, 9),
                                      np.linspace(3, 35, 9) ** 1.1,
                                      (0.3, 0.9, 0.4, 0.7), 2))):
        getattr(overlay2d, f)(a, *args)
        getattr(jo2d, f)(b, *args)
        assert_bits(a, b, f)
