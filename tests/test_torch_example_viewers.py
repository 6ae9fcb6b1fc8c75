"""PyTorch port, the interactive example programs on the CPU:
examples/torch_orbit.py, torch_term_viewer.py and the camera arm of
torch_parity_report.py. No JAX frame is compiled here: the port's
Renderer and SceneManager are held to JAX by test_torch_renderer_facade.py
and test_torch_scene_manager.py.

- orbit at 32x24, 6 frames, churn at (2, 4): each frame's camera and
  instance list are orbit.py's formulas (orbit.py:246-266); every
  presented frame (before the HUD) is bit-equal to a Renderer set up as
  orbit.py:120-174 does and called frame by frame, with --inflight 0 and
  2 and 1 and 2 present workers (and --present f32): a frame read back
  while later frames render is never one they overwrote; stats.json has
  orbit.py's keys; the glTF interior orbit's bounds are orbit.py:91-118's
  formulas on the JAX loader's arrays.
- frame_to_ansi is string-equal to term_viewer.frame_to_ansi (odd heights
  too); RawTerm on a pty reads what term_viewer.RawTerm reads; a scripted
  run ends with its summary line.
- the parity report's camera arm passes at 1600x1200.
- without --cpu and with no card, every torch_*.py example raises.
"""

import json
import os
import pty
import select
import sys
import time

import numpy as np
import pytest
import torch

from examples import term_viewer as jax_term
from examples import (
    torch_optimize_camera,
    torch_optimize_material,
    torch_orbit,
    torch_parity_report,
    torch_render_png,
    torch_term_viewer,
)
from sunray_tpu_torch.camera import Camera
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render.renderer import Renderer
from sunray_tpu_torch.scene import cornell_box
from sunray_tpu_torch.scene.manager import SceneManager
from sunray_tpu_torch.scene.types import translate
from tools.synth_gltf import write_scene

W, H, FRAMES, CHURN = 32, 24, 6, (2, 4)
STATS_KEYS = (      # orbit.py:305-334
    "scene", "resolution", "frames", "inflight", "present",
    "present_workers", "device", "prewarm_s", "first_present_ms",
    "steady_mean_ms", "steady_p50_ms", "steady_max_ms", "steady_fps",
    "churn_frames", "churn_frame_ms", "no_recompile_on_churn")


def expected_frames(present):
    """orbit.py's cameras and instance lists for FRAMES frames, and the
    frames a Renderer set up as orbit.py does renders from them, in the
    present format, as float host images."""
    box = cornell_box(device="cpu")
    r = Renderer(RenderConfig(width=W, height=H, lighting="restir"),
                 device="cpu")
    r._manager = SceneManager.from_scene_buffers(box)
    base = r._manager.default_instances(box)
    r.scene = r._manager.build(base)
    r._sync_scene_flags()
    smallest = min(base, key=lambda kt: r._manager._meshes[kt[0]]
                   .tri_vidx.shape[0])[0]
    spawn = list(base) + [(smallest, translate(0.0, -0.8, 0.0))]
    warm = Camera(position=(1.0, 1.3, 3.6), target=(1.0, 1.0, 1.0),
                  fov_y=50.0)
    r.render(warm, instances=spawn)
    r.render(warm, instances=list(base))
    r.reset_history()
    cams, insts, imgs = [], [], []
    center = np.asarray([1.0, 1.0, 1.0])
    for frame in range(FRAMES):
        angle = 2.0 * np.pi * frame / FRAMES
        eye = (float(center[0]) + 2.6 * np.sin(angle), 1.3,
               float(center[2]) + 2.6 * np.cos(angle))
        cam = Camera(position=eye, target=tuple(float(c) for c in center),
                     fov_y=50.0)
        inst = spawn if CHURN[0] <= frame < CHURN[1] else list(base)
        ldr = r.render(cam, instances=inst)
        if present == "u8":
            u8 = (torch.clamp(ldr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
            img = u8.numpy().astype(np.float32) / 255.0
        else:
            img = ldr.numpy().copy()
        cams.append(cam)
        insts.append(inst)
        imgs.append(img)
    return cams, insts, imgs


@pytest.fixture(scope="module")
def expected():
    return {p: expected_frames(p) for p in ("u8", "f32")}


def run_orbit(tmp_path, monkeypatch, **kw):
    """torch_orbit.run at W x H with the presented images captured before
    the HUD and the Renderer's calls recorded."""
    presented, calls = {}, []
    hud = torch_orbit.hud_overlay_np

    def capture(img, lines, **hud_kw):
        presented[int(lines[1].split()[1])] = img.copy()
        return hud(img, lines, **hud_kw)

    render = Renderer.render

    def record(self, camera, instances=None):
        calls.append((camera, instances))
        return render(self, camera, instances=instances)

    monkeypatch.setattr(torch_orbit, "hud_overlay_np", capture)
    monkeypatch.setattr(Renderer, "render", record)
    stats = torch_orbit.run(frames=FRAMES, size=f"{W}x{H}",
                            out=str(tmp_path), device="cpu", churn=CHURN,
                            **kw)
    return stats, presented, calls[2:]


@pytest.mark.parametrize("inflight, workers, present", [
    (0, 1, "u8"), (2, 1, "u8"), (0, 2, "u8"), (2, 2, "u8"), (2, 2, "f32")])
def test_orbit_frames(expected, tmp_path, monkeypatch, inflight, workers,
                      present):
    cams, insts, imgs = expected[present]
    stats, presented, calls = run_orbit(
        tmp_path, monkeypatch, inflight=inflight, present_workers=workers,
        present=present)
    assert len(calls) == FRAMES
    for frame, (cam, inst) in enumerate(calls):
        assert cam == cams[frame], frame
        assert [k for k, _ in inst] == [k for k, _ in insts[frame]], frame
        for (_, t), (_, want) in zip(inst, insts[frame]):
            np.testing.assert_array_equal(t, want)
    assert sorted(presented) == list(range(FRAMES))
    for frame in range(FRAMES):
        np.testing.assert_array_equal(presented[frame], imgs[frame],
                                      err_msg=f"frame {frame}")
    assert stats["churn_frames"] == list(CHURN)
    assert (stats["inflight"], stats["present_workers"],
            stats["present"]) == (inflight, workers, present)
    pngs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".png"))
    assert pngs == [f"frame_{f:04d}.png" for f in range(FRAMES)]


def test_orbit_stats(tmp_path, monkeypatch):
    stats, _, _ = run_orbit(tmp_path, monkeypatch, inflight=1)
    with open(tmp_path / "stats.json") as f:
        written = json.load(f)
    assert tuple(written) == STATS_KEYS
    assert written == stats
    assert stats["churn_frames"] == [2, 4]
    assert stats["device"] == "cpu" and stats["frames"] == FRAMES
    assert len(stats["churn_frame_ms"]) == 2
    assert stats["no_recompile_on_churn"] is True


def test_interior_orbit_bounds(tmp_path, capsys):
    """orbit.py:91-118 on the JAX loader's arrays against the port's
    interior_orbit on its own loader's; then 3 frames of the orbit."""
    from sunray_tpu.scene.gltf import load_gltf as jax_load_gltf
    from sunray_tpu_torch.scene.gltf import load_gltf

    path = write_scene(str(tmp_path / "room.glb"), seed=3, tex=8, subdiv=0,
                       spheres=2)
    scene = jax_load_gltf(path)
    pos = np.asarray(scene.positions)
    tv = np.asarray(scene.tri_vidx)
    ti = np.asarray(scene.tri_inst)
    xf = np.asarray(scene.inst_transform)
    corners = pos[tv.reshape(-1)]
    xfc = xf[np.repeat(ti, 3)]
    world = np.einsum("nij,nj->ni", xfc[:, :, :3], corners) + xfc[:, :, 3]
    lo, hi = world.min(0), world.max(0)
    orbit_center = (lo + hi) / 2.0
    ext = hi - lo
    orbit_radius = 0.32 * float(min(ext[0], ext[2]))
    eye_h = float(lo[1] + 0.45 * ext[1])
    orbit_center = np.asarray(
        [orbit_center[0], lo[1] + 0.30 * ext[1], orbit_center[2]])

    center, radius, got_eye_h, fov, bounds = torch_orbit.interior_orbit(
        load_gltf(path, device="cpu"))
    np.testing.assert_array_equal(center, orbit_center)
    assert (radius, got_eye_h, fov) == (orbit_radius, eye_h, 60.0)
    np.testing.assert_array_equal(bounds[0], lo)
    np.testing.assert_array_equal(bounds[1], hi)

    stats = torch_orbit.run(frames=3, size="16x12", out=str(tmp_path / "o"),
                            scene=path, device="cpu", churn=(1, 2))
    assert stats["churn_frames"] == [1, 2]
    assert f"interior orbit r={orbit_radius:.2f}" in capsys.readouterr().out


@pytest.mark.parametrize("h", [6, 7, 1])
def test_frame_to_ansi_matches_reference(h):
    rng = np.random.default_rng(h)
    img = rng.uniform(-0.1, 1.1, (h, 9, 3)).astype(np.float32)
    img[0, 0] = (0.0, 0.5, 1.0)
    assert torch_term_viewer.frame_to_ansi(img) == jax_term.frame_to_ansi(img)


SEQUENCES = ("w", "\x1b[A", "\x1b[D", "x")


def pty_keys(make_term, monkeypatch):
    """read_keys after each of SEQUENCES written to a fresh pty."""
    master, slave = pty.openpty()
    stream = os.fdopen(slave, "r")
    monkeypatch.setattr(sys, "stdin", stream)
    out = []
    try:
        with make_term(stream) as term:
            assert term.raw
            for seq in SEQUENCES:
                os.write(master, seq.encode())
                select.select([stream], [], [], 1.0)
                time.sleep(0.02)
                out.append(term.read_keys())
    finally:
        stream.close()
        os.close(master)
    return out


def test_raw_term_matches_reference(monkeypatch):
    """The same keys and dx/dy as term_viewer.RawTerm on the same bytes.
    Both read one character at a time from the buffered text stream after
    a select() on its descriptor, so an arrow key's escape sequence is
    split (ROADMAP Queue 3); the port keeps that."""
    want = pty_keys(lambda s: jax_term.RawTerm(), monkeypatch)
    got = pty_keys(torch_term_viewer.RawTerm, monkeypatch)
    assert got == want
    assert got[0] == (["w"], 0.0, 0.0)
    assert "x" in got[-1][0]


def test_term_viewer_scripted_run(monkeypatch, capsys):
    with open(os.devnull) as null:
        monkeypatch.setattr(sys, "stdin", null)
        got = torch_term_viewer.main(["--cpu", "--frames", "3"])
    out = capsys.readouterr().out
    assert got["frames"] == 3
    assert out.rstrip().splitlines()[-1].startswith(
        "term_viewer: 3 frames, steady fps ")
    assert out.count("frame ") == 3
    assert got["ansi_bytes"] > 160 * 48 * 30


def test_parity_camera_arm():
    got = torch_parity_report.camera_parity(1600, 1200, device="cpu")
    assert got["pass"] is True
    assert got["max_abs_diff_view_proj"] < 1e-4


@pytest.mark.parametrize("module, argv", [
    (torch_render_png, []),
    (torch_optimize_material, []),
    (torch_optimize_camera, ["--joint", "--edge-aa"]),
    (torch_orbit, ["--no-save"]),
    (torch_term_viewer, ["--frames", "1"]),
    (torch_parity_report, ["--gltf", "unused.glb"]),
])
def test_examples_need_a_card(module, argv):
    """On the card unless --cpu: without one, main raises before it
    renders anything."""
    assert not torch.cuda.is_available()
    with pytest.raises((AssertionError, RuntimeError)):
        module.main(argv)
