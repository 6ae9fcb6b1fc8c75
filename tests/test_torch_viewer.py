"""PyTorch port, integrations/engine.py and integrations/viewer.py:

  - FlyCamera and FlyCameraAdapter bit-equal to the JAX package's on
    seeded key and mouse sequences (position, yaw, pitch, the camera);
  - the LiveViewer's HTTP surface (/, /frame.jpg, /stream, /input,
    /stats) on the CPU at 48x32 NEE with denoise_passes=0, one server
    for the file: the served JPEG equals write_jpeg of the port's own
    Renderer.render of the same cameras with the overlay, and a POST
    /input moves the camera."""

import http.client
import json
import math

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu.integrations import engine as jengine
from sunray_tpu_torch.camera import Camera
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.integrations import engine
from sunray_tpu_torch.integrations.viewer import LiveViewer, frame_u8
from sunray_tpu_torch.render.overlay import stats_overlay
from sunray_tpu_torch.render.renderer import Renderer
from sunray_tpu_torch.scene import cornell_box
from sunray_tpu_torch.utils.jpeg import read_jpeg, write_jpeg

CFG = dict(width=48, height=32, lighting="nee", denoise_passes=0)


def input_sequence(seed, n=60):
    g = np.random.default_rng(seed)
    keys = list("wasdqe") + ["x", "shift"]
    return [([k for k in keys if g.random() < 0.3],
             float(g.normal(0, 40)), float(g.normal(0, 40)),
             float(g.uniform(0.001, 0.1))) for _ in range(n)]


def assert_flycam_equal(p, j):
    np.testing.assert_array_equal(p.position, j.position)
    assert p.position.dtype == j.position.dtype
    assert p.yaw == j.yaw and p.pitch == j.pitch
    pc, jc = p.camera(), j.camera()
    assert pc.position == jc.position and pc.target == jc.target
    assert pc.fov_y == jc.fov_y and isinstance(pc, Camera)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flycam_bit_equal(seed):
    p, j = engine.FlyCamera(), jengine.FlyCamera()
    for keys, dx, dy, dt in input_sequence(seed):
        p.apply_input(keys, dx, dy, dt)
        j.apply_input(keys, dx, dy, dt)
        assert_flycam_equal(p, j)
    # The pitch limit is reached and held.
    p.apply_input([], 0.0, -1e6, 0.01)
    j.apply_input([], 0.0, -1e6, 0.01)
    assert_flycam_equal(p, j)
    assert p.pitch == pytest.approx(math.radians(89.0))


@pytest.mark.parametrize("seed", [3, 4])
def test_adapter_bit_equal(seed):
    p, j = engine.FlyCameraAdapter(), jengine.FlyCameraAdapter()
    t = 0.0
    for i, (keys, dx, dy, dt) in enumerate(input_sequence(seed, 40)):
        for a in (p, j):
            a.queue_input(keys, dx, dy)
            if i % 3 == 0:                       # two queued inputs a tick
                a.queue_input(keys[:1], dx * 0.5, -dy)
        t += dt
        pc, _ = p.extract(t, dt)
        jc, _ = j.extract(t, dt)
        assert pc.position == jc.position and pc.target == jc.target
        assert p._pending[1:] == j._pending[1:] == (0.0, 0.0)
    assert p.overlay_lines(12.5, 7) == j.overlay_lines(12.5, 7)
    assert engine.EngineAdapter().overlay_lines(59.94, 42) == \
        jengine.EngineAdapter().overlay_lines(59.94, 42)


class RecordingAdapter(engine.FlyCameraAdapter):
    """A fly-cam whose overlay text does not depend on the wall clock, and
    which keeps every camera it hands out."""

    def __init__(self):
        super().__init__()
        self.cameras = []

    def extract(self, t, dt):
        cam, inst = super().extract(t, 0.05)
        self.cameras.append(cam)
        return cam, inst

    def overlay_lines(self, fps, frame_index):
        return [f"FRAME {frame_index:05d}"]


@pytest.fixture(scope="module")
def viewer():
    r = Renderer(RenderConfig(**CFG), scene=cornell_box(device="cpu"),
                 device="cpu")
    v = LiveViewer(r, RecordingAdapter(), port=0)
    yield v
    v.stop()


def get(v, path, method="GET", body=None):
    port = int(v.address.rsplit(":", 1)[1])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def test_live_viewer_round_trip(viewer):
    v = viewer
    assert get(v, "/frame.jpg")[0] == 503                 # no frame yet
    status, ctype, page = get(v, "/")
    assert status == 200 and ctype == "text/html" and b"/stream" in page
    assert v.run(max_frames=2) == 2
    status, ctype, jpg = get(v, "/frame.jpg")
    assert status == 200 and ctype == "image/jpeg"
    assert read_jpeg(jpg).shape == (32, 48, 3)
    stats = json.loads(get(v, "/stats")[2])
    assert stats["frame"] == 2
    before = v.adapter.flycam.position.copy()
    status, _, body = get(v, "/input", "POST",
                          json.dumps({"keys": ["w", "e"], "dx": 30.0,
                                      "dy": -12.0}))
    assert status == 200 and body == b"{}"
    assert get(v, "/input", "POST", b"{not json")[0] == 400
    assert get(v, "/nowhere")[0] == 404
    assert v.run(max_frames=1) == 1
    assert not np.array_equal(v.adapter.flycam.position, before)
    cams = v.adapter.cameras
    assert len(cams) == 3 and cams[2].position != cams[1].position

    # The served stream is write_jpeg of the port's own render of the same
    # cameras, overlay drawn.
    r = Renderer(RenderConfig(**CFG), scene=cornell_box(device="cpu"),
                 device="cpu")
    for cam in cams:
        ldr = r.render(cam)
    want = write_jpeg(frame_u8(stats_overlay(ldr, ["FRAME 00002"])), 85)
    assert get(v, "/frame.jpg")[2] == want


def test_live_viewer_stream(viewer):
    v = viewer
    port = int(v.address.rsplit(":", 1)[1])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith(
        "multipart/x-mixed-replace")
    head = b""
    while not head.endswith(b"\r\n\r\n"):
        head += resp.read(1)
    assert head.startswith(b"--frame\r\nContent-Type: image/jpeg\r\n")
    n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
    part = resp.read(n)
    conn.close()
    assert part == get(v, "/frame.jpg")[2]
