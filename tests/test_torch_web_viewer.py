"""PyTorch port, integrations/web_viewer.py: the widgets against the JAX
package's (the same event sequence gives the same snapshots after every
event, and the same pixels when drawn), and one ViewerServer on the CPU
(160x24 NEE, one bounce, denoise_passes=0) for the HTTP contract (/, /state,
/stream, /input, 404s), SPAWN and CLEAR through POST /input, and PAUSE
freezing the camera clock."""

import http.client
import json
import time

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu.integrations import web_viewer as jweb
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.integrations import web_viewer
from sunray_tpu_torch.utils.jpeg import read_jpeg

W, H = 160, 24


def widgets(mod, log):
    return mod.WidgetState([
        mod.Button("SPAWN", 6, H - 20, 46, 14, lambda: log.append("spawn")),
        mod.Button("CLEAR", 58, H - 20, 46, 14, lambda: log.append("clear")),
        mod.Button("PAUSE", 110, H - 20, 46, 14, lambda: log.append("pause")),
    ])


def test_widget_state_matches_jax():
    g = np.random.default_rng(0)
    plog, jlog = [], []
    p, j = widgets(web_viewer, plog), widgets(jweb, jlog)
    for _ in range(600):
        ev = {"type": str(g.choice(["move", "down", "up", "keys"])),
              "x": float(g.uniform(-5, W + 5)),
              "y": float(g.uniform(H - 23, H - 3))}
        if g.random() < 0.05:
            del ev["x"]                                   # missing -> -1
        p.handle(ev)
        j.handle(ev)
        assert p.snapshot() == j.snapshot()
        if g.random() < 0.1:
            a = g.random((H, W, 3)).astype(np.float32)
            b = a.copy()
            p.draw(a)
            j.draw(b)
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert plog == jlog and len(plog) > 0


@pytest.fixture(scope="module")
def server():
    cfg = RenderConfig(width=W, height=H, lighting="nee", denoise_passes=0,
                       bounces=1)
    s = web_viewer.ViewerServer(cfg, port=0, device="cpu")
    s.start()
    yield s
    s.stop()
    s._render_thread.join(timeout=60)


def request(s, path, method="GET", body=None):
    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def state(s):
    return json.loads(request(s, "/state")[2])


def post(s, ev):
    return request(s, "/input", "POST", json.dumps(ev))[0]


def wait_frames(s, k=2, timeout=60.0):
    """The state after k more frames have been rendered."""
    start = state(s)["frame"]
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = state(s)
        if st["frame"] >= start + k:
            return st
        time.sleep(0.02)
    raise AssertionError(f"no {k} frames in {timeout} s")


def click(s, label):
    x = {"SPAWN": 20, "CLEAR": 70, "PAUSE": 120}[label]
    for kind in ("move", "down", "up"):
        assert post(s, {"type": kind, "x": x, "y": H - 13}) == 204


def test_http_contract(server):
    s = server
    status, ctype, page = request(s, "/")
    assert status == 200 and ctype == "text/html" and b"/stream" in page
    st = wait_frames(s, 1)
    assert set(st) == {"frame", "fps", "camera", "yaw_pitch", "instances",
                       "spawned", "paused", "widgets"}
    assert [w["label"] for w in st["widgets"]] == ["SPAWN", "CLEAR", "PAUSE"]
    assert request(s, "/nowhere")[0] == 404
    assert request(s, "/elsewhere", "POST", b"{}")[0] == 404
    assert post(s, {"type": "move", "x": 1, "y": 1}) == 204
    assert request(s, "/input", "POST", b"{bad")[0] == 204   # ignored

    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=60)
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    assert resp.getheader("Content-Type") == \
        "multipart/x-mixed-replace; boundary=frame"
    frames = []
    for _ in range(2):
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += resp.read(1)
        assert head.startswith(b"--frame\r\nContent-Type: image/jpeg\r\n")
        n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
        frames.append(resp.read(n))
        assert resp.read(2) == b"\r\n"
    conn.close()
    for f in frames:
        assert read_jpeg(f).shape == (H, W, 3)


def test_spawn_clear_and_pause(server):
    s = server
    base = state(s)["instances"]
    click(s, "SPAWN")
    st = wait_frames(s)
    assert st["spawned"] == 1 and st["instances"] == base + 1
    assert st["widgets"][0]["clicks"] == 1
    assert len(s.renderer._instances) == base + 1        # reached the frame
    click(s, "SPAWN")
    assert wait_frames(s)["spawned"] == 2
    click(s, "CLEAR")
    st = wait_frames(s)
    assert st["spawned"] == 0 and st["instances"] == base

    # The fly-cam's exact float64 position: a key moves it by the frame's
    # dt times the speed, and dt is the gap since the last frame ended
    # (the reference's clock), often below /state's 4 decimals.
    click(s, "PAUSE")
    assert wait_frames(s)["paused"] is True
    pos = s.adapter.flycam.position.copy()
    post(s, {"type": "keys", "keys": ["w", "d"], "dx": 0.0, "dy": 0.0})
    wait_frames(s)
    np.testing.assert_array_equal(s.adapter.flycam.position, pos)  # frozen
    click(s, "PAUSE")
    assert wait_frames(s)["paused"] is False
    post(s, {"type": "keys", "keys": ["w"], "dx": 0.0, "dy": 0.0})
    wait_frames(s)
    assert (s.adapter.flycam.position != pos).any()
