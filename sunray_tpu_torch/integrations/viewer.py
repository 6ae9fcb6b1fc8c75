"""HTTP live viewer — port of sunray_tpu/integrations/viewer.py, the
interactive `window` example / swapchain analog.

The reference presents through a winit window + Vulkan swapchain
(examples/window/main.rs, image/swapchain.rs). The port streams the
latest LDR frame to a browser instead:

- `GET /`          the viewer page (canvas + pointer-lock fly-cam controls)
- `GET /frame.jpg` the most recent frame (poll target)
- `GET /stream`    multipart/x-mixed-replace MJPEG stream
- `POST /input`    {"keys": [...], "dx": px, "dy": px} fly-cam input
- `GET /stats`     {"fps": ..., "frame": ...}

A frame stays on the renderer's device through the render, the stats
overlay (render/overlay.py) and the u8 conversion, crosses to the host
once as (H, W, 3) uint8, and is encoded there by utils/jpeg.write_jpeg
(the port's own encoder; the card's machine has no PIL).

The render loop runs on the CALLER's thread (`run()`), matching the
reference's single-threaded renderer (Rc/!Send; bevy plugin pins the render
SubApp to the main thread, plugin.rs:38-105). The HTTP server runs on
daemon threads and only touches the latest-frame JPEG buffer + the input
queue, both lock-guarded.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from sunray_tpu_torch.integrations.engine import EngineAdapter, FlyCameraAdapter
from sunray_tpu_torch.render.overlay import stats_overlay
from sunray_tpu_torch.utils.jpeg import write_jpeg

_PAGE = """<!doctype html>
<html><head><title>sunray_tpu_torch live viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 img { display:block; margin:0 auto; image-rendering:pixelated; }
</style></head><body>
<div id="hud">click to fly (WASD + mouse, Q/E down/up, Esc releases)</div>
<img id="view" src="/stream">
<script>
const view = document.getElementById("view");
const keys = new Set(); let dx = 0, dy = 0;
document.addEventListener("keydown", e => keys.add(e.key.toLowerCase()));
document.addEventListener("keyup",  e => keys.delete(e.key.toLowerCase()));
view.addEventListener("click", () => view.requestPointerLock());
document.addEventListener("mousemove", e => {
  if (document.pointerLockElement === view) { dx += e.movementX; dy += e.movementY; }
});
setInterval(() => {
  if (!keys.size && !dx && !dy) return;
  fetch("/input", {method:"POST", body: JSON.stringify(
    {keys:[...keys], dx:dx, dy:dy})});
  dx = 0; dy = 0;
}, 33);
</script></body></html>
"""


def frame_u8(frame) -> np.ndarray:
    """(clip(frame, 0, 1) * 255 + 0.5) as uint8 on the frame's device
    (the reference's order, viewer.py:63), then one copy to the host."""
    u8 = (torch.clamp(frame, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return u8.cpu().numpy()


class LiveViewer:
    """Serve an interactive fly-cam view of a Renderer over HTTP.

    viewer = LiveViewer(renderer, adapter=FlyCameraAdapter(), port=8090)
    viewer.run(max_frames=None)   # blocks; Ctrl-C / stop() to end

    The renderer renders on its own device (the card unless it was made
    with device="cpu")."""

    def __init__(self, renderer, adapter: Optional[EngineAdapter] = None,
                 host: str = "127.0.0.1", port: int = 8090,
                 overlay: bool = True, jpeg_quality: int = 85):
        self.renderer = renderer
        self.adapter = adapter or FlyCameraAdapter()
        self.overlay = overlay
        self.jpeg_quality = jpeg_quality
        self._lock = threading.Lock()
        self._jpeg: Optional[bytes] = None
        self._frame_event = threading.Event()
        self._stop = threading.Event()
        self.fps = 0.0
        self.frame_index = 0
        self._server = ThreadingHTTPServer((host, port), self._make_handler())
        self._server.daemon_threads = True
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._server_thread.start()
        self.address = f"http://{host}:{self._server.server_address[1]}"

    # -- render loop (caller thread; renderer is single-threaded) --
    def run(self, max_frames: Optional[int] = None,
            max_seconds: Optional[float] = None) -> int:
        t_start = t_prev = time.time()
        n = 0
        while not self._stop.is_set():
            if max_frames is not None and n >= max_frames:
                break
            if max_seconds is not None and time.time() - t_start > max_seconds:
                break
            t_now = time.time()
            dt = max(t_now - t_prev, 1e-6)
            t_prev = t_now
            camera, instances = self.adapter.extract(t_now - t_start, dt)
            ldr = self.renderer.render(camera, instances=instances)
            inst_fps = 1.0 / dt
            self.fps = inst_fps if n == 0 else 0.9 * self.fps + 0.1 * inst_fps
            frame = ldr
            if self.overlay:
                lines = self.adapter.overlay_lines(self.fps, self.frame_index)
                if lines:
                    frame = stats_overlay(frame, list(lines))
            self.adapter.present(frame, self.frame_index)
            jpeg = write_jpeg(frame_u8(frame), self.jpeg_quality)
            with self._lock:
                self._jpeg = jpeg
            self._frame_event.set()
            self._frame_event.clear()
            self.frame_index += 1
            n += 1
        return n

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()

    # -- HTTP plumbing --
    def _make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path.startswith("/frame"):
                    with viewer._lock:
                        jpeg = viewer._jpeg
                    if jpeg is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/jpeg", jpeg)
                elif self.path == "/stats":
                    body = json.dumps({
                        "fps": round(viewer.fps, 2),
                        "frame": viewer.frame_index,
                    }).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        while not viewer._stop.is_set():
                            viewer._frame_event.wait(timeout=1.0)
                            with viewer._lock:
                                jpeg = viewer._jpeg
                            if jpeg is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n\r\n"
                                .encode())
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/input":
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        msg = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError:
                        self._send(400, "text/plain", b"bad json")
                        return
                    if hasattr(viewer.adapter, "queue_input"):
                        viewer.adapter.queue_input(
                            msg.get("keys", []),
                            float(msg.get("dx", 0.0)),
                            float(msg.get("dy", 0.0)))
                    self._send(200, "application/json", b"{}")
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler
