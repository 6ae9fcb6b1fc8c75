"""Browser-reachable live viewer — port of
sunray_tpu/integrations/web_viewer.py: MJPEG stream + interactive HUD
widgets.

The reference's windowed fly-cam app (examples/window/main.rs:222-249 +
image/swapchain.rs present loop) becomes an HTTP server any browser can
reach through an ssh port-forward:

  - GET  /        : the client page (canvas-free <img> + input JS)
  - GET  /stream  : multipart/x-mixed-replace MJPEG of rendered frames
                    (the swapchain-present analog; JPEG by the port's own
                    encoder, utils/jpeg.write_jpeg)
  - POST /input   : {keys, dx, dy, click, move, down, up} JSON events
  - GET  /state   : JSON status (fps, frame, camera, instances, widgets)
                    — also the test surface

Input drives the same EngineAdapter contract as the terminal viewer
(integrations/engine.FlyCameraAdapter), and the HUD is an interactive
WIDGET STATE MACHINE — the portable slice of the reference's
bevy_integration/egui_support.rs (egui's hover/press/click cycle):
buttons get idle/hover/pressed states from mouse events and fire
callbacks on release-inside (Spawn/Despawn drive runtime instance churn
through Renderer.set_instances; Pause freezes the camera clock). The
frame renders on the renderer's device (the card unless device="cpu"),
and comes to the host as float32 for the widgets, which draw with
render/overlay2d's numpy helpers, as in the reference.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np

from sunray_tpu_torch.render.overlay2d import _np_blend_rect, _np_text
from sunray_tpu_torch.utils.jpeg import write_jpeg


class Button:
    """egui-style immediate widget with retained interaction state.

    State machine (egui_support.rs's portable logic): idle -> hover on
    pointer-over; hover -> pressed on mouse-down inside; pressed ->
    fires `on_click` on mouse-up while still inside, else back to idle.
    """

    def __init__(self, label: str, x: int, y: int, w: int, h: int,
                 on_click: Callable[[], None]):
        self.label = label
        self.x, self.y, self.w, self.h = x, y, w, h
        self.on_click = on_click
        self.state = "idle"
        self.clicks = 0

    def contains(self, px: float, py: float) -> bool:
        return (self.x <= px < self.x + self.w
                and self.y <= py < self.y + self.h)

    def on_move(self, px, py):
        if self.state != "pressed":
            self.state = "hover" if self.contains(px, py) else "idle"

    def on_down(self, px, py):
        if self.contains(px, py):
            self.state = "pressed"

    def on_up(self, px, py):
        if self.state == "pressed" and self.contains(px, py):
            self.clicks += 1
            self.on_click()
        self.state = "hover" if self.contains(px, py) else "idle"

    def draw(self, img: np.ndarray):
        base = {"idle": (0.10, 0.10, 0.14, 0.78),
                "hover": (0.22, 0.22, 0.30, 0.85),
                "pressed": (0.45, 0.35, 0.10, 0.92)}[self.state]
        _np_blend_rect(img, self.x, self.y, self.x + self.w,
                       self.y + self.h, base)
        _np_text(img, self.label, self.x + 4, self.y + (self.h - 7) // 2,
                 (0.95, 0.95, 0.95, 1.0))


class WidgetState:
    """Pointer-event dispatch over a widget list (one egui 'ui' frame)."""

    def __init__(self, widgets: List[Button]):
        self.widgets = widgets

    def handle(self, ev: dict):
        kind = ev.get("type")
        px, py = float(ev.get("x", -1)), float(ev.get("y", -1))
        for wdg in self.widgets:
            if kind == "move":
                wdg.on_move(px, py)
            elif kind == "down":
                wdg.on_down(px, py)
            elif kind == "up":
                wdg.on_up(px, py)

    def draw(self, img: np.ndarray):
        for wdg in self.widgets:
            wdg.draw(img)

    def snapshot(self):
        return [
            {"label": w.label, "state": w.state, "clicks": w.clicks}
            for w in self.widgets
        ]


_PAGE = """<!doctype html>
<html><head><title>sunray_tpu_torch live</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:12px}
img{image-rendering:pixelated;border:1px solid #444}
</style></head><body>
<div>sunray_tpu_torch web viewer — wasdqe move, drag to look, click the HUD</div>
<img id=v src="/stream" draggable=false>
<script>
const img=document.getElementById('v');
let keys=new Set(), dx=0, dy=0, drag=false, lx=0, ly=0;
function post(o){fetch('/input',{method:'POST',body:JSON.stringify(o)});}
function scale(e){const r=img.getBoundingClientRect();
  return [ (e.clientX-r.left)*img.naturalWidth/r.width,
           (e.clientY-r.top)*img.naturalHeight/r.height ];}
document.addEventListener('keydown',e=>keys.add(e.key.toLowerCase()));
document.addEventListener('keyup',e=>keys.delete(e.key.toLowerCase()));
img.addEventListener('mousedown',e=>{drag=true;lx=e.clientX;ly=e.clientY;
  const [x,y]=scale(e);post({type:'down',x,y});e.preventDefault();});
document.addEventListener('mouseup',e=>{drag=false;
  const [x,y]=scale(e);post({type:'up',x,y});});
img.addEventListener('mousemove',e=>{
  const [x,y]=scale(e);post({type:'move',x,y});
  if(drag){dx+=e.clientX-lx;dy+=e.clientY-ly;lx=e.clientX;ly=e.clientY;}});
setInterval(()=>{ if(keys.size||dx||dy){
  post({type:'keys',keys:[...keys],dx,dy}); dx=0; dy=0;}},90);
</script></body></html>
"""


class ViewerServer:
    """Render loop + HTTP front end. Start with serve() (blocking) or
    start() (background thread; used by tests). device: the renderer's
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, cfg, scene=None, host="127.0.0.1", port=8000,
                 jpeg_quality=85, max_frames=0, device="cuda"):
        from sunray_tpu_torch.integrations.engine import FlyCameraAdapter
        from sunray_tpu_torch.render.renderer import Renderer
        from sunray_tpu_torch.scene import cornell_box
        from sunray_tpu_torch.scene.manager import SceneManager

        self.cfg = cfg
        base = scene if scene is not None else cornell_box(device=device)
        self.renderer = Renderer(cfg, device=device)
        self.renderer._manager = SceneManager.from_scene_buffers(base)
        self._base_instances = list(
            self.renderer._manager.default_instances(base))
        self.renderer.scene = self.renderer._manager.build(
            self._base_instances)
        self.renderer._sync_scene_flags()
        self._spawn_key = min(
            self._base_instances,
            key=lambda kt:
                self.renderer._manager._meshes[kt[0]].tri_vidx.shape[0],
        )[0]
        self._spawned: List[np.ndarray] = []

        self.adapter = FlyCameraAdapter()
        self.adapter.flycam.position = np.array([1.0, 1.0, 3.4])
        self.paused = False

        h = cfg.height
        self.widgets = WidgetState([
            Button("SPAWN", 6, h - 20, 46, 14, self._spawn),
            Button("CLEAR", 58, h - 20, 46, 14, self._despawn),
            Button("PAUSE", 110, h - 20, 46, 14, self._toggle_pause),
        ])

        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._frame_cond = threading.Condition()
        self._jpeg: Optional[bytes] = None
        self._frame_index = 0
        self._fps = 0.0
        self._running = False
        self._max_frames = max_frames
        self._jpeg_quality = jpeg_quality
        self.host, self.port = host, port
        self._httpd = None

    # --- widget callbacks -------------------------------------------------
    def _spawn(self):
        k = len(self._spawned)
        t = np.eye(3, 4, dtype=np.float32)
        t[:, 3] = [0.5 + 0.35 * (k % 4), 0.25, 0.6 + 0.3 * (k // 4)]
        t[:3, :3] *= 0.35
        self._spawned.append(t)

    def _despawn(self):
        self._spawned = []

    def _toggle_pause(self):
        self.paused = not self.paused

    # --- render loop ------------------------------------------------------
    def _instances(self):
        return self._base_instances + [
            (self._spawn_key, t) for t in self._spawned
        ]

    def _render_loop(self):
        t_prev = time.time()
        while self._running:
            with self._lock:
                events, self._events = self._events, []
            keys, dx, dy = [], 0.0, 0.0
            for ev in events:
                if ev.get("type") == "keys":
                    keys += [k for k in ev.get("keys", []) if k in "wasdqe"]
                    dx += float(ev.get("dx", 0.0))
                    dy += float(ev.get("dy", 0.0))
                else:
                    self.widgets.handle(ev)
            t_now = time.time()
            dt = 0.0 if self.paused else max(t_now - t_prev, 1e-6)
            self.adapter.queue_input(keys, dx, dy)
            cam, _ = self.adapter.extract(t_now, dt)
            ldr = self.renderer.render(
                cam, instances=self._instances()).to("cpu", copy=True).numpy()
            self.widgets.draw(ldr)
            u8 = np.clip(ldr * 255.0 + 0.5, 0, 255).astype(np.uint8)
            jpeg = write_jpeg(u8, self._jpeg_quality)
            inst = 1.0 / max(time.time() - t_prev, 1e-6)
            self._fps = inst if self._fps == 0 else (
                0.9 * self._fps + 0.1 * inst)
            t_prev = time.time()
            with self._frame_cond:
                self._jpeg = jpeg
                self._frame_index += 1
                self._frame_cond.notify_all()
            if self._max_frames and self._frame_index >= self._max_frames:
                break

    # --- HTTP -------------------------------------------------------------
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/state":
                    fc = server.adapter.flycam
                    body = json.dumps({
                        "frame": server._frame_index,
                        "fps": round(server._fps, 2),
                        "camera": [round(float(v), 4)
                                   for v in fc.position],
                        "yaw_pitch": [round(float(fc.yaw), 4),
                                      round(float(fc.pitch), 4)],
                        "instances": len(server._instances()),
                        "spawned": len(server._spawned),
                        "paused": server.paused,
                        "widgets": server.widgets.snapshot(),
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    last = -1
                    try:
                        while server._running:
                            with server._frame_cond:
                                if server._frame_index == last:
                                    server._frame_cond.wait(timeout=5.0)
                                jpeg = server._jpeg
                                last = server._frame_index
                            if jpeg is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n\r\n"
                                .encode() + jpeg + b"\r\n")
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/input":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    ev = {}
                with server._lock:
                    server._events.append(ev)
                self.send_response(204)
                self.end_headers()

        return Handler

    def start(self):
        """Background start (render thread + HTTP thread); returns port."""
        self._running = True
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True)
        self._render_thread.start()
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self.port

    def stop(self):
        self._running = False
        with self._frame_cond:
            self._frame_cond.notify_all()
        if self._httpd is not None:
            self._httpd.shutdown()

    def serve(self):
        """Blocking run (the examples/web_viewer.py entry)."""
        port = self.start()
        print(f"sunray_tpu_torch web viewer: http://{self.host}:{port}/ "
              f"({self.cfg.width}x{self.cfg.height})", flush=True)
        try:
            while True:
                time.sleep(1.0)
                if self._max_frames and \
                        self._frame_index >= self._max_frames:
                    break
        except KeyboardInterrupt:
            pass
        self.stop()
