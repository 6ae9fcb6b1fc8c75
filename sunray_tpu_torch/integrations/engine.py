"""Engine-integration contract + fly camera — port of
sunray_tpu/integrations/engine.py.

The reference's Bevy plugin (src/bevy_integration/plugin.rs:38-105,
systems.rs:36-180) runs a single-threaded render SubApp that each tick
EXTRACTS the camera and the caller-owned instance list from the engine
world, calls `Renderer::render_to_swapchain`, and hands the image back for
presentation. `EngineAdapter` is that contract with the Vulkan specifics
removed: any host loop (game engine, viewer, batch driver) implements
`extract()` and receives frames via `present()`.

`FlyCamera` reproduces the winit fly-cam of examples/window/main.rs
(WASD + mouse-look, yaw/pitch integration on the host).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from sunray_tpu_torch.camera import Camera


class EngineAdapter:
    """Per-tick extract/present contract (bevy_integration/systems.rs).

    Subclass and override `extract` (and optionally `present` /
    `overlay_lines`); drive it with `LiveViewer` or your own loop calling
    `renderer.render(*adapter.extract(t, dt))`.
    """

    def extract(self, t: float, dt: float):
        """Return (camera, instances-or-None) for this tick."""
        raise NotImplementedError

    def present(self, frame, frame_index: int) -> None:
        """Receive the rendered LDR frame: an (H, W, 3) float32 tensor on
        the renderer's device, the overlay drawn. Default: drop (the
        viewer/stream keeps its own copy)."""

    def overlay_lines(self, fps: float, frame_index: int) -> Sequence[str]:
        """Stats overlay text (the egui-overlay analog); [] disables."""
        return [f"FPS {fps:6.2f}", f"FRAME {frame_index:05d}"]


@dataclass
class FlyCamera:
    """WASD + mouse-look camera (examples/window/main.rs fly-cam).

    State is yaw/pitch/position; `apply_input` integrates one tick of host
    input in numpy float64 (the reference's arithmetic, bit for bit),
    `camera()` emits the port's Camera (position + target).
    """

    position: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 1.0, 3.4], np.float64))
    yaw: float = math.pi          # radians; pi looks down -z toward origin
    pitch: float = 0.0
    fov_y: float = 45.0
    move_speed: float = 2.0       # units / s
    look_speed: float = 0.0025    # radians / pixel of mouse motion

    _PITCH_LIMIT = math.radians(89.0)

    def forward(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        return np.array([
            math.sin(self.yaw) * cp, math.sin(self.pitch),
            math.cos(self.yaw) * cp,
        ])

    def apply_input(self, keys: Sequence[str], mouse_dx: float,
                    mouse_dy: float, dt: float) -> None:
        """keys: pressed key names among w/a/s/d/q/e (q/e = down/up);
        mouse deltas in pixels (positive dy looks down, winit convention)."""
        self.yaw -= mouse_dx * self.look_speed
        self.pitch = float(np.clip(self.pitch - mouse_dy * self.look_speed,
                                   -self._PITCH_LIMIT, self._PITCH_LIMIT))
        fwd = self.forward()
        flat = np.array([fwd[0], 0.0, fwd[2]])
        n = np.linalg.norm(flat)
        flat = flat / n if n > 1e-8 else np.array([0.0, 0.0, 1.0])
        right = np.array([-flat[2], 0.0, flat[0]])  # cross(forward, up)
        step = np.zeros(3)
        ks = set(keys)
        if "w" in ks:
            step += flat
        if "s" in ks:
            step -= flat
        if "d" in ks:
            step += right
        if "a" in ks:
            step -= right
        if "e" in ks:
            step += np.array([0.0, 1.0, 0.0])
        if "q" in ks:
            step -= np.array([0.0, 1.0, 0.0])
        self.position = self.position + step * (self.move_speed * dt)

    def camera(self) -> Camera:
        return Camera(position=tuple(self.position),
                      target=tuple(self.position + self.forward()),
                      fov_y=self.fov_y)


class FlyCameraAdapter(EngineAdapter):
    """EngineAdapter that wires a FlyCamera to viewer input. Instances stay
    whatever the renderer already holds (caller-owned list semantics,
    lib.rs:984) unless `instances_fn(t, dt)` is given."""

    def __init__(self, flycam: Optional[FlyCamera] = None, instances_fn=None):
        self.flycam = flycam or FlyCamera()
        self.instances_fn = instances_fn
        self._pending = ([], 0.0, 0.0)   # (keys, dx, dy) since last tick

    def queue_input(self, keys, dx: float, dy: float) -> None:
        k0, dx0, dy0 = self._pending
        self._pending = (list(keys), dx0 + dx, dy0 + dy)

    def extract(self, t: float, dt: float):
        keys, dx, dy = self._pending
        self._pending = (keys, 0.0, 0.0)
        self.flycam.apply_input(keys, dx, dy, dt)
        inst = self.instances_fn(t, dt) if self.instances_fn else None
        return self.flycam.camera(), inst
