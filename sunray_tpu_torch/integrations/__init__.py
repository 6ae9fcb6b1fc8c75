"""Host-app integrations — port of sunray_tpu/integrations (the analog of
the reference's L7 layer).

The reference integrates via a winit window fly-cam app
(examples/window/main.rs) and a Bevy engine plugin
(src/bevy_integration/plugin.rs). The integration points here are:

- `EngineAdapter` (engine.py): the per-tick extract contract the Bevy
  plugin implements (camera + instance list in, frame out).
- `LiveViewer` (viewer.py): an HTTP live viewer with a browser fly-cam —
  the interactive `window` example analog (swapchain-present becomes an
  MJPEG/poll stream to the browser).
- `ViewerServer` (web_viewer.py, imported from there): the MJPEG viewer
  with clickable HUD widgets.
"""

from sunray_tpu_torch.integrations.engine import EngineAdapter, FlyCamera
from sunray_tpu_torch.integrations.viewer import LiveViewer

__all__ = ["EngineAdapter", "FlyCamera", "LiveViewer"]
