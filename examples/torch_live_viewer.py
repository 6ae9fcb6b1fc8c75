"""Interactive fly-cam viewer on the PyTorch port (sunray_tpu_torch) — the
examples/window analog with real input, on the card unless --cpu.

Serves the renderer at http://127.0.0.1:8090 : click the image for
pointer-lock mouse-look, WASD to fly (Q/E down/up). Also runs the scripted
runtime-churn test from the reference's window example (spawn a duplicate
instance at frame 120, despawn at 240, window/main.rs:222-234).

Usage: python examples/torch_live_viewer.py [--size 480x360] [--port 8090]
       [--frames N] [--seconds S] [--cpu]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="480x360")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.integrations import LiveViewer
    from sunray_tpu_torch.integrations.engine import FlyCameraAdapter
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.scene import cornell_box
    from sunray_tpu_torch.scene.manager import SceneManager
    from sunray_tpu_torch.scene.types import translate

    w, h = (int(x) for x in args.size.split("x"))
    r = Renderer(RenderConfig(width=w, height=h, lighting="restir"),
                 device=device)
    box = cornell_box(device=device)
    r._manager = SceneManager.from_scene_buffers(box)
    base = r._manager.default_instances(box)
    r.scene = r._manager.build(base)

    smallest = min(
        base, key=lambda kt: r._manager._meshes[kt[0]].tri_vidx.shape[0])[0]

    adapter = FlyCameraAdapter()
    frame_box = {"n": 0}

    def instances_fn(t, dt):
        # window/main.rs:222-234 scripted churn at frames 120/240.
        n = frame_box["n"]
        frame_box["n"] = n + 1
        if 120 <= n < 240:
            return list(base) + [(smallest, translate(0.0, -0.8, 0.0))]
        return list(base)

    adapter.instances_fn = instances_fn

    viewer = LiveViewer(r, adapter, port=args.port)
    print(f"live viewer at {viewer.address}  (Ctrl-C to stop)")
    try:
        n = viewer.run(max_frames=args.frames, max_seconds=args.seconds)
    except KeyboardInterrupt:
        n = viewer.frame_index
    finally:
        viewer.stop()
    print(f"rendered {n} frames, final fps {viewer.fps:.2f}")


if __name__ == "__main__":
    main()
