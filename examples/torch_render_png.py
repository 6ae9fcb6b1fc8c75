"""Offline render on the PyTorch port (sunray_tpu_torch) — the examples/png
analog (examples/png/main.rs), port of examples/render_png.py; on the card
unless --cpu.

Renders the Cornell box (or the reflection room with --scene room, or a
glTF file with --scene glb --gltf PATH) through the full pipeline with
16 warm-up frames and writes a PNG.

Usage: python examples/torch_render_png.py [--scene cornell|room|glb]
       [--gltf PATH] [--size WxH] [--out out/render.png]
       [--lighting restir|nee|brdf] [--warmup 16] [--cpu]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import os
import sys
import time

# The reference's offline golden setup (examples/png/main.rs:45-57): camera
# (13, 30, 25) -> (0, 13, 0), fov_y 45, at 1600x1200.
GLB_CAMERA = dict(position=(13.0, 30.0, 25.0), target=(0.0, 13.0, 0.0),
                  fov_y=45.0)
GLB_SIZE = "1600x1200"


def scene_and_camera(scene, device):
    """(SceneBuffers or None, Camera) of render_png.py:60-74; "glb" has no
    scene until the Renderer loads the file."""
    from sunray_tpu_torch.camera import Camera
    from sunray_tpu_torch.scene import cornell_box, reflection_room

    if scene == "cornell":
        return (cornell_box(device=device),
                Camera(position=(1.0, 1.0, 4.4), target=(1.0, 1.0, 0.0),
                       fov_y=50.0))
    if scene == "room":
        return (reflection_room(device=device),
                Camera(position=(2.0, 2.2, 9.0), target=(2.0, 1.6, 0.0),
                       fov_y=50.0))
    return None, Camera(**GLB_CAMERA)


def run(scene="cornell", gltf=None, size=None, out="out/render.png",
        lighting="restir", warmup=16, device="cuda"):
    """Render and write the PNG, printing what render_png.py prints.
    size: "WxH" (default 800x600, 1600x1200 for "glb"). Returns
    {"path", "image" ((H, W, 4) uint8), "seconds", "size", "frames"}."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.utils.png import write_png

    if scene == "glb" and gltf is None:
        raise ValueError("--scene glb needs --gltf PATH (ReflectionRoom.glb "
                         "is not in the repository)")
    size = size or (GLB_SIZE if scene == "glb" else "800x600")
    w, h = (int(x) for x in size.split("x"))
    cfg = RenderConfig(width=w, height=h, lighting=lighting)
    buffers, camera = scene_and_camera(scene, device)
    r = Renderer(cfg, buffers, device=device)
    if scene == "glb":
        r.load_gltf(gltf)
    t0 = time.time()
    img = r.render_to_host_memory(camera, warmup=warmup)
    dt = time.time() - t0
    print(f"rendered {w}x{h} ({warmup}+1 frames) in {dt:.2f}s",
          file=sys.stderr)

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_png(out, img)
    print(f"You can find your render here: {out}")
    return {"path": out, "image": img, "seconds": dt, "size": [w, h],
            "frames": warmup + 1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "room", "glb"])
    ap.add_argument("--gltf", default=None,
                    help="GLB/glTF path for --scene glb, rendered with the "
                         "camera of examples/png/main.rs:45-57")
    ap.add_argument("--size", default=None,
                    help="WxH (default 800x600; 1600x1200 with --scene glb)")
    ap.add_argument("--out", default="out/render.png")
    ap.add_argument("--lighting", default="restir",
                    choices=["restir", "nee", "brdf"])
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.scene == "glb" and args.gltf is None:
        ap.error("--scene glb needs --gltf PATH")
    return run(scene=args.scene, gltf=args.gltf, size=args.size,
               out=args.out, lighting=args.lighting, warmup=args.warmup,
               device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
