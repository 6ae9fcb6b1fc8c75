"""Browser live viewer on the PyTorch port (sunray_tpu_torch/integrations/
web_viewer.py): MJPEG fly-cam + clickable HUD over HTTP, on the card
unless --cpu (reach it through `ssh -L 8000:127.0.0.1:8000 ...`).

Usage:
  python examples/torch_web_viewer.py [--size 640x360] [--port 8000] [--cpu]
                                      [--scene cornell] [--frames N]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:
    pass

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scene", default="cornell", choices=["cornell"])
    ap.add_argument("--frames", type=int, default=0,
                    help="exit after N frames (0 = run forever)")
    args = ap.parse_args()

    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.integrations.web_viewer import ViewerServer

    w, h = (int(x) for x in args.size.split("x"))
    cfg = RenderConfig(width=w, height=h, lighting="restir",
                       denoise_passes=2)
    ViewerServer(cfg, host=args.host, port=args.port, max_frames=args.frames,
                 device="cpu" if args.cpu else "cuda").serve()


if __name__ == "__main__":
    main()
