"""Terminal live viewer on the PyTorch port (sunray_tpu_torch) — port of
examples/term_viewer.py; on the card unless --cpu.

An interactive display client for a headless host reached over ssh/tmux:
frames are ANSI half-block art (each character cell is two vertical
pixels: the upper-half-block glyph with separate fg/bg colors), and
WASD/QE + arrow-key look input is read from the raw terminal — the
examples/window fly-cam loop (examples/window/main.rs) through the same
EngineAdapter contract as the HTTP viewer (integrations/engine.py).

Usage:
  python examples/torch_term_viewer.py [--size 160x96] [--cpu] [--frames N]
  (run inside tmux or a real terminal; --frames for scripted runs)

Keys: w/a/s/d move, q/e down/up, arrows look, x quits.
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import select
import sys
import termios
import time
import tty

import numpy as np

ESC = "\x1b"


def frame_to_ansi(img: np.ndarray) -> str:
    """(H, W, 3) float -> ANSI string, two pixels per character cell
    (upper half block: fg = top row, bg = bottom row); an odd last row is
    dropped."""
    u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h = u8.shape[0] - (u8.shape[0] % 2)
    top = u8[0:h:2]
    bot = u8[1:h:2]
    rows = []
    for y in range(top.shape[0]):
        cells = []
        for x in range(top.shape[1]):
            tr, tg, tb = (int(v) for v in top[y, x])
            br, bg_, bb = (int(v) for v in bot[y, x])
            cells.append(
                f"{ESC}[38;2;{tr};{tg};{tb}m{ESC}[48;2;{br};{bg_};{bb}m▀"
            )
        rows.append("".join(cells) + f"{ESC}[0m")
    return "\n".join(rows)


class RawTerm:
    """cbreak input stream for non-blocking key reads (restored on exit).
    stream: a text stream on a terminal (default sys.stdin); a stream that
    is not a terminal (piped, scripted) gives no keys.

    Keys are read one character at a time from the text stream after a
    select() on its descriptor, as term_viewer.py reads sys.stdin. The
    stream's buffer can hold the rest of an arrow key's escape sequence
    where select() does not see it: the reference's fault, kept (ROADMAP
    Queue 3)."""

    def __init__(self, stream=None):
        self.stream = sys.stdin if stream is None else stream

    def __enter__(self):
        self.fd = self.stream.fileno()
        try:
            self.saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
            self.raw = True
        except (termios.error, OSError):
            self.raw = False     # piped input (scripted run)
        return self

    def __exit__(self, *exc):
        if self.raw:
            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def read_keys(self):
        keys = []
        dx = dy = 0.0
        if not self.raw:
            return keys, dx, dy
        stream = self.stream
        while select.select([stream], [], [], 0)[0]:
            ch = stream.read(1)
            if ch == ESC:  # arrow keys: ESC [ A/B/C/D
                rest = stream.read(2) if select.select(
                    [stream], [], [], 0)[0] else ""
                if rest.endswith("A"):
                    dy -= 40
                elif rest.endswith("B"):
                    dy += 40
                elif rest.endswith("C"):
                    dx += 40
                elif rest.endswith("D"):
                    dx -= 40
            elif ch:
                keys.append(ch.lower())
        return keys, dx, dy


def run(size="160x96", frames=0, device="cuda", stdin=None):
    """The loop of term_viewer.py:115-152 on sys.stdout, keys from `stdin`
    (default sys.stdin), until 'x' or `frames` frames. Returns {"frames",
    "fps", "seconds", "position", "ansi_bytes" (of the last frame)}."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.integrations.engine import FlyCameraAdapter
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.scene import cornell_box

    out = sys.stdout
    w, h = (int(x) for x in size.split("x"))
    cfg = RenderConfig(width=w, height=h, lighting="restir",
                       denoise_passes=2)
    r = Renderer(cfg, device=device)
    r.load_scene(cornell_box(device=device))
    adapter = FlyCameraAdapter()
    adapter.flycam.position = np.array([1.0, 1.0, 3.4])

    out.write(f"{ESC}[2J")          # clear once
    t_start = t_prev = time.time()
    fps = 0.0
    frame = 0
    ansi = ""
    with RawTerm(stdin) as term:
        while True:
            keys, dx, dy = term.read_keys()
            if "x" in keys:
                break
            t_now = time.time()
            dt = max(t_now - t_prev, 1e-6)
            adapter.queue_input([k for k in keys if k in "wasdqe"], dx, dy)
            cam, instances = adapter.extract(t_now, dt)
            ldr = r.render(cam, instances=instances).cpu().numpy()
            inst = 1.0 / max(time.time() - t_prev, 1e-6)
            fps = inst if fps == 0 else 0.9 * fps + 0.1 * inst
            t_prev = time.time()
            ansi = frame_to_ansi(ldr)
            out.write(f"{ESC}[H")   # home cursor, no flicker clear
            out.write(ansi)
            out.write(
                f"\n{ESC}[0mFPS {fps:6.2f}  frame {frame:5d}  "
                f"pos {np.round(adapter.flycam.position, 2)}  "
                f"[wasdqe move, arrows look, x quits]{ESC}[K\n"
            )
            out.flush()
            frame += 1
            if frames and frame >= frames:
                break
    print(f"{ESC}[0m\nterm_viewer: {frame} frames, steady fps {fps:.2f}")
    return {"frames": frame, "fps": fps, "seconds": time.time() - t_start,
            "position": adapter.flycam.position.tolist(),
            "ansi_bytes": len(ansi.encode())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="160x96",
                    help="render WxH; terminal shows W x H/2 cells")
    ap.add_argument("--frames", type=int, default=0,
                    help="exit after N frames (0 = run until 'x')")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    return run(size=args.size, frames=args.frames,
               device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
