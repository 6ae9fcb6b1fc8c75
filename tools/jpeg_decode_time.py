"""Time the port's JPEG reader (sunray_tpu_torch/utils/jpeg.py) on a
1024x1024 4:2:0 texture, against PIL's decode of the same stream.

    python3 tools/jpeg_decode_time.py [--size 1024] [--reps 3]

The textures are seeded: smooth bands with Gaussian noise of sigma 0, 8
and 20 levels, encoded by PIL at quality 75 and 95 with 4:2:0 chroma.
Needs PIL (to encode), so it runs where the tests run. Prints one line a
texture: stream bytes, the reader's best time of `reps`, PIL's, and
whether the pixels are equal.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sunray_tpu_torch.utils.jpeg import read_jpeg_rgba  # noqa: E402


def best(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return min(times), out


def main():
    from PIL import Image

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    n = args.size
    g = np.random.default_rng(0)
    yy, xx = np.mgrid[0:n, 0:n]
    base = np.stack([128 + 100 * np.sin(xx / 37 + c) * np.cos(yy / 53)
                     for c in range(3)], -1)
    for sigma in (0, 8, 20):
        img = np.clip(base + g.normal(0, sigma, base.shape), 0,
                      255).astype(np.uint8)
        for quality in (75, 95):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=quality,
                                      subsampling=2)
            data = buf.getvalue()
            t, got = best(lambda: read_jpeg_rgba(data), args.reps)
            tp, want = best(lambda: np.asarray(
                Image.open(io.BytesIO(data)).convert("RGBA")), args.reps)
            print(f"{n}x{n} 4:2:0 sigma {sigma:2d} q{quality}: "
                  f"{len(data):7d} bytes, read_jpeg_rgba {t:.3f} s, "
                  f"PIL {tp:.4f} s, equal {np.array_equal(got, want)}")


if __name__ == "__main__":
    main()
