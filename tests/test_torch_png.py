"""PyTorch port, utils/png.py: the decoder against PIL's convert("RGBA")
and against the JAX package's read_png, for every colour type the port
reads (grey, RGB, palette with tRNS, grey + alpha, RGBA, and grey / RGB
with a tRNS key) and each of the five row filters, from seeded images
written here; the reader takes a path, bytes and a file object; what it
cannot decode raises NotImplementedError naming it."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from sunray_tpu.utils.png import read_png as jread_png
from sunray_tpu_torch.utils import png

SIG = b"\x89PNG\r\n\x1a\n"


def chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(img, ftype):
    """Rows of img (H, W, C) uint8 under filter ftype, each with its
    filter byte."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        pred = [0, left, up, (left + up) >> 1, paeth(left, up, upleft)][ftype]
        out.append(bytes([ftype]) + ((x[y] - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
    return b"".join(out)


def encode(img, ctype, ftype, plte=None, trns=None, depth=8, interlace=0):
    h, w = img.shape[:2]
    data = SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                            0, interlace))
    if plte is not None:
        data += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", trns)
    # Split the image data over two IDAT chunks.
    z = zlib.compress(filter_rows(img, ftype))
    data += chunk(b"IDAT", z[:len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:])
    return data + chunk(b"IEND", b"")


def case(kind, seed):
    g = np.random.default_rng(seed)
    h, w = 7, 9
    if kind == "palette":
        plte = g.integers(0, 256, (12, 3))
        trns = bytes(g.integers(0, 256, 7).astype(np.uint8))
        return dict(img=g.integers(0, 12, (h, w, 1)).astype(np.uint8),
                    ctype=3, plte=plte, trns=trns)
    ctype, c = {"grey": (0, 1), "rgb": (2, 3), "grey_alpha": (4, 2),
                "rgba": (6, 4), "grey_key": (0, 1), "rgb_key": (2, 3)}[kind]
    img = g.integers(0, 256, (h, w, c)).astype(np.uint8)
    trns = None
    if kind.endswith("_key"):
        key = img[2, 3].astype(np.uint16)
        trns = struct.pack(">" + "H" * c, *key)
    return dict(img=img, ctype=ctype, trns=trns)


KINDS = ["grey", "rgb", "palette", "grey_alpha", "rgba", "grey_key", "rgb_key"]


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_pil_and_jax(kind, ftype, tmp_path):
    c = case(kind, seed=KINDS.index(kind) * 5 + ftype)
    data = encode(c["img"], c["ctype"], ftype, c.get("plte"), c.get("trns"))
    path = tmp_path / "img.png"
    path.write_bytes(data)
    raw = png.read_png(str(path))
    np.testing.assert_array_equal(raw, c["img"])
    np.testing.assert_array_equal(raw, jread_png(str(path)))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(png.read_png_rgba(data), want)


def test_reader_takes_path_bytes_and_file_objects(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (5, 6, 4)).astype(np.uint8)
    path = tmp_path / "a.png"
    png.write_png(str(path), img)
    data = path.read_bytes()
    for src in (str(path), path, data, io.BytesIO(data)):
        np.testing.assert_array_equal(png.read_png_rgba(src), img)
    # the encoder is the JAX package's: its reader reads what this writes
    np.testing.assert_array_equal(jread_png(str(path)), img)


@pytest.mark.parametrize("what", ["jpeg", "16bit", "interlaced"])
def test_undecodable_raises(what):
    img = np.zeros((4, 4, 3), np.uint8)
    if what == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        data, match = buf.getvalue(), "JPEG"
    elif what == "16bit":
        data, match = encode(img, 2, 0, depth=16), "16-bit"
    else:
        data, match = encode(img, 2, 0, interlace=1), "interlaced"
    with pytest.raises(NotImplementedError, match=match):
        png.read_png_rgba(data)
