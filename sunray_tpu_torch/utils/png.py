"""Dependency-free PNG encode / decode — port of sunray_tpu/utils/png.py.

The port's only image decoder (the machine with the card has no PIL):
8-bit, non-interlaced PNG of colour types 0 (grey), 2 (RGB), 3 (palette,
with tRNS alpha), 4 (grey + alpha) and 6 (RGBA), all five row filters.
read_png returns the stored channels, as the JAX package's read_png does;
read_png_rgba expands them to RGBA as PIL's Image.convert("RGBA") does (a
tRNS key of a grey or RGB image is alpha 0 on the pixels equal to it).
Both accept a path, bytes or a binary file object. Anything else (16-bit
or sub-byte samples, interlacing, another format such as JPEG) raises
NotImplementedError naming it.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"RIFF", "WebP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
          (b"\xabKTX", "KTX2"))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """img: (H, W), (H, W, 3 | 4) uint8, or float in [0, 1] -> PNG bytes
    (filter 0 on every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0,
                                          0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3 | 4) uint8 or float in [0, 1] (png.py:25-42)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the row filters (PNG spec 9.2): None and Up on whole rows, Sub
    as a running sum a channel, Average and Paeth pixel by pixel."""
    stride = w * c
    if raw.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    zero = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y > 0 else zero
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            cur = line.reshape(w, c).copy()
            up = prev.reshape(w, c)
            left = np.zeros(c, np.int32)
            upleft = np.zeros(c, np.int32)
            for x in range(w):
                b = up[x]
                if ftype == 3:
                    pred = (left + b) >> 1
                else:
                    pa = np.abs(b - upleft)
                    pb = np.abs(left - upleft)
                    pc = np.abs(left + b - 2 * upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, b, upleft))
                cur[x] = (cur[x] + pred) & 0xFF
                left, upleft = cur[x], b
            cur = cur.reshape(-1)
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
    return out.reshape(h, w, c)


def _read_bytes(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return f.read()
    return src.read()


def image_kind(data: bytes) -> str:
    """"PNG" or the format a file's magic bytes name ("unknown" if none)."""
    if data[:8] == _SIG:
        return "PNG"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


def _decode(data: bytes):
    """(stored channels (H, W, C) uint8, colour type, PLTE, tRNS)."""
    kind = image_kind(data)
    if kind != "PNG":
        raise NotImplementedError(f"{kind} images are not decoded (PNG only)")
    pos, idat, meta, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body)
            if ctype not in _CHANNELS:
                raise ValueError(f"bad PNG colour type {ctype}")
            if depth != 8:
                raise NotImplementedError(
                    f"{depth}-bit PNG samples are not decoded (8-bit only)")
            if interlace != 0:
                raise NotImplementedError("interlaced (Adam7) PNG is not "
                                          "decoded")
            meta = (w, h, ctype)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if meta is None:
        raise ValueError("PNG without IHDR")
    w, h, ctype = meta
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w, _CHANNELS[ctype]), ctype, plte, trns


def read_png(src) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG (path, bytes or file object) ->
    (H, W, C) uint8 of the stored channels (png.py:81-109)."""
    return _decode(_read_bytes(src))[0]


def read_png_rgba(src) -> np.ndarray:
    """Decode to (H, W, 4) uint8 RGBA, as PIL's convert("RGBA") does."""
    img, ctype, plte, trns = _decode(_read_bytes(src))
    h, w = img.shape[:2]
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        alpha = np.full(plte.shape[0], 255, np.uint8)
        if trns is not None:
            a = np.frombuffer(trns, np.uint8)[:plte.shape[0]]
            alpha[:a.size] = a
        lut = np.concatenate([plte, alpha[:, None]], axis=1)
        idx = img[..., 0].astype(np.int64)
        # An index past the palette reads as black, opaque or not, as PIL.
        lut = np.concatenate([lut, np.zeros((256 - lut.shape[0], 4), np.uint8)
                              + np.uint8([0, 0, 0, 255])])
        return lut[idx]
    if ctype in (0, 4):
        rgb = np.repeat(img[..., :1], 3, axis=-1)
    else:
        rgb = img[..., :3]
    if ctype in (4, 6):
        alpha = img[..., -1:]
    else:
        alpha = np.full((h, w, 1), 255, np.uint8)
        if trns is not None:
            key = struct.unpack(">" + "H" * (len(trns) // 2), trns)
            key = np.asarray(key[:1] * 3 if ctype == 0 else key[:3])
            if (key < 256).all():
                alpha[(rgb == key.astype(np.uint8)).all(axis=-1)] = 0
    return np.concatenate([rgb, alpha], axis=-1)
