"""PyTorch port, utils/jpeg.py: the baseline JPEG reader against PIL's
decode (libjpeg-turbo), bit for bit, on

  - the repo's two JPEGs (docs/renders/web_viewer_*.jpg) and their pixels'
    SHA-256 (chip_smoke.py phase 13 checks the same constants on the
    machine with the card, which has no PIL);
  - seeded images that PIL encodes at quality 25, 75, 95 and 100 with
    subsampling 0, 1 and 2 (4:4:4, 4:2:2, 4:2:0), grey, restart markers
    and optimised Huffman tables, at 1x1, 17x9, 37x23 and 480x270;
  - streams written by a small baseline encoder here, for what PIL does
    not write: 4:4:0 (h1v2) and the other mixes of factors 1 and 2,
    one-component scans, 16-bit quantisation tables under SOF1, an Adobe
    or component-id RGB image, restart intervals across scans;

and the streams it refuses: arithmetic-coded progressive, lossless,
arithmetic-coded, 12-bit and CMYK raise NotImplementedError naming the
format, a truncated stream ValueError (progressive Huffman streams are
tests/test_torch_jpeg_progressive.py's)."""

import hashlib
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu_torch.utils import jpeg
from sunray_tpu_torch.utils.jpeg import read_jpeg, read_jpeg_rgba

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_JPEGS = {
    "web_viewer_frame.jpg":
        "e94f9e31b4ba42ef3e811a50f8c00f68b0b2e00c58275f6ce8f0733adf6eb4b4",
    "web_viewer_spawned.jpg":
        "25936acc50ad4d44c6e983a96e7443335eb20e20e19e9059f6e57669b913dc2f",
}
SIZES = [(1, 1), (9, 17), (23, 37), (270, 480)]      # (height, width)


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def seeded_image(h, w, seed, channels=3):
    """Smooth bands plus noise: structure at every frequency."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / (5 + 3 * c) + c)
                     * np.cos(yy / (7 + 2 * c)) for c in range(channels)], -1)
    img = np.clip(base + g.normal(0, 24, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def pil_jpeg(img, **kw):
    """img: a uint8 array, or a PIL image (e.g. CMYK)."""
    buf = io.BytesIO()
    im = img if isinstance(img, Image.Image) else Image.fromarray(img)
    im.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def assert_pil_equal(data):
    got, want = read_jpeg_rgba(data), pil_rgba(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(REPO_JPEGS))
def test_repo_jpegs(name):
    path = os.path.join(REPO, "docs", "renders", name)
    got = read_jpeg_rgba(path)
    np.testing.assert_array_equal(got, np.asarray(
        Image.open(path).convert("RGBA")))
    assert hashlib.sha256(got.tobytes()).hexdigest() == REPO_JPEGS[name]
    with open(path, "rb") as f:                 # a file object
        np.testing.assert_array_equal(read_jpeg_rgba(f), got)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [25, 75, 95, 100])
def test_pil_encoded(quality, subsampling, size):
    img = seeded_image(*size, seed=quality + 7 * subsampling)
    assert_pil_equal(pil_jpeg(img, quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", ["grey", "restart", "optimize"])
def test_pil_encoded_options(kind, size):
    if kind == "grey":
        data = pil_jpeg(seeded_image(*size, seed=3, channels=1), quality=80)
        assert read_jpeg(data).shape == (*size, 1)
    elif kind == "restart":
        data = pil_jpeg(seeded_image(*size, seed=4), quality=85,
                        restart_marker_blocks=2, subsampling=2)
        assert b"\xff\xdd" in data
    else:
        data = pil_jpeg(seeded_image(*size, seed=5), quality=90,
                        optimize=True, subsampling=1)
    assert_pil_equal(data)


# -- a baseline encoder for the streams PIL does not write -------------------

_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8.0)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _flat_table(symbols):
    """A valid Huffman table giving every symbol the same length L with
    2^L > count (the all-ones code stays free)."""
    length = max(1, int(np.ceil(np.log2(len(symbols) + 1))))
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    codes = {s: (i, length) for i, s in enumerate(symbols)}
    return counts, list(symbols), codes


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v):
    return 0 if v == 0 else int(abs(v)).bit_length()


def _bits_of(v, s):
    return v if v >= 0 else v + (1 << s) - 1


def _seg(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode(img, factors, quality_scale=1.0, interleaved=True, restart=0,
           q16=False, color="ycc", markers=("jfif",), extreme=False):
    """img: (H, W, 3) uint8 RGB (or (H, W) grey, factors of length 1).
    factors: (h, v) per component. color: "ycc" converts to YCbCr, "rgb"
    stores RGB. extreme: the first luma block's coefficients set to +-1023
    in a checkerboard, so the inverse DCT's output leaves [-512, 511].
    Returns a baseline (SOF0) or, with q16, SOF1 stream."""
    img = np.asarray(img, np.float64)
    h_img, w_img = img.shape[:2]
    if img.ndim == 2:
        planes = [img]
    elif color == "ycc":
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    else:
        planes = [img[..., c] for c in range(3)]
    nc = len(planes)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    base_q = np.clip(np.round((4 + np.add.outer(np.arange(8), np.arange(8))
                               * 3) * quality_scale), 1,
                     1000 if q16 else 255).astype(np.int64)
    qts = [base_q, np.clip(base_q * 2, 1, 1000 if q16 else 255)]
    dc_tab = _flat_table(list(range(12)))
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]
    ac_tab = _flat_table(ac_syms)
    comps = []
    for ci, (plane, (fh, fv)) in enumerate(zip(planes, factors)):
        dw, dh = -(-w_img * fh // hmax), -(-h_img * fv // vmax)
        # Downsample by block means over the factor ratio, then pad by
        # edge repetition to the MCU grid.
        rh, rv = hmax // fh, vmax // fv
        p = np.pad(plane, ((0, dh * rv - h_img), (0, dw * rh - w_img)),
                   mode="edge").reshape(dh, rv, dw, rh).mean(axis=(1, 3))
        bx, by = mcux * fh, mcuy * fv
        p = np.pad(p, ((0, by * 8 - dh), (0, bx * 8 - dw)), mode="edge")
        blocks = p.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT)
        q = qts[min(ci, 1)]
        quant = np.round(coef / q).astype(np.int64)
        quant[..., 0, 0] = np.clip(quant[..., 0, 0], -2047, 2047)
        if extreme and ci == 0:
            quant[0, 0] = np.where(np.add.outer(np.arange(8), np.arange(8))
                                   % 2, -1023, 1023)
            quant[0, 0, 0, 0] = 0
        comps.append(dict(id=ci + 1 if color == "ycc" else b"RGB"[ci],
                          h=fh, v=fv, tq=min(ci, 1), quant=quant, dw=dw,
                          dh=dh, bx=bx))

    def block_bits(bits, blk, pred):
        zz = blk.reshape(64)[jpeg.ZIGZAG]
        zz[1:] = np.clip(zz[1:], -1023, 1023)
        diff = int(zz[0]) - pred
        s = _category(diff)
        code, ln = dc_tab[2][s]
        bits.put(code, ln)
        if s:
            bits.put(_bits_of(diff, s), s)
        run = 0
        for k in range(1, 64):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_tab[2][0xF0])
                run -= 16
            s = _category(v)
            bits.put(*ac_tab[2][(run << 4) | s])
            bits.put(_bits_of(v, s), s)
            run = 0
        if run:
            bits.put(*ac_tab[2][0x00])
        return int(zz[0])

    def scan(scan_comps, units):
        """units: list of MCUs, each a list of (component index, by, bx)."""
        out = bytearray()
        bits, pred, rst = _Bits(), [0] * nc, 0
        for m, unit in enumerate(units):
            if restart and m and m % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
                bits, pred = _Bits(), [0] * nc
            for ci, by, bx in unit:
                pred[ci] = block_bits(bits, comps[ci]["quant"][by, bx],
                                      pred[ci])
        bits.flush()
        out += bits.out
        header = bytes([len(scan_comps)]) + b"".join(
            bytes([comps[ci]["id"], (0 << 4) | 0]) for ci in scan_comps)
        return _seg(0xDA, header + bytes([0, 63, 0])) + bytes(out)

    out = bytearray(b"\xff\xd8")
    if "jfif" in markers:
        out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if "adobe_rgb" in markers:
        out += _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    for t, q in enumerate(qts[:min(nc, 2)]):
        zz = q.reshape(64)[jpeg.ZIGZAG]
        body = (bytes([0x10 | t]) + zz.astype(">u2").tobytes() if q16
                else bytes([t]) + zz.astype(np.uint8).tobytes())
        out += _seg(0xDB, body)
    sof = bytes([8]) + struct.pack(">HH", h_img, w_img) + bytes([nc]) + \
        b"".join(bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]])
                 for c in comps)
    out += _seg(0xC1 if q16 else 0xC0, sof)
    for tc, tab in ((0, dc_tab), (1, ac_tab)):
        out += _seg(0xC4, bytes([tc << 4]) + bytes(tab[0]) + bytes(tab[1]))
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    if interleaved or nc == 1:
        units = []
        if nc == 1:
            c = comps[0]
            units = [[(0, y, x)] for y in range(-(-c["dh"] // 8))
                     for x in range(-(-c["dw"] // 8))]
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    units.append([(ci, my * c["v"] + yy, mx * c["h"] + xx)
                                  for ci, c in enumerate(comps)
                                  for yy in range(c["v"])
                                  for xx in range(c["h"])])
        out += scan(list(range(nc)), units)
    else:
        for ci, c in enumerate(comps):
            units = [[(ci, y, x)] for y in range(-(-c["dh"] // 8))
                     for x in range(-(-c["dw"] // 8))]
            out += scan([ci], units)
    return bytes(out + b"\xff\xd9")


FACTOR_CASES = {
    "440": [(1, 2), (1, 1), (1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)],
    "luma_h2_chroma_v2": [(2, 1), (1, 2), (1, 2)],
    "chroma_full_luma_half": [(1, 1), (2, 2), (2, 2)],
    "mixed": [(2, 2), (2, 1), (1, 2)],
}
ENC_SIZES = [(1, 1), (5, 3), (4, 4), (9, 17), (23, 37), (64, 48)]


@pytest.mark.parametrize("size", ENC_SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", sorted(FACTOR_CASES))
def test_sampling_factors(case, size):
    img = seeded_image(*size, seed=11)
    assert_pil_equal(encode(img, FACTOR_CASES[case], quality_scale=0.7))


@pytest.mark.parametrize("kind", ["noninterleaved", "noninterleaved_restart",
                                  "q16_sof1", "adobe_rgb", "rgb_ids",
                                  "grey_factor_2x2", "restart_420",
                                  "coarse"])
def test_encoder_streams(kind):
    img = seeded_image(37, 45, seed=12)
    f420 = FACTOR_CASES["420"]
    data = {
        "noninterleaved": lambda: encode(img, f420, interleaved=False),
        "noninterleaved_restart": lambda: encode(img, f420, restart=3,
                                                 interleaved=False),
        "q16_sof1": lambda: encode(img, f420, quality_scale=9.0, q16=True),
        "adobe_rgb": lambda: encode(img, [(1, 1)] * 3, color="rgb",
                                    markers=("adobe_rgb",)),
        "rgb_ids": lambda: encode(img, [(1, 1)] * 3, color="rgb",
                                  markers=()),
        "grey_factor_2x2": lambda: encode(img[..., 0], [(2, 2)]),
        "restart_420": lambda: encode(img, f420, restart=1),
        # Coarse tables: large coefficient errors, samples past [0, 255].
        "coarse": lambda: encode(img, f420, quality_scale=30.0),
    }[kind]()
    assert_pil_equal(data)


def test_out_of_range_block_alone_differs():
    """Dequantised coefficients past 16 bits (no encoder of 8-bit samples
    writes them): libjpeg-turbo's SIMD inverse DCT wraps and saturates its
    16-bit lanes there, the port computes in 64 bits and saturates the
    output, so that block's MCU (16x16 pixels at 4:2:0, its chroma
    context a row and a column further) may differ; every other pixel is
    PIL's."""
    img = seeded_image(37, 45, seed=12)
    data = encode(img, FACTOR_CASES["420"], quality_scale=30.0, extreme=True)
    got, want = read_jpeg_rgba(data), pil_rgba(data)
    differ = (got != want).any(-1)
    assert differ[:16, :16].any()
    assert not differ[17:].any() and not differ[:, 17:].any()


# -- the streams it refuses --------------------------------------------------

def _patch_sof(data, marker=None, precision=None, sof=0xC0):
    i = data.index(bytes([0xFF, sof]))
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


BASE = pil_jpeg(seeded_image(16, 16, seed=1), quality=75)


@pytest.mark.parametrize("kind,match", [
    ("progressive", "progressive"),
    ("lossless", "lossless"),
    ("arithmetic", "arithmetic"),
    ("12bit", "12-bit"),
    ("cmyk", "CMYK"),
])
def test_unsupported_raise(kind, match):
    data = {
        # Progressive Huffman streams decode (test_torch_jpeg_progressive.py);
        # the arithmetic-coded progressive process stays refused.
        "progressive": lambda: _patch_sof(pil_jpeg(
            seeded_image(16, 16, seed=1), progressive=True), marker=0xCA,
            sof=0xC2),
        "lossless": lambda: _patch_sof(BASE, marker=0xC3),
        "arithmetic": lambda: _patch_sof(BASE, marker=0xC9),
        "12bit": lambda: _patch_sof(BASE, precision=12),
        "cmyk": lambda: pil_jpeg(Image.fromarray(
            seeded_image(16, 16, seed=1)).convert("CMYK")),
    }[kind]()
    with pytest.raises(NotImplementedError, match=match):
        read_jpeg_rgba(data)


@pytest.mark.parametrize("cut", [2, 100, 300, -200, -40, -2])
def test_truncated_raises(cut):
    data = pil_jpeg(seeded_image(64, 64, seed=9), quality=90)
    with pytest.raises(ValueError):
        read_jpeg_rgba(data[:cut])


def test_not_a_jpeg_raises():
    with pytest.raises(ValueError, match="SOI"):
        read_jpeg_rgba(b"\x89PNG\r\n\x1a\n" + bytes(32))
