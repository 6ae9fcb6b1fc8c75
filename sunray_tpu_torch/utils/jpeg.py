"""Dependency-free JPEG decoder and baseline encoder.

The port's JPEG reader for glTF textures and writer for the viewers'
MJPEG streams (the machine with the card has no PIL; the JAX package
decodes and encodes every image through PIL, sunray_tpu/scene/gltf.py,
integrations/viewer.py). read_jpeg_rgba returns the (H, W, 4) uint8 array
that PIL's Image.open(...).convert("RGBA") gives, computed the way
libjpeg-turbo's default decompression computes it, so that the two agree
bit for bit (tests/test_torch_jpeg.py, test_torch_jpeg_progressive.py):

  - Huffman entropy decoding (a bit loop in Python; everything else is
    vectorised numpy): sequential scans, and progressive scans (DC first
    and refinement, spectral bands with end-of-band runs and successive
    approximation; jdphuff.c) into coefficient planes kept across scans;
  - dequantisation and the "islow" integer inverse DCT (jidctint.c: 13
    constant bits, 2 pass-1 bits), its output limited to [0, 255] as the
    SIMD build saturates it. The arithmetic here is 64-bit; the SIMD
    build's lanes are 16 bits wide, so a stream whose dequantised
    coefficients leave 16 bits (no encoder of 8-bit samples writes one)
    decodes differently in the blocks that hold them;
  - "fancy" chroma upsampling (jdsample.c): the triangular h2v1 and h2v2
    filters with the image's edge rows and columns repeated as context,
    h1v2, and box replication where a subsampled plane is at most two
    samples wide (libjpeg-turbo's rule);
  - jdcolor.c's fixed-point YCbCr -> RGB tables (16 scale bits).

Covered: baseline, extended-sequential and progressive Huffman streams
(SOF0, SOF1, SOF2) of 8-bit samples; 1 component (grey, expanded to RGBA
as PIL's "L") or 3 (YCbCr, or RGB by an Adobe marker or the component
ids, as libjpeg decides); sampling factors of 1 or 2 on each axis;
several DQT (8- or 16-bit) and DHT tables, optimised Huffman tables,
restart intervals, interleaved or one-component scans, any width and
height. APPn and COM segments are skipped. Lossless, hierarchical and
arithmetic-coded streams, 12-bit samples and 4-component (CMYK, YCCK)
images raise NotImplementedError naming what they are; a corrupt or
truncated stream raises ValueError. A complete progressive stream needs
no block smoothing (libjpeg applies it only while coefficients are
missing).

write_jpeg encodes (H, W, 3) uint8 RGB as the baseline stream PIL
12.1.0 writes with Image.save(..., "JPEG", quality=q), byte for byte
(tests/test_torch_jpeg_encode.py); its pixel work and entropy coding are
native/jpeg_encoder.cpp, on the host.
"""

from __future__ import annotations

import numpy as np

from sunray_tpu_torch.utils.png import _read_bytes

# Zig-zag position -> natural (row-major) index in the 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

_SOF_UNSUPPORTED = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical progressive JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCC: "arithmetic-coded JPEG (DAC)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)",
}
_PAD = 8                      # zero bytes after a segment for the lookahead


def _u16(data, pos):
    if pos + 2 > len(data):
        raise ValueError("truncated JPEG (marker segment)")
    return (data[pos] << 8) | data[pos + 1]


def _huffman_lookup(counts, symbols):
    """A 16-bit lookahead table: entry = (code length << 8) | symbol, 0 for
    a bit pattern that starts no code."""
    table = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols) or code >= (1 << length):
                raise ValueError("bad JPEG Huffman table")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _segments(data, pos):
    """The entropy-coded data from pos up to the next marker that is not a
    restart: a list of byte strings, one per restart interval, stuffed
    0xFF00 pairs undone. Returns (segments, position of that marker)."""
    out, cur = [], bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            raise ValueError("truncated JPEG (entropy-coded data without a "
                             "closing marker)")
        cur += data[pos:j]
        m = data[j + 1]
        if m == 0x00:
            cur.append(0xFF)
            pos = j + 2
        elif m == 0xFF:                   # fill byte before a marker
            pos = j + 1
        elif 0xD0 <= m <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        else:
            out.append(bytes(cur))
            return out, j


def _decode_segment(seg, blocks, dc_tabs, ac_tabs, coef_idx, coef_val):
    """Huffman-decode the blocks of one restart interval. blocks: a list of
    (slot, base) in decode order, slot indexing the scan's components and
    base the block's first coefficient in the frame's flat array. The
    nonzero coefficients are appended to coef_idx / coef_val."""
    data = seg + bytes(_PAD)
    n_bits_real = 8 * len(seg)
    zz = ZIGZAG.tolist()
    pred = [0] * len(dc_tabs)
    buf, nbits, pos = 0, 0, 0
    add_i, add_v = coef_idx.append, coef_val.append
    try:
        for slot, base in blocks:
            # -- DC: a size category, then that many bits of difference --
            if nbits < 32:
                buf &= (1 << nbits) - 1
                while nbits < 32:
                    buf = (buf << 8) | data[pos]
                    pos += 1
                    nbits += 8
            e = dc_tabs[slot][(buf >> (nbits - 16)) & 0xFFFF]
            if not e:
                raise ValueError("bad Huffman code in JPEG data")
            nbits -= e >> 8
            s = e & 0xFF
            if s:
                if s > 11:
                    raise ValueError("bad DC difference size in JPEG data")
                v = (buf >> (nbits - s)) & ((1 << s) - 1)
                nbits -= s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[slot] += v
            if pred[slot]:
                add_i(base)
                add_v(pred[slot])
            # -- AC: (run, size) symbols up to the end of block --
            act = ac_tabs[slot]
            k = 1
            while k < 64:
                if nbits < 32:
                    buf &= (1 << nbits) - 1
                    while nbits < 32:
                        buf = (buf << 8) | data[pos]
                        pos += 1
                        nbits += 8
                e = act[(buf >> (nbits - 16)) & 0xFFFF]
                if not e:
                    raise ValueError("bad Huffman code in JPEG data")
                nbits -= e >> 8
                rs = e & 0xFF
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise ValueError("bad AC run in JPEG data")
                    v = (buf >> (nbits - s)) & ((1 << s) - 1)
                    nbits -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    add_i(base + zz[k])
                    add_v(v)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
    except IndexError:
        raise ValueError("truncated JPEG (entropy-coded data)") from None
    if 8 * pos - nbits > n_bits_real:
        raise ValueError("truncated JPEG (entropy-coded data)")


def _decode_progressive_segment(seg, blocks, dc_tabs, ac_tabs, scan, coef):
    """Decode one restart interval of a progressive scan (jdphuff.c) into
    coef, a flat list of the frame's coefficients kept across scans.
    scan: (Ss, Se, Ah, Al). DC scans hold the first or a refining bit of
    each block's DC; AC scans (one component) a spectral band, first
    pass with end-of-band runs or a refinement of one bit."""
    ss, se, ah, al = scan
    data = seg + bytes(_PAD)
    n_bits_real = 8 * len(seg)
    zz = ZIGZAG.tolist()
    buf = nbits = pos = 0

    def get(n):
        nonlocal buf, nbits, pos
        while nbits < n:
            buf = ((buf & ((1 << nbits) - 1)) << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= n
        return (buf >> nbits) & ((1 << n) - 1)

    def huff(tab):
        nonlocal buf, nbits, pos
        while nbits < 16:
            buf = ((buf & ((1 << nbits) - 1)) << 8) | data[pos]
            pos += 1
            nbits += 8
        e = tab[(buf >> (nbits - 16)) & 0xFFFF]
        if not e:
            raise ValueError("bad Huffman code in JPEG data")
        nbits -= e >> 8
        return e & 0xFF

    def extend(v, n):
        return v - (1 << n) + 1 if v < (1 << (n - 1)) else v

    p1 = 1 << al
    m1 = -p1
    pred = [0] * len(dc_tabs)
    eobrun = 0
    try:
        for slot, base in blocks:
            if ss == 0 and ah == 0:             # DC, first scan
                n = huff(dc_tabs[slot])
                if n > 11:
                    raise ValueError("bad DC difference size in JPEG data")
                if n:
                    pred[slot] += extend(get(n), n)
                coef[base] = pred[slot] << al
            elif ss == 0:                       # DC, refinement
                if get(1):
                    coef[base] |= p1
            elif ah == 0:                       # AC, first scan
                if eobrun:
                    eobrun -= 1
                    continue
                tab = ac_tabs[slot]
                k = ss
                while k <= se:
                    rs = huff(tab)
                    r, n = rs >> 4, rs & 15
                    if n:
                        k += r
                        if k > se:
                            raise ValueError("bad AC run in JPEG data")
                        coef[base + zz[k]] = extend(get(n), n) << al
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        eobrun = (1 << r) - 1 + (get(r) if r else 0)
                        break
            else:                               # AC, refinement
                tab = ac_tabs[slot]
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = huff(tab)
                        r, n = rs >> 4, rs & 15
                        if n:
                            if n != 1:
                                raise ValueError("bad AC refinement in JPEG "
                                                 "data")
                            n = p1 if get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + (get(r) if r else 0)
                            break
                        # Correction bits for the nonzero coefficients up to
                        # the r-th zero one, which takes the new value.
                        while k <= se:
                            i = base + zz[k]
                            if coef[i]:
                                if get(1) and not coef[i] & p1:
                                    coef[i] += p1 if coef[i] >= 0 else m1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if n:
                            if k > se:
                                raise ValueError("bad AC run in JPEG data")
                            coef[base + zz[k]] = n
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        i = base + zz[k]
                        if coef[i] and get(1) and not coef[i] & p1:
                            coef[i] += p1 if coef[i] >= 0 else m1
                        k += 1
                    eobrun -= 1
    except IndexError:
        raise ValueError("truncated JPEG (entropy-coded data)") from None
    if 8 * pos - nbits > n_bits_real:
        raise ValueError("truncated JPEG (entropy-coded data)")


# -- islow IDCT (jidctint.c) -------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0_298631336=2446, f0_390180644=3196, f0_541196100=4433,
          f0_765366865=6270, f0_899976223=7373, f1_175875602=9633,
          f1_501321110=12299, f1_847759065=15137, f1_961570560=16069,
          f2_053119869=16819, f2_562915447=20995, f3_072711026=25172)


def _idct_1d(x):
    """One pass of jpeg_idct_islow over axis 1 of x (N, 8, ...), int64:
    the eight outputs before descaling."""
    f = _F
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * f["f0_541196100"]
    tmp2 = z1 + z3 * -f["f1_847759065"]
    tmp3 = z1 + z2 * f["f0_765366865"]
    z2, z3 = x[:, 0], x[:, 4]
    tmp0 = (z2 + z3) << _CONST_BITS
    tmp1 = (z2 - z3) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * f["f1_175875602"]
    tmp0 = tmp0 * f["f0_298631336"]
    tmp1 = tmp1 * f["f2_053119869"]
    tmp2 = tmp2 * f["f3_072711026"]
    tmp3 = tmp3 * f["f1_501321110"]
    z1 = z1 * -f["f0_899976223"]
    z2 = z2 * -f["f2_562915447"]
    z3 = z3 * -f["f1_961570560"] + z5
    z4 = z4 * -f["f0_390180644"] + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    return np.stack([tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                     tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3],
                    axis=1)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef):
    """(N, 8, 8) dequantised coefficients (int64, natural order) -> (N, 8, 8)
    uint8 samples: columns first, then rows, as jpeg_idct_islow."""
    ws = _descale(_idct_1d(coef), _CONST_BITS - _PASS1_BITS)
    out = _descale(_idct_1d(ws.transpose(0, 2, 1)),
                   _CONST_BITS + _PASS1_BITS + 3).transpose(0, 2, 1)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# -- upsampling (jdsample.c) -------------------------------------------------

def _fancy_h2(x):
    """h2v1_fancy_upsample along axis 1 of x (int32): 3/4 of the nearer
    sample and 1/4 of the further one, the edge columns repeated; the
    rounding bias is 1 for the left output of a pair and 2 for the right."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_v2_sums(x):
    """h1v2 / h2v2 vertical step: 3 x nearer row + further row, the edge
    rows repeated (the context rows). Returns (above-pair, below-pair)."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    return 3 * x + up, 3 * x + down


def _interleave_rows(a, b):
    out = np.empty((2 * a.shape[0], a.shape[1]), np.int32)
    out[0::2], out[1::2] = a, b
    return out


def _fancy_h1v2(x):
    a, b = _fancy_v2_sums(x)
    return _interleave_rows((a + 1) >> 2, (b + 2) >> 2)


def _fancy_h2v2(x):
    """h2v2_fancy_upsample: column sums 3 x nearer row + further row, then
    3 x nearer sum + further sum across, biases 8 and 7 (>> 4)."""
    rows = []
    for cs in _fancy_v2_sums(x):
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int32)
        out[:, 0::2] = (3 * cs + left + 8) >> 4
        out[:, 1::2] = (3 * cs + right + 7) >> 4
        rows.append(out)
    return _interleave_rows(*rows)


def upsample(plane, fh, fv):
    """A component plane (its downsampled width and height) upsampled by
    (fh, fv) in {1, 2}^2 as libjpeg-turbo's default decompression does."""
    x = plane.astype(np.int32)
    wide = x.shape[1] > 2
    if (fh, fv) == (1, 1):
        out = x
    elif (fh, fv) == (2, 1):
        out = _fancy_h2(x) if wide else np.repeat(x, 2, axis=1)
    elif (fh, fv) == (1, 2):
        out = _fancy_h1v2(x)
    else:
        out = (_fancy_h2v2(x) if wide
               else np.repeat(np.repeat(x, 2, axis=0), 2, axis=1))
    return out


# -- colour conversion (jdcolor.c) -------------------------------------------

def _ycc_tables():
    def fix(v):
        return int(v * (1 << 16) + 0.5)
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr):
    """uint8 planes -> (H, W, 3) uint8 through jdcolor.c's tables."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# -- the stream --------------------------------------------------------------

class _Frame:
    def __init__(self, data, pos, marker):
        if marker in _SOF_UNSUPPORTED:
            raise NotImplementedError(f"{_SOF_UNSUPPORTED[marker]} is not "
                                      "decoded (baseline, extended "
                                      "sequential and progressive Huffman "
                                      "only)")
        length = _u16(data, pos)
        seg = data[pos + 2:pos + length]
        if len(seg) < 6:
            raise ValueError("truncated JPEG (SOF)")
        precision = seg[0]
        self.height = (seg[1] << 8) | seg[2]
        self.width = (seg[3] << 8) | seg[4]
        nc = seg[5]
        self.progressive = marker == 0xC2
        if precision != 8:
            raise NotImplementedError(f"{precision}-bit JPEG samples are not "
                                      "decoded (8-bit only)")
        if nc == 4:
            raise NotImplementedError("4-component JPEG (CMYK or YCCK) is "
                                      "not decoded")
        if nc not in (1, 3):
            raise NotImplementedError(f"{nc}-component JPEG is not decoded")
        if self.height == 0:
            raise NotImplementedError("JPEG with its height in a DNL marker "
                                      "is not decoded")
        if self.width == 0 or len(seg) < 6 + 3 * nc:
            raise ValueError("bad JPEG frame header")
        self.comps = []
        for i in range(nc):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if h not in (1, 2) or v not in (1, 2):
                raise NotImplementedError(f"JPEG sampling factors {h}x{v} are "
                                          "not decoded (1 or 2 only)")
            self.comps.append(dict(id=cid, h=h, v=v, tq=tq, q=None))
        self.hmax = max(c["h"] for c in self.comps)
        self.vmax = max(c["v"] for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        base = 0
        for c in self.comps:
            c["bx"], c["by"] = self.mcux * c["h"], self.mcuy * c["v"]
            c["base"] = base
            base += c["bx"] * c["by"] * 64
            # The plane's own size (downsampled width / height).
            c["w"] = -(-self.width * c["h"] // self.hmax)
            c["hgt"] = -(-self.height * c["v"] // self.vmax)
        self.n_coef = base


def _scan_blocks(frame, comps, mcu_range):
    """(slot, base) of each block of the scan's MCUs in mcu_range, in decode
    order: an interleaved scan's MCU holds h x v blocks of each component,
    a one-component scan's MCU is one block of its (unpadded) grid."""
    out = []
    if len(comps) == 1:
        c = comps[0]
        nbx = -(-c["w"] // 8)
        for m in mcu_range:
            by, bx = divmod(m, nbx)
            out.append((0, c["base"] + (by * c["bx"] + bx) * 64))
        return out
    for m in mcu_range:
        my, mx = divmod(m, frame.mcux)
        for slot, c in enumerate(comps):
            for yy in range(c["v"]):
                row = (my * c["v"] + yy) * c["bx"] + mx * c["h"]
                for xx in range(c["h"]):
                    out.append((slot, c["base"] + (row + xx) * 64))
    return out


def _parse(data):
    """Walk the markers; returns (frame, flat coefficient array int64,
    colour space "grey" | "ycc" | "rgb")."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    pos = 2
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, coef_idx, coef_val = None, 0, [], []
    dense = None                # a progressive frame's coefficients
    jfif, adobe = False, None
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1                    # garbage between segments
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue                    # stray RSTn / SOI / TEM
        length = _u16(data, pos)
        if length < 2 or pos + length > n:
            raise ValueError("truncated JPEG (marker segment)")
        seg = data[pos + 2:pos + length]
        if marker in (0xC0, 0xC1, 0xC2) or marker in _SOF_UNSUPPORTED:
            if frame is not None:
                raise ValueError("JPEG with two frame headers")
            frame = _Frame(data, pos, marker)
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                total = sum(counts)
                symbols = list(seg[i + 17:i + 17 + total])
                if len(counts) < 16 or len(symbols) < total or tc > 1:
                    raise ValueError("bad JPEG DHT segment")
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lookup(counts,
                                                                   symbols)
                i += 17 + total
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                body = seg[i + 1:i + 1 + size]
                if len(body) < size:
                    raise ValueError("bad JPEG DQT segment")
                q = (np.frombuffer(body, ">u2") if pq
                     else np.frombuffer(body, np.uint8)).astype(np.int64)
                qt[tq] = np.zeros(64, np.int64)
                qt[tq][ZIGZAG] = q
                i += 1 + size
        elif marker == 0xDD:
            restart = _u16(seg, 0)
        elif marker == 0xDC:
            raise NotImplementedError("JPEG DNL marker is not decoded")
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            if len(seg) < 4 + 2 * ns:
                raise ValueError("bad JPEG scan header")
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            prog = frame.progressive
            if prog and ((ss == 0 and se != 0)
                         or (ss > 0 and (ss > se or se > 63 or ns != 1))
                         or (ah and al != ah - 1) or al > 13):
                raise ValueError(f"bad JPEG progression (Ss {ss}, Se {se}, "
                                 f"Ah {ah}, Al {al}, {ns} components)")
            need_dc = not prog or (ss == 0 and ah == 0)
            need_ac = not prog or ss > 0
            comps, dcs, acs = [], [], []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                c = next((c for c in frame.comps if c["id"] == cid), None)
                if c is None or (need_dc and (t >> 4) not in dc_tabs) \
                        or (need_ac and (t & 15) not in ac_tabs):
                    raise ValueError("bad JPEG scan header")
                if c["q"] is None:
                    if c["tq"] not in qt:
                        raise ValueError("JPEG component without its "
                                         "quantisation table")
                    c["q"] = qt[c["tq"]]
                comps.append(c)
                dcs.append(dc_tabs.get(t >> 4))
                acs.append(ac_tabs.get(t & 15))
            segs, pos = _segments(data, pos + length)
            if len(comps) == 1:
                c = comps[0]
                total = -(-c["w"] // 8) * -(-c["hgt"] // 8)
            else:
                total = frame.mcux * frame.mcuy
            per = restart if restart else total
            if len(segs) < -(-total // per):
                raise ValueError("truncated JPEG (restart intervals missing)")
            if prog and dense is None:
                dense = [0] * frame.n_coef
            for k in range(-(-total // per)):
                mcus = range(k * per, min((k + 1) * per, total))
                blocks = _scan_blocks(frame, comps, mcus)
                if prog:
                    _decode_progressive_segment(segs[k], blocks, dcs, acs,
                                                (ss, se, ah, al), dense)
                else:
                    _decode_segment(segs[k], blocks, dcs, acs, coef_idx,
                                    coef_val)
            continue
        pos += length
    if frame is None:
        raise ValueError("JPEG without a frame header")
    if any(c["q"] is None for c in frame.comps):
        raise ValueError("truncated JPEG (a component has no scan)")
    if frame.progressive:
        coef = np.asarray(dense, np.int64)
    else:
        coef = np.zeros(frame.n_coef, np.int64)
        coef[np.asarray(coef_idx, np.int64)] = coef_val
    if len(frame.comps) == 1:
        space = "grey"
    elif jfif:
        space = "ycc"
    elif adobe is not None:
        space = "rgb" if adobe == 0 else "ycc"
    elif [c["id"] for c in frame.comps] == [82, 71, 66]:
        space = "rgb"
    else:
        space = "ycc"
    return frame, coef, space


def _planes(frame, coef):
    """Each component's samples at full size (frame.height, frame.width)."""
    out = []
    for c in frame.comps:
        n = c["bx"] * c["by"]
        blk = coef[c["base"]:c["base"] + 64 * n].reshape(n, 8, 8)
        blk = blk * c["q"].reshape(1, 8, 8)
        s = idct_islow(blk).reshape(c["by"], c["bx"], 8, 8)
        s = s.transpose(0, 2, 1, 3).reshape(c["by"] * 8, c["bx"] * 8)
        s = s[:c["hgt"], :c["w"]]
        up = upsample(s, frame.hmax // c["h"], frame.vmax // c["v"])
        out.append(up[:frame.height, :frame.width].astype(np.uint8))
    return out


def read_jpeg(src) -> np.ndarray:
    """Decode a JPEG (path, bytes or file object) -> (H, W, 1) grey or
    (H, W, 3) RGB uint8, as PIL's Image.open gives them ("L" or "RGB")."""
    frame, coef, space = _parse(_read_bytes(src))
    planes = _planes(frame, coef)
    if space == "grey":
        return planes[0][..., None]
    if space == "rgb":
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


def read_jpeg_rgba(src) -> np.ndarray:
    """Decode to (H, W, 4) uint8 RGBA, as PIL's convert("RGBA") does (grey
    to three equal channels, alpha 255)."""
    img = read_jpeg(src)
    h, w = img.shape[:2]
    rgb = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], axis=-1)


# -- the encoder -------------------------------------------------------------

# The IJG example quantisation tables (jcparam.c; ITU-T T.81 K.1, K.2), in
# natural order.
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# The standard Huffman tables (jstdhuff.c; T.81 K.3-K.6): each is a DHT
# body after its class/id byte, 16 code counts by length then the symbols.
STD_HUFFMAN = {
    0x00: bytes.fromhex(                        # DC luma
        "00010501010101010100000000000000000102030405060708090a0b"),
    0x10: bytes.fromhex(                        # AC luma
        "0002010303020403050504040000017d01020300041105122131410613516107"
        "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
        "292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    0x01: bytes.fromhex(                        # DC chroma
        "00030101010101010101010000000000000102030405060708090a0b"),
    0x11: bytes.fromhex(                        # AC chroma
        "0002010204040304070504040001027700010203110405213106124151076171"
        "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
        "2728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
        "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}


def quality_tables(quality: int):
    """(luma, chroma) quantisation tables in natural order for an IJG
    quality (jcparam.c jpeg_quality_scaling and jpeg_add_quant_table with
    force_baseline, as PIL calls jpeg_set_quality)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMA_QUANT, STD_CHROMA_QUANT))


def _huffman_codes(body):
    """(code, length) by symbol, 256 each, of a DHT body (canonical codes,
    jchuff.c jpeg_make_c_derived_tbl)."""
    counts, symbols = body[:16], body[16:]
    codes = np.zeros(256, np.int32)
    sizes = np.zeros(256, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = code
            sizes[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, sizes


def _segment(marker, body):
    return bytes([0xFF, marker]) + len(body + b"..").to_bytes(2, "big") + body


def write_jpeg(u8, quality: int = 85) -> bytes:
    """Encode an (H, W, 3) uint8 RGB array as a baseline JPEG: the bytes
    PIL 12.1.0 (libjpeg-turbo) writes for Image.fromarray(u8).save(buf,
    "JPEG", quality=quality): a JFIF 1.01 APP0, the IJG tables scaled by
    quality, 4:2:0, the islow forward DCT and the standard Huffman tables
    (tests/test_torch_jpeg_encode.py). The pixel work and the entropy
    coding run in native/jpeg_encoder.cpp, built with g++ at first use."""
    import ctypes

    from sunray_tpu_torch.native import jpeg_lib

    img = np.ascontiguousarray(u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg takes (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"write_jpeg: {w}x{h} is outside 1..65535")
    luma, chroma = quality_tables(quality)
    natural = np.ascontiguousarray(ZIGZAG, np.int32)
    qt = np.ascontiguousarray(np.stack([luma, chroma]), np.int32)
    tabs = [_huffman_codes(STD_HUFFMAN[k]) for k in (0x00, 0x10, 0x01, 0x11)]
    codes = np.ascontiguousarray(np.stack([c for c, _ in tabs]), np.int32)
    sizes = np.ascontiguousarray(np.stack([s for _, s in tabs]), np.int32)
    lib = jpeg_lib()
    cap = h * w * 3 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.sunray_jpeg_encode(img.ctypes.data, h, w, natural.ctypes.data,
                                   qt.ctypes.data, codes.ctypes.data,
                                   sizes.ctypes.data, out.ctypes.data,
                                   ctypes.c_long(cap))
        if n >= 0:
            break
        cap *= 2
    head = bytearray(b"\xff\xd8")
    head += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate((luma, chroma)):
        head += _segment(0xDB, bytes([t])
                         + q[ZIGZAG].astype(np.uint8).tobytes())
    head += _segment(0xC0, bytes([8]) + h.to_bytes(2, "big")
                     + w.to_bytes(2, "big")
                     + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for k in (0x00, 0x10, 0x01, 0x11):
        head += _segment(0xC4, bytes([k]) + STD_HUFFMAN[k])
    head += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return bytes(head) + out[:n].tobytes() + b"\xff\xd9"
