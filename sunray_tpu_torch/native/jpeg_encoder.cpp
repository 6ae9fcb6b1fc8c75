// Baseline JPEG encoder: the entropy-coded data of an RGB image, as
// libjpeg-turbo's default compression writes it (what PIL's
// Image.save(..., "JPEG", quality=q) calls; utils/jpeg.write_jpeg adds the
// markers and tables around it).
//
// The steps and their arithmetic are libjpeg's:
//   - jccolor.c rgb_ycc_convert: fixed-point RGB -> YCbCr through tables of
//     16 scale bits (Cb and Cr rounded with the 0.5 - epsilon fudge);
//   - jcprepro.c / jcsample.c: 4:2:0. The image's last row is repeated to
//     fill a row pair, each row's last sample repeated to the component's
//     whole blocks; h2v2_downsample averages 2 x 2 samples with the bias
//     1, 2, 1, 2, ... along a row; the last output row is repeated to a
//     whole MCU row;
//   - jccoefct.c: blocks past a component's last whole block column or
//     row inside an MCU are dummies: zero AC, and the DC of the block
//     before them in the MCU (already quantised);
//   - jfdctint.c jpeg_fdct_islow: 13 constant bits, 2 pass-1 bits, the
//     output scaled up by 8;
//   - jcdctmgr.c: quantisation by reciprocal multiplication (divisor
//     q << 3, compute_reciprocal's reciprocal, correction and shift);
//   - jchuff.c encode_one_block: DC differences and (run, size) AC
//     symbols through the given code tables, 0xFF stuffed with 0x00, the
//     last byte filled with one bits.
// libjpeg-turbo's SIMD versions of these steps compute the same values.
//
// It runs on the host: entropy coding is serial. The caller passes the
// zig-zag order, the two quantisation tables (natural order) and the four
// Huffman code tables (DC luma, AC luma, DC chroma, AC chroma; code and
// length by symbol), so the tables live in one place (utils/jpeg.py).

#include <stddef.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t kCbCrOffset = 128 << kScaleBits;

constexpr int32_t fix16(double x) {
  return static_cast<int32_t>(x * (1L << kScaleBits) + 0.5);
}

struct YccTables {
  int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256],
      bcr[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix16(0.29900) * i;
      gy[i] = fix16(0.58700) * i;
      by[i] = fix16(0.11400) * i + kOneHalf;
      rcb[i] = -fix16(0.16874) * i;
      gcb[i] = -fix16(0.33126) * i;
      // B's Cb term is also R's Cr term.
      bcb[i] = fix16(0.50000) * i + kCbCrOffset + kOneHalf - 1;
      gcr[i] = -fix16(0.41869) * i;
      bcr[i] = -fix16(0.08131) * i;
    }
  }
};

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// jpeg_fdct_islow on 64 samples already less 128, in place. The pass-1
// and pass-2 loops differ only in stride and descaling.
template <int kStride, bool kPass2>
inline void fdct_pass(int32_t* data) {
  for (int ctr = 0; ctr < 8; ++ctr) {
    int32_t* d = data + ctr * (kStride == 1 ? 8 : 1);
    const int32_t tmp0 = d[0] + d[7 * kStride], tmp7 = d[0] - d[7 * kStride];
    const int32_t tmp1 = d[kStride] + d[6 * kStride],
                  tmp6 = d[kStride] - d[6 * kStride];
    const int32_t tmp2 = d[2 * kStride] + d[5 * kStride],
                  tmp5 = d[2 * kStride] - d[5 * kStride];
    const int32_t tmp3 = d[3 * kStride] + d[4 * kStride],
                  tmp4 = d[3 * kStride] - d[4 * kStride];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    constexpr int kOdd = kPass2 ? kConstBits + kPass1Bits
                                : kConstBits - kPass1Bits;
    if (kPass2) {
      d[0] = descale(tmp10 + tmp11, kPass1Bits);
      d[4 * kStride] = descale(tmp10 - tmp11, kPass1Bits);
    } else {
      d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
      d[4 * kStride] = (tmp10 - tmp11) * (1 << kPass1Bits);
    }
    int32_t z1 = (tmp12 + tmp13) * F0_541196100;
    d[2 * kStride] = descale(z1 + tmp13 * F0_765366865, kOdd);
    d[6 * kStride] = descale(z1 + tmp12 * -F1_847759065, kOdd);

    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6;
    int32_t z3 = tmp4 + tmp6;
    int32_t z4 = tmp5 + tmp7;
    const int32_t z5 = (z3 + z4) * F1_175875602;
    const int32_t t4 = tmp4 * F0_298631336, t5 = tmp5 * F2_053119869,
                  t6 = tmp6 * F3_072711026, t7 = tmp7 * F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 = z3 * -F1_961570560 + z5;
    z4 = z4 * -F0_390180644 + z5;
    d[7 * kStride] = descale(t4 + z1 + z3, kOdd);
    d[5 * kStride] = descale(t5 + z2 + z4, kOdd);
    d[3 * kStride] = descale(t6 + z2 + z3, kOdd);
    d[kStride] = descale(t7 + z1 + z4, kOdd);
  }
}

// compute_reciprocal (jcdctmgr.c) for a 16-bit DCTELEM.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);     // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  const uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

inline int32_t quantize(int32_t x, const Divisor& q) {
  const uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
  const int32_t v = static_cast<int32_t>(
      (static_cast<uint64_t>(a + q.corr) * q.recip) >> q.shift);
  return x < 0 ? -v : v;
}

struct Plane {
  int rows, cols;
  std::vector<uint8_t> s;
  uint8_t at(int r, int c) const {
    return s[static_cast<size_t>(r) * cols + c];
  }
};

class BitWriter {
 public:
  BitWriter(uint8_t* out, long cap) : out_(out), cap_(cap) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      n_ -= 8;
      byte(static_cast<uint8_t>(acc_ >> n_));
    }
    acc_ &= (1ull << n_) - 1;
  }
  void flush() {
    if (n_) put((1u << (8 - n_)) - 1, 8 - n_);
  }
  long size() const { return overflow_ ? -1 : len_; }

 private:
  void byte(uint8_t b) {
    if (len_ + 2 > cap_) {
      overflow_ = true;
      return;
    }
    out_[len_++] = b;
    if (b == 0xFF) out_[len_++] = 0;
  }
  uint8_t* out_;
  long cap_, len_ = 0;
  uint64_t acc_ = 0;
  int n_ = 0;
  bool overflow_ = false;
};

inline int nbits(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

}  // namespace

// rgb: (h, w, 3) uint8. natural: zig-zag position -> natural index (64).
// qtables: luma then chroma quantisation values, natural order (2 x 64).
// codes, sizes: 4 x 256 Huffman codes and their lengths by symbol (DC
// luma, AC luma, DC chroma, AC chroma). Writes the scan's entropy-coded
// bytes to out; returns their count, or -1 when cap is too small.
extern "C" long sunray_jpeg_encode(const uint8_t* rgb, int h, int w,
                                   const int* natural, const int* qtables,
                                   const int* codes, const int* sizes,
                                   uint8_t* out, long cap) {
  static const YccTables t;
  if (h <= 0 || w <= 0) return -1;
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int wib_y = (w + 7) / 8, hib_y = (h + 7) / 8;

  // Full-size Y, Cb, Cr, then the padded component planes.
  Plane y{mcuy * 16, wib_y * 8, {}}, cb{mcuy * 8, mcux * 8, {}},
      cr{mcuy * 8, mcux * 8, {}};
  y.s.resize(static_cast<size_t>(y.rows) * y.cols);
  cb.s.resize(static_cast<size_t>(cb.rows) * cb.cols);
  cr.s.resize(static_cast<size_t>(cr.rows) * cr.cols);
  // The Cb and Cr rows of a row pair, expanded to 2 * mcux * 8 samples.
  const int wide = 2 * cb.cols;
  std::vector<uint8_t> fb(2 * wide), fr(2 * wide);
  const int pairs = (h + 1) / 2;
  for (int pr = 0; pr < pairs; ++pr) {
    for (int k = 0; k < 2; ++k) {
      const int row = 2 * pr + k;
      const int src = row < h ? row : h - 1;       // bottom row repeated
      const uint8_t* px = rgb + static_cast<size_t>(src) * w * 3;
      uint8_t* yrow = &y.s[static_cast<size_t>(row) * y.cols];
      for (int c = 0; c < w; ++c) {
        const int r = px[3 * c], g = px[3 * c + 1], b = px[3 * c + 2];
        yrow[c] = static_cast<uint8_t>((t.ry[r] + t.gy[g] + t.by[b]) >>
                                       kScaleBits);
        fb[k * wide + c] = static_cast<uint8_t>(
            (t.rcb[r] + t.gcb[g] + t.bcb[b]) >> kScaleBits);
        fr[k * wide + c] = static_cast<uint8_t>(
            (t.bcb[r] + t.gcr[g] + t.bcr[b]) >> kScaleBits);
      }
      for (int c = w; c < y.cols; ++c) yrow[c] = yrow[w - 1];
      for (int c = w; c < wide; ++c) {
        fb[k * wide + c] = fb[k * wide + w - 1];
        fr[k * wide + c] = fr[k * wide + w - 1];
      }
    }
    uint8_t* cbrow = &cb.s[static_cast<size_t>(pr) * cb.cols];
    uint8_t* crrow = &cr.s[static_cast<size_t>(pr) * cr.cols];
    int bias = 1;
    for (int c = 0; c < cb.cols; ++c) {
      cbrow[c] = static_cast<uint8_t>((fb[2 * c] + fb[2 * c + 1] +
                                       fb[wide + 2 * c] +
                                       fb[wide + 2 * c + 1] + bias) >> 2);
      crrow[c] = static_cast<uint8_t>((fr[2 * c] + fr[2 * c + 1] +
                                       fr[wide + 2 * c] +
                                       fr[wide + 2 * c + 1] + bias) >> 2);
      bias ^= 3;
    }
  }
  for (int row = 2 * pairs; row < y.rows; ++row)
    for (int c = 0; c < y.cols; ++c)
      y.s[static_cast<size_t>(row) * y.cols + c] =
          y.s[static_cast<size_t>(2 * pairs - 1) * y.cols + c];
  for (Plane* p : {&cb, &cr})
    for (int row = pairs; row < p->rows; ++row)
      for (int c = 0; c < p->cols; ++c)
        p->s[static_cast<size_t>(row) * p->cols + c] =
            p->s[static_cast<size_t>(pairs - 1) * p->cols + c];

  Divisor div[2][64];
  for (int q = 0; q < 2; ++q)
    for (int i = 0; i < 64; ++i)
      div[q][i] = reciprocal(static_cast<uint32_t>(qtables[64 * q + i]) << 3);

  auto dct_block = [&](const Plane& p, int by, int bx, const Divisor* dv,
                       int32_t* coef) {
    int32_t d[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        d[8 * r + c] = static_cast<int32_t>(p.at(8 * by + r, 8 * bx + c)) - 128;
    fdct_pass<1, false>(d);
    fdct_pass<8, true>(d);
    for (int i = 0; i < 64; ++i) coef[i] = quantize(d[i], dv[i]);
  };

  BitWriter bits(out, cap);
  int32_t pred[3] = {0, 0, 0};
  auto encode = [&](const int32_t* coef, int comp, int tab) {
    const int* dc_code = codes + 256 * (2 * tab);
    const int* dc_size = sizes + 256 * (2 * tab);
    const int* ac_code = codes + 256 * (2 * tab + 1);
    const int* ac_size = sizes + 256 * (2 * tab + 1);
    int32_t diff = coef[0] - pred[comp];
    pred[comp] = coef[0];
    int32_t v = diff;
    if (diff < 0) {
      diff = -diff;
      --v;
    }
    int nb = nbits(static_cast<uint32_t>(diff));
    bits.put(dc_code[nb], dc_size[nb]);
    if (nb) bits.put(static_cast<uint32_t>(v), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t a = coef[natural[k]];
      if (a == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bits.put(ac_code[0xF0], ac_size[0xF0]);
        run -= 16;
      }
      int32_t vv = a;
      if (a < 0) {
        a = -a;
        --vv;
      }
      nb = nbits(static_cast<uint32_t>(a));
      const int sym = (run << 4) + nb;
      bits.put(ac_code[sym], ac_size[sym]);
      bits.put(static_cast<uint32_t>(vv), nb);
      run = 0;
    }
    if (run > 0) bits.put(ac_code[0], ac_size[0]);
  };

  // jccoefct.c's dummy blocks: columns past the last whole block column of
  // the last MCU column, rows past the last block row of the last MCU row.
  const int last_col = wib_y % 2 ? wib_y % 2 : 2;
  const int last_row = hib_y % 2 ? hib_y % 2 : 2;
  int32_t blk[4][64], chroma[64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      const int cols = mx < mcux - 1 ? 2 : last_col;
      for (int yi = 0; yi < 2; ++yi) {
        int32_t* row = blk[2 * yi];
        if (my < mcuy - 1 || yi < last_row) {
          for (int xi = 0; xi < cols; ++xi)
            dct_block(y, 2 * my + yi, 2 * mx + xi, div[0], row + 64 * xi);
          for (int xi = cols; xi < 2; ++xi) {
            for (int i = 0; i < 64; ++i) row[64 * xi + i] = 0;
            row[64 * xi] = row[64 * (xi - 1)];
          }
        } else {
          for (int xi = 0; xi < 2; ++xi) {
            for (int i = 0; i < 64; ++i) row[64 * xi + i] = 0;
            row[64 * xi] = (&blk[0][0])[64 * (2 * yi + xi - 1)];
          }
        }
      }
      for (int b = 0; b < 4; ++b) encode(blk[b], 0, 0);
      dct_block(cb, my, mx, div[1], chroma);
      encode(chroma, 1, 1);
      dct_block(cr, my, mx, div[1], chroma);
      encode(chroma, 2, 1);
    }
  }
  bits.flush();
  return bits.size();
}
