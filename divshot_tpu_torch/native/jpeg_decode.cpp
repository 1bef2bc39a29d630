// JPEG decoding for divshot_tpu_torch/gsio/jpeg.py (C ABI, loaded via
// ctypes, linked into the same library as divshot_native.cpp).
//
// Python parses the markers (tables, frame, scans) and calls:
//
// - jpeg_decode_scan: the Huffman entropy decode of one sequential scan
//   (baseline or extended, 8-bit), restart intervals included, into the
//   quantised coefficients of each block in zigzag order (int16, as
//   libjpeg's JCOEF);
// - jpeg_reconstruct: the dequantisation and inverse DCT of every block,
//   the chroma upsampling and the colour conversion into 8-bit pixels.
//
// The second pass is libjpeg's default decompression, written out so that
// the pixels are bitwise those of libjpeg-turbo as Pillow runs it:
// - the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2, the
//   IDCT range-limit table with its wrap-around, jdmaster.c);
// - the upsampling methods jdsample.c picks with do_fancy_upsampling on:
//   h2v1 and h2v2 "fancy" (triangle filter, edge samples replicated) when
//   the downsampled width exceeds 2, h1v2 fancy, else box replication;
// - the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// Huffman tables (ITU T.81 Annex C and F.2.2.3) with an 8-bit lookahead

struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[256];  // 0: the code is longer than 8 bits
  uint8_t look_sym[256];
};

bool build_huff(const uint8_t* bits, const uint8_t* vals, Huff* h) {
  int total = 0;
  for (int l = 0; l < 16; l++) total += bits[l];
  if (total > 256) return false;
  std::memcpy(h->vals, vals, 256);
  std::memset(h->look_len, 0, sizeof(h->look_len));
  int p = 0;
  int32_t code = 0;
  for (int l = 1; l <= 16; l++) {
    int n = bits[l - 1];
    if (n) {
      h->valoffset[l] = p - code;
      for (int i = 0; i < n; i++, p++, code++) {
        if (l <= 8) {
          int shift = 8 - l;
          for (int j = 0; j < (1 << shift); j++) {
            h->look_len[(code << shift) | j] = (uint8_t)l;
            h->look_sym[(code << shift) | j] = vals[p];
          }
        }
      }
      h->maxcode[l] = code - 1;
    } else {
      h->valoffset[l] = 0;
      h->maxcode[l] = -1;
    }
    if (code > (1 << l)) return false;  // over-subscribed
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  h->defined = true;
  return true;
}

// The entropy-coded segment as a bit stream: 0xFF 0x00 is a stuffed 0xFF;
// at a marker the stream stops and yields zero bits, as libjpeg does.
struct Bits {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  uint64_t acc = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t nx = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nx == 0) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      acc |= b << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t get(int s) {
    if (s == 0) return 0;
    if (cnt < s) fill();
    uint32_t v = (uint32_t)(acc >> (64 - s));
    acc <<= s;
    cnt -= s;
    return v;
  }
  void reset() {
    acc = 0;
    cnt = 0;
  }
};

inline int decode_sym(Bits& b, const Huff& h) {
  if (b.cnt < 16) b.fill();
  int peek = (int)(b.acc >> 56);
  int l = h.look_len[peek];
  if (l) {
    b.acc <<= l;
    b.cnt -= l;
    return h.look_sym[peek];
  }
  for (l = 9; l <= 16; l++) {
    int32_t code = (int32_t)(b.acc >> (64 - l));
    if (code <= h.maxcode[l]) {
      b.acc <<= l;
      b.cnt -= l;
      return h.vals[(code + h.valoffset[l]) & 0xFF];
    }
  }
  return -1;
}

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

// ---------------------------------------------------------------------------
// ISLOW IDCT (jidctint.c, 8-bit samples)

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// the post-IDCT range limit: x & 1023 -> sample (jdmaster.c,
// prepare_range_limit_table, from CENTERJSAMPLE on)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* zz, const int32_t* qnat, uint8_t* out,
                int64_t stride) {
  int32_t in[64];
  for (int k = 0; k < 64; k++) in[kZigzag[k]] = zz[k];
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int32_t* ip = in + c;
    const int32_t* qp = qnat + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int32_t dc = (int32_t)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16];
    int64_t z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int32_t)descale(tmp10 + tmp3, sh);
    wp[56] = (int32_t)descale(tmp10 - tmp3, sh);
    wp[8] = (int32_t)descale(tmp11 + tmp2, sh);
    wp[48] = (int32_t)descale(tmp11 - tmp2, sh);
    wp[16] = (int32_t)descale(tmp12 + tmp1, sh);
    wp[40] = (int32_t)descale(tmp12 - tmp1, sh);
    wp[24] = (int32_t)descale(tmp13 + tmp0, sh);
    wp[32] = (int32_t)descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = kRange.t[(int)descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[(int)descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[(int)descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[(int)descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[(int)descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[(int)descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[(int)descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[(int)descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ---------------------------------------------------------------------------
// upsampling (jdsample.c) of one component plane (dh, dw), row stride ps,
// into an (dh * vf, dw * hf) plane

enum Method { kFull, kH2V1Fancy, kH1V2Fancy, kH2V2Fancy, kBox };

inline const uint8_t* row_at(const uint8_t* p, int64_t ps, int64_t r,
                             int64_t dh) {
  r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);  // context rows replicated
  return p + r * ps;
}

void upsample(const uint8_t* p, int64_t ps, int64_t dh, int64_t dw, int hf,
              int vf, Method m, uint8_t* o, int64_t os) {
  for (int64_t r = 0; r < dh; r++) {
    const uint8_t* in = p + r * ps;
    if (m == kFull) {
      std::memcpy(o + r * os, in, dw);
    } else if (m == kH2V1Fancy) {
      uint8_t* out = o + r * os;
      for (int64_t c = 0; c < dw; c++) {
        int v3 = in[c] * 3;
        int left = in[c > 0 ? c - 1 : 0];
        int right = in[c + 1 < dw ? c + 1 : dw - 1];
        out[2 * c] = (uint8_t)((v3 + left + 1) >> 2);
        out[2 * c + 1] = (uint8_t)((v3 + right + 2) >> 2);
      }
    } else if (m == kH1V2Fancy) {
      for (int v = 0; v < 2; v++) {
        const uint8_t* nb = row_at(p, ps, v == 0 ? r - 1 : r + 1, dh);
        int bias = v == 0 ? 1 : 2;
        uint8_t* out = o + (2 * r + v) * os;
        for (int64_t c = 0; c < dw; c++)
          out[c] = (uint8_t)((in[c] * 3 + nb[c] + bias) >> 2);
      }
    } else if (m == kH2V2Fancy) {
      for (int v = 0; v < 2; v++) {
        const uint8_t* nb = row_at(p, ps, v == 0 ? r - 1 : r + 1, dh);
        uint8_t* out = o + (2 * r + v) * os;
        for (int64_t c = 0; c < dw; c++) {
          int64_t cl = c > 0 ? c - 1 : 0, cr = c + 1 < dw ? c + 1 : dw - 1;
          int this_sum = in[c] * 3 + nb[c];
          int last_sum = in[cl] * 3 + nb[cl];
          int next_sum = in[cr] * 3 + nb[cr];
          out[2 * c] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          out[2 * c + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        }
      }
    } else {  // box: each sample repeated hf x vf
      for (int v = 0; v < vf; v++) {
        uint8_t* out = o + (r * vf + v) * os;
        for (int64_t c = 0; c < dw; c++)
          for (int h = 0; h < hf; h++) out[c * hf + h] = in[c];
      }
    }
  }
}

// jdcolor.c's build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// One sequential Huffman scan. comp_info holds, per scan component, 6
// int32: h, v, the block row stride of its coefficient plane, the blocks
// a row and the block rows of a non-interleaved scan, and (dc table << 4)
// | ac table. coef_offset: each component's first coefficient in coef.
// Tables: 4 DC and 4 AC, 16 code-length counts and 256 symbols each.
// Returns the position of the marker that ends the scan, or -1 on a bad
// Huffman code, -2 on a missing restart marker, -3 on a bad table.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t size, int64_t start,
                         int32_t ns, const int32_t* comp_info,
                         const int64_t* coef_offset, int32_t mcux,
                         int32_t mcuy, const uint8_t* dc_bits,
                         const uint8_t* dc_vals, const uint8_t* ac_bits,
                         const uint8_t* ac_vals, int32_t restart_interval,
                         int16_t* coef) {
  Huff dc[4], ac[4];
  for (int i = 0; i < ns; i++) {
    int t_dc = comp_info[i * 6 + 5] >> 4, t_ac = comp_info[i * 6 + 5] & 15;
    if (t_dc > 3 || t_ac > 3) return -3;
    if (!dc[t_dc].defined &&
        !build_huff(dc_bits + t_dc * 16, dc_vals + t_dc * 256, &dc[t_dc]))
      return -3;
    if (!ac[t_ac].defined &&
        !build_huff(ac_bits + t_ac * 16, ac_vals + t_ac * 256, &ac[t_ac]))
      return -3;
  }
  Bits b{data, size, start};
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t nmcu_x = mcux, nmcu_y = mcuy;
  if (ns == 1) {
    nmcu_x = comp_info[3];
    nmcu_y = comp_info[4];
  }
  int64_t total = nmcu_x * nmcu_y, done = 0;
  int rst_next = 0;
  for (int64_t my = 0; my < nmcu_y; my++) {
    for (int64_t mx = 0; mx < nmcu_x; mx++) {
      if (restart_interval && done && done % restart_interval == 0) {
        // discard the partial byte, then expect RSTn
        b.reset();
        int64_t p = b.pos;
        while (p < size && data[p] != 0xFF) p++;
        while (p + 1 < size && data[p + 1] == 0xFF) p++;
        if (p + 1 >= size || data[p + 1] != 0xD0 + rst_next) return -2;
        b.pos = p + 2;
        b.at_marker = false;
        rst_next = (rst_next + 1) & 7;
        for (int i = 0; i < 4; i++) pred[i] = 0;
      }
      for (int i = 0; i < ns; i++) {
        const int32_t* ci = comp_info + i * 6;
        int hs = ns == 1 ? 1 : ci[0], vs = ns == 1 ? 1 : ci[1];
        const Huff& hd = dc[ci[5] >> 4];
        const Huff& ha = ac[ci[5] & 15];
        for (int by = 0; by < vs; by++) {
          for (int bx = 0; bx < hs; bx++) {
            int64_t row = my * vs + by, col = mx * hs + bx;
            int16_t* blk = coef + coef_offset[i] + (row * ci[2] + col) * 64;
            std::memset(blk, 0, 64 * sizeof(int16_t));
            int s = decode_sym(b, hd);
            if (s < 0 || s > 16) return -1;
            pred[i] += extend(b.get(s), s);
            blk[0] = (int16_t)pred[i];
            for (int k = 1; k < 64; k++) {
              int rs = decode_sym(b, ha);
              if (rs < 0) return -1;
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[k < 63 ? k : 63] = (int16_t)extend(b.get(s), s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
        }
      }
      done++;
    }
  }
  (void)total;
  // the scan ends at the next marker that is not a restart marker
  int64_t p = b.pos;
  while (p + 1 < size) {
    if (data[p] == 0xFF && data[p + 1] != 0 && data[p + 1] != 0xFF &&
        !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7))
      return p;
    p++;
  }
  return size;
}

// Every block's dequantisation and ISLOW IDCT, the upsampling and the
// colour conversion. comp_info holds, per component, 4 int32: h, v, the
// block row stride and the block rows of its coefficient plane. qt: each
// component's quantisation table in zigzag order. transform: 1 for YCbCr
// -> RGB, 0 to copy the components. out: (height, width, nc) uint8.
// Returns 0, or -1 for sampling factors that are not integral ratios.
int32_t jpeg_reconstruct(const int16_t* coef, int32_t nc,
                         const int32_t* comp_info, const int64_t* coef_offset,
                         const uint16_t* qt, int32_t width, int32_t height,
                         int32_t transform, uint8_t* out) {
  int hmax = 1, vmax = 1;
  for (int c = 0; c < nc; c++) {
    hmax = comp_info[c * 4] > hmax ? comp_info[c * 4] : hmax;
    vmax = comp_info[c * 4 + 1] > vmax ? comp_info[c * 4 + 1] : vmax;
  }
  std::vector<std::vector<uint8_t>> full(nc);
  std::vector<int64_t> full_stride(nc);
  for (int c = 0; c < nc; c++) {
    const int32_t* ci = comp_info + c * 4;
    int h = ci[0], v = ci[1];
    if (hmax % h || vmax % v) return -1;
    int hf = hmax / h, vf = vmax / v;
    int64_t bw = ci[2], bh = ci[3];
    int64_t ps = bw * 8;
    std::vector<uint8_t> plane(ps * bh * 8);
    int32_t qnat[64];
    for (int k = 0; k < 64; k++) qnat[kZigzag[k]] = qt[c * 64 + k];
    const int16_t* cp = coef + coef_offset[c];
    for (int64_t r = 0; r < bh; r++)
      for (int64_t q = 0; q < bw; q++)
        idct_islow(cp + (r * bw + q) * 64, qnat,
                   plane.data() + r * 8 * ps + q * 8, ps);
    // the component's own size (jdinput.c: jdiv_round_up)
    int64_t dw = ((int64_t)width * h + hmax - 1) / hmax;
    int64_t dh = ((int64_t)height * v + vmax - 1) / vmax;
    Method m;
    if (hf == 1 && vf == 1) m = kFull;
    else if (hf == 2 && vf == 1) m = dw > 2 ? kH2V1Fancy : kBox;
    else if (hf == 1 && vf == 2) m = kH1V2Fancy;
    else if (hf == 2 && vf == 2) m = dw > 2 ? kH2V2Fancy : kBox;
    else m = kBox;
    full_stride[c] = dw * hf;
    full[c].resize(full_stride[c] * dh * vf);
    upsample(plane.data(), ps, dh, dw, hf, vf, m, full[c].data(),
             full_stride[c]);
  }
  for (int64_t y = 0; y < height; y++) {
    uint8_t* o = out + y * (int64_t)width * nc;
    if (transform == 1 && nc == 3) {
      const uint8_t* py = full[0].data() + y * full_stride[0];
      const uint8_t* pb = full[1].data() + y * full_stride[1];
      const uint8_t* pr = full[2].data() + y * full_stride[2];
      for (int64_t x = 0; x < width; x++) {
        int yy = py[x], cb = pb[x], cr = pr[x];
        o[x * 3] = clamp8(yy + kYcc.cr_r[cr]);
        o[x * 3 + 1] =
            clamp8(yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[x * 3 + 2] = clamp8(yy + kYcc.cb_b[cb]);
      }
    } else {
      for (int c = 0; c < nc; c++) {
        const uint8_t* pc = full[c].data() + y * full_stride[c];
        for (int64_t x = 0; x < width; x++) o[x * nc + c] = pc[x];
      }
    }
  }
  return 0;
}

}  // extern "C"
