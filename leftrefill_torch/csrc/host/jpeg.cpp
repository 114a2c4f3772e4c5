// The pixel path of the port's JPEG decoder (leftrefill_torch/data/jpeg.py),
// host code: the Huffman scans, the dequantisation with libjpeg's islow
// IDCT and range limit, the fancy chroma upsampling and the YCbCr -> RGB
// tables, bit for bit as jpeg.py's numpy/Python versions (its plain
// versions), which give libjpeg-turbo's pixels (what cv2.imread gives).
//
// It replaces no TPU kernel: it is the counterpart of the native code that
// the JAX package's data path reaches through cv2.imread
// (leftrefill_tpu/data/datasets.py, masks.py).  It runs on the host, on the
// loader's threads; ctypes releases the GIL for the call, so the threads
// decode in parallel.  Bounded by the entropy decode's serial bit reads
// (one symbol after another), then by the bytes the IDCT and the colour
// conversion write.
//
// The marker parse, the tables and the Exif orientation stay in Python.
// Every buffer is allocated by the caller (numpy); errors come back as
// codes that the wrapper (data/native.py) turns into jpeg.py's exceptions.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural index (jpeg.py's NATURAL)
const int kNatural[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63};

enum Error { kOk = 0, kBadCode = 1, kPastBlock = 2, kFewIntervals = 3, kPastData = 4 };

constexpr int kLookBits = 9;

// A canonical Huffman table (jpeg.py's _canonical): codes of one length
// consecutive, shifted left between lengths.  `look` decodes codes of up
// to kLookBits bits from the window's first bits; longer ones go through
// maxcode / valoffset.  A window whose prefix is no code has no length l
// with code_l <= maxcode[l] (the codes cover [0, end) of the left-aligned
// windows contiguously), which jpeg.py's 16-bit table marks None.
struct Huffman {
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: no code of <= kLookBits bits
  int32_t maxcode[17];            // the largest code of each length, -1 for none
  int32_t valoffset[17];
  uint8_t symbols[256];

  void build(const uint8_t* spec) {  // spec: 16 counts, then the symbols
    std::memset(look, 0, sizeof(look));
    std::memcpy(symbols, spec + 16, 256);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = spec[l - 1];
      valoffset[l] = k - code;
      maxcode[l] = n ? code + n - 1 : -1;
      for (int i = 0; i < n; ++i, ++code, ++k) {
        if (l <= kLookBits) {
          int lo = code << (kLookBits - l), span = 1 << (kLookBits - l);
          for (int j = 0; j < span; ++j) look[lo + j] = uint16_t((l << 8) | symbols[k]);
        }
      }
      code <<= 1;
    }
  }

  // the (length, symbol) of the code at the top of a 16-bit window; false
  // where no code starts there
  inline bool decode(uint32_t window, int& length, int& symbol) const {
    uint16_t e = look[window >> (16 - kLookBits)];
    if (e) {
      length = e >> 8;
      symbol = e & 0xFF;
      return true;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t c = int32_t(window >> (16 - l));
      if (c <= maxcode[l]) {
        length = l;
        symbol = symbols[c + valoffset[l]];
        return true;
      }
    }
    return false;
  }
};

// One de-stuffed segment, read as jpeg.py reads it: zero bits past its end,
// and an access at a byte offset of len + 8 or more is past the data (the
// plain version's table of windows ends there).
struct Bits {
  std::vector<uint8_t> buf;
  int64_t limit = 0;  // len + 8
  int64_t pos = 0;    // in bits

  void reset(const uint8_t* d, int64_t len) {
    buf.assign(size_t(len + 16), 0);
    if (len) std::memcpy(buf.data(), d, size_t(len));
    limit = len + 8;
    pos = 0;
  }
  inline bool ok(int64_t p) const { return (p >> 3) < limit; }
  inline uint32_t peek16(int64_t p) const {  // bits [p, p + 16)
    const uint8_t* b = buf.data() + (p >> 3);
    uint32_t w = (uint32_t(b[0]) << 16) | (uint32_t(b[1]) << 8) | b[2];
    return (w >> (8 - (p & 7))) & 0xFFFF;
  }
  inline uint32_t peek(int64_t p, int n) const {  // bits [p, p + n), n <= 16
    const uint8_t* b = buf.data() + (p >> 3);
    uint32_t w = (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) | (uint32_t(b[2]) << 8) | b[3];
    return (w >> (32 - n - (p & 7))) & ((1u << n) - 1);
  }
  // the progressive scans' reader (jpeg.py's _Bits)
  inline int bits(int n, int& err) {
    if (n == 0) return 0;
    if (!ok(pos)) {
      err = kPastData;
      return 0;
    }
    uint32_t v = peek(pos, n);
    pos += n;
    return int(v);
  }
  inline int huff(const Huffman& t, int& err) {
    if (!ok(pos)) {
      err = kPastData;
      return 0;
    }
    int length, symbol;
    if (!t.decode(peek16(pos), length, symbol)) {
      err = kBadCode;
      return 0;
    }
    pos += length;
    return symbol;
  }
};

inline int extend(int v, int s) { return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v; }

// The blocks of a scan in its order (jpeg.py's _scan_blocks): (slot,
// offset of the block's 64 coefficients).
struct Slot {
  int h, v, bw, bx, by;  // sampling factors, blocks a row of the plane, blocks the scan covers (one component)
  int16_t* coef;
};

void scan_blocks(const std::vector<Slot>& slots, int mcux, int mcuy, std::vector<int>& slot_of,
                 std::vector<int64_t>& offset) {
  if (slots.size() == 1) {
    const Slot& s = slots[0];
    for (int y = 0; y < s.by; ++y)
      for (int x = 0; x < s.bx; ++x) {
        slot_of.push_back(0);
        offset.push_back((int64_t(y) * s.bw + x) * 64);
      }
    return;
  }
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx)
      for (size_t k = 0; k < slots.size(); ++k) {
        const Slot& s = slots[k];
        for (int vy = 0; vy < s.v; ++vy)
          for (int hx = 0; hx < s.h; ++hx) {
            slot_of.push_back(int(k));
            offset.push_back((int64_t(my * s.v + vy) * s.bw + mx * s.h + hx) * 64);
          }
      }
}

// A sequential scan (jpeg.py's _baseline_scan), with the plain version's
// checks at the same places: the window of each code, and of a value whose
// bits pass the code's 16-bit window.
int baseline_block(Bits& br, const Huffman& dc, const Huffman& ac, int16_t* c, int& pred) {
  int length, sym;
  int64_t p = br.pos;
  if (!br.ok(p)) return kPastData;
  uint32_t w = br.peek16(p);
  if (!dc.decode(w, length, sym)) return kBadCode;
  int v = 0;
  if (sym) {
    if (length + sym <= 16) {
      v = extend(int((w >> (16 - length - sym)) & ((1u << sym) - 1)), sym);
    } else {
      if (!br.ok(p + length)) return kPastData;
      v = extend(int(br.peek(p + length, sym)), sym);
    }
  }
  p += length + sym;
  pred += v;
  c[0] = int16_t(pred);
  int k = 1;
  while (k < 64) {
    if (!br.ok(p)) return kPastData;
    w = br.peek16(p);
    if (!ac.decode(w, length, sym)) return kBadCode;
    int r = sym >> 4, s = sym & 15;
    if (s == 0 && r != 15) {  // end of block
      p += length;
      break;
    }
    k += r;
    if (s) {
      if (length + s <= 16) {
        v = extend(int((w >> (16 - length - s)) & ((1u << s) - 1)), s);
      } else {
        if (!br.ok(p + length)) return kPastData;
        v = extend(int(br.peek(p + length, s)), s);
      }
      if (k > 63) return kPastBlock;
      c[kNatural[k]] = int16_t(v);
    }
    p += length + s;
    ++k;
  }
  br.pos = p;
  return kOk;
}

int dc_block(Bits& br, const Huffman* dc, int16_t* c, int& pred, int ah, int al) {
  int err = kOk;
  if (ah == 0) {
    int s = br.huff(*dc, err);
    if (err) return err;
    int v = br.bits(s, err);
    if (err) return err;
    pred += extend(v, s);
    c[0] = int16_t(pred * (1 << al));
  } else {
    int b = br.bits(1, err);
    if (err) return err;
    if (b) c[0] = int16_t(c[0] | (1 << al));
  }
  return kOk;
}

// A progressive AC scan's block (jpeg.py's _ac_scan: the first scan, and
// jdphuff.c's decode_mcu_AC_refine)
int ac_block(Bits& br, const Huffman& ac, int16_t* c, int& eobrun, int ss, int se, int ah, int al) {
  int err = kOk;
  const int p1 = 1 << al, m1 = -(1 << al);
  if (ah == 0) {
    if (eobrun) {
      --eobrun;
      return kOk;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.huff(ac, err);
      if (err) return err;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return kPastBlock;
        int v = br.bits(s, err);
        if (err) return err;
        c[kNatural[k]] = int16_t(extend(v, s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        int v = br.bits(r, err);
        if (err) return err;
        eobrun = (1 << r) + v - 1;
        break;
      }
    }
    return kOk;
  }
  int k = ss;
  if (eobrun == 0) {
    while (k <= se) {
      int rs = br.huff(ac, err);
      if (err) return err;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        int b = br.bits(1, err);
        if (err) return err;
        s = b ? p1 : m1;
      } else if (r != 15) {
        int v = br.bits(r, err);
        if (err) return err;
        eobrun = (1 << r) + v;
        break;
      }
      while (k <= se) {
        int16_t& x = c[kNatural[k]];
        if (x) {
          int b = br.bits(1, err);
          if (err) return err;
          if (b && !(x & p1)) x = int16_t(x + (x >= 0 ? p1 : m1));
        } else {
          if (--r < 0) break;
        }
        ++k;
      }
      if (s && k <= se) c[kNatural[k]] = int16_t(s);
      ++k;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t& x = c[kNatural[k]];
      if (x) {
        int b = br.bits(1, err);
        if (err) return err;
        if (b && !(x & p1)) x = int16_t(x + (x >= 0 ? p1 : m1));
      }
    }
    --eobrun;
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// islow IDCT (jidctint.c), in 64-bit products as jpeg.py's idct_islow; the
// column pass's work array is int (wrapped to 32 bits), as libjpeg's

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

inline void idct_1d(const int64_t* s, int64_t* out, int shift) {
  int64_t z1 = (s[2] + s[6]) * F0_541;
  int64_t tmp2 = z1 + s[6] * -F1_847;
  int64_t tmp3 = z1 + s[2] * F0_765;
  int64_t tmp0 = (s[0] + s[4]) * (int64_t(1) << kConstBits);
  int64_t tmp1 = (s[0] - s[4]) * (int64_t(1) << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = s[7], t1 = s[5], t2 = s[3], t3 = s[1];
  int64_t a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  int64_t z5 = (a3 + a4) * F1_175;
  t0 *= F0_298;
  t1 *= F2_053;
  t2 *= F3_072;
  t3 *= F1_501;
  a1 *= -F0_899;
  a2 *= -F2_562;
  a3 = a3 * -F1_961 + z5;
  a4 = a4 * -F0_390 + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  out[0] = descale(tmp10 + t3, shift);
  out[7] = descale(tmp10 - t3, shift);
  out[1] = descale(tmp11 + t2, shift);
  out[6] = descale(tmp11 - t2, shift);
  out[2] = descale(tmp12 + t1, shift);
  out[5] = descale(tmp12 - t1, shift);
  out[3] = descale(tmp13 + t0, shift);
  out[4] = descale(tmp13 - t0, shift);
}

inline uint8_t range_limit(int64_t x) {  // jdmaster.c's table at x & 1023 (x before the +128 level shift)
  int v = int(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// YCbCr -> RGB (jdcolor.c, 16 fraction bits)

struct YccTables {
  // the four tables in 32 bits (|cb_g + cr_g| < 2^24), and the clamp to
  // [0, 255] as a table over y + [-227, 227] (offset 512)
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  uint8_t clamp[1024];
  YccTables() {
    auto fix = [](double x) { return int64_t(x * 65536 + 0.5); };
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int32_t((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int32_t((fix(1.77200) * x + half) >> 16);
      cr_g[i] = int32_t(-fix(0.71414) * x);
      cb_g[i] = int32_t(-fix(0.34414) * x + half);
    }
    for (int i = 0; i < 1024; ++i) clamp[i] = uint8_t(i < 512 ? 0 : (i > 512 + 255 ? 255 : i - 512));
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

}  // namespace

extern "C" {

// A scan's entropy-coded data from `start` (jpeg.py's _entropy_segments):
// split at its restart markers, each segment de-stuffed (0xFF, any fill
// 0xFFs, 0x00 -> the data byte 0xFF) into `out` back to back, segment i at
// [seg_off[i], seg_off[i + 1]).  `out` holds n - start bytes, `seg_off`
// (n - start) / 2 + 2 offsets.  Returns the number of segments; `*end` is
// the offset of the marker that ends the scan (n where none does).
int lr_jpeg_segments(const uint8_t* data, int64_t n, int64_t start, uint8_t* out, int64_t* seg_off, int64_t* end) {
  int segs = 0;
  int64_t w = 0, cur = start, i = start;
  seg_off[0] = 0;
  auto emit = [&](int64_t from, int64_t to) {  // data[from:to] de-stuffed
    for (int64_t p = from; p < to; ++p) {
      out[w++] = data[p];
      if (data[p] == 0xFF) {
        int64_t q = p + 1;
        while (q < to && data[q] == 0xFF) ++q;
        if (q < to && data[q] == 0x00) p = q;  // FF+ 00 -> FF
      }
    }
    seg_off[++segs] = w;
  };
  while (true) {
    const uint8_t* f = static_cast<const uint8_t*>(i < n ? std::memchr(data + i, 0xFF, size_t(n - i)) : nullptr);
    if (!f) {
      emit(cur, n);
      *end = n;
      return segs;
    }
    const int64_t j = f - data;
    int64_t k = j + 1;
    while (k < n && data[k] == 0xFF) ++k;  // fill bytes
    if (k < n && data[k] == 0x00) {        // a stuffed data byte
      i = k + 1;
      continue;
    }
    emit(cur, j);
    if (k < n && data[k] >= 0xD0 && data[k] <= 0xD7) {  // RSTn
      cur = i = k + 1;
      continue;
    }
    *end = j;
    return segs;
  }
}

// Decodes one scan into the components' coefficients (int16, natural order,
// [bh, bw, 64] each).  `data`: the scan's de-stuffed segments back to back,
// segment i at [seg_off[i], seg_off[i + 1]).  `slot_info`: h, v, bw, bx, by
// of each of the ns components of the scan; `tables`: each slot's DC and AC
// table as 16 counts and 256 symbols (2 x 272 bytes a slot).  `interval`:
// blocks a restart interval (0: none).  `progressive` 0: a sequential scan;
// 1: a progressive one over the band [ss, se] at (ah, al).  Returns 0 or an
// Error code.
int lr_jpeg_scan(const uint8_t* data, const int64_t* seg_off, int n_segs, int ns, const int32_t* slot_info,
                 int16_t** coefs, const uint8_t* tables, int mcux, int mcuy, int interval, int progressive, int ss,
                 int se, int ah, int al) {
  std::vector<Slot> slots(ns);
  std::vector<Huffman> dc(ns), ac(ns);
  for (int k = 0; k < ns; ++k) {
    const int32_t* s = slot_info + 5 * k;
    slots[k] = Slot{s[0], s[1], s[2], s[3], s[4], coefs[k]};
    dc[k].build(tables + 544 * k);
    ac[k].build(tables + 544 * k + 272);
  }
  std::vector<int> slot_of;
  std::vector<int64_t> offset;
  scan_blocks(slots, mcux, mcuy, slot_of, offset);
  const int64_t n = int64_t(offset.size());
  const int64_t per = interval > 0 ? interval : n;
  Bits br;
  int segment = 0;
  for (int64_t start = 0; start < n; start += per, ++segment) {
    if (segment >= n_segs) return kFewIntervals;
    br.reset(data + seg_off[segment], seg_off[segment + 1] - seg_off[segment]);
    std::vector<int> pred(size_t(ns), 0);
    int eobrun = 0;
    const int64_t end = start + per < n ? start + per : n;
    for (int64_t b = start; b < end; ++b) {
      const int k = slot_of[size_t(b)];
      int16_t* c = slots[k].coef + offset[size_t(b)];
      int err;
      if (!progressive)
        err = baseline_block(br, dc[k], ac[k], c, pred[k]);
      else if (ss == 0)
        err = dc_block(br, &dc[k], c, pred[k], ah, al);
      else
        err = ac_block(br, ac[k], c, eobrun, ss, se, ah, al);
      if (err) return err;
    }
    if (interval <= 0) break;
  }
  return kOk;
}

// Dequantise, IDCT and range-limit the [by, bx, 64] coefficients of a
// component with its table (natural order) into the [by * 8, bx * 8] plane.
void lr_jpeg_idct(const int16_t* coef, int by, int bx, const int64_t* quant, uint8_t* out) {
  const int64_t stride = int64_t(bx) * 8;
  for (int y = 0; y < by; ++y)
    for (int x = 0; x < bx; ++x) {
      const int16_t* c = coef + (int64_t(y) * bx + x) * 64;
      int32_t ws[64];
      int64_t in[8], o[8];
      // jidctint.c's shortcuts, exact: a pass whose inputs 1-7 are zero
      // gives its DESCALEd input 0 everywhere (the column pass: 4 x it; the
      // row pass: (ws0 + 16) >> 5)
      for (int v = 0; v < 8; ++v) {  // columns
        bool ac = false;
        for (int u = 1; u < 8; ++u) ac |= c[u * 8 + v] != 0;
        if (!ac) {
          const int32_t dc = int32_t(uint32_t(uint64_t(int64_t(c[v]) * quant[v] * 4)));
          for (int u = 0; u < 8; ++u) ws[u * 8 + v] = dc;
          continue;
        }
        for (int u = 0; u < 8; ++u) in[u] = int64_t(c[u * 8 + v]) * quant[u * 8 + v];
        idct_1d(in, o, kConstBits - kPass1Bits);
        for (int u = 0; u < 8; ++u) ws[u * 8 + v] = int32_t(uint32_t(uint64_t(o[u])));
      }
      uint8_t* dst = out + int64_t(y) * 8 * stride + int64_t(x) * 8;
      for (int u = 0; u < 8; ++u) {  // rows
        const int32_t* w = ws + u * 8;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
          const uint8_t px = range_limit(descale(w[0], kPass1Bits + 3));
          for (int v = 0; v < 8; ++v) dst[u * stride + v] = px;
          continue;
        }
        for (int v = 0; v < 8; ++v) in[v] = w[v];
        idct_1d(in, o, kConstBits + kPass1Bits + 3);
        for (int v = 0; v < 8; ++v) dst[u * stride + v] = range_limit(o[v]);
      }
    }
}

// A component plane at its downsampled size [ph, pw] (row stride `stride`)
// -> [height, width] by the factors (fh, fv), as jpeg.py's upsample: the
// fancy triangle filters for 2x1 and 2x2 (planes wider than two samples)
// and 1x2, box replication otherwise.
void lr_jpeg_upsample(const uint8_t* in, int ph, int pw, int64_t stride, int fh, int fv, uint8_t* out, int height,
                      int width) {
  const bool h2v1 = fh == 2 && fv == 1 && pw > 2, h1v2 = fh == 1 && fv == 2, h2v2 = fh == 2 && fv == 2 && pw > 2;
  std::vector<int> s(static_cast<size_t>(pw));
  std::vector<uint8_t> t(static_cast<size_t>(pw) * fh);  // a whole output row, before the crop to `width`
  for (int y = 0; y < height; ++y) {
    uint8_t* dst = out + int64_t(y) * width;
    if (h2v1) {  // (3 x + left + 1) >> 2, (3 x + right + 2) >> 2; the ends their own value
      const uint8_t* x = in + int64_t(y) * stride;
      t[0] = x[0];
      for (int j = 1; j < pw; ++j) t[size_t(2 * j)] = uint8_t((3 * x[j] + x[j - 1] + 1) >> 2);
      for (int j = 0; j < pw - 1; ++j) t[size_t(2 * j + 1)] = uint8_t((3 * x[j] + x[j + 1] + 2) >> 2);
      t[size_t(2 * pw - 1)] = x[pw - 1];
      std::memcpy(dst, t.data(), size_t(width));
    } else if (h1v2 || h2v2) {
      // the column sums 3 x + the row above (upper output row) or below
      // (lower), the edge rows repeated
      const int i = y >> 1, r = y & 1;
      const uint8_t* row = in + int64_t(i) * stride;
      const uint8_t* nb = in + int64_t(r ? (i + 1 < ph ? i + 1 : ph - 1) : (i > 0 ? i - 1 : 0)) * stride;
      if (h1v2) {
        for (int x = 0; x < width; ++x) dst[x] = uint8_t((3 * row[x] + nb[x] + 1 + r) >> 2);
        continue;
      }
      for (int j = 0; j < pw; ++j) s[size_t(j)] = 3 * row[j] + nb[j];
      t[0] = uint8_t((4 * s[0] + 8) >> 4);
      for (int j = 1; j < pw; ++j) t[size_t(2 * j)] = uint8_t((3 * s[size_t(j)] + s[size_t(j - 1)] + 8) >> 4);
      for (int j = 0; j < pw - 1; ++j) t[size_t(2 * j + 1)] = uint8_t((3 * s[size_t(j)] + s[size_t(j + 1)] + 7) >> 4);
      t[size_t(2 * pw - 1)] = uint8_t((4 * s[size_t(pw - 1)] + 7) >> 4);
      std::memcpy(dst, t.data(), size_t(width));
    } else {  // box replication
      const uint8_t* row = in + int64_t(y / fv) * stride;
      if (fh == 1) {
        std::memcpy(dst, row, size_t(width));
      } else {
        for (int x = 0; x < width; ++x) dst[x] = row[x / fh];
      }
    }
  }
}

// jdcolor.c's ycc_rgb_convert: n pixels of three planes -> n x 3 RGB
void lr_jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n, uint8_t* out) {
  const YccTables& t = ycc_tables();
  const uint8_t* clamp = t.clamp + 512;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t l = y[i];
    out[3 * i] = clamp[l + t.cr_r[cr[i]]];
    out[3 * i + 1] = clamp[l + ((t.cb_g[cb[i]] + t.cr_g[cr[i]]) >> 16)];
    out[3 * i + 2] = clamp[l + t.cb_b[cb[i]]];
  }
}

}  // extern "C"
