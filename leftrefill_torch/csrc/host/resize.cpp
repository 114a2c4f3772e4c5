// cv2.resize for the port's data path (leftrefill_torch/data/image_io.py),
// host code: INTER_NEAREST, INTER_LINEAR and INTER_AREA on uint8 and
// float32 images of any channel count, bit for bit as image_io.py's numpy
// versions (its plain versions): the same taps and area tables in double
// and float32, the same fixed point for uint8 bilinear, the same order of
// float32 sums.  Built with -ffp-contract=off, so that no multiply-add is
// fused where the plain version rounds twice.
//
// It replaces no TPU kernel: it is the counterpart of the native code that
// the JAX package's data path reaches through cv2.resize.  The loader's
// threads call it with the GIL released (ctypes).  Bounded by the bytes it
// reads and writes; a few multiply-adds a sample.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct Taps {
  std::vector<int64_t> s0, s1;
  std::vector<float> f;
};

// image_io._linear_taps: f = float32((d + 0.5) * scale - 0.5), its floor and
// rest; with `clamp` a fraction outside [0, ssize - 1) is 0 there
Taps linear_taps(int ssize, int dsize, bool clamp) {
  Taps t;
  const double scale = 1.0 / (double(dsize) / double(ssize));
  for (int d = 0; d < dsize; ++d) {
    float f = float((d + 0.5) * scale - 0.5);
    int64_t s = int64_t(std::floor(double(f)));
    f = f - float(s);
    if (clamp && (s < 0 || s >= ssize - 1)) {
      f = 0.0f;
      s = s < 0 ? 0 : ssize - 1;
    }
    t.s0.push_back(s < 0 ? 0 : (s > ssize - 1 ? ssize - 1 : s));
    t.s1.push_back(s + 1 < 0 ? 0 : (s + 1 > ssize - 1 ? ssize - 1 : s + 1));
    t.f.push_back(f);
  }
  return t;
}

// image_io._area_taps: OpenCV's bilinear emulation of an enlarging area resize
Taps area_taps(int ssize, int dsize, bool clamp) {
  Taps t;
  const double inv = double(dsize) / double(ssize), scale = 1.0 / inv;
  for (int d = 0; d < dsize; ++d) {
    int64_t s = int64_t(std::floor(d * scale));
    float f = float(double(d + 1) - double(s + 1) * inv);
    f = f <= 0.0f ? 0.0f : f - std::floor(f);
    if (clamp && s >= ssize - 1) {
      f = 0.0f;
      s = ssize - 1;
    }
    t.s0.push_back(s < 0 ? 0 : (s > ssize - 1 ? ssize - 1 : s));
    t.s1.push_back(s + 1 < 0 ? 0 : (s + 1 > ssize - 1 ? ssize - 1 : s + 1));
    t.f.push_back(f);
  }
  return t;
}

// image_io._area_table: OpenCV's computeResizeAreaTab as [dsize, k] index
// and float32 weight tables, zero-weight pads at index 0
struct AreaTable {
  int k = 0;
  std::vector<int64_t> idx;
  std::vector<float> wgt;
};

AreaTable area_table(int ssize, int dsize) {
  const double scale = double(ssize) / double(dsize);
  std::vector<std::vector<std::pair<int64_t, double>>> rows(static_cast<size_t>(dsize));
  AreaTable t;
  for (int d = 0; d < dsize; ++d) {
    const double f1 = d * scale, f2 = f1 + scale;
    const double cell = std::min(scale, ssize - f1);
    const int64_t s2 = std::min(int64_t(std::floor(f2)), int64_t(ssize - 1));
    const int64_t s1 = std::min(int64_t(std::ceil(f1)), s2);
    auto& row = rows[size_t(d)];
    if (s1 - f1 > 1e-3) row.emplace_back(s1 - 1, (s1 - f1) / cell);
    for (int64_t s = s1; s < s2; ++s) row.emplace_back(s, 1.0 / cell);
    if (f2 - s2 > 1e-3) row.emplace_back(s2, std::min(std::min(f2 - s2, 1.0), cell) / cell);
    t.k = std::max(t.k, int(row.size()));
  }
  t.idx.assign(size_t(dsize) * t.k, 0);
  t.wgt.assign(size_t(dsize) * t.k, 0.0f);
  for (int d = 0; d < dsize; ++d)
    for (size_t j = 0; j < rows[size_t(d)].size(); ++j) {
      t.idx[size_t(d) * t.k + j] = rows[size_t(d)][j].first;
      t.wgt[size_t(d) * t.k + j] = float(rows[size_t(d)][j].second);
    }
  return t;
}

inline uint8_t saturate_u8(float x) {  // image_io._saturate: rint (halves to even), clip
  float r = std::nearbyint(x);
  return uint8_t(r < 0.0f ? 0 : (r > 255.0f ? 255 : int(r)));
}

template <typename T>
void area(const T* src, int h, int w, int c, T* dst, int dh, int dw) {
  const AreaTable xt = area_table(w, dw), yt = area_table(h, dh);
  const int64_t rw = int64_t(dw) * c;
  std::vector<float> rows(static_cast<size_t>(h) * rw, 0.0f);
  for (int y = 0; y < h; ++y) {  // each output's terms added in table order, as the plain version's
    const T* s = src + int64_t(y) * w * c;
    float* r = rows.data() + y * rw;
    for (int x = 0; x < dw; ++x) {
      const int64_t* idx = xt.idx.data() + size_t(x) * xt.k;
      const float* wgt = xt.wgt.data() + size_t(x) * xt.k;
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int j = 0; j < xt.k; ++j) acc = acc + float(s[idx[j] * c + ch]) * wgt[j];
        r[x * c + ch] = acc;
      }
    }
  }
  std::vector<float> out(static_cast<size_t>(rw));
  for (int y = 0; y < dh; ++y) {
    std::fill(out.begin(), out.end(), 0.0f);
    for (int j = 0; j < yt.k; ++j) {
      const float b = yt.wgt[size_t(y) * yt.k + j];
      const float* r = rows.data() + yt.idx[size_t(y) * yt.k + j] * rw;
      for (int64_t i = 0; i < rw; ++i) out[size_t(i)] = out[size_t(i)] + r[i] * b;
    }
    T* d = dst + y * rw;
    for (int64_t i = 0; i < rw; ++i) {
      if constexpr (sizeof(T) == 1)
        d[i] = saturate_u8(out[size_t(i)]);
      else
        d[i] = out[size_t(i)];
    }
  }
}

}  // namespace

extern "C" {

// INTER_NEAREST: source index floor(d * (1 / (dsize / ssize))), at most the
// last; a pixel is `pix` bytes
void lr_resize_nearest(const uint8_t* src, int h, int w, int64_t pix, uint8_t* dst, int dh, int dw) {
  const double sx = 1.0 / (double(dw) / double(w)), sy = 1.0 / (double(dh) / double(h));
  std::vector<int64_t> xs(static_cast<size_t>(dw));
  for (int x = 0; x < dw; ++x) xs[size_t(x)] = std::min(int64_t(std::floor(x * sx)), int64_t(w - 1));
  for (int y = 0; y < dh; ++y) {
    const uint8_t* s = src + std::min(int64_t(std::floor(y * sy)), int64_t(h - 1)) * w * pix;
    uint8_t* d = dst + int64_t(y) * dw * pix;
    for (int x = 0; x < dw; ++x)
      for (int64_t b = 0; b < pix; ++b) d[x * pix + b] = s[xs[size_t(x)] * pix + b];
  }
}

// image_io._area_fast on uint8: each sx x sy block's integer sum times
// float32 1 / (sx sy), rounded to even, or (sum + 2) >> 2 for 2 x 2 blocks
void lr_area_fast_u8(const uint8_t* src, int h, int w, int c, int sx, int sy, uint8_t* dst) {
  const int oh = h / sy, ow = w / sx;
  const float inv = float(1.0 / (sx * sy));
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x)
      for (int ch = 0; ch < c; ++ch) {
        int64_t total = 0;
        for (int i = 0; i < sy; ++i)
          for (int j = 0; j < sx; ++j) total += src[(int64_t(y * sy + i) * w + x * sx + j) * c + ch];
        dst[(int64_t(y) * ow + x) * c + ch] =
            (sx == 2 && sy == 2) ? uint8_t((total + 2) >> 2) : saturate_u8(float(total) * inv);
      }
}

// image_io._area_fast on float32: the block's values in row-major order,
// four at a time ((a + b) + c) + d onto the sum, then the rest one by one,
// times float32 1 / (sx sy); a 2 x 2 block of 1 or 4 channels as
// ((a + b) + (c + d)) * 0.25
void lr_area_fast_f32(const float* src, int h, int w, int c, int sx, int sy, float* dst) {
  const int oh = h / sy, ow = w / sx, n = sx * sy;
  const float inv = float(1.0 / n);
  const bool pair = sx == 2 && sy == 2 && (c == 1 || c == 4);
  std::vector<float> t(static_cast<size_t>(n));
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x)
      for (int ch = 0; ch < c; ++ch) {
        for (int i = 0; i < sy; ++i)
          for (int j = 0; j < sx; ++j) t[size_t(i * sx + j)] = src[(int64_t(y * sy + i) * w + x * sx + j) * c + ch];
        float out;
        if (pair) {
          out = ((t[0] + t[1]) + (t[2] + t[3])) * 0.25f;
        } else {
          out = 0.0f;
          int k = 0;
          for (; k < n - 3; k += 4) out = out + (((t[size_t(k)] + t[size_t(k + 1)]) + t[size_t(k + 2)]) + t[size_t(k + 3)]);
          for (k = n / 4 * 4; k < n; ++k) out = out + t[size_t(k)];
          out = out * inv;
        }
        dst[(int64_t(y) * ow + x) * c + ch] = out;
      }
}

// image_io._area: OpenCV's general area average (a shrink)
void lr_area_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst, int dh, int dw) {
  area(src, h, w, c, dst, dh, dw);
}

void lr_area_f32(const float* src, int h, int w, int c, float* dst, int dh, int dw) {
  area(src, h, w, c, dst, dh, dw);
}

// image_io._linear on uint8: 11-bit coefficients, each rounded on its own;
// the horizontal sums exact, the vertical pass in 16-bit lanes (each row
// >> 4, times its coefficient, the high 16 bits kept, the two added and
// rounded >> 2).  `area`: the taps of an enlarging area resize.
void lr_linear_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst, int dh, int dw, int area) {
  const Taps tx = area ? area_taps(w, dw, true) : linear_taps(w, dw, true);
  const Taps ty = area ? area_taps(h, dh, false) : linear_taps(h, dh, false);
  const float one = 2048.0f;
  std::vector<int64_t> ax0(static_cast<size_t>(dw)), ax1(static_cast<size_t>(dw));
  for (int x = 0; x < dw; ++x) {
    ax0[size_t(x)] = int64_t(std::nearbyint((1.0f - tx.f[size_t(x)]) * one));
    ax1[size_t(x)] = int64_t(std::nearbyint(tx.f[size_t(x)] * one));
  }
  const int64_t rw = int64_t(dw) * c;
  std::vector<int64_t> rows(static_cast<size_t>(h) * rw);
  std::vector<char> done(size_t(h), 0);
  auto row = [&](int64_t y) -> const int64_t* {
    int64_t* r = rows.data() + y * rw;
    if (!done[size_t(y)]) {
      const uint8_t* s = src + y * w * c;
      for (int x = 0; x < dw; ++x)
        for (int ch = 0; ch < c; ++ch)
          r[x * c + ch] = s[tx.s0[size_t(x)] * c + ch] * ax0[size_t(x)] + s[tx.s1[size_t(x)] * c + ch] * ax1[size_t(x)];
      done[size_t(y)] = 1;
    }
    return r;
  };
  for (int y = 0; y < dh; ++y) {
    const int64_t b0 = int64_t(std::nearbyint((1.0f - ty.f[size_t(y)]) * one));
    const int64_t b1 = int64_t(std::nearbyint(ty.f[size_t(y)] * one));
    const int64_t* r0 = row(ty.s0[size_t(y)]);
    const int64_t* r1 = row(ty.s1[size_t(y)]);
    uint8_t* d = dst + y * rw;
    for (int64_t i = 0; i < rw; ++i) {
      int64_t v = ((((r0[i] >> 4) * b0) >> 16) + (((r1[i] >> 4) * b1) >> 16) + 2) >> 2;
      d[i] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// image_io._linear on float32: each pass as (s0 * (1 - f)) + (s1 * f),
// every product and sum rounded to float32
void lr_linear_f32(const float* src, int h, int w, int c, float* dst, int dh, int dw, int area) {
  const Taps tx = area ? area_taps(w, dw, true) : linear_taps(w, dw, true);
  const Taps ty = area ? area_taps(h, dh, false) : linear_taps(h, dh, false);
  const int64_t rw = int64_t(dw) * c;
  std::vector<float> rows(static_cast<size_t>(h) * rw);
  std::vector<char> done(size_t(h), 0);
  auto row = [&](int64_t y) -> const float* {
    float* r = rows.data() + y * rw;
    if (!done[size_t(y)]) {
      const float* s = src + y * w * c;
      for (int x = 0; x < dw; ++x) {
        const float a1 = tx.f[size_t(x)], a0 = 1.0f - a1;
        for (int ch = 0; ch < c; ++ch) r[x * c + ch] = s[tx.s0[size_t(x)] * c + ch] * a0 + s[tx.s1[size_t(x)] * c + ch] * a1;
      }
      done[size_t(y)] = 1;
    }
    return r;
  };
  for (int y = 0; y < dh; ++y) {
    const float b1 = ty.f[size_t(y)], b0 = 1.0f - b1;
    const float* r0 = row(ty.s0[size_t(y)]);
    const float* r1 = row(ty.s1[size_t(y)]);
    float* d = dst + y * rw;
    for (int64_t i = 0; i < rw; ++i) d[i] = r0[i] * b0 + r1[i] * b1;
  }
}

}  // extern "C"
