// cv2.dilate with the ellipse kernel and the PNG scanline filters, for the
// port's data path (leftrefill_torch/data/image_io.py), host code, bit for
// bit as image_io.py's numpy versions (its plain versions).
//
// They replace no TPU kernel: dilate is the counterpart of the cv2.dilate
// of the JAX package's novel-view masks (leftrefill_tpu/data/masks.py), the
// unfilter of what libpng does under cv2.imread.  The loader's threads call
// them with the GIL released (ctypes).
//
// dilate: each kernel row is one run of columns (the ellipse's), so the
// output is the largest, over the kernel's rows, of a horizontal running
// maximum of the source row that row reaches; each running maximum of
// width L is van Herk / Gil-Werman's (a prefix and a suffix maximum within
// blocks of L, three comparisons a sample whatever L), computed a source
// row at a time so that its rows stay in cache.  Bounded by the kernel's
// rows: k comparisons an output sample, each a compare and a select that
// the compiler vectorizes.
// unfilter: a byte a step, each depending on its left neighbour (Sub,
// Average, Paeth), so serial along a row; bounded by that dependency.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// np.maximum: NaN if either is NaN, a branch-free select
template <typename T>
inline T max_of(T a, T b) {
  return ((a > b) | (a != a)) ? a : b;
}

// Source row by source row: its running maxima of each width the kernel's
// rows need (van Herk / Gil-Werman over blocks of that width), then each
// kernel row's share max-ed into the output row it reaches.  An output row
// takes its kernel rows in their order, as the plain version does.
template <typename T>
void dilate(const T* img, int h, int w, const int32_t* runs, int kh, int kw, T low, T* out) {
  const int ay = kh / 2, ax = kw / 2, pw = w + 2 * kw;
  std::vector<int> lens, slot(static_cast<size_t>(kh), -1);
  for (int i = 0; i < kh; ++i) {
    const int len = runs[2 * i + 1] - runs[2 * i];
    if (len <= 0) continue;
    auto it = std::find(lens.begin(), lens.end(), len);
    slot[size_t(i)] = int(it - lens.begin());
    if (it == lens.end()) lens.push_back(len);
  }
  std::vector<T> pad(static_cast<size_t>(pw)), g(static_cast<size_t>(pw)), s(static_cast<size_t>(pw));
  std::vector<T> win(lens.size() * size_t(pw));
  std::fill(out, out + int64_t(h) * w, low);
  for (int sy = 0; sy < h; ++sy) {
    std::fill(pad.begin(), pad.end(), low);
    std::copy(img + int64_t(sy) * w, img + int64_t(sy + 1) * w, pad.begin() + kw);
    for (size_t li = 0; li < lens.size(); ++li) {
      const int len = lens[li];
      for (int b0 = 0; b0 < pw; b0 += len) {  // prefix and suffix maxima within each block of len
        const int b1 = std::min(b0 + len, pw);
        g[size_t(b0)] = pad[size_t(b0)];
        for (int x = b0 + 1; x < b1; ++x) g[size_t(x)] = max_of(g[size_t(x - 1)], pad[size_t(x)]);
        s[size_t(b1 - 1)] = pad[size_t(b1 - 1)];
        for (int x = b1 - 2; x >= b0; --x) s[size_t(x)] = max_of(s[size_t(x + 1)], pad[size_t(x)]);
      }
      T* row = win.data() + li * size_t(pw);
      for (int x = 0; x + len - 1 < pw; ++x) row[x] = max_of(s[size_t(x)], g[size_t(x + len - 1)]);
    }
    // kernel row i reaches output row sy - i + ay, so an output row takes
    // its kernel rows in increasing order as sy grows
    for (int i = 0; i < kh; ++i) {
      const int y = sy - i + ay;
      if (slot[size_t(i)] < 0 || y < 0 || y >= h) continue;
      const T* row = win.data() + size_t(slot[size_t(i)]) * pw + (runs[2 * i] - ax + kw);
      T* o = out + int64_t(y) * w;
      for (int x = 0; x < w; ++x) o[x] = max_of(o[x], row[x]);
    }
  }
}

}  // namespace

extern "C" {

// cv2.dilate(img, kernel), one iteration, the anchor at the kernel's
// centre, nothing from outside the image: [h, w] -> [h, w].  `runs`: each
// of the kh kernel rows' columns [j0, j1) (j1 <= j0: an empty row).
void lr_dilate_u8(const uint8_t* img, int h, int w, const int32_t* runs, int kh, int kw, uint8_t* out) {
  dilate<uint8_t>(img, h, w, runs, kh, kw, 0, out);
}

void lr_dilate_f32(const float* img, int h, int w, const int32_t* runs, int kh, int kw, float* out) {
  dilate<float>(img, h, w, runs, kh, kw, -__builtin_inff(), out);
}

// Undo the PNG scanline filters (PNG spec section 9) of h rows of `stride`
// bytes, each after its filter-type byte, with `bpp` bytes a pixel.
// Returns -1, or the first row whose filter type is unknown.
int lr_png_unfilter(const uint8_t* raw, int h, int64_t stride, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero(size_t(stride), 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + int64_t(y) * (stride + 1);
    const uint8_t kind = line[0];
    ++line;
    const uint8_t* up = y ? out + int64_t(y - 1) * stride : zero.data();
    uint8_t* cur = out + int64_t(y) * stride;
    switch (kind) {
      case 0:
        for (int64_t x = 0; x < stride; ++x) cur[x] = line[x];
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x) cur[x] = uint8_t(line[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) cur[x] = uint8_t(line[x] + up[x]);
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) cur[x] = uint8_t(line[x] + (((x >= bpp ? cur[x - bpp] : 0) + up[x]) >> 1));
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0, b = up[x], c = x >= bpp ? up[x - bpp] : 0;
          const int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          cur[x] = uint8_t(line[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

}  // extern "C"
