// PIL's wide polyline and filled ellipse (ImageDraw.line(width=) and
// ellipse), for the port's training masks (leftrefill_torch/data/masks.py),
// host code, bit for bit as masks.py's Python versions (its plain
// versions), which are PIL's pixels.
//
// It replaces no TPU kernel: it is the counterpart of the PIL calls of the
// JAX package's draw_polyline_mask (leftrefill_tpu/data/masks.py), which
// paint the novel-view, match-based and random-stroke masks.  One call draws
// a whole mask, so the loader's threads paint with the GIL released (ctypes).
//
// A segment is PIL's quadrilateral (ImagingDrawWideLine) filled by PIL's
// scanline rule, a vertex's ellipse PIL's quarter walk over doubled
// coordinates.  Both are bounded by the pixels they write and a few
// operations a row.  Every float32 value is computed in the plain
// version's order, one rounding an operation (-ffp-contract=off).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// a vertex's coordinates must be integers that float32 holds exactly, so
// that every product below stays exact in int64 and hypot's argument in
// float64
constexpr int64_t kCoordLimit = int64_t(1) << 24;
// an ellipse box side past this overflows int64 in a^2 (b + 2)^2 + b^2 a^2
constexpr int64_t kBoxLimit = 40000;

inline float sign(float v) { return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v); }
inline double sign(double v) { return v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : v); }

// PIL's ROUND_UP / ROUND_DOWN: to nearest, halves away from / towards zero
inline int64_t round_up(float v) { return int64_t(sign(v) * std::floor(std::fabs(v) + 0.5f)); }
inline int64_t round_down(float v) { return int64_t(sign(v) * std::ceil(std::fabs(v) - 0.5f)); }
inline int64_t round_up(double v) { return int64_t(sign(v) * std::floor(std::fabs(v) + 0.5)); }
inline int64_t round_down(double v) { return int64_t(sign(v) * std::ceil(std::fabs(v) - 0.5)); }

struct Canvas {
  uint8_t* px;
  int64_t h, w;

  // columns [x0, x1) of row y, clipped
  void run(int64_t y, int64_t x0, int64_t x1) {
    if (y < 0 || y >= h) return;
    x0 = std::max<int64_t>(x0, 0);
    x1 = std::min<int64_t>(x1, w);
    if (x1 > x0) std::memset(px + y * w + x0, 1, size_t(x1 - x0));
  }
};

// masks._fill_polygon on four vertices
void fill_quad(Canvas& c, const int64_t* vx, const int64_t* vy) {
  const int n = 4;
  int64_t lo_all = vy[0], hi_all = vy[0];
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    lo_all = std::min(lo_all, std::min(vy[i], vy[j]));
    hi_all = std::max(hi_all, std::max(vy[i], vy[j]));
    if (vy[i] == vy[j]) c.run(vy[i], std::min(vx[i], vx[j]), std::max(vx[i], vx[j]) + 1);  // a horizontal edge
  }
  const int64_t y_first = std::max<int64_t>(lo_all, 0), y_last = std::min(hi_all, c.h);
  // the sloped edges: first vertex, float32 slope, their rows
  int64_t ex[n], ey[n], elo[n], ehi[n];
  float edx[n];
  int ne = 0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    if (vy[i] == vy[j]) continue;
    ex[ne] = vx[i];
    ey[ne] = vy[i];
    elo[ne] = std::min(vy[i], vy[j]);
    ehi[ne] = std::max(vy[i], vy[j]);
    edx[ne] = float(vx[j] - vx[i]) / float(vy[j] - vy[i]);
    ++ne;
  }
  if (y_last < y_first || ne == 0) return;
  float cross[2 * n];
  for (int64_t y = y_first; y <= y_last && y < c.h; ++y) {
    int k = 0;
    for (int e = 0; e < ne; ++e) {
      if (y < elo[e] || y > ehi[e]) continue;
      const float t = float(y - ey[e]) * edx[e];
      const float x = t + float(ex[e]);
      cross[k++] = x;
      if (y == ehi[e] && y < y_last) cross[k++] = x;  // PIL's last row: the polygon's, clipped to the image
    }
    std::sort(cross, cross + k);
    for (int i = 1; i < k; i += 2) c.run(y, round_up(cross[i - 1]), round_down(cross[i]) + 1);
  }
}

// masks._wide_segment
void wide_segment(Canvas& c, int64_t xa, int64_t ya, int64_t xb, int64_t yb, int width) {
  const int64_t dx = xb - xa, dy = yb - ya;
  if (dx == 0 && dy == 0) {
    c.run(ya, xa, xa + 1);
    return;
  }
  // hypot, correctly rounded as Python's math.hypot: dx^2 + dy^2 < 2^53 is exact
  const double big = std::sqrt(double(dx * dx + dy * dy));
  const double small = (width - 1) / 2.0;
  const double r_max = double(round_up(small)) / big, r_min = double(round_down(small)) / big;
  const int64_t dxmin = round_down(r_min * double(dy)), dxmax = round_down(r_max * double(dy));
  const int64_t dymin = round_down(r_min * double(dx)), dymax = round_down(r_max * double(dx));
  const int64_t vx[4] = {xa - dxmin, xb - dxmin, xb + dxmax, xa + dxmax};
  const int64_t vy[4] = {ya + dymax, yb + dymax, yb - dymin, ya - dymin};
  fill_quad(c, vx, vy);
}

inline int64_t miss(int64_t a2, int64_t b2, int64_t x, int64_t y) {
  const int64_t m = a2 * y * y + b2 * x * x - a2 * b2;
  return m < 0 ? -m : m;
}

// masks._ellipse (with _quarter_rows' walk) in the pixel box [x0, x1] x [y0, y1]
void ellipse(Canvas& c, int64_t x0, int64_t y0, int64_t x1, int64_t y1) {
  const int64_t a = x1 - x0, b = y1 - y0;
  if (a <= 0 && b <= 0) return;
  const int64_t a2 = a * a, b2 = b * b;
  // a, b >= 0 (lr_ellipse refuses reversed boxes) and the walk keeps
  // 0 <= x <= a, y <= b (y steps by 2 from b % 2 and stops at b): every
  // operand of / and % below is non-negative, where C++'s truncation is
  // Python's floor
  auto rows = [&](int64_t y, int64_t x) {
    const int64_t r0 = y0 + (b + y) / 2, r1 = y0 + (b - y) / 2;
    const int64_t c0 = x0 + (a - x) / 2, c1 = x0 + (a + x) / 2 + 1;
    c.run(r0, c0, c1);
    if (r1 != r0) c.run(r1, c0, c1);
  };
  // per doubled row, the largest x the walk reaches: the walk's x never
  // grows, so a row's largest x is the first one the walk gives it
  int64_t cx = a, cy = b % 2, row_y = cy, row_x = cx;
  while (true) {
    if (cy != row_y) {
      rows(row_y, row_x);
      row_y = cy;
      row_x = cx;
    }
    if (cx == a % 2 && cy == b) break;
    int64_t nx = cx, ny = cy + 2, best = miss(a2, b2, nx, ny);
    if (nx > 1) {
      const int64_t cand[2][2] = {{cx - 2, cy + 2}, {cx - 2, cy}};
      for (const auto& p : cand) {
        const int64_t m = miss(a2, b2, p[0], p[1]);
        if (best > m) {
          nx = p[0];
          ny = p[1];
          best = m;
        }
      }
    }
    cx = nx;
    cy = ny;
  }
  rows(row_y, row_x);
}

}  // namespace

extern "C" {

// masks.draw_polyline_mask on a zeroed [canvas, canvas] uint8 `out`: the
// closed polyline through the n float32 vertices (x, y) `pts`, `width`
// wide (>= 2), and an ellipse of that width at each vertex.  Returns 0, 1
// where a vertex lies past +-2^24, 2 where the ellipse box is too large for
// int64.
int lr_polyline_mask(const float* pts, int n, int width, int canvas, uint8_t* out) {
  Canvas c{out, canvas, canvas};
  const int64_t half = width / 2;
  for (int i = 0; i < 2 * n; ++i)
    if (!(std::fabs(pts[i]) < float(kCoordLimit))) return 1;
  if (2 * half + 1 > kBoxLimit) return 2;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    wide_segment(c, int64_t(pts[2 * i]), int64_t(pts[2 * i + 1]), int64_t(pts[2 * j]), int64_t(pts[2 * j + 1]),
                 width);
  }
  const float fh = float(half);
  for (int i = 0; i < n; ++i) {  // the closing vertex is the first: its ellipse once
    const float x = pts[2 * i], y = pts[2 * i + 1];
    ellipse(c, int64_t(x - fh), int64_t(y - fh), int64_t(x + fh), int64_t(y + fh));
  }
  return 0;
}

// masks._ellipse on [h, w] uint8 `out`, the box's corners included: the
// tests' entry (the data path draws its ellipses in lr_polyline_mask).
// Returns 0, 2 where the box is too large for int64, 3 where a corner
// comes before the other (PIL refuses it, the walk would not end).
int lr_ellipse(int64_t x0, int64_t y0, int64_t x1, int64_t y1, int h, int w, uint8_t* out) {
  const int64_t a = x1 - x0, b = y1 - y0;
  if ((a < 0 || b < 0) && (a > 0 || b > 0)) return 3;
  if (a > kBoxLimit || b > kBoxLimit) return 2;
  Canvas c{out, h, w};
  ellipse(c, x0, y0, x1, y1);
  return 0;
}

}  // extern "C"
