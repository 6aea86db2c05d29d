// Native captcha renderer: the host-side synth hot loop in C++.
//
// The port's copy of the JAX package's native/synth.cpp, unchanged below
// this comment, so that both packages render the same pixels for the same
// labels and seed. It re-implements the captcha renderer's visual pipeline
// (data/captcha.py) as a C library: glyph compositing from a pre-rasterized
// atlas, per-character rotation + quad warp, overlap layout, noise dots, a
// noise arc, PIL-SMOOTH 3x3 filtering, and the aspect-preserving resize to
// model height, writing grayscale uint8 rows directly. Python
// (native/synth.py) owns the glyph atlas and label selection; everything
// per image runs here. Built with g++ -O3 -shared -fPIC -ffp-contract=off
// at first use (ops/_build.py:host_library).
//
// Determinism: every image derives its own splitmix/xorshift RNG from
// (seed, image_index), so a batch is reproducible given its seed and
// independent of worker scheduling.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// --- RNG: splitmix64 seeding + xorshift128+ stream --------------------------

struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    auto mix = [](uint64_t& z) {
      z += 0x9e3779b97f4a7c15ull;
      uint64_t x = z;
      x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
      x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
      return x ^ (x >> 31);
    };
    uint64_t z = seed;
    s0 = mix(z);
    s1 = mix(z);
    if (!(s0 | s1)) s1 = 1;
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform double in [0, 1)
  double uni() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double a, double b) { return a + (b - a) * uni(); }
  // inclusive randint like python's random.randint
  int randint(int a, int b) {
    if (b <= a) return a;
    return a + (int)(next() % (uint64_t)(b - a + 1));
  }
};

// luminance of a random "dark" RGB (each channel uniform 0..140) — the
// grayscale the PIL path ends up with after .convert('L')
inline int dark_gray(Rng& rng) {
  int r = rng.randint(0, 140), g = rng.randint(0, 140), b = rng.randint(0, 140);
  return (299 * r + 587 * g + 114 * b) / 1000;
}

inline int light_gray(Rng& rng) {
  int r = rng.randint(220, 255), g = rng.randint(220, 255),
      b = rng.randint(220, 255);
  return (299 * r + 587 * g + 114 * b) / 1000;
}

// --- small grayscale alpha image ---------------------------------------------

struct Img {
  int w = 0, h = 0;
  std::vector<uint8_t> px;  // row-major
  void alloc(int w_, int h_) {
    w = w_;
    h = h_;
    px.assign((size_t)w * h, 0);
  }
  uint8_t at(int x, int y) const {
    if (x < 0 || y < 0 || x >= w || y >= h) return 0;
    return px[(size_t)y * w + x];
  }
};

inline float bilinear(const Img& im, float x, float y) {
  int x0 = (int)std::floor(x), y0 = (int)std::floor(y);
  float fx = x - x0, fy = y - y0;
  float v00 = im.at(x0, y0), v10 = im.at(x0 + 1, y0);
  float v01 = im.at(x0, y0 + 1), v11 = im.at(x0 + 1, y0 + 1);
  return (v00 * (1 - fx) + v10 * fx) * (1 - fy) +
         (v01 * (1 - fx) + v11 * fx) * fy;
}

// rotate by `deg` around the center with expand=True (PIL semantics),
// bilinear sampling of the alpha channel
void rotate_expand(const Img& src, float deg, Img& dst) {
  float th = deg * (float)M_PI / 180.0f;
  float c = std::cos(th), s = std::sin(th);
  int w1 = (int)std::ceil(std::fabs(src.w * c) + std::fabs(src.h * s));
  int h1 = (int)std::ceil(std::fabs(src.w * s) + std::fabs(src.h * c));
  dst.alloc(std::max(w1, 1), std::max(h1, 1));
  float cx0 = src.w * 0.5f, cy0 = src.h * 0.5f;
  float cx1 = dst.w * 0.5f, cy1 = dst.h * 0.5f;
  for (int y = 0; y < dst.h; ++y)
    for (int x = 0; x < dst.w; ++x) {
      // inverse map: rotate output coords by -deg (PIL rotates CCW for
      // positive angles; the inverse is the transpose)
      float dx = x + 0.5f - cx1, dy = y + 0.5f - cy1;
      float sx = c * dx - s * dy + cx0 - 0.5f;
      float sy = s * dx + c * dy + cy0 - 0.5f;
      float v = bilinear(src, sx, sy);
      dst.px[(size_t)y * dst.w + x] = (uint8_t)std::min(255.f, std::max(0.f, v));
    }
}

// PIL Image.transform(QUAD): the 4 given source-image corners (nw, sw,
// se, ne) map to the output rectangle's corners; inner pixels form a
// bilinear blend of the corner coordinates.
void quad_warp(const Img& src, const float q[8], Img& dst) {
  dst.alloc(src.w, src.h);
  float inv_w = dst.w > 1 ? 1.0f / dst.w : 0.f;
  float inv_h = dst.h > 1 ? 1.0f / dst.h : 0.f;
  for (int y = 0; y < dst.h; ++y) {
    float v = (y + 0.5f) * inv_h;
    for (int x = 0; x < dst.w; ++x) {
      float u = (x + 0.5f) * inv_w;
      float sx = q[0] * (1 - u) * (1 - v) + q[2] * (1 - u) * v +
                 q[4] * u * v + q[6] * u * (1 - v);
      float sy = q[1] * (1 - u) * (1 - v) + q[3] * (1 - u) * v +
                 q[5] * u * v + q[7] * u * (1 - v);
      float val = bilinear(src, sx - 0.5f, sy - 0.5f);
      dst.px[(size_t)y * dst.w + x] =
          (uint8_t)std::min(255.f, std::max(0.f, val));
    }
  }
}

// tight crop to the inked bbox (alpha > 0); returns false if empty
bool crop_bbox(Img& im) {
  int x0 = im.w, y0 = im.h, x1 = -1, y1 = -1;
  for (int y = 0; y < im.h; ++y)
    for (int x = 0; x < im.w; ++x)
      if (im.px[(size_t)y * im.w + x]) {
        x0 = std::min(x0, x);
        y0 = std::min(y0, y);
        x1 = std::max(x1, x);
        y1 = std::max(y1, y);
      }
  if (x1 < 0) return false;
  Img out;
  out.alloc(x1 - x0 + 1, y1 - y0 + 1);
  for (int y = 0; y < out.h; ++y)
    std::memcpy(&out.px[(size_t)y * out.w], &im.px[(size_t)(y + y0) * im.w + x0],
                out.w);
  im = std::move(out);
  return true;
}

// one glyph: atlas bitmap -> random rotation -> random quad warp -> crop
void make_glyph(const uint8_t* bmp, int bw, int bh, Rng& rng, Img& out) {
  Img base;
  base.alloc(bw, bh);
  std::memcpy(base.px.data(), bmp, (size_t)bw * bh);
  Img rot;
  rotate_expand(base, (float)rng.uniform(-30.0, 30.0), rot);
  float dx = (float)(rot.w * rng.uniform(0.05, 0.25));
  float dy = (float)(rot.h * rng.uniform(0.05, 0.25));
  float q[8] = {
      (float)rng.uniform(-dx, dx),          (float)rng.uniform(-dy, dy),
      (float)rng.uniform(-dx, dx),          (float)(rot.h + rng.uniform(-dy, dy)),
      (float)(rot.w + rng.uniform(-dx, dx)), (float)(rot.h + rng.uniform(-dy, dy)),
      (float)(rot.w + rng.uniform(-dx, dx)), (float)rng.uniform(-dy, dy)};
  quad_warp(rot, q, out);
  if (!crop_bbox(out)) {  // degenerate warp: fall back to the raw bitmap
    out = std::move(base);
    crop_bbox(out);
  }
}

// --- canvas ops ---------------------------------------------------------------

void composite(std::vector<uint8_t>& canvas, int cw, int ch, const Img& g,
               int gx, int gy, int ink) {
  for (int y = 0; y < g.h; ++y) {
    int cy = gy + y;
    if (cy < 0 || cy >= ch) continue;
    for (int x = 0; x < g.w; ++x) {
      int cx = gx + x;
      if (cx < 0 || cx >= cw) continue;
      int a = g.px[(size_t)y * g.w + x];
      if (!a) continue;
      uint8_t& d = canvas[(size_t)cy * cw + cx];
      d = (uint8_t)((a * ink + (255 - a) * d) / 255);
    }
  }
}

void noise_dots(std::vector<uint8_t>& canvas, int cw, int ch, Rng& rng,
                int number = 30) {
  int ink = dark_gray(rng);
  for (int i = 0; i < number; ++i) {
    int x1 = rng.randint(0, cw - 1), y1 = rng.randint(0, ch - 1);
    // PIL: 3-wide line from (x1,y1) to (x1-1,y1-1) — a ~3x3 blob
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -2; dx <= 1; ++dx) {
        int x = x1 + dx, y = y1 + dy;
        if (x >= 0 && y >= 0 && x < cw && y < ch)
          canvas[(size_t)y * cw + x] = (uint8_t)ink;
      }
  }
}

void noise_arc(std::vector<uint8_t>& canvas, int cw, int ch, Rng& rng) {
  int ink = dark_gray(rng);
  int x1 = rng.randint(0, std::max(1, cw / 5));
  int x2 = rng.randint(cw - cw / 5, cw - 1);
  int y1 = rng.randint(ch / 5, ch - ch / 5);
  int y2 = rng.randint(y1, ch - ch / 5);
  int start = rng.randint(160, 200);
  int end = rng.randint(0, 20);
  if (end < start) end += 360;  // PIL arc wraps clockwise from start to end
  float cx = (x1 + x2) * 0.5f, cy = (y1 + y2) * 0.5f;
  float rx = std::max(1.f, (x2 - x1) * 0.5f), ry = std::max(1.f, (y2 - y1) * 0.5f);
  float step = 0.5f / std::max(rx, ry);
  for (float t = start * (float)M_PI / 180.f; t <= end * (float)M_PI / 180.f;
       t += step) {
    int x = (int)std::lround(cx + rx * std::cos(t));
    int y = (int)std::lround(cy + ry * std::sin(t));
    if (x >= 0 && y >= 0 && x < cw && y < ch)
      canvas[(size_t)y * cw + x] = (uint8_t)ink;
  }
}

// PIL ImageFilter.SMOOTH: 3x3 kernel (1,1,1,1,5,1,1,1,1)/13, border kept
void smooth(std::vector<uint8_t>& canvas, int cw, int ch) {
  std::vector<uint8_t> src = canvas;
  for (int y = 1; y < ch - 1; ++y)
    for (int x = 1; x < cw - 1; ++x) {
      const uint8_t* r0 = &src[(size_t)(y - 1) * cw + x];
      const uint8_t* r1 = &src[(size_t)y * cw + x];
      const uint8_t* r2 = &src[(size_t)(y + 1) * cw + x];
      int v = r0[-1] + r0[0] + r0[1] + r1[-1] + 5 * r1[0] + r1[1] + r2[-1] +
              r2[0] + r2[1];
      canvas[(size_t)y * cw + x] = (uint8_t)(v / 13);
    }
}

// bilinear resize (cv2-style sample positions: src = (dst+0.5)*scale-0.5)
void resize_into(const std::vector<uint8_t>& src, int sw, int sh, uint8_t* dst,
                 int dw, int dh, int dst_stride) {
  float sx_scale = (float)sw / dw, sy_scale = (float)sh / dh;
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * sy_scale - 0.5f;
    int y0 = (int)std::floor(sy);
    float fy = sy - y0;
    int ya = std::min(std::max(y0, 0), sh - 1);
    int yb = std::min(std::max(y0 + 1, 0), sh - 1);
    for (int x = 0; x < dw; ++x) {
      float sx = (x + 0.5f) * sx_scale - 0.5f;
      int x0 = (int)std::floor(sx);
      float fx = sx - x0;
      int xa = std::min(std::max(x0, 0), sw - 1);
      int xb = std::min(std::max(x0 + 1, 0), sw - 1);
      float v = (src[(size_t)ya * sw + xa] * (1 - fx) +
                 src[(size_t)ya * sw + xb] * fx) *
                    (1 - fy) +
                (src[(size_t)yb * sw + xa] * (1 - fx) +
                 src[(size_t)yb * sw + xb] * fx) *
                    fy;
      dst[(size_t)y * dst_stride + x] =
          (uint8_t)std::min(255.f, std::max(0.f, v + 0.5f));
    }
  }
}

}  // namespace

extern "C" {

// Render n_images captchas, resized to out_h, grayscale uint8.
//
// Atlas: per (charset index k, size variant v) bitmap at
//   data + off[k*variants+v], dims aw[..] x ah[..] (alpha, row-major).
// codes/code_off: per-image glyph index lists (CSR layout).
// out: [n_images, out_h, max_w] row-major; rows past each image's width
//   stay zero. out_w: the per-image resized width (<= max_w; wider
//   renders are squeezed to max_w, matching the eval-path clamp).
// min_canvas_w/canvas_h: the renderer's stock canvas (reference: 160x60).
int synth_render(const uint8_t* atlas, const int32_t* off, const int32_t* aw,
                 const int32_t* ah, int32_t variants, const int32_t* codes,
                 const int32_t* code_off, int32_t n_images,
                 int32_t min_canvas_w, int32_t canvas_h, int32_t out_h,
                 uint64_t seed, uint8_t* out, int32_t* out_w, int32_t max_w) {
  if (!atlas || !off || !aw || !ah || !codes || !code_off || !out || !out_w)
    return 1;
  std::memset(out, 0, (size_t)n_images * out_h * max_w);

  for (int i = 0; i < n_images; ++i) {
    Rng rng(seed * 0x100000001b3ull + (uint64_t)i);
    int n_chars = code_off[i + 1] - code_off[i];
    if (n_chars <= 0) return 2;

    // glyphs
    std::vector<Img> glyphs((size_t)n_chars);
    int total_w = 0;
    for (int k = 0; k < n_chars; ++k) {
      int code = codes[code_off[i] + k];
      int v = rng.randint(0, variants - 1);
      int e = code * variants + v;
      make_glyph(atlas + off[e], aw[e], ah[e], rng, glyphs[k]);
      total_w += glyphs[k].w;
    }

    // layout with random overlap (captcha.py:116-141 semantics)
    int overlap = (int)(0.18 * total_w / std::max(n_chars, 1));
    std::vector<int> xs((size_t)n_chars);
    int x = 0;
    for (int k = 0; k < n_chars; ++k) {
      if (k > 0) x += glyphs[k - 1].w - rng.randint(0, std::max(overlap, 1));
      xs[k] = x;
    }
    int needed = xs[n_chars - 1] + glyphs[n_chars - 1].w + 12;
    int cw = std::max((int)min_canvas_w, needed);
    int ch = canvas_h;

    std::vector<uint8_t> canvas((size_t)cw * ch,
                                (uint8_t)light_gray(rng));
    int x0 = std::max(2, (cw - needed) / 2 + 6);
    for (int k = 0; k < n_chars; ++k) {
      const Img& g = glyphs[k];
      int y = g.h < ch ? rng.randint(0, std::max(ch - g.h, 0))
                       : -(g.h - ch) / 2;
      composite(canvas, cw, ch, g, x0 + xs[k], y, dark_gray(rng));
    }
    noise_dots(canvas, cw, ch, rng);
    noise_arc(canvas, cw, ch, rng);
    smooth(canvas, cw, ch);

    // aspect-preserving resize to out_h (squeeze to max_w if over)
    int dw = (int)std::lround((double)cw * out_h / ch);
    dw = std::max(1, std::min(dw, (int)max_w));
    resize_into(canvas, cw, ch, out + (size_t)i * out_h * max_w, dw, out_h,
                max_w);
    out_w[i] = dw;
  }
  return 0;
}

}  // extern "C"
