// Host-side image preprocessing: PIL-bit-parity separable resampling.
//
// The retrieval stage's CLIP preprocess must match PIL's bicubic resize
// bit-for-bit or top-100 indices drift (SURVEY.md §7 hard part 3). PIL is
// single-threaded per image; corpus embedding walks 10^5+ images, so this
// reimplements Pillow's 8-bit resample algorithm (fixed-point separable
// convolution, horizontal then vertical pass with uint8 intermediate
// rounding) with a thread pool across the batch.
//
// Parity is enforced by tests against PIL on random images/sizes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow PRECISION_BITS

inline uint8_t clip8(int64_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

double bicubic_filter(double x) {
  // Pillow's bicubic (Catmull-Rom family, a = -0.5), support 2.0
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

double bilinear_filter(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;  // (xmin, xcount) per output pixel
  std::vector<int32_t> kk;  // ksize coefficients per output pixel
};

// Pillow precompute_coeffs for one axis.
Coeffs precompute(int in_size, int out_size, double (*filter)(double),
                  double support_base) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = support_base * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(2 * out_size);
  std::vector<double> prekk(c.ksize);
  c.kk.resize(static_cast<size_t>(c.ksize) * out_size);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      const double w = filter((x + xmin - center + 0.5) * ss);
      prekk[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) prekk[x] /= ww;
    }
    int32_t* kk = c.kk.data() + static_cast<size_t>(xx) * c.ksize;
    for (int x = 0; x < xmax; ++x) {
      // Pillow rounds half away from zero into fixed point
      if (prekk[x] < 0) {
        kk[x] = static_cast<int32_t>(-0.5 + prekk[x]
                                     * (1 << kPrecisionBits));
      } else {
        kk[x] = static_cast<int32_t>(0.5 + prekk[x]
                                     * (1 << kPrecisionBits));
      }
    }
    for (int x = xmax; x < c.ksize; ++x) kk[x] = 0;
    c.bounds[xx * 2 + 0] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

// horizontal pass: (h, in_w, 3) -> (h, out_w, 3), uint8 intermediates
void resample_horizontal(const uint8_t* src, uint8_t* dst, int h, int in_w,
                         int out_w, const Coeffs& c) {
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = src + static_cast<size_t>(yy) * in_w * 3;
    uint8_t* out = dst + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = c.bounds[xx * 2 + 0];
      const int xcount = c.bounds[xx * 2 + 1];
      const int32_t* kk = c.kk.data() + static_cast<size_t>(xx) * c.ksize;
      for (int ch = 0; ch < 3; ++ch) {
        int64_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xcount; ++x) {
          ss += static_cast<int64_t>(row[(xmin + x) * 3 + ch]) * kk[x];
        }
        out[xx * 3 + ch] = clip8(ss);
      }
    }
  }
}

// vertical pass: (in_h, w, 3) -> (out_h, w, 3)
void resample_vertical(const uint8_t* src, uint8_t* dst, int in_h, int w,
                       int out_h, const Coeffs& c) {
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = c.bounds[yy * 2 + 0];
    const int ycount = c.bounds[yy * 2 + 1];
    const int32_t* kk = c.kk.data() + static_cast<size_t>(yy) * c.ksize;
    uint8_t* out = dst + static_cast<size_t>(yy) * w * 3;
    for (int xx = 0; xx < w * 3; ++xx) {
      int64_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ycount; ++y) {
        ss += static_cast<int64_t>(
                  src[static_cast<size_t>(ymin + y) * w * 3 + xx]) * kk[y];
      }
      out[xx] = clip8(ss);
    }
  }
}

void resize_one(const uint8_t* src, uint8_t* dst, int in_h, int in_w,
                int out_h, int out_w, int filter_id) {
  double (*filter)(double) = filter_id == 1 ? bilinear_filter
                                            : bicubic_filter;
  const double support = filter_id == 1 ? 1.0 : 2.0;
  // Pillow: horizontal pass first, then vertical, uint8 intermediate
  std::vector<uint8_t> tmp;
  const uint8_t* h_src = src;
  int cur_h = in_h;
  if (out_w != in_w) {
    Coeffs ch = precompute(in_w, out_w, filter, support);
    tmp.resize(static_cast<size_t>(in_h) * out_w * 3);
    resample_horizontal(src, tmp.data(), in_h, in_w, out_w, ch);
    h_src = tmp.data();
  }
  if (out_h != in_h) {
    Coeffs cv = precompute(in_h, out_h, filter, support);
    resample_vertical(h_src, dst, cur_h, out_w, out_h, cv);
  } else {
    std::memcpy(dst, h_src, static_cast<size_t>(out_h) * out_w * 3);
  }
}

}  // namespace

extern "C" {

// Single image: src (in_h, in_w, 3) uint8 -> dst (out_h, out_w, 3).
// filter_id: 0 = bicubic, 1 = bilinear.
void drtpu_resize(const uint8_t* src, uint8_t* dst, int64_t in_h,
                  int64_t in_w, int64_t out_h, int64_t out_w,
                  int32_t filter_id) {
  resize_one(src, dst, static_cast<int>(in_h), static_cast<int>(in_w),
             static_cast<int>(out_h), static_cast<int>(out_w), filter_id);
}

// Batch with uniform input/output sizes, threaded across images.
void drtpu_resize_batch(const uint8_t* src, uint8_t* dst, int64_t n,
                        int64_t in_h, int64_t in_w, int64_t out_h,
                        int64_t out_w, int32_t filter_id,
                        int32_t n_threads) {
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * 3;
  const size_t out_stride = static_cast<size_t>(out_h) * out_w * 3;
  auto work = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      resize_one(src + i * in_stride, dst + i * out_stride,
                 static_cast<int>(in_h), static_cast<int>(in_w),
                 static_cast<int>(out_h), static_cast<int>(out_w),
                 filter_id);
    }
  };
  if (n_threads <= 1 || n <= 1) {
    work(0, n);
    return;
  }
  const int64_t nt = std::min<int64_t>(n_threads, n);
  const int64_t per = (n + nt - 1) / nt;
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t begin = t * per;
    const int64_t end = std::min(begin + per, n);
    if (begin >= end) break;
    threads.emplace_back(work, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
