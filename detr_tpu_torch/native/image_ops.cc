// Host image kernels of the training input pipeline (OpenMP).
//
// The port's copy of the JAX package's native/image_ops.cc: the same
// functions, the same float math and the same extern "C" signatures, so the
// two packages give the same bytes on one host.  Each kernel is the one-pass
// form of a numpy/PIL operation in detr_tpu_torch/data/transforms.py, which
// keeps the numpy/PIL forms as the path taken when no C++ toolchain builds
// this file: the HSV hue rotation, the affine-gray photometric passes
// (brightness, contrast, saturation), the gray mean, the antialiased uint8
// resize and the uint8 ImageNet normalisation.
//
// Built lazily by detr_tpu_torch/data/_native.py (g++ -O3 -fopenmp
// -march=native, then portable fallbacks) into build/native/.

#include <cmath>
#include <cstdint>

extern "C" {

// In-place hue rotation on interleaved (n_px, 3) float32 RGB in [0, 255].
// delta is a fraction of the full hue circle.  Matches
// transforms.adjust_hue's float math (HSV roundtrip, sextant gather).
void hue_rotate_f32(float* img, long n_px, float delta) {
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n_px; ++i) {
    float r = img[3 * i] * (1.0f / 255.0f);
    float g = img[3 * i + 1] * (1.0f / 255.0f);
    float b = img[3 * i + 2] * (1.0f / 255.0f);
    float mx = r > g ? (r > b ? r : b) : (g > b ? g : b);
    float mn = r < g ? (r < b ? r : b) : (g < b ? g : b);
    float diff = mx - mn + 1e-12f;
    float h;
    if (mx == r) {
      h = fmodf((g - b) / diff, 6.0f);
      if (h < 0.0f) h += 6.0f;  // python % semantics
    } else if (mx == g) {
      h = (b - r) / diff + 2.0f;
    } else {
      h = (r - g) / diff + 4.0f;
    }
    h *= (1.0f / 6.0f);
    float s = mx > 0.0f ? diff / (mx + 1e-12f) : 0.0f;
    float v = mx;
    h = fmodf(h + delta, 1.0f);
    if (h < 0.0f) h += 1.0f;
    float h6 = h * 6.0f;
    float fi = floorf(h6);
    float f = h6 - fi;
    float p = v * (1.0f - s);
    float q = v * (1.0f - f * s);
    float t = v * (1.0f - (1.0f - f) * s);
    int sex = ((int)fi) % 6;
    float ro, go, bo;
    switch (sex) {
      case 0: ro = v; go = t; bo = p; break;
      case 1: ro = q; go = v; bo = p; break;
      case 2: ro = p; go = v; bo = t; break;
      case 3: ro = p; go = q; bo = v; break;
      case 4: ro = t; go = p; bo = v; break;
      default: ro = v; go = p; bo = q; break;
    }
    auto clip = [](float x) {
      x *= 255.0f;
      return x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
    };
    img[3 * i] = clip(ro);
    img[3 * i + 1] = clip(go);
    img[3 * i + 2] = clip(bo);
  }
}

// Antialiased separable bilinear resize, uint8 HWC3 -> uint8 HWC3.
//
// The triangle-filter algorithm of PIL BILINEAR / torchvision
// antialias=True: filter support scales with the
// downscale ratio, coefficients normalized per output pixel, horizontal
// pass into a float32 buffer then vertical pass with round-half-up.
// This kernel is the same math in float32 accumulation instead of PIL's
// int16 fixed point: the two differ by at most 1 uint8 level.
//
// coeff tables are built per axis: for output index o, the input window is
// [bounds[2o], bounds[2o]+bounds[2o+1]) with weights at coef + o*kmax.

namespace {

// Returns kmax (max taps per output pixel); fills bounds (2*out_n ints)
// and coef (out_n * kmax floats, zero-padded).
int precompute_coeffs(int in_n, int out_n, int** bounds_out,
                      float** coef_out) {
  const double scale = static_cast<double>(in_n) / out_n;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // bilinear support = 1
  const int kmax = static_cast<int>(support) * 2 + 2;
  int* bounds = new int[2 * out_n];
  float* coef = new float[static_cast<long>(out_n) * kmax]();
  for (int o = 0; o < out_n; ++o) {
    const double center = (o + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_n) xmax = in_n;
    double total = 0.0;
    float* k = coef + static_cast<long>(o) * kmax;
    for (int x = xmin; x < xmax; ++x) {
      const double d = (x + 0.5 - center) / filterscale;
      const double wgt = d < 0.0 ? (d > -1.0 ? 1.0 + d : 0.0)
                                 : (d < 1.0 ? 1.0 - d : 0.0);
      k[x - xmin] = static_cast<float>(wgt);
      total += wgt;
    }
    if (total > 0.0) {
      for (int x = 0; x < xmax - xmin; ++x)
        k[x] = static_cast<float>(k[x] / total);
    }
    bounds[2 * o] = xmin;
    bounds[2 * o + 1] = xmax - xmin;
  }
  *bounds_out = bounds;
  *coef_out = coef;
  return kmax;
}

}  // namespace

void resize_bilinear_u8(const uint8_t* src, int h, int w, uint8_t* dst,
                        int nh, int nw) {
  int *xb, *yb;
  float *xc, *yc;
  const int xkmax = precompute_coeffs(w, nw, &xb, &xc);
  const int ykmax = precompute_coeffs(h, nh, &yb, &yc);

  // horizontal pass: (h, w, 3) u8 -> (h, nw, 3) f32
  float* tmp = new float[static_cast<long>(h) * nw * 3];
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<long>(y) * w * 3;
    float* orow = tmp + static_cast<long>(y) * nw * 3;
    for (int o = 0; o < nw; ++o) {
      const int x0 = xb[2 * o], n = xb[2 * o + 1];
      const float* k = xc + static_cast<long>(o) * xkmax;
      float r = 0.0f, g = 0.0f, b = 0.0f;
      for (int i = 0; i < n; ++i) {
        const uint8_t* p = row + static_cast<long>(x0 + i) * 3;
        r += k[i] * p[0];
        g += k[i] * p[1];
        b += k[i] * p[2];
      }
      orow[3 * o] = r;
      orow[3 * o + 1] = g;
      orow[3 * o + 2] = b;
    }
  }

  // vertical pass: (h, nw, 3) f32 -> (nh, nw, 3) u8, round half up
#pragma omp parallel for schedule(static)
  for (int o = 0; o < nh; ++o) {
    const int y0 = yb[2 * o], n = yb[2 * o + 1];
    const float* k = yc + static_cast<long>(o) * ykmax;
    uint8_t* orow = dst + static_cast<long>(o) * nw * 3;
    for (int x = 0; x < nw * 3; ++x) {
      float acc = 0.0f;
      for (int i = 0; i < n; ++i)
        acc += k[i] * tmp[static_cast<long>(y0 + i) * nw * 3 + x];
      const float v = acc + 0.5f;
      orow[x] = v <= 0.0f ? 0 : (v >= 255.0f ? 255 : static_cast<uint8_t>(v));
    }
  }

  delete[] tmp;
  delete[] xb;
  delete[] yb;
  delete[] xc;
  delete[] yc;
}

// out = u8 * scale[c] - bias[c]   (ImageNet normalization, fused)
void normalize_u8_f32(const uint8_t* img, float* out, long n_px,
                      const float* scale, const float* bias) {
  const float s0 = scale[0], s1 = scale[1], s2 = scale[2];
  const float b0 = bias[0], b1 = bias[1], b2 = bias[2];
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n_px; ++i) {
    out[3 * i] = img[3 * i] * s0 - b0;
    out[3 * i + 1] = img[3 * i + 1] * s1 - b1;
    out[3 * i + 2] = img[3 * i + 2] * s2 - b2;
  }
}

// Photometric-distort building block: one pass computing
//   out = clip(alpha * img + beta * gray(img) + gamma, 0, 255)
// on interleaved float32 HWC3.  Covers the reference's brightness
// (alpha=f), saturation (alpha=f, beta=1-f), and contrast
// (alpha=f, gamma=(1-f)*mean_gray) adjustments in a single fused pass
// each — the numpy forms are 3-4 full-image passes per op (grayscale
// matmul, blend broadcast, clip).  ITU-R 601 gray, same constants as
// transforms._grayscale.
void affine_gray_f32(const float* src, float* dst, long n_px, float alpha,
                     float beta, float gamma) {
  auto clip = [](float x) {
    return x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
  };
  if (beta == 0.0f) {
    // brightness/contrast call sites: skip the gray dot product entirely
    const long n = n_px * 3;
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) dst[i] = clip(alpha * src[i] + gamma);
    return;
  }
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n_px; ++i) {
    const float r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
    const float gray = 0.299f * r + 0.587f * g + 0.114f * b;
    const float base = beta * gray + gamma;
    dst[3 * i] = clip(alpha * r + base);
    dst[3 * i + 1] = clip(alpha * g + base);
    dst[3 * i + 2] = clip(alpha * b + base);
  }
}

// Mean of ITU-R 601 gray over a float32 HWC3 image (contrast's blend
// target).  double accumulator: numpy's pairwise float32 mean and a naive
// float32 sum diverge at megapixel scale.
double gray_mean_f32(const float* src, long n_px) {
  double acc = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : acc)
  for (long i = 0; i < n_px; ++i) {
    acc += 0.299f * src[3 * i] + 0.587f * src[3 * i + 1] +
           0.114f * src[3 * i + 2];
  }
  return n_px > 0 ? acc / n_px : 0.0;
}

}  // extern "C"
