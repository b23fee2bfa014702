// The row splat of one band and its fold into the film: one sample for
// every pixel of a band of image rows, each spread over the film pixels
// its reconstruction filter reaches, a thread a film pixel.
//
// Replaces no TPU kernel.  The JAX package's splat (add_samples_rows and
// splat_band_halo, gopbrt_tpu/models/film.py) is jnp under jit, which XLA
// fuses; in the port the same function in eager PyTorch
// (gopbrt_tpu_torch/models/film.py::add_samples_rows_plain) is ~115
// operations a band for the box filter of radius 1 (12 a tap of its 3x3,
// the accumulators, the row mask, the fold), and launching them is what a
// frame's splat costs.  This kernel is the whole of it in one launch.
//
// A gather, no atomics.  For a band of `rows` rows from image row row0 and
// a filter of radius r, rr = ceil(r), the threads cover the film rows
// [max(0, row0 - rr), min(H, row0 + rows + rr)) and every column.  Film
// pixel (y, x) sums the taps of the samples that reach it, sample (s, sx)
// = (y - row0 - oy, x - ox) of the band for oy, ox in [-rr, rr]: oy outer,
// ox inner, both from -rr, as splat_band_halo adds its shifted taps; the
// sums start at 0; then the film adds them, rgb and weight.  A sample on a
// row at or past the image's last row weighs 0 and its 0 * L is still
// added (a NaN or an Inf in L spreads as in the plain version); a source
// column outside [0, W) has no sample and adds nothing, as the plain
// version's cut padding columns.
//
// Numbers.  The filters are ops/filters.evaluate's expressions in its order,
// with its constants as PyTorch rounds them to f32 (splat_params computes
// them in double, as Python does, then rounds).  This file is built with
// -fmad=false (_build.SOURCE_FLAGS), so each tap's fw * L and each sum
// round on their own, as PyTorch's separate operations round them: with the
// box filter the film is bit-equal to the plain version's.  The other
// filters agree within a few ulps (expf, sinf and the division by the
// radius are the card's, not PyTorch's).
//
// Bound on the H100: bytes.  A 1920x273 band reads its jitter and L once
// (20 B a sample) and reads and writes the film rows it reaches (16 B a
// pixel each way): about 27 MB for the box filter of radius 1, 8 us at
// 3.35 TB/s.  Tiles of 32 x 8 threads: a warp reads 32 neighbouring
// samples, and the (2rr+1)^2 taps of a tile hit in L1.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "prim_test.cuh"

namespace gopbrt {

// filter kinds (ops/filters.py FILTER_*)
constexpr int FILTER_BOX = 0, FILTER_TRIANGLE = 1, FILTER_GAUSSIAN = 2, FILTER_MITCHELL = 3,
              FILTER_LANCZOS = 4;

// A filter's constants as ops/filters.evaluate's f32 operations see them.
struct SplatFilter {
  int rr;                // ceil(radius): the taps' reach in pixels
  float r;               // the radius
  float neg_alpha, expv;  // Gaussian: -alpha, exp(-alpha r^2)
  float p1[3];           // Mitchell, |2x| < 1: the x^3, x^2 and 1 coefficients
  float p2[4];           // Mitchell, |2x| < 2: the x^3, x^2, x and 1 coefficients
  float sixth;           // 1/6
  float tau, pi, tiny, small;  // Lanczos: tau; sinc's pi, 1e-20, 1e-5
};

struct SplatParams {
  int height, width;  // the film
  int row0, rows;     // the band: its first image row, its rows
  int y_lo, y_hi;     // the film rows it reaches
  SplatFilter f;
};

// The constants of filters.Filter(kind, radius, alpha, b, c), computed in
// double as Python computes them, then rounded to f32 as PyTorch rounds a
// Python scalar against an f32 tensor; and the film rows the band reaches.
// False on arguments the kernel does not take.
inline bool splat_params(int height, int width, int row0, int rows, int kind, double radius,
                         double alpha, double b, double c, SplatParams& P) {
  if (height < 1 || width < 1 || rows < 0 || kind < FILTER_BOX || kind > FILTER_LANCZOS ||
      !(radius >= 0.0) || radius > 64.0)
    return false;
  SplatFilter& f = P.f;
  f.rr = (int)std::ceil(radius);
  f.r = (float)radius;
  f.neg_alpha = (float)(-alpha);
  f.expv = (float)std::exp(-alpha * radius * radius);
  f.p1[0] = (float)(12 - 9 * b - 6 * c);
  f.p1[1] = (float)(-18 + 12 * b + 6 * c);
  f.p1[2] = (float)(6 - 2 * b);
  f.p2[0] = (float)(-b - 6 * c);
  f.p2[1] = (float)(6 * b + 30 * c);
  f.p2[2] = (float)(-12 * b - 48 * c);
  f.p2[3] = (float)(8 * b + 24 * c);
  f.sixth = (float)(1.0 / 6.0);
  f.tau = (float)alpha;
  f.pi = (float)3.141592653589793;
  f.tiny = (float)1e-20;
  f.small = (float)1e-5;
  P.height = height;
  P.width = width;
  P.row0 = row0;
  P.rows = rows;
  P.y_lo = std::max(0, row0 - f.rr);
  P.y_hi = std::min(height, row0 + rows + f.rr);
  return true;
}

// torch.clamp(v, min=0): NaN stays NaN
GOPBRT_HD float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

// filters._mitchell_1d
GOPBRT_HD float mitchell_1d(const SplatFilter& f, float x) {
  x = fabsf(2.0f * x);
  const float x2 = x * x, x3 = x * x * x;
  const float p1 = (f.p1[0] * x3 + f.p1[1] * x2 + f.p1[2]) * f.sixth;
  const float p2 = (f.p2[0] * x3 + f.p2[1] * x2 + f.p2[2] * x + f.p2[3]) * f.sixth;
  return x < 1.0f ? p1 : (x < 2.0f ? p2 : 0.0f);
}

// filters._sinc
GOPBRT_HD float sinc(const SplatFilter& f, float x) {
  x = fabsf(x);
  return x < f.small ? 1.0f : sinf(f.pi * x) / (f.pi * x + f.tiny);
}

// filters.evaluate: the weight at offset (dx, dy) from the sample, 0
// outside the support
template <int KIND>
GOPBRT_HD float filter_weight(const SplatFilter& f, float dx, float dy) {
  if (!(fabsf(dx) <= f.r && fabsf(dy) <= f.r)) return 0.0f;
  if (KIND == FILTER_BOX) return 1.0f;
  if (KIND == FILTER_TRIANGLE) return clamp0(f.r - fabsf(dx)) * clamp0(f.r - fabsf(dy));
  if (KIND == FILTER_GAUSSIAN)
    return clamp0(expf(f.neg_alpha * dx * dx) - f.expv) *
           clamp0(expf(f.neg_alpha * dy * dy) - f.expv);
  if (KIND == FILTER_MITCHELL) return mitchell_1d(f, dx / f.r) * mitchell_1d(f, dy / f.r);
  return (sinc(f, dx) * sinc(f, dx / f.tau)) * (sinc(f, dy) * sinc(f, dy / f.tau));
}

// Film pixel (y, x), y in [y_lo, y_hi): the taps of the band's samples
// that reach it, summed in splat_band_halo's order, folded into the film.
// jitter f32[rows, W, 2], L f32[rows, W, 3]; rgb f32[H, W, 3], wsum
// f32[H, W].
template <int KIND>
GOPBRT_HD void splat_pixel(const SplatParams& P, const float* jitter, const float* L,
                           float* rgb, float* wsum, int y, int x) {
  const int rr = P.f.rr;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aw = 0.0f;
  for (int oy = -rr; oy <= rr; ++oy) {
    const int s = y - P.row0 - oy;
    if (s < 0 || s >= P.rows) continue;
    const bool on_image = P.row0 + s < P.height;
    const float cy = (float)oy + 0.5f;
    for (int ox = -rr; ox <= rr; ++ox) {
      const int sx = x - ox;
      if (sx < 0 || sx >= P.width) continue;
      const long long i = (long long)s * P.width + sx;
      float fw = filter_weight<KIND>(P.f, (float)ox + 0.5f - ld1(jitter + 2 * i),
                                     cy - ld1(jitter + 2 * i + 1));
      if (!on_image) fw = 0.0f;
      ar = ar + fw * ld1(L + 3 * i);
      ag = ag + fw * ld1(L + 3 * i + 1);
      ab = ab + fw * ld1(L + 3 * i + 2);
      aw = aw + fw;
    }
  }
  const long long p = (long long)y * P.width + x;
  rgb[3 * p] = rgb[3 * p] + ar;
  rgb[3 * p + 1] = rgb[3 * p + 1] + ag;
  rgb[3 * p + 2] = rgb[3 * p + 2] + ab;
  wsum[p] = wsum[p] + aw;
}

#ifdef __CUDACC__

constexpr int SPLAT_TX = 32, SPLAT_TY = 8;

template <int KIND>
__global__ void __launch_bounds__(SPLAT_TX* SPLAT_TY)
    splat_rows_kernel(SplatParams P, const float* __restrict__ jitter,
                      const float* __restrict__ L, float* __restrict__ rgb,
                      float* __restrict__ wsum) {
  const int x = blockIdx.x * SPLAT_TX + threadIdx.x;
  const int y = P.y_lo + (int)blockIdx.y * SPLAT_TY + (int)threadIdx.y;
  if (x < P.width && y < P.y_hi) splat_pixel<KIND>(P, jitter, L, rgb, wsum, y, x);
}

#endif  // __CUDACC__

}  // namespace gopbrt

#ifdef __CUDACC__

// Plain C entry point (loaded with ctypes).  rgb f32[H,W,3] and wsum
// f32[H,W]: the film, on the card, updated in place; jitter f32[rows,W,2]
// and L f32[rows,W,3]: the band from image row row0; the filter as
// filters.Filter holds it (alpha is the Gaussian's falloff or Lanczos'
// tau).  Launches one grid over the film rows the band reaches on `stream`
// (none where it reaches none) and returns the cudaError_t of the launch;
// it does not synchronise.
extern "C" int gopbrt_splat_rows(float* rgb, float* wsum, const float* jitter, const float* L,
                                 int height, int width, int row0, int rows, int kind,
                                 double radius, double alpha, double b, double c,
                                 void* stream) {
  using namespace gopbrt;
  SplatParams p;
  if (!splat_params(height, width, row0, rows, kind, radius, alpha, b, c, p))
    return (int)cudaErrorInvalidValue;
  if (p.y_hi <= p.y_lo) return 0;
  const dim3 block(SPLAT_TX, SPLAT_TY);
  const dim3 grid((width + SPLAT_TX - 1) / SPLAT_TX, (p.y_hi - p.y_lo + SPLAT_TY - 1) / SPLAT_TY);
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case FILTER_BOX:
      splat_rows_kernel<FILTER_BOX><<<grid, block, 0, s>>>(p, jitter, L, rgb, wsum);
      break;
    case FILTER_TRIANGLE:
      splat_rows_kernel<FILTER_TRIANGLE><<<grid, block, 0, s>>>(p, jitter, L, rgb, wsum);
      break;
    case FILTER_GAUSSIAN:
      splat_rows_kernel<FILTER_GAUSSIAN><<<grid, block, 0, s>>>(p, jitter, L, rgb, wsum);
      break;
    case FILTER_MITCHELL:
      splat_rows_kernel<FILTER_MITCHELL><<<grid, block, 0, s>>>(p, jitter, L, rgb, wsum);
      break;
    default:
      splat_rows_kernel<FILTER_LANCZOS><<<grid, block, 0, s>>>(p, jitter, L, rgb, wsum);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
