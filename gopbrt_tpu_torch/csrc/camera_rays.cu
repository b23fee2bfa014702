// Camera rays of one band: one sample for every pixel of a window of
// image rows and columns (a band of whole rows, or a crop window), a
// thread a lane.
//
// Replaces no TPU kernel.  The JAX package's band_rays
// (gopbrt_tpu/models/render.py) is jnp under jit, which XLA fuses into a
// few kernels; in the port the same function, eager PyTorch
// (gopbrt_tpu_torch/models/render.py::band_rays_plain), is ~520 operations
// a band on 524,160-lane int64 tensors (the counter hash in int64 masked
// to 32 bits, every product split into 16-bit halves) and 8 copies of
// Python ints to the card, each a host sync.  This kernel is the whole of
// it in one launch: the counter hash in uint32 (csrc/bounce.cuh, the same
// helpers the bounce kernels use, bit-exact with ops/rng.py), the
// stratified, random or Halton film sample, the lens sample, and
// generate_rays for the perspective and orthographic cameras with the thin
// lens (models/camera.py).
//
// Lanes are in image order: lane i of the window of `cols` columns from
// column col0 and rows from row0 is pixel (row0 + i / cols) * width + col0
// + i % cols (a band: col0 0, cols the width).  The outputs are band_rays_plain's: jitter f32[N,2]
// ((px + u) - px, the film point's round trip), o and d f32[N,3], pixel and
// sample int64[N].
//
// Numbers.  The integers, the film sample and the jitter are bit-equal to
// the plain version.  This file is built with -fmad=false
// (_build.SOURCE_FLAGS), so every product and sum rounds on its own, in
// the plain version's order, as PyTorch's separate operations round them;
// division and sqrtf are IEEE.  The plain version's transforms are einsums,
// a matrix product in BLAS's (cuBLAS's) order, so o and d agree within a
// few ulps, not bit for bit.
//
// Bound on the H100.  The work is four hash chains and two 4x4 transforms
// a lane; the bytes are the 48 a lane written (jitter 8, o 12, d 12, pixel
// 8, sample 8): 25.2 MB for a 1920x273 band, 7.5 us at 3.35 TB/s.  No
// intermediate goes to device memory; the two matrices are 32 floats that
// every thread reads through the read-only cache.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bounce.cuh"

namespace gopbrt {

// samplers (ops/camera_rays.py SAMPLERS) and cameras (models/camera.py CAM_*)
constexpr int SAMPLER_STRATIFIED = 0, SAMPLER_RANDOM = 1, SAMPLER_HALTON = 2;
constexpr int CAM_PERSPECTIVE = 0, CAM_ORTHOGRAPHIC = 1;
// the RNG dimension of the pixel jitter (rng.DIM_CAMERA); the lens takes
// the two after it
constexpr uint32_t DIM_CAMERA = 0;
// nextafter(1, 0) in f32 (geom.ONE_MINUS_EPSILON)
constexpr float ONE_MINUS_EPS = 0.99999994f;
// f32(1/3): the inverse base of radical_inverse(1, .) (sampling.py)
constexpr float INV_BASE3 = (float)(1.0 / 3.0);
// ceil(32 / log2(3)): its digits
constexpr int BASE3_DIGITS = 21;

struct CameraParams {
  int width, row0, col0, cols, n;  // image width, the window's first row,
                                   // first column, columns, lanes
  uint32_t seed;       // the render seed, mod 2^32
  long long sample;    // the band's sample index
  int sampler, nx, ny;  // SAMPLER_*; the stratified grid
  int kind;             // CAM_*
  float lens_radius, focal_distance;
};

GOPBRT_HD uint32_t reverse_bits32(uint32_t x) {
  x = (x << 16) | (x >> 16);
  x = ((x & 0x00FF00FFu) << 8) | ((x & 0xFF00FF00u) >> 8);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x & 0xF0F0F0F0u) >> 4);
  x = ((x & 0x33333333u) << 2) | ((x & 0xCCCCCCCCu) >> 2);
  return ((x & 0x55555555u) << 1) | ((x & 0xAAAAAAAAu) >> 1);
}

// sampling.radical_inverse(1, a): the fixed digit loop in base 3, rev
// wrapping mod 2^32, the inverse powers multiplied in f32
GOPBRT_HD float radical_inverse3(uint32_t a) {
  uint32_t rev = 0;
  float inv_n = 1.0f;
  for (int k = 0; k < BASE3_DIGITS; ++k) {
    if (a > 0) {
      rev = rev * 3u + a % 3u;
      inv_n = inv_n * INV_BASE3;
    }
    a /= 3u;
  }
  return fminf((float)rev * inv_n, ONE_MINUS_EPS);
}

// rows 0-2 of m (row-major f32[4,4]) times (x, y, z): geom.apply_vector
GOPBRT_HD void rows3(const float* m, float x, float y, float z, float& rx, float& ry,
                     float& rz) {
  rx = ld1(m + 0) * x + ld1(m + 1) * y + ld1(m + 2) * z;
  ry = ld1(m + 4) * x + ld1(m + 5) * y + ld1(m + 6) * z;
  rz = ld1(m + 8) * x + ld1(m + 9) * y + ld1(m + 10) * z;
}

// m (x, y, z, 1) without the homogeneous divide: geom.apply_point_affine
GOPBRT_HD void point_affine(const float* m, float x, float y, float z, float& px, float& py,
                            float& pz) {
  rows3(m, x, y, z, px, py, pz);
  px = px + ld1(m + 3);
  py = py + ld1(m + 7);
  pz = pz + ld1(m + 11);
}

// m (x, y, z, 1) with the homogeneous divide: geom.apply_point
GOPBRT_HD void point_projective(const float* m, float x, float y, float z, float& px,
                                float& py, float& pz) {
  point_affine(m, x, y, z, px, py, pz);
  const float w = ld1(m + 12) * x + ld1(m + 13) * y + ld1(m + 14) * z + ld1(m + 15);
  px = px / w;
  py = py / w;
  pz = pz / w;
}

// geom.normalize with eps 0: v / sqrt(max(|v|^2, 1e-30)), 0 where |v|^2 is
// 0
GOPBRT_HD void normalize_plain(float& x, float& y, float& z) {
  const float n2 = x * x + y * y + z * z;
  const float keep = n2 > 0.0f ? 1.0f : 0.0f;
  const float len = sqrtf(fmaxf(n2, 1e-30f));
  x = x * keep / len;
  y = y * keep / len;
  z = z * keep / len;
}

// Lane `lane` of the band: render.band_rays_plain, that is camera_samples
// then camera.generate_rays.
GOPBRT_HD void camera_ray(const CameraParams& P, const float* r2c, const float* c2w,
                          int lane, float* jitter, float* o, float* d, long long* pixel,
                          long long* sample) {
  const int col = P.col0 + lane % P.cols, row = P.row0 + lane / P.cols;
  const long long pix = (long long)row * P.width + col;
  const float px = (float)col;
  const float py = (float)row;
  const uint32_t s = (uint32_t)P.sample;
  const uint32_t h_ps = hash_combine(hash_combine(P.seed, (uint32_t)pix), s);

  // the film sample's offset in the pixel (render.camera_samples)
  float jx, jy;
  if (P.sampler == SAMPLER_HALTON) {
    // Halton (2, 3) over the sample index, rotated by the pixel's stream
    // at sample 0
    const uint32_t h_p0 = hash_combine(hash_combine(P.seed, (uint32_t)pix), 0u);
    const float h0 = fminf((float)reverse_bits32(s) * 2.3283064365386963e-10f, ONE_MINUS_EPS);
    const float h1 = radical_inverse3(s);
    jx = fmodf(h0 + to_unit(hash_combine(h_p0, DIM_CAMERA)), 1.0f);
    jy = fmodf(h1 + to_unit(hash_combine(h_p0, DIM_CAMERA + 1)), 1.0f);
  } else {
    jx = to_unit(hash_combine(h_ps, DIM_CAMERA));
    jy = to_unit(hash_combine(h_ps, DIM_CAMERA + 1));
    if (P.sampler == SAMPLER_STRATIFIED) {
      // rng.stratified_2d: the sample index picks the stratum
      const uint32_t st = s % (uint32_t)(P.nx * P.ny);
      const float sx = (float)(st % (uint32_t)P.nx);
      const float sy = (float)(st / (uint32_t)P.nx);
      jx = fminf((sx + jx) / (float)P.nx, ONE_MINUS_EPS);
      jy = fminf((sy + jy) / (float)P.ny, ONE_MINUS_EPS);
    }
  }
  const float pfx = px + jx;
  const float pfy = py + jy;
  const float ul0 = to_unit(hash_combine(h_ps, DIM_CAMERA + 2));
  const float ul1 = to_unit(hash_combine(h_ps, DIM_CAMERA + 3));

  // camera.generate_rays
  float cx, cy, cz;
  point_projective(r2c, pfx, pfy, 0.0f, cx, cy, cz);
  float ox, oy, oz, dx, dy, dz;
  if (P.kind == CAM_PERSPECTIVE) {
    ox = oy = oz = 0.0f;
    dx = cx;
    dy = cy;
    dz = cz;
    normalize_plain(dx, dy, dz);
  } else {
    ox = cx;
    oy = cy;
    oz = cz;
    dx = dy = 0.0f;
    dz = 1.0f;
  }
  if (P.lens_radius > 0.0f) {
    // thin lens: through the lens point toward the point of focus
    float lx, ly;
    concentric_disk(ul0, ul1, lx, ly);
    lx = lx * P.lens_radius;
    ly = ly * P.lens_radius;
    // PyTorch's scalar / tensor is the tensor's reciprocal times the scalar
    const float ft = (1.0f / fmaxf(dz, 1e-8f)) * P.focal_distance;
    const float fx = ox + dx * ft, fy = oy + dy * ft, fz = oz + dz * ft;
    ox = lx;
    oy = ly;
    oz = 0.0f;
    dx = fx - ox;
    dy = fy - oy;
    dz = fz - oz;
    normalize_plain(dx, dy, dz);
  }
  float wx, wy, wz, vx, vy, vz;
  point_affine(c2w, ox, oy, oz, wx, wy, wz);
  rows3(c2w, dx, dy, dz, vx, vy, vz);
  normalize_plain(vx, vy, vz);

  jitter[2 * lane] = pfx - px;
  jitter[2 * lane + 1] = pfy - py;
  o[3 * lane] = wx;
  o[3 * lane + 1] = wy;
  o[3 * lane + 2] = wz;
  d[3 * lane] = vx;
  d[3 * lane + 1] = vy;
  d[3 * lane + 2] = vz;
  pixel[lane] = pix;
  sample[lane] = P.sample;
}

#ifdef __CUDACC__

constexpr int CAMERA_THREADS = 256;

__global__ void __launch_bounds__(CAMERA_THREADS)
    camera_rays_kernel(CameraParams P, const float* __restrict__ r2c,
                       const float* __restrict__ c2w, float* __restrict__ jitter,
                       float* __restrict__ o, float* __restrict__ d,
                       long long* __restrict__ pixel, long long* __restrict__ sample) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < P.n) camera_ray(P, r2c, c2w, lane, jitter, o, d, pixel, sample);
}

#endif  // __CUDACC__

}  // namespace gopbrt

#ifdef __CUDACC__

// Plain C entry point (loaded with ctypes).  r2c, c2w: the camera's
// row-major f32[4,4] raster-to-camera and camera-to-world matrices on the
// card.  Launches n = n_rows * cols lanes (the window's columns [col0,
// col0 + cols)) on `stream` and returns the cudaError_t of the launch; it
// does not synchronise.
extern "C" int gopbrt_camera_rays(const float* r2c, const float* c2w, int width, int row0,
                                  int col0, int cols, int n, unsigned int seed, long long sample, int sampler,
                                  int nx, int ny, int kind, float lens_radius,
                                  float focal_distance, float* jitter, float* o, float* d,
                                  long long* pixel, long long* sample_out, void* stream) {
  using namespace gopbrt;
  if (width < 1 || row0 < 0 || col0 < 0 || cols < 1 || col0 + cols > width || n < 0 ||
      nx < 1 || ny < 1 || sampler < SAMPLER_STRATIFIED || sampler > SAMPLER_HALTON ||
      (kind != CAM_PERSPECTIVE && kind != CAM_ORTHOGRAPHIC))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const CameraParams p{width, row0, col0, cols, n, seed, sample, sampler, nx, ny, kind, lens_radius,
                       focal_distance};
  const int blocks = (n + CAMERA_THREADS - 1) / CAMERA_THREADS;
  camera_rays_kernel<<<blocks, CAMERA_THREADS, 0, (cudaStream_t)stream>>>(
      p, r2c, c2w, jitter, o, d, pixel, sample_out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
