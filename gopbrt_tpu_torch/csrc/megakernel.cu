// The bounce megakernel for sphere/disk scenes: the bounce skeleton of
// csrc/bounce.cuh over a brute sweep of tables in shared memory.
//
// Replaces gopbrt_tpu/ops/pallas_megakernel.py::_mega_kernel (lines
// 255-1050; entry path_li_fused -> _li_fused_fwd -> pallas_call at :1201).
// The plain PyTorch twin is gopbrt_tpu_torch/ops/megakernel.py
// ::path_li_plain (accel="brute").
//
// Design.  A resident grid (csrc/lanes.cuh): each block copies the prim,
// shade and light tables (14 KB at the 64-prim, 16-light maximum) to
// shared memory once, and every read is a broadcast (all threads of a warp
// test the same primitive); its lanes then run the skeleton's persistent
// loop, a new path the moment one ends.  The static flags of the TPU
// kernel (full_sph, full_disk, use_cone, any_glass, any_rough) are a bit
// set argument; `types` is subsumed by the per-primitive switch on the tag.
//
// Bound on the H100.  Each path reads 32 bytes (o, d, pixel, sample) and
// writes 12 (L): 23 MB per 1080p band of 524,160 paths, about 7 us at
// 3.35 TB/s.  The work is fp32 arithmetic: per live bounce, one closest-hit
// sweep over all P primitives, a shadow sweep, and the shading math, so the
// kernel is bound by operations (67 TFLOP/s fp32 outside the tensor cores)
// and, beyond that, by divergence between the paths of a warp: the
// persistent loop keeps the lanes busy across paths of different lengths,
// but the lanes of a warp still take different branches within a bounce.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bounce.cuh"

namespace gopbrt {

constexpr int MAX_PRIMS = 64;

// Packed tables, all f32, in the order of ops/megakernel.py TABLE_LAYOUT.
struct Tables {
  float w2o[MAX_PRIMS][12];
  float params[MAX_PRIMS][9];
  float shade[MAX_PRIMS][SH_K];
  float ptype[MAX_PRIMS];
  LightTables lights;
};
constexpr int TABLE_WORDS = (int)(sizeof(Tables) / sizeof(float));
static_assert(TABLE_WORDS == 3585, "Tables must match TABLE_LAYOUT");

// The brute sweep over the tables: the skeleton's scene policy.
struct BruteScene {
  static constexpr bool kTriangles = false;  // the fast path: spheres and disks
  static constexpr bool kPlastic = false;
  static constexpr bool kShadowAtOnce = true;
  const Tables& T;
  int n_prims;
  bool full_sph, full_disk;

  // The nearest prim closer than r.t_max, or (r.shadow) the first found:
  // an any hit closer than t_max, the same answer as a sweep limited to
  // t_max returning a prim.
  GOPBRT_HD float trace(const Ray& r, int& idx) const {
    float t_best = r.t_max;
    idx = -1;
    for (int p = 0; p < n_prims; ++p) {
      const float tp = prim_test((int)T.ptype[p], T.w2o[p], T.params[p], r.ox, r.oy, r.oz,
                                 r.dx, r.dy, r.dz, t_best, full_sph, full_disk);
      if (tp < t_best) {
        t_best = tp;
        idx = p;
        if (r.shadow) break;
      }
    }
    return t_best;
  }

  GOPBRT_HD Winner winner(int idx) const {
    const float* sh = T.shade[idx];
    return Winner{(int)T.ptype[idx], T.w2o[idx], T.params[idx], sh, (int)sh[SH_ALID],
                  sh[SH_SCALE2]};
  }
};

#ifdef __CUDACC__

constexpr int THREADS = 128;

// kCount: the counting instance (run_paths), launched after
// trace.enable()
template <bool kCount>
__global__ void __launch_bounds__(THREADS)
    mega_kernel(const float* __restrict__ tables, Params P, const float* __restrict__ o,
                const float* __restrict__ d, const int* __restrict__ pixel,
                const int* __restrict__ sample, float* __restrict__ L, int* next) {
  __shared__ Tables T;
  float* dst = reinterpret_cast<float*>(&T);
  for (int i = threadIdx.x; i < TABLE_WORDS; i += blockDim.x) dst[i] = tables[i];
  __syncthreads();
  const BruteScene scene{T, P.n_prims, (P.flags & FLAG_FULL_SPH) != 0,
                         (P.flags & FLAG_FULL_DISK) != 0};
  PathState s;  // in registers: in shared memory beside the tables it ran slower
  run_paths<kCount>(scene, T.lights, P, o, d, pixel, sample, L, next, s);
}

#endif  // __CUDACC__

}  // namespace gopbrt

#ifdef __CUDACC__

// Plain C entry point (loaded with ctypes).  next: one int of device
// memory, the path counter, zeroed here on `stream`; count: nonzero for
// the counting instance, which fills the three ints after `next` (paths,
// steps, warp slots), zeroed by the same memset.  Launches on `stream` and
// returns the cudaError_t of the launch; it does not synchronise.
extern "C" int gopbrt_path_li(const float* o, const float* d, const int* pixel,
                              const int* sample, float* L, int n, const float* tables,
                              int table_words, int n_prims, int n_lights,
                              unsigned int seed, float func_int, float world_radius,
                              float cone_w0, float cone_sp, int max_depth, int rr_start,
                              float rr_threshold, int flags, void* stream, int* next,
                              int count) {
  using namespace gopbrt;
  if (table_words != TABLE_WORDS || n_prims < 1 || n_prims > MAX_PRIMS ||
      n_lights < 1 || n_lights > MAX_LIGHTS || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params p{n, n_prims, n_lights, seed, func_int, world_radius, cone_w0, cone_sp,
           max_depth, rr_start, rr_threshold, flags};
  const auto kernel = count ? mega_kernel<true> : mega_kernel<false>;
  int blocks;
  cudaError_t err = persistent_blocks(kernel, THREADS, n, blocks);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(next, 0, (count ? 4 : 1) * sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tables, p, o, d, pixel, sample, L,
                                                        next);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
