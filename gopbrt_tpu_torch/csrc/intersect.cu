// Brute-force ray intersection over the primitive table: closest hit and
// any hit, one thread per ray.
//
// Replaces gopbrt_tpu/ops/pallas_intersect.py::_intersect_kernel (:172,
// pallas_call :247) and ::_intersect_any_kernel (:276, pallas_call :350).
// The plain PyTorch twins are gopbrt_tpu_torch/ops/brute_intersect.py
// ::intersect_brute and ::intersect_p_brute; the wrappers that launch
// these kernels are intersect_brute_fused and intersect_p_brute_fused
// there.
//
// What bounds it on the H100: fp32 operations.  A ray costs 36 bytes in and
// 9 (closest) or 1 (any) out, while each primitive test is 40-60 flops, so
// at the 24 prims of the demo a ray does ~1,400 flops for ~45 bytes.
//
// Design.  On the TPU a block of 8x1024 rays runs every primitive's test on
// every lane, with the tables in SMEM.  Here one thread holds one ray in
// registers and walks the table in order; the table is staged through
// shared memory in chunks of CHUNK rows, so there is no cap on its size.
// All threads of a warp test the same primitive, so the shape branch in
// prim_test does not diverge.  The closest hit keeps the first primitive
// on a tie (strict tp < t_best, pallas_intersect.py:189) and on a miss
// returns t_max and primitive 0 (:272-273).  The any hit stops a thread at
// its own first occluder, which gives the same boolean as the full sweep;
// a block leaves the table early once all its threads have stopped.  No
// lane is skipped: a lane with a tiny t_max (the integrators' marker for a
// dead lane) runs the same tests as the plain version, whose answer it
// must give.
#include <cuda_runtime.h>

#include "prim_test.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 256;  // primitives per shared-memory chunk (22.5 KB)
constexpr int FLAG_FULL_SPH = 1;
constexpr int FLAG_FULL_DISK = 2;

struct Chunk {
  int ptype[CHUNK];
  float w2o[CHUNK * 12];
  float params[CHUNK * 9];
};

// Stage rows [base, base + cnt) of the table into shared memory.
__device__ void load_chunk(Chunk& sh, const int* __restrict__ ptype,
                           const float* __restrict__ w2o,
                           const float* __restrict__ params, int base, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) sh.ptype[k] = ptype[base + k];
  for (int k = threadIdx.x; k < cnt * 12; k += blockDim.x)
    sh.w2o[k] = w2o[base * 12 + k];
  for (int k = threadIdx.x; k < cnt * 9; k += blockDim.x)
    sh.params[k] = params[base * 9 + k];
}

__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, int n,
                   const int* __restrict__ ptype, const float* __restrict__ w2o,
                   const float* __restrict__ params, int n_prims, int flags,
                   bool* __restrict__ hit_out, float* __restrict__ t_out,
                   int* __restrict__ idx_out) {
  __shared__ Chunk sh;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const bool full_sph = flags & FLAG_FULL_SPH;
  const bool full_disk = flags & FLAG_FULL_DISK;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f, t_best = 0.f;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    t_best = t_max[i];
  }
  int idx = -1;
  for (int base = 0; base < n_prims; base += CHUNK) {
    const int cnt = min(CHUNK, n_prims - base);
    __syncthreads();  // the previous chunk is no longer read
    load_chunk(sh, ptype, w2o, params, base, cnt);
    __syncthreads();
    if (!live) continue;
    for (int p = 0; p < cnt; ++p) {
      const float tp = gopbrt::prim_test(sh.ptype[p], &sh.w2o[12 * p],
                                         &sh.params[9 * p], ox, oy, oz, dx, dy,
                                         dz, t_best, full_sph, full_disk);
      if (tp < t_best) {
        t_best = tp;
        idx = base + p;
      }
    }
  }
  if (live) {
    hit_out[i] = idx >= 0;
    t_out[i] = t_best;  // t_max itself where nothing is hit
    idx_out[i] = idx < 0 ? 0 : idx;
  }
}

__global__ void __launch_bounds__(THREADS)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int n,
               const int* __restrict__ ptype, const float* __restrict__ w2o,
               const float* __restrict__ params, int n_prims, int flags,
               bool* __restrict__ occ_out) {
  __shared__ Chunk sh;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const bool full_sph = flags & FLAG_FULL_SPH;
  const bool full_disk = flags & FLAG_FULL_DISK;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f, t_lim = 0.f;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    t_lim = t_max[i];
  }
  bool occluded = false;
  bool done = !live;
  for (int base = 0; base < n_prims; base += CHUNK) {
    // a barrier too: the previous chunk is no longer read
    if (__syncthreads_and(done)) break;
    const int cnt = min(CHUNK, n_prims - base);
    load_chunk(sh, ptype, w2o, params, base, cnt);
    __syncthreads();
    for (int p = 0; p < cnt && !done; ++p) {
      const float tp = gopbrt::prim_test(sh.ptype[p], &sh.w2o[12 * p],
                                         &sh.params[9 * p], ox, oy, oz, dx, dy,
                                         dz, t_lim, full_sph, full_disk);
      if (tp < t_lim) occluded = done = true;
    }
  }
  if (live) occ_out[i] = occluded;
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// o, d: f32[n, 3] (AoS); t_max: f32[n]; ptype: i32[P]; w2o: f32[P, 12]
// (rows 0-2 of world->object); params: f32[P, 9].  Outputs: hit bool[n],
// t f32[n], prim i32[n].  Returns the cudaError_t of the launch.
extern "C" int gopbrt_intersect(const float* o, const float* d, const float* t_max,
                                int n, const int* ptype, const float* w2o,
                                const float* params, int n_prims, int flags,
                                bool* hit_out, float* t_out, int* idx_out,
                                cudaStream_t stream) {
  closest_hit_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      o, d, t_max, n, ptype, w2o, params, n_prims, flags, hit_out, t_out, idx_out);
  return (int)cudaGetLastError();
}

// As gopbrt_intersect; output: occluded bool[n].
extern "C" int gopbrt_intersect_any(const float* o, const float* d,
                                    const float* t_max, int n, const int* ptype,
                                    const float* w2o, const float* params,
                                    int n_prims, int flags, bool* occ_out,
                                    cudaStream_t stream) {
  any_hit_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      o, d, t_max, n, ptype, w2o, params, n_prims, flags, occ_out);
  return (int)cudaGetLastError();
}
