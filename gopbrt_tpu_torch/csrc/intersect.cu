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
// What bounds it on the H100: fp32 operations on the lanes that test.  A
// ray costs 28 bytes in and 9 (closest) or 1 (any) out, while each
// primitive test is 40-60 flops, so at the 24 prims of the demo a live ray
// does ~1,400 flops for ~37 bytes.  A dead lane (below) tests nothing: it
// moves its t_max (and, where the table holds spheres, d) in and its
// answer out.
//
// Design.  On the TPU a block of 8x1024 rays runs every primitive's test on
// every lane, with the tables in SMEM.  Here one thread holds one ray in
// registers and walks the table in order, each row six 16-byte words
// (ops/brute_intersect.py REC_K), read from device memory through the
// read-only path; all threads of a warp read the same row, a broadcast
// from L1, and the shape branch in prim_test does not diverge.  There is
// no staging and no barrier, and no cap on the table's size.  Two
// compile-time instances, as the TPU kernel specialises on its static
// `types`, `full_sph` and `full_disk` (pallas_intersect.py:240-246):
// spheres and disks that are all full (four words a row, no clip and no
// triangle code), and the general one.  Measured in turns against a
// resident grid that stages the table in shared memory once and against
// two rays a thread (PERF.md §6): neither won.
// The closest hit keeps the first primitive on a tie (strict tp < t_best,
// pallas_intersect.py:189) and on a miss returns t_max and primitive 0
// (:272-273).  The any hit stops a thread at its own first occluder,
// which gives the same boolean as the full sweep.
//
// Dead lanes.  The integrators give a lane that has nothing to trace
// t_max = 1e-4 (half the launches of a config-1 pass have no other lane).
// Such a lane's answer is known without a test, and it takes it, exactly:
// - a disk or a triangle accepts only t > 1e-4f and t < t_limit
//   (prim_test.cuh), and t_limit <= t_max: never where t_max <= 1e-4f;
// - a sphere accepts a root only above t_eps = 1e-4f * olen / dlen, with
//   olen >= 1, so only where dlen > olen.  ops/brute_intersect.py dead_d2
//   packs, per table, a |d|^2 under which no sphere can do so (the bound
//   of its world->object norm and its radius, with a 1% margin; the
//   argument is in its docstring), inf for a table without spheres.
// So a lane with t_max <= 1e-4f, and |d|^2 <= dead_d2 where that is
// finite, gets the plain version's miss (t = t_max, prim 0; false) without
// reading o.  A warp whose lanes are all dead leaves after that test,
// having read t_max (and d, where the table holds spheres).  The TPU
// kernel's t_max <= 2e-4 (pallas_intersect.py:282-292) is its early-out,
// not an answer: a disk or a triangle can still be hit in (1e-4, 2e-4].
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "prim_test.cuh"

// (in namespace gopbrt::brute: csrc/bvh.cuh and csrc/bounce.cuh have
// constants of these names for their own tables)
namespace gopbrt {
namespace brute {

constexpr int REC_WORDS = 6;  // float4 words of a table row (REC_K = 24)
constexpr int INSTANCE_FULL_SPH_DISK = 0;
constexpr int INSTANCE_GENERAL = 1;
constexpr int FLAG_FULL_SPH = 1;
constexpr int FLAG_FULL_DISK = 2;
constexpr float DEAD_T_MAX = 1e-4f;

// Whether a lane's answer is the plain version's miss without a test:
// t_max <= 1e-4f, and where the table holds spheres (dead_d2 finite) a
// direction no longer than dead_d2 allows.  Reads d only then.
GOPBRT_HD bool dead_lane(float t_max, const float* d, float dead_d2) {
  if (!(t_max <= DEAD_T_MAX)) return false;  // a NaN t_max is live
  if (dead_d2 == INFINITY) return true;      // no sphere in the table
  const float dx = d[0], dy = d[1], dz = d[2];
  return dx * dx + dy * dy + dz * dz <= dead_d2;
}

// A row of the table (layout: w2o 0-11, type 12, params 13-21, padding):
// word k of row p.
GOPBRT_HD float4 row_word(const float4* rec, int p, int k) {
  return ld4(rec + REC_WORDS * p + k);
}

// Table row p against one ray.
template <int INSTANCE>
GOPBRT_HD float row_test(const float4* rec, int p, float ox, float oy, float oz, float dx,
                         float dy, float dz, float t_limit, bool full_sph, bool full_disk) {
  const float4 w0 = row_word(rec, p, 0), w1 = row_word(rec, p, 1), w2 = row_word(rec, p, 2),
               w3 = row_word(rec, p, 3);
  const float m[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w,
                       w2.x, w2.y, w2.z, w2.w};
  const int type = (int)w3.x;
  if (INSTANCE == INSTANCE_FULL_SPH_DISK) {
    // full spheres read the radius, full disks the height and the radius
    const float pr[9] = {w3.y, w3.z, w3.w, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    return prim_test<false>(type, m, pr, ox, oy, oz, dx, dy, dz, t_limit, true, true);
  }
  const float4 w4 = row_word(rec, p, 4), w5 = row_word(rec, p, 5);
  const float pr[9] = {w3.y, w3.z, w3.w, w4.x, w4.y, w4.z, w4.w, w5.x, w5.y};
  return prim_test(type, m, pr, ox, oy, oz, dx, dy, dz, t_limit, full_sph, full_disk);
}

// Closest hit of one live ray over the table: t (t_max on a miss) and the
// first nearest row in idx (-1 on a miss).
template <int INSTANCE>
GOPBRT_HD float closest_sweep(const float4* rec, int n_prims, int flags, const float* o,
                              const float* d, float t_max, int& idx) {
  const float ox = o[0], oy = o[1], oz = o[2], dx = d[0], dy = d[1], dz = d[2];
  const bool full_sph = flags & FLAG_FULL_SPH, full_disk = flags & FLAG_FULL_DISK;
  float t_best = t_max;
  idx = -1;
  for (int p = 0; p < n_prims; ++p) {
    const float tp = row_test<INSTANCE>(rec, p, ox, oy, oz, dx, dy, dz, t_best, full_sph,
                                        full_disk);
    if (tp < t_best) {
      t_best = tp;
      idx = p;
    }
  }
  return t_best;
}

// Any hit of one live ray closer than t_max: stops at its first occluder.
template <int INSTANCE>
GOPBRT_HD bool any_sweep(const float4* rec, int n_prims, int flags, const float* o,
                         const float* d, float t_max) {
  const float ox = o[0], oy = o[1], oz = o[2], dx = d[0], dy = d[1], dz = d[2];
  const bool full_sph = flags & FLAG_FULL_SPH, full_disk = flags & FLAG_FULL_DISK;
  for (int p = 0; p < n_prims; ++p)
    if (row_test<INSTANCE>(rec, p, ox, oy, oz, dx, dy, dz, t_max, full_sph, full_disk) <
        t_max)
      return true;
  return false;
}

#ifdef __CUDACC__

constexpr int THREADS = 128;

template <int INSTANCE>
__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, int n, const float4* __restrict__ rec,
                   int n_prims, const float* __restrict__ dead_d2, int flags,
                   bool* __restrict__ hit_out, float* __restrict__ t_out,
                   int* __restrict__ idx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const float tm = in ? t_max[i] : 0.f;
  const bool dead = !in || dead_lane(tm, d + 3 * i, __ldg(dead_d2));
  int idx = -1;
  float t = tm;
  if (!__all_sync(0xffffffffu, dead) && !dead)
    t = closest_sweep<INSTANCE>(rec, n_prims, flags, o + 3 * i, d + 3 * i, tm, idx);
  if (in) {
    hit_out[i] = idx >= 0;
    t_out[i] = t;  // t_max itself where nothing is hit
    idx_out[i] = idx < 0 ? 0 : idx;
  }
}

template <int INSTANCE>
__global__ void __launch_bounds__(THREADS)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int n, const float4* __restrict__ rec,
               int n_prims, const float* __restrict__ dead_d2, int flags,
               bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const float tm = in ? t_max[i] : 0.f;
  const bool dead = !in || dead_lane(tm, d + 3 * i, __ldg(dead_d2));
  bool occluded = false;
  if (!__all_sync(0xffffffffu, dead) && !dead)
    occluded = any_sweep<INSTANCE>(rec, n_prims, flags, o + 3 * i, d + 3 * i, tm);
  if (in) occ_out[i] = occluded;
}

// The launch of the closest hit (occ_out null) or the any hit, in the
// instance `instance`.
int launch(int instance, const float* o, const float* d, const float* t_max, int n,
           const float* rec, int n_prims, const float* dead_d2, int flags, bool* hit_out,
           float* t_out, int* idx_out, bool* occ_out, cudaStream_t stream) {
  if (instance != INSTANCE_FULL_SPH_DISK && instance != INSTANCE_GENERAL)
    return (int)cudaErrorInvalidValue;
  const bool fast = instance == INSTANCE_FULL_SPH_DISK;
  const int blocks = (n + THREADS - 1) / THREADS;
  const float4* r = reinterpret_cast<const float4*>(rec);
  if (occ_out) {
    const auto kernel =
        fast ? &any_hit_kernel<INSTANCE_FULL_SPH_DISK> : &any_hit_kernel<INSTANCE_GENERAL>;
    kernel<<<blocks, THREADS, 0, stream>>>(o, d, t_max, n, r, n_prims, dead_d2, flags, occ_out);
  } else {
    const auto kernel = fast ? &closest_hit_kernel<INSTANCE_FULL_SPH_DISK>
                             : &closest_hit_kernel<INSTANCE_GENERAL>;
    kernel<<<blocks, THREADS, 0, stream>>>(o, d, t_max, n, r, n_prims, dead_d2, flags, hit_out,
                                           t_out, idx_out);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace brute
}  // namespace gopbrt

#ifdef __CUDACC__

// o, d: f32[n, 3] (AoS); t_max: f32[n]; rec: f32[P, 24], the table rows
// (ops/brute_intersect.py BruteTable.rec); dead_d2: f32[1] on the card;
// instance: INSTANCE_*; flags: FLAG_FULL_* (the general instance's).
// Outputs: hit bool[n], t f32[n], prim i32[n].  Returns the cudaError_t of
// the launch.
extern "C" int gopbrt_intersect(const float* o, const float* d, const float* t_max, int n,
                                const float* rec, int n_prims, const float* dead_d2,
                                int instance, int flags, bool* hit_out, float* t_out,
                                int* idx_out, cudaStream_t stream) {
  return gopbrt::brute::launch(instance, o, d, t_max, n, rec, n_prims, dead_d2, flags, hit_out,
                               t_out, idx_out, nullptr, stream);
}

// As gopbrt_intersect; output: occluded bool[n].
extern "C" int gopbrt_intersect_any(const float* o, const float* d, const float* t_max,
                                    int n, const float* rec, int n_prims,
                                    const float* dead_d2, int instance, int flags,
                                    bool* occ_out, cudaStream_t stream) {
  return gopbrt::brute::launch(instance, o, d, t_max, n, rec, n_prims, dead_d2, flags, nullptr,
                               nullptr, nullptr, occ_out, stream);
}

#endif  // __CUDACC__
