// The mesh megakernel: the bounce skeleton of csrc/bounce.cuh over the BVH
// walk of csrc/bvh.cuh.
//
// Replaces gopbrt_tpu/ops/pallas_mesh_megakernel.py::_mesh_kernel (:357;
// entry mesh_li_fused :1560 -> _mesh_li_fwd -> pallas_call :1368).  The
// plain PyTorch twin is gopbrt_tpu_torch/ops/megakernel.py::path_li_plain
// (accel="bvh"); the wrapper is ops/mesh_megakernel.py::mesh_li_fused.
//
// Design.  The TPU kernel tests BVH-leaf-ordered triangle clusters eight
// per vector op behind block-wide box culls, the non-triangle prims
// ("extras", :582-602) in a separate brute loop, and recovers the winner's
// attributes with a masked sweep (:604-649); it runs the depth in phases
// with host re-sorts of the wavefront (:1455-1516).  Here one thread is one
// path for the whole depth in one launch: every prim, triangles and the
// rest, sits in the one BVH, the walk returns the winner's record row, and
// the winner's attributes are one read of it (material, area light) and of
// the per-material shade table (<= MAX_MATS rows of MAT_K floats, with the
// light tables in shared memory).  The tree and the records stay in global
// memory (L2-resident at the mesh scene's 10k prims).
//
// What bounds it: per bounce, a closest-hit walk and a shadow walk per
// path, whose cost is divergence between the paths of a warp (see
// csrc/bvh.cuh), then the shading math; the bytes (32 in, 12 out a path)
// bound far less.  This first version neither sorts paths nor walks
// packets.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bounce.cuh"
#include "bvh.cuh"

namespace gopbrt {

constexpr int MAX_MATS = 16;
constexpr int MAT_K = 32;  // the shade columns, then SH_PLA (ops/megakernel.py)

struct MeshTables {
  float mat[MAX_MATS][MAT_K];
  LightTables lights;
};
constexpr int MESH_TABLE_WORDS = (int)(sizeof(MeshTables) / sizeof(float));
static_assert(MESH_TABLE_WORDS == 769, "MeshTables must match MESH_TABLE_LAYOUT");

// The BVH walk and the records: the skeleton's scene policy.
struct MeshScene {
  static constexpr bool kTriangles = true;
  static constexpr bool kPlastic = true;
  BvhView B;
  const float (*mat)[MAT_K];

  GOPBRT_HD float closest(float ox, float oy, float oz, float dx, float dy, float dz,
                          int& idx) const {
    return bvh_walk<false>(B, ox, oy, oz, dx, dy, dz, BIG, idx);
  }

  GOPBRT_HD bool occluded(float ox, float oy, float oz, float dx, float dy, float dz,
                          float t_max) const {
    int slot;
    bvh_walk<true>(B, ox, oy, oz, dx, dy, dz, t_max, slot);
    return slot >= 0;
  }

  GOPBRT_HD Winner winner(int slot) const {
    const float* r = reinterpret_cast<const float*>(B.recs) + (size_t)slot * REC_K;
    return Winner{(int)r[REC_TYPE], r + REC_W2O, r + REC_PARAMS, mat[(int)r[REC_MAT]],
                  (int)r[REC_ALID], r[REC_SCALE2]};
  }
};

#ifdef __CUDACC__

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    mesh_kernel(const float* __restrict__ tables, BvhView B, Params P,
                const float* __restrict__ o, const float* __restrict__ d,
                const int* __restrict__ pixel, const int* __restrict__ sample,
                float* __restrict__ L) {
  __shared__ MeshTables T;
  float* dst = reinterpret_cast<float*>(&T);
  for (int i = threadIdx.x; i < MESH_TABLE_WORDS; i += blockDim.x) dst[i] = tables[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < P.n) trace_path(MeshScene{B, T.mat}, T.lights, P, o, d, pixel, sample, L, lane);
}

#endif  // __CUDACC__

}  // namespace gopbrt

#ifdef __CUDACC__

// Plain C entry point (loaded with ctypes).  tables: f32[MESH_TABLE_WORDS]
// (ops/mesh_megakernel.py pack_tables); nodes, recs: the BVH tables
// (ops/bvh.py bvh_table).  Launches on `stream` and returns the
// cudaError_t of the launch; it does not synchronise.
extern "C" int gopbrt_mesh_li(const float* o, const float* d, const int* pixel,
                              const int* sample, float* L, int n, const float* tables,
                              int table_words, const float* nodes, const float* recs,
                              int bvh_flags, int n_mats, int n_lights, unsigned int seed,
                              float func_int, float world_radius, float cone_w0,
                              float cone_sp, int max_depth, int rr_start,
                              float rr_threshold, int flags, void* stream) {
  using namespace gopbrt;
  if (table_words != MESH_TABLE_WORDS || n_mats < 1 || n_mats > MAX_MATS ||
      n_lights < 1 || n_lights > MAX_LIGHTS || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const BvhView B{reinterpret_cast<const float4*>(nodes),
                  reinterpret_cast<const float4*>(recs), bvh_flags};
  Params p{n, 0, n_lights, seed, func_int, world_radius, cone_w0, cone_sp,
           max_depth, rr_start, rr_threshold, flags};
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tables, B, p, o, d, pixel,
                                                             sample, L);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
