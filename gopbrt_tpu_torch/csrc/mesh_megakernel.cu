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
// with host re-sorts of the wavefront (:1455-1516).  Here the whole depth
// runs in one launch, on the skeleton's persistent loop (a resident grid,
// a lane takes the next path when its own ends): every prim, triangles and
// the rest, sits in the one BVH, the walk returns the winner's record row,
// and the winner's attributes are one read of it (material, area light,
// the geometric normal N) and of the per-material shade table (<= MAX_MATS
// rows of MAT_K floats, with the light tables in shared memory, copied once
// per block).  The tree and the records stay in global memory
// (L2-resident at the mesh scene's 10k prims).  Triangles are tested in
// the TPU kernel's Havel-Herout plane form (_tri_test_h, :330-354) on the
// planes ops/bvh.py precomputes into each triangle's record: three dot
// products and a divide, where the walk kernels' vertex form takes two
// cross products.
//
// What bounds it: per bounce, a closest-hit walk and a shadow walk per
// path, whose cost is divergence between the paths of a warp and the
// registers a walk holds (see csrc/bvh.cuh), then the shading math; the
// bytes (32 in, 12 out a path) bound far less.  So no shading value is live
// across a walk, the path state waits in shared memory (PathState, 92 bytes
// a thread beside the 3 KB of tables), and both walks of a bounce run from
// one call site (csrc/bounce.cuh run_paths).  It neither sorts paths nor
// walks packets: the TPU kernel's octant x origin-cell re-sort between
// bounces ran slower on the H100 (PERF.md §6).
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
  static constexpr bool kShadowAtOnce = false;
  BvhView B;
  const float (*mat)[MAT_K];

  // the closest or (r.shadow) any hit: one walk for both, triangles in
  // the plane form
  GOPBRT_HD float trace(const Ray& r, int& idx) const {
    return bvh_walk<true>(B, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.t_max, r.shadow, idx);
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
                float* __restrict__ L, int* next) {
  __shared__ MeshTables T;
  __shared__ PathState paths[THREADS];
  float* dst = reinterpret_cast<float*>(&T);
  for (int i = threadIdx.x; i < MESH_TABLE_WORDS; i += blockDim.x) dst[i] = tables[i];
  __syncthreads();
  run_paths(MeshScene{B, T.mat}, T.lights, P, o, d, pixel, sample, L, next,
            paths[threadIdx.x]);
}

#endif  // __CUDACC__

}  // namespace gopbrt

#ifdef __CUDACC__

// Plain C entry point (loaded with ctypes).  tables: f32[MESH_TABLE_WORDS]
// (ops/mesh_megakernel.py pack_tables); nodes, recs: the BVH tables
// (ops/bvh.py bvh_table); next: one int of device memory, the path
// counter, zeroed here on `stream`.  Launches on `stream` and returns the
// cudaError_t of the launch; it does not synchronise.
extern "C" int gopbrt_mesh_li(const float* o, const float* d, const int* pixel,
                              const int* sample, float* L, int n, const float* tables,
                              int table_words, const float* nodes, const float* recs,
                              int bvh_flags, int n_mats, int n_lights, unsigned int seed,
                              float func_int, float world_radius, float cone_w0,
                              float cone_sp, int max_depth, int rr_start,
                              float rr_threshold, int flags, void* stream, int* next) {
  using namespace gopbrt;
  if (table_words != MESH_TABLE_WORDS || n_mats < 1 || n_mats > MAX_MATS ||
      n_lights < 1 || n_lights > MAX_LIGHTS || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const BvhView B{reinterpret_cast<const float4*>(nodes),
                  reinterpret_cast<const float4*>(recs), bvh_flags};
  Params p{n, 0, n_lights, seed, func_int, world_radius, cone_w0, cone_sp,
           max_depth, rr_start, rr_threshold, flags};
  int blocks;
  cudaError_t err = persistent_blocks(mesh_kernel, THREADS, n, blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(next, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  mesh_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tables, B, p, o, d, pixel,
                                                             sample, L, next);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
