// BVH ray intersection: closest hit and any hit, one thread per ray.
//
// Replaces gopbrt_tpu/ops/pallas_cluster.py::_cluster_kernel (:127,
// pallas_call :278) behind its entry points cluster_intersect (:313) and
// cluster_intersect_p (:329).  The walk itself is csrc/bvh.cuh (see its
// note: the node that holds both child boxes, the while-while step, and the
// same leaves in the same order as the plain walk); these kernels read one
// ray, walk, and write the result.  Triangles take the vertex form
// (Moller-Trumbore), as the cluster kernel's shared _prim_test does.  The
// plain PyTorch twins are gopbrt_tpu_torch/ops/bvh.py::bvh_intersect and
// ::bvh_intersect_p; the wrappers that launch these kernels are
// bvh_intersect_fused and bvh_intersect_p_fused there.  A miss returns
// t_max and prim 0, as the cluster kernel does (pallas_cluster.py:325).
//
// One thread per ray, not persistent lanes (csrc/lanes.cuh): neighbouring
// rays of a band walk alike, so a warp of them already fills most of its
// lane slots (chip_smoke.py's [lane-slots] lines), and on the H100 the
// persistent walk ran slower than this launch in the same call.
#include <cuda_runtime.h>

#include "bvh.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, int n, gopbrt::BvhView B,
                   const int* __restrict__ prim_order, bool* __restrict__ hit_out,
                   float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int slot;
  const float t = gopbrt::bvh_walk<false>(B, o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                          d[3 * i], d[3 * i + 1], d[3 * i + 2], t_max[i],
                                          gopbrt::AnyHit<false>{}, slot);
  hit_out[i] = slot >= 0;
  t_out[i] = t;  // t_max itself where nothing is hit
  prim_out[i] = slot >= 0 ? prim_order[slot] : 0;
}

__global__ void __launch_bounds__(THREADS)
bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int n, gopbrt::BvhView B,
               bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int slot;
  gopbrt::bvh_walk<false>(B, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
                          d[3 * i + 2], t_max[i], gopbrt::AnyHit<true>{}, slot);
  occ_out[i] = slot >= 0;
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// o, d: f32[n, 3]; t_max: f32[n]; nodes: f32[1 + interior nodes, 16]
// (64-byte aligned); recs: f32[P, REC_K] (ops/bvh.py bvh_table);
// prim_order: i32[P].  Outputs: hit bool[n], t f32[n], prim i32[n].
// Returns the cudaError_t of the launch.
extern "C" int gopbrt_bvh_intersect(const float* o, const float* d, const float* t_max,
                                    int n, const float* nodes, const float* recs,
                                    const int* prim_order, int flags, bool* hit_out,
                                    float* t_out, int* prim_out, cudaStream_t stream) {
  const gopbrt::BvhView B{reinterpret_cast<const float4*>(nodes),
                          reinterpret_cast<const float4*>(recs), flags};
  bvh_closest_kernel<<<blocks_for(n), THREADS, 0, stream>>>(o, d, t_max, n, B, prim_order,
                                                            hit_out, t_out, prim_out);
  return (int)cudaGetLastError();
}

// As gopbrt_bvh_intersect, without prim_order; output: occluded bool[n].
extern "C" int gopbrt_bvh_intersect_any(const float* o, const float* d,
                                        const float* t_max, int n, const float* nodes,
                                        const float* recs, int flags, bool* occ_out,
                                        cudaStream_t stream) {
  const gopbrt::BvhView B{reinterpret_cast<const float4*>(nodes),
                          reinterpret_cast<const float4*>(recs), flags};
  bvh_any_kernel<<<blocks_for(n), THREADS, 0, stream>>>(o, d, t_max, n, B, occ_out);
  return (int)cudaGetLastError();
}
