// Host harness of the port's CUDA kernels: their device code compiled as
// plain C++ (the GOPBRT_HD path of gopbrt_tpu_torch/csrc/prim_test.cuh) and
// driven the way the persistent kernels drive it, so the tests can hold it
// per lane against the plain PyTorch versions without a card.
//
// g++ -std=c++17 -O2 -shared -fPIC -I gopbrt_tpu_torch/csrc host_kernels.cpp
//
// The bounce entry points keep a few lanes in flight, take the paths in a
// shuffled order, step the lanes round robin, and hand a lane its next path
// as soon as its current one ends: the refill of the bounce skeleton's
// persistent loop (csrc/bounce.cuh), in another order.  Each writes path
// i's radiance at row i.
#include <algorithm>
#include <numeric>
#include <random>
#include <vector>

#include "megakernel.cu"
#include "mesh_megakernel.cu"

namespace {

// Paths 0..n-1 in a shuffled order over `lanes` lanes, round robin:
// start(lane, path) -> whether the path needs bounces; step(lane) ->
// whether it goes on; end(lane) when it is over.
template <class Start, class Step, class End>
void round_robin(int n, int lanes, unsigned order_seed, Start start, Step step, End end) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), std::mt19937(order_seed));
  std::vector<bool> busy(lanes, false);
  int next = 0, live = 0;
  while (next < n || live > 0) {
    for (int k = 0; k < lanes; ++k) {
      if (!busy[k] && next < n) {
        busy[k] = start(k, order[next++]);
        if (busy[k]) ++live;
      }
      if (busy[k] && !step(k)) {
        end(k);
        busy[k] = false;
        --live;
      }
    }
  }
}

gopbrt::Params params(int n, int n_prims, int n_lights, unsigned seed, float func_int,
                      float world_radius, float cone_w0, float cone_sp, int max_depth,
                      int rr_start, float rr_threshold, int flags) {
  return gopbrt::Params{n, n_prims, n_lights, seed, func_int, world_radius, cone_w0,
                        cone_sp, max_depth, rr_start, rr_threshold, flags};
}

// The bounce skeleton over `scene`: init / bounce / finish per lane.
template <class S>
void paths(const S& scene, const gopbrt::LightTables& LT, const gopbrt::Params& P,
           const float* o, const float* d, const int* pixel, const int* sample, float* L,
           int lanes, unsigned order_seed) {
  std::vector<gopbrt::PathState> st(lanes);
  round_robin(
      P.n, lanes, order_seed,
      [&](int k, int i) {
        gopbrt::path_init(st[k], P, o, d, pixel, sample, i);
        if (P.max_depth > 0) return true;
        gopbrt::path_finish(st[k], L);
        return false;
      },
      [&](int k) { return gopbrt::path_bounce(scene, LT, P, st[k]); },
      [&](int k) { gopbrt::path_finish(st[k], L); });
}

}  // namespace

extern "C" {

// The BVH walk of csrc/bvh.cuh on rays o, d (f32[n, 3]) below t_max, over
// the packed nodes and records (ops/bvh.py bvh_table): t_out (t_max on a
// miss) and slot_out (record row, -1 on a miss) of bvh_walk, the kernels'
// walk; and, from a second walk of each ray one node at a time
// (interior_node / leaf_node, the pieces of walk_step), its nodes and
// leaves, interior nodes and pops: the events the kernels' bound counts.
void host_bvh_walk(const float* nodes, const float* recs, int flags, const float* o,
                   const float* d, const float* t_max, int n, int any_hit, float* t_out,
                   int* slot_out, int* steps_out, int* nodes_out, int* pops_out) {
  const gopbrt::BvhView B{reinterpret_cast<const float4*>(nodes),
                          reinterpret_cast<const float4*>(recs), flags};
  gopbrt::StackEntry stack[gopbrt::STACK_DEPTH];
  for (int i = 0; i < n; ++i) {
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    t_out[i] = any_hit ? gopbrt::bvh_walk<true>(B, oi[0], oi[1], oi[2], di[0], di[1], di[2],
                                                t_max[i], slot_out[i])
                       : gopbrt::bvh_walk<false>(B, oi[0], oi[1], oi[2], di[0], di[1],
                                                 di[2], t_max[i], slot_out[i]);
    gopbrt::Walk w;
    steps_out[i] = nodes_out[i] = pops_out[i] = 0;
    bool more = any_hit ? gopbrt::walk_start<true>(B, w, oi[0], oi[1], oi[2], di[0], di[1],
                                                   di[2], t_max[i])
                        : gopbrt::walk_start<false>(B, w, oi[0], oi[1], oi[2], di[0], di[1],
                                                    di[2], t_max[i]);
    while (more) {
      const int sp0 = w.sp;
      const bool inner = w.cur >= 0;
      steps_out[i] += 1;
      nodes_out[i] += inner;
      more = inner ? gopbrt::interior_node(B, w, stack)
                   : (any_hit ? gopbrt::leaf_node<true>(B, w, stack)
                              : gopbrt::leaf_node<false>(B, w, stack));
      // a node pushes at most one entry and pops only when no child comes
      // next
      pops_out[i] += std::max(0, sp0 - w.sp);
    }
  }
}

// The brute instance of the bounce skeleton (csrc/megakernel.cu) on the
// packed tables (ops/megakernel.py pack_tables); L: f32[n, 3].
void host_paths_brute(const float* tables, int n_prims, int n_lights, unsigned seed,
                      float func_int, float world_radius, float cone_w0, float cone_sp,
                      int max_depth, int rr_start, float rr_threshold, int flags,
                      const float* o, const float* d, const int* pixel, const int* sample,
                      float* L, int n, int lanes, unsigned order_seed) {
  const auto& T = *reinterpret_cast<const gopbrt::Tables*>(tables);
  const gopbrt::BruteScene scene{T, n_prims, (flags & gopbrt::FLAG_FULL_SPH) != 0,
                                 (flags & gopbrt::FLAG_FULL_DISK) != 0};
  paths(scene, T.lights,
        params(n, n_prims, n_lights, seed, func_int, world_radius, cone_w0, cone_sp,
               max_depth, rr_start, rr_threshold, flags),
        o, d, pixel, sample, L, lanes, order_seed);
}

// The BVH instance (csrc/mesh_megakernel.cu) on the mesh tables
// (ops/mesh_megakernel.py mesh_tables) and the packed tree.
void host_paths_mesh(const float* tables, const float* nodes, const float* recs,
                     int bvh_flags, int n_lights, unsigned seed, float func_int,
                     float world_radius, float cone_w0, float cone_sp, int max_depth,
                     int rr_start, float rr_threshold, int flags, const float* o,
                     const float* d, const int* pixel, const int* sample, float* L, int n,
                     int lanes, unsigned order_seed) {
  const auto& T = *reinterpret_cast<const gopbrt::MeshTables*>(tables);
  const gopbrt::MeshScene scene{{reinterpret_cast<const float4*>(nodes),
                                 reinterpret_cast<const float4*>(recs), bvh_flags},
                                T.mat};
  paths(scene, T.lights,
        params(n, 0, n_lights, seed, func_int, world_radius, cone_w0, cone_sp, max_depth,
               rr_start, rr_threshold, flags),
        o, d, pixel, sample, L, lanes, order_seed);
}

}  // extern "C"
