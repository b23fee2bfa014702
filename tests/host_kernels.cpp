// Host harness of the port's CUDA kernels: their device code compiled as
// plain C++ (the GOPBRT_HD path of gopbrt_tpu_torch/csrc/prim_test.cuh) and
// driven the way the kernels drive it, so the tests can hold it per lane
// against the plain PyTorch versions without a card.
//
// g++ -std=c++17 -O2 -shared -fPIC -I gopbrt_tpu_torch/csrc host_kernels.cpp
//
// The bounce entry points keep a few lanes in flight, take the paths in a
// shuffled order, step the lanes round robin (path_step, the step of
// run_paths), and hand a lane its next path as soon as its current one
// ends: the refill of the bounce skeleton's persistent loop (csrc/bounce.cuh
// run_paths), in another order.  Each writes path i's
// radiance at row i.  The camera-ray entry runs csrc/camera_rays.cu's lane
// function on every lane of a band, as its kernel's threads do; the splat
// entry csrc/splat_rows.cu's pixel function on every film pixel a band
// reaches.
#include <algorithm>
#include <numeric>
#include <random>
#include <vector>

#include "camera_rays.cu"
#include "intersect.cu"
#include "megakernel.cu"
#include "mesh_megakernel.cu"
#include "splat_rows.cu"

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

// The bounce skeleton over `scene`: per lane init, then path_step, the
// step of run_paths, until the path ends; finish.
template <class S>
void paths(const S& scene, const gopbrt::LightTables& LT, const gopbrt::Params& P,
           const float* o, const float* d, const int* pixel, const int* sample, float* L,
           int lanes, unsigned order_seed) {
  std::vector<gopbrt::PathState> st(lanes);
  std::vector<gopbrt::Ray> ray(lanes);
  round_robin(
      P.n, lanes, order_seed,
      [&](int k, int i) {
        gopbrt::path_init(st[k], ray[k], P, o, d, pixel, sample, i);
        if (P.max_depth > 0) return true;
        gopbrt::path_finish(st[k], L);
        return false;
      },
      [&](int k) { return gopbrt::path_step(scene, LT, P, st[k], ray[k]); },
      [&](int k) { gopbrt::path_finish(st[k], L); });
}

// One ray's walk, node by node: its steps, interior nodes and pops.
template <bool PLANE>
void walk_events(const gopbrt::BvhView& B, const float* o, const float* d, float t_max,
                 bool any, int& steps, int& inner_nodes, int& pops) {
  gopbrt::StackEntry stack[gopbrt::STACK_DEPTH];
  gopbrt::Walk w;
  steps = inner_nodes = pops = 0;
  bool more = gopbrt::walk_start(B, w, o[0], o[1], o[2], d[0], d[1], d[2], t_max, any);
  while (more) {
    const int sp0 = w.sp;
    const bool inner = w.cur >= 0;
    steps += 1;
    inner_nodes += inner;
    more = inner ? gopbrt::interior_node(B, w, stack)
                 : gopbrt::leaf_node<PLANE>(B, w, stack, any);
    // a node pushes at most one entry and pops only when no child comes
    // next
    pops += std::max(0, sp0 - w.sp);
  }
}

// The brute intersection kernels' lane (csrc/intersect.cu): the dead-lane
// test, then, on a live lane, the sweep of the compile-time instance
// `instance` over the table rows rec (f32[P, 24]).  any_hit: occ_out, else
// hit_out / t_out / idx_out as the closest-hit kernel writes them;
// dead_out: the lanes that took their answer without a test.
template <int INSTANCE>
void intersect_lanes(const float4* rec, int n_prims, float dead_d2, int flags, const float* o,
                     const float* d, const float* t_max, int n, int any_hit, bool* hit_out,
                     float* t_out, int* idx_out, bool* occ_out, bool* dead_out) {
  namespace b = gopbrt::brute;
  for (int i = 0; i < n; ++i) {
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    const bool dead = dead_out[i] = b::dead_lane(t_max[i], di, dead_d2);
    if (any_hit) {
      occ_out[i] = !dead && b::any_sweep<INSTANCE>(rec, n_prims, flags, oi, di, t_max[i]);
      continue;
    }
    int idx = -1;
    const float t =
        dead ? t_max[i] : b::closest_sweep<INSTANCE>(rec, n_prims, flags, oi, di, t_max[i], idx);
    hit_out[i] = idx >= 0;
    t_out[i] = t;
    idx_out[i] = idx < 0 ? 0 : idx;
  }
}

}  // namespace

extern "C" {

void host_intersect(const float* rec, int n_prims, float dead_d2, int instance, int flags,
                    const float* o, const float* d, const float* t_max, int n, int any_hit,
                    bool* hit_out, float* t_out, int* idx_out, bool* occ_out, bool* dead_out) {
  namespace b = gopbrt::brute;
  const float4* r = reinterpret_cast<const float4*>(rec);
  if (instance == b::INSTANCE_GENERAL)
    intersect_lanes<b::INSTANCE_GENERAL>(r, n_prims, dead_d2, flags, o, d, t_max, n, any_hit,
                                         hit_out, t_out, idx_out, occ_out, dead_out);
  else
    intersect_lanes<b::INSTANCE_FULL_SPH_DISK>(r, n_prims, dead_d2, flags, o, d, t_max, n,
                                               any_hit, hit_out, t_out, idx_out, occ_out,
                                               dead_out);
}

// The BVH walk of csrc/bvh.cuh on rays o, d (f32[n, 3]) below t_max, over
// the packed nodes and records (ops/bvh.py bvh_table): t_out (t_max on a
// miss) and slot_out (record row, -1 on a miss) of bvh_walk, the kernels'
// walk; and, from a second walk of each ray one node at a time
// (interior_node / leaf_node, the pieces of walk_step), its nodes and
// leaves, interior nodes and pops: the events the kernels' bound counts.
// plane: triangles in the plane form (the mesh megakernel's walk), else
// the vertex form (the walk kernels').
void host_bvh_walk(const float* nodes, const float* recs, int flags, const float* o,
                   const float* d, const float* t_max, int n, int any_hit, int plane,
                   float* t_out, int* slot_out, int* steps_out, int* nodes_out,
                   int* pops_out) {
  const gopbrt::BvhView B{reinterpret_cast<const float4*>(nodes),
                          reinterpret_cast<const float4*>(recs), flags};
  for (int i = 0; i < n; ++i) {
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    if (plane) {
      t_out[i] = gopbrt::bvh_walk<true>(B, oi[0], oi[1], oi[2], di[0], di[1], di[2], t_max[i],
                                        any_hit, slot_out[i]);
      walk_events<true>(B, oi, di, t_max[i], any_hit, steps_out[i], nodes_out[i], pops_out[i]);
    } else {
      t_out[i] = gopbrt::bvh_walk<false>(B, oi[0], oi[1], oi[2], di[0], di[1], di[2],
                                         t_max[i], any_hit, slot_out[i]);
      walk_events<false>(B, oi, di, t_max[i], any_hit, steps_out[i], nodes_out[i],
                         pops_out[i]);
    }
  }
}

// The plane-form triangle test of csrc/prim_test.cuh, one triangle's planes
// (f32[n, 12]: N, d_n, U, d_u, V, d_v) per ray -> t (BIG on a miss).
void host_plane_test(const float* planes, const float* o, const float* d,
                     const float* t_limit, int n, float* t_out) {
  for (int i = 0; i < n; ++i) {
    const float* q = planes + 12 * i;
    const float4 pn{q[0], q[1], q[2], q[3]}, pu{q[4], q[5], q[6], q[7]},
        pv{q[8], q[9], q[10], q[11]};
    t_out[i] = gopbrt::plane_test(pn, pu, pv, o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                  d[3 * i], d[3 * i + 1], d[3 * i + 2], t_limit[i]);
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

// The camera rays of a window (csrc/camera_rays.cu): the lane function on
// lanes 0..n-1; the arguments are gopbrt_camera_rays'.
void host_camera_rays(const float* r2c, const float* c2w, int width, int row0, int col0,
                      int cols, int n, unsigned seed, long long sample, int sampler, int nx, int ny, int kind,
                      float lens_radius, float focal_distance, float* jitter, float* o,
                      float* d, long long* pixel, long long* sample_out) {
  const gopbrt::CameraParams P{width, row0, col0, cols, n, seed, sample, sampler, nx, ny, kind,
                               lens_radius, focal_distance};
  for (int lane = 0; lane < n; ++lane)
    gopbrt::camera_ray(P, r2c, c2w, lane, jitter, o, d, pixel, sample_out);
}

// The row splat of a band (csrc/splat_rows.cu): the pixel function on every
// film pixel the band reaches, as the kernel's threads run it; the
// arguments are gopbrt_splat_rows'.  -1 where splat_params refuses them.
int host_splat_rows(float* rgb, float* wsum, const float* jitter, const float* L, int height,
                    int width, int row0, int rows, int kind, double radius, double alpha,
                    double b, double c) {
  using namespace gopbrt;
  SplatParams P;
  if (!splat_params(height, width, row0, rows, kind, radius, alpha, b, c, P)) return -1;
  for (int y = P.y_lo; y < P.y_hi; ++y)
    for (int x = 0; x < width; ++x) {
      if (kind == FILTER_BOX) splat_pixel<FILTER_BOX>(P, jitter, L, rgb, wsum, y, x);
      if (kind == FILTER_TRIANGLE) splat_pixel<FILTER_TRIANGLE>(P, jitter, L, rgb, wsum, y, x);
      if (kind == FILTER_GAUSSIAN) splat_pixel<FILTER_GAUSSIAN>(P, jitter, L, rgb, wsum, y, x);
      if (kind == FILTER_MITCHELL) splat_pixel<FILTER_MITCHELL>(P, jitter, L, rgb, wsum, y, x);
      if (kind == FILTER_LANCZOS) splat_pixel<FILTER_LANCZOS>(P, jitter, L, rgb, wsum, y, x);
    }
  return 0;
}

}  // extern "C"
