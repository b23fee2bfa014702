// The BVH walk: one ray's closest or any hit over a LinearBVH.
//
// Replaces the traversal of gopbrt_tpu/ops/pallas_cluster.py
// (_cluster_kernel / _trace_row, lines 127-249, and the host cluster table
// build_clusters, :83-124).  The TPU kernel tests BVH-leaf-ordered clusters
// of 128 prims, eight per vector op, behind a block-wide box cull, because
// the TPU has no per-lane branching.  Here one thread walks one ray over
// the tree itself (the reference's stack walk, bvh.go:659-765): depth first,
// near child first (the second child when the ray's direction is negative
// on the node's split axis), the far child on a stack of STACK_DEPTH node
// ids in local memory, boxes pruned by the robust slab test against the
// best t so far.  Leaf prims are tested with the shared prim_test.cuh, in
// order, a hit kept only when strictly closer, so the walk and its plain
// version (gopbrt_tpu_torch/ops/bvh.py::walk) visit the same nodes and pick
// the same prim on ties.  The any hit stops at the end of the leaf that
// holds its first accepted hit; lanes with t_max <= DEAD_T_MAX (the
// integrators' dead shadow rays) are not walked and come out unoccluded.
//
// Layout.  A node is 32 bytes, two 16-byte loads: (lo.xyz, right | first)
// and (hi.xyz, count * 4 + axis), the ints as their bits; a leaf has count
// >= 1.  Primitive records (REC_K floats, rows in leaf order, so a leaf
// reads contiguous rows) hold the params, the type, the material, the
// area-light id, the world->object rows and the squared uniform scale.  At
// the 10,226 prims of the mesh scene the nodes (about 0.3 MB) and records
// (1.3 MB) stay in the H100's 50 MB L2; they do not fit in shared memory,
// so this version reads them from global memory.
//
// What bounds it: divergence between the rays of a warp.  Each thread
// walks its own path through the tree and the warp runs the union of its
// threads' steps; the arithmetic per step (a slab test, or up to 4 shape
// tests) is small.  This first version does nothing about it (no ray
// sorting, no packets).
#pragma once

#include "prim_test.cuh"

namespace gopbrt {

constexpr int STACK_DEPTH = 64;
constexpr float DEAD_T_MAX = 2e-4f;
// primitive record columns (ops/bvh.py REC_*)
constexpr int REC_PARAMS = 0, REC_TYPE = 9, REC_MAT = 10, REC_ALID = 11,
              REC_W2O = 12, REC_SCALE2 = 24, REC_K = 32;
constexpr int BVH_FULL_SPH = 1, BVH_FULL_DISK = 2;
// far-plane widening of the slab test: 1 + 2 gamma(3), eps = 2^-24
constexpr double MACH_EPS_D = 5.9604644775390625e-08;
constexpr float BOX_WIDEN =
    (float)(1.0 + 2.0 * (3.0 * MACH_EPS_D / (1.0 - 3.0 * MACH_EPS_D)));

struct BvhView {
  const float4* nodes;  // [n_nodes * 2]
  const float4* recs;   // [n_prims * REC_K / 4]
  int flags;            // BVH_FULL_SPH | BVH_FULL_DISK
};

GOPBRT_HD float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

// the robust slab test (bounds.go:149-185; geom.bounds_intersect_p)
GOPBRT_HD bool box_hit(const float4& a, const float4& b, float ox, float oy, float oz,
                       float ix, float iy, float iz, float t_max) {
  const float tx0 = (a.x - ox) * ix, tx1 = (b.x - ox) * ix;
  const float ty0 = (a.y - oy) * iy, ty1 = (b.y - oy) * iy;
  const float tz0 = (a.z - oz) * iz, tz1 = (b.z - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1) * BOX_WIDEN, fmaxf(ty0, ty1) * BOX_WIDEN),
                         fmaxf(tz0, tz1) * BOX_WIDEN);
  return tn <= tf && tf > 0.0f && tn < t_max;
}

// ray vs one primitive record: three 16-byte loads for a triangle, six
// for a sphere or disk
GOPBRT_HD float record_test(const float4* rec, float ox, float oy, float oz, float dx,
                            float dy, float dz, float t_limit, bool full_sph,
                            bool full_disk) {
  float pr[12], m[12];
  const float4 r0 = ld4(rec), r1 = ld4(rec + 1), r2 = ld4(rec + 2);
  pr[0] = r0.x; pr[1] = r0.y; pr[2] = r0.z; pr[3] = r0.w;
  pr[4] = r1.x; pr[5] = r1.y; pr[6] = r1.z; pr[7] = r1.w;
  pr[8] = r2.x; pr[9] = r2.y; pr[10] = r2.z; pr[11] = r2.w;
  const int ptype = (int)pr[REC_TYPE];
  if (ptype != TRIANGLE) {
    const float4 w0 = ld4(rec + 3), w1 = ld4(rec + 4), w2 = ld4(rec + 5);
    m[0] = w0.x; m[1] = w0.y; m[2] = w0.z; m[3] = w0.w;
    m[4] = w1.x; m[5] = w1.y; m[6] = w1.z; m[7] = w1.w;
    m[8] = w2.x; m[9] = w2.y; m[10] = w2.z; m[11] = w2.w;
  }
  return prim_test(ptype, m, pr, ox, oy, oz, dx, dy, dz, t_limit, full_sph, full_disk);
}

// The walk: the nearest hit closer than t_max and its record row (slot, -1
// and t_max where none is).  ANY: the any hit.
template <bool ANY>
GOPBRT_HD float bvh_walk(const BvhView& B, float ox, float oy, float oz, float dx,
                         float dy, float dz, float t_max, int& slot) {
  slot = -1;
  if (ANY && t_max <= DEAD_T_MAX) return t_max;
  const bool full_sph = B.flags & BVH_FULL_SPH;
  const bool full_disk = B.flags & BVH_FULL_DISK;
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  int stack[STACK_DEPTH];
  int sp = 0, node = 0;
  float best = t_max;
  for (;;) {
    const float4 a = ld4(B.nodes + 2 * node), b = ld4(B.nodes + 2 * node + 1);
    if (box_hit(a, b, ox, oy, oz, ix, iy, iz, best)) {
      const int ca = as_int(b.w);
      if (ca >= 4) {  // leaf: count * 4
        const int first = as_int(a.w);
        for (int k = 0; k < (ca >> 2); ++k) {
          const float tp = record_test(B.recs + (first + k) * (REC_K / 4), ox, oy, oz, dx,
                                       dy, dz, best, full_sph, full_disk);
          if (tp < best) {
            best = tp;
            slot = first + k;
          }
        }
        if (ANY && slot >= 0) return best;
      } else {  // interior: near child next, far child on the stack
        const int axis = ca & 3;
        const float ia = axis == 0 ? ix : (axis == 1 ? iy : iz);
        const int right = as_int(a.w);
        const bool neg = ia < 0.0f;
        stack[sp < STACK_DEPTH ? sp : STACK_DEPTH - 1] = neg ? node + 1 : right;
        sp = sp < STACK_DEPTH ? sp + 1 : STACK_DEPTH;
        node = neg ? right : node + 1;
        continue;
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  return best;
}

}  // namespace gopbrt
