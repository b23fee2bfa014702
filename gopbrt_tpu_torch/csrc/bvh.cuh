// The BVH walk: one ray's closest or any hit over the packed tree.
//
// Replaces the traversal of gopbrt_tpu/ops/pallas_cluster.py
// (_cluster_kernel / _trace_row, lines 127-249, and the host cluster table
// build_clusters, :83-124).  The TPU kernel tests BVH-leaf-ordered clusters
// of 128 prims, eight per vector op, behind a block-wide box cull, because
// the TPU has no per-lane branching.  Here one thread walks one ray over
// the tree itself (the reference's stack walk, bvh.go:659-765): depth first,
// near child first (the second child when the ray's direction is negative
// on the node's split axis), leaf prims tested with the shared
// prim_test.cuh, in order, a hit kept only when strictly closer.  The any
// hit stops at the end of the leaf that holds its first accepted hit;
// lanes with t_max <= DEAD_T_MAX (the integrators' dead shadow rays) are
// not walked and come out unoccluded.
//
// Layout (ops/bvh.py bvh_table).  An interior node is 64 bytes, four
// 16-byte loads, and holds both children: (left lo.xyz, left code),
// (left hi.xyz, split axis), (right lo.xyz, right code), (right hi.xyz, 0),
// the ints as their bits.  A child's code is its node index (>= 1) if it
// is interior, else ~(first record << LEAF_SHIFT | count).  Node 0 is the
// header: the root's box and code in its first half.  Primitive records
// (REC_K floats, rows in leaf order, so a leaf reads contiguous rows) hold
// the params, the type, the material, the area-light id, the world->object
// rows and the squared uniform scale.  At the 10,226 prims of the mesh
// scene the nodes (about 0.2 MB) and records (1.3 MB) stay in the H100's
// 50 MB L2.
//
// What bounds it: dependent loads and divergence.  The previous walk
// fetched a node's box only once it was popped, so every pushed far child
// cost an L2 round trip even when it then missed.  Here one fetch tests
// both children against the best t so far: the walk goes to the near child
// if its box is hit and pushes the far child only if its box is hit, with
// its entry distance; a pop skips an entry no longer closer than the best
// t.  The leaves are tested in the same order as by the previous walk, the
// plain walk (ops/bvh.py walk) and JAX's _traverse, so each lane's t and
// record are theirs.  A step runs interior nodes until a leaf comes next,
// then the leaf (walk_step), so the lanes of a warp test their leaves
// together.  The stack (STACK_DEPTH entries of a code and an entry
// distance, 512 bytes a thread) is in local memory, cached in L1: in
// shared memory, [depth][thread], its 64 KB a block cut the occupancy and
// the walk ran slower on the H100.
#pragma once

#include "prim_test.cuh"

namespace gopbrt {

constexpr int STACK_DEPTH = 64;
constexpr float DEAD_T_MAX = 2e-4f;
// primitive record columns (ops/bvh.py REC_*)
constexpr int REC_PARAMS = 0, REC_TYPE = 9, REC_MAT = 10, REC_ALID = 11,
              REC_W2O = 12, REC_SCALE2 = 24, REC_K = 32;
constexpr int BVH_FULL_SPH = 1, BVH_FULL_DISK = 2;
// a leaf child's code: ~(first << LEAF_SHIFT | count) (ops/bvh.py LEAF_SHIFT)
constexpr int LEAF_SHIFT = 4;
constexpr int NODE_F4 = 4;  // 16-byte words per node
// far-plane widening of the slab test: 1 + 2 gamma(3), eps = 2^-24
constexpr double MACH_EPS_D = 5.9604644775390625e-08;
constexpr float BOX_WIDEN =
    (float)(1.0 + 2.0 * (3.0 * MACH_EPS_D / (1.0 - 3.0 * MACH_EPS_D)));

struct BvhView {
  const float4* nodes;  // [n_nodes * NODE_F4]
  const float4* recs;   // [n_prims * REC_K / 4]
  int flags;            // BVH_FULL_SPH | BVH_FULL_DISK
};

GOPBRT_HD float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

// the robust slab test (bounds.go:149-185; geom.bounds_intersect_p); tn is
// the entry distance
GOPBRT_HD bool box_hit(const float4& a, const float4& b, float ox, float oy, float oz,
                       float ix, float iy, float iz, float t_max, float& tn) {
  const float tx0 = (a.x - ox) * ix, tx1 = (b.x - ox) * ix;
  const float ty0 = (a.y - oy) * iy, ty1 = (b.y - oy) * iy;
  const float tz0 = (a.z - oz) * iz, tz1 = (b.z - oz) * iz;
  tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
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

// A pushed far child: its code and entry distance.
struct StackEntry {
  int code;
  float t;
};

// One ray's walk: the ray, the best t and record row so far (slot -1: none),
// the entry to visit next and the depth of its stack.  The stack itself,
// STACK_DEPTH entries, is a separate array: an array indexed at run time
// inside the struct would keep the whole struct in local memory, and these
// fields belong in registers.
struct Walk {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float best;
  int slot, cur, sp;
};

// Sets up the walk of one ray; false when it ends before a step (a dead
// any-hit lane, or the root's box missed): best is then t_max, slot -1.
template <bool ANY>
GOPBRT_HD bool walk_start(const BvhView& B, Walk& w, float ox, float oy, float oz, float dx,
                          float dy, float dz, float t_max) {
  w.ox = ox; w.oy = oy; w.oz = oz;
  w.dx = dx; w.dy = dy; w.dz = dz;
  w.best = t_max;
  w.slot = -1;
  w.sp = 0;
  if (ANY && t_max <= DEAD_T_MAX) return false;
  w.ix = inv_dir(dx);
  w.iy = inv_dir(dy);
  w.iz = inv_dir(dz);
  const float4 a = ld4(B.nodes), b = ld4(B.nodes + 1);  // the header: the root
  float tn;
  if (!box_hit(a, b, ox, oy, oz, w.ix, w.iy, w.iz, t_max, tn)) return false;
  w.cur = as_int(a.w);
  return true;
}

// Pops to the next entry still closer than the best t; false when none is.
GOPBRT_HD bool pop_next(Walk& w, const StackEntry* stack) {
  while (w.sp > 0) {
    const StackEntry e = stack[--w.sp];
    if (e.t < w.best) {
      w.cur = e.code;
      return true;
    }
  }
  return false;
}

// The interior node w.cur: both children's boxes in one fetch; the near
// child next if its box is hit, the far one pushed (or next) if its box is
// hit, else a pop.  False when the walk is over.
GOPBRT_HD bool interior_node(const BvhView& B, Walk& w, StackEntry* stack) {
  const float4* n = B.nodes + NODE_F4 * w.cur;
  const float4 l0 = ld4(n), l1 = ld4(n + 1), r0 = ld4(n + 2), r1 = ld4(n + 3);
  float tl, tr;
  const bool hl = box_hit(l0, l1, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.best, tl);
  const bool hr = box_hit(r0, r1, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.best, tr);
  const int axis = as_int(l1.w);
  const bool neg = (axis == 0 ? w.ix : (axis == 1 ? w.iy : w.iz)) < 0.0f;
  const bool near_hit = neg ? hr : hl, far_hit = neg ? hl : hr;
  const int near_code = as_int(neg ? r0.w : l0.w), far_code = as_int(neg ? l0.w : r0.w);
  if (near_hit) {
    if (far_hit) {  // clamped at STACK_DEPTH as JAX's _traverse clamps
      stack[w.sp < STACK_DEPTH ? w.sp : STACK_DEPTH - 1] = StackEntry{far_code,
                                                                      neg ? tl : tr};
      w.sp = w.sp < STACK_DEPTH ? w.sp + 1 : STACK_DEPTH;
    }
    w.cur = near_code;
    return true;
  }
  if (far_hit) {
    w.cur = far_code;
    return true;
  }
  return pop_next(w, stack);
}

// The leaf w.cur: its records in order, then a pop.  False when the walk
// is over (ANY: at the end of the leaf of the first hit).
template <bool ANY>
GOPBRT_HD bool leaf_node(const BvhView& B, Walk& w, StackEntry* stack) {
  const int leaf = ~w.cur;
  const int first = leaf >> LEAF_SHIFT, count = leaf & ((1 << LEAF_SHIFT) - 1);
  const bool full_sph = B.flags & BVH_FULL_SPH, full_disk = B.flags & BVH_FULL_DISK;
  for (int k = 0; k < count; ++k) {
    const float tp = record_test(B.recs + (first + k) * (REC_K / 4), w.ox, w.oy, w.oz, w.dx,
                                 w.dy, w.dz, w.best, full_sph, full_disk);
    if (tp < w.best) {
      w.best = tp;
      w.slot = first + k;
    }
  }
  if (ANY && w.slot >= 0) return false;
  return pop_next(w, stack);
}

// One step, while-while (Aila & Laine, HPG 2009): interior nodes until a
// leaf comes next, then that leaf.  The lanes of a warp that reach a leaf
// wait for the others and test their leaves together, where a step of one
// node each would run the interior and the leaf branch one after the
// other.  False when the walk is over.
template <bool ANY>
GOPBRT_HD bool walk_step(const BvhView& B, Walk& w, StackEntry* stack) {
  while (w.cur >= 0)
    if (!interior_node(B, w, stack)) return false;
  return leaf_node<ANY>(B, w, stack);
}

// The whole walk: the nearest hit closer than t_max and its record row
// (slot, -1 and t_max where none is).  ANY: the any hit.
template <bool ANY>
GOPBRT_HD float bvh_walk(const BvhView& B, float ox, float oy, float oz, float dx,
                         float dy, float dz, float t_max, int& slot) {
  Walk w;
  StackEntry stack[STACK_DEPTH];
  if (walk_start<ANY>(B, w, ox, oy, oz, dx, dy, dz, t_max))
    while (walk_step<ANY>(B, w, stack)) {
    }
  slot = w.slot;
  return w.best;
}

}  // namespace gopbrt
