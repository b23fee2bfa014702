// Native BVH builder: multithreaded binned-SAH and HLBVH (Morton radix)
// construction producing the flat LinearBVH layout consumed by the BVH walk
// (gopbrt_tpu_torch/ops/bvh.py, csrc/bvh.cuh).  The code is a copy of
// gopbrt_tpu/native/bvh_builder.cpp, built with the same flags, so both
// packages build the same tree from the same bounds.
//
// Counterpart of the reference's build paths (pkg/accelerator/bvh.go):
//   * RecursiveBuild, 12-bucket binned SAH  (bvh.go:272-411)
//   * HLBVH: 30-bit Morton codes (:89-108), radix sort (:110-161),
//     treelets built in parallel goroutines (:454-483), upper SAH (:550-630)
//   * flattenBVHTree -> LinearBVHNode array (:632-651)
// The reference parallelises the build with goroutines + atomics; here the
// same roles are played by std::async subtree tasks (SAH) / per-treelet
// tasks (HLBVH) over disjoint subranges of one in-place prim-id array, so
// no atomics are needed for the ordered-prim offsets.
//
// C ABI (ctypes-friendly), no exceptions across the boundary.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <future>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Node {
  float lo[3], hi[3];
  int32_t left = -1;   // arena index; -1 for leaf
  int32_t right = -1;  // arena index; -1 for leaf
  int32_t axis = 0;
  int64_t first = 0;  // start into prim_ids (leaf)
  int32_t count = 0;  // >0 leaf
};

struct Arena {
  std::vector<Node> nodes;
  std::atomic<int64_t> next{0};
  explicit Arena(int64_t cap) : nodes(cap) {}
  int32_t alloc() { return static_cast<int32_t>(next.fetch_add(1)); }
};

struct Ctx {
  const float* lo;
  const float* hi;
  std::vector<float> cx, cy, cz;  // centroids, SoA
  int max_leaf;
  int n_buckets;
  int n_threads;
};

inline float surface_area(const float lo[3], const float hi[3]) {
  float dx = std::max(hi[0] - lo[0], 0.f);
  float dy = std::max(hi[1] - lo[1], 0.f);
  float dz = std::max(hi[2] - lo[2], 0.f);
  return 2.f * (dx * dy + dx * dz + dy * dz);
}

inline void grow(float lo[3], float hi[3], const float* plo, const float* phi) {
  for (int k = 0; k < 3; ++k) {
    lo[k] = std::min(lo[k], plo[k]);
    hi[k] = std::max(hi[k], phi[k]);
  }
}

inline void init_bounds(float lo[3], float hi[3]) {
  for (int k = 0; k < 3; ++k) {
    lo[k] = INFINITY;
    hi[k] = -INFINITY;
  }
}

inline float cent(const Ctx& c, int axis, int32_t id) {
  return axis == 0 ? c.cx[id] : (axis == 1 ? c.cy[id] : c.cz[id]);
}

// ---------------------------------------------------------------------------
// Binned SAH (RecursiveBuild semantics, bvh.go:272-411)
// ---------------------------------------------------------------------------

int32_t build_sah(const Ctx& c, Arena& a, int32_t* ids, int64_t s, int64_t e,
                  int depth) {
  int32_t node = a.alloc();
  Node& nd = a.nodes[node];
  init_bounds(nd.lo, nd.hi);
  float clo[3], chi[3];
  init_bounds(clo, chi);
  for (int64_t i = s; i < e; ++i) {
    int32_t id = ids[i];
    grow(nd.lo, nd.hi, c.lo + 3 * id, c.hi + 3 * id);
    float cc[3] = {c.cx[id], c.cy[id], c.cz[id]};
    grow(clo, chi, cc, cc);
  }
  int64_t n = e - s;
  auto make_leaf = [&]() {
    nd.first = s;
    nd.count = static_cast<int32_t>(n);
    return node;
  };
  if (n <= c.max_leaf) return make_leaf();

  float ext[3] = {chi[0] - clo[0], chi[1] - clo[1], chi[2] - clo[2]};
  int axis = 0;
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;
  nd.axis = axis;

  int64_t mid;
  if (ext[axis] < 1e-12f) {
    mid = s + n / 2;  // degenerate: equal counts (bvh.go EqualCounts fallback)
  } else {
    const int nb = c.n_buckets;
    std::vector<int64_t> bcount(nb, 0);
    std::vector<float> blo(3 * nb, INFINITY), bhi(3 * nb, -INFINITY);
    float inv = nb / ext[axis];
    for (int64_t i = s; i < e; ++i) {
      int32_t id = ids[i];
      int b = std::min(static_cast<int>((cent(c, axis, id) - clo[axis]) * inv),
                       nb - 1);
      b = std::max(b, 0);
      bcount[b]++;
      grow(&blo[3 * b], &bhi[3 * b], c.lo + 3 * id, c.hi + 3 * id);
    }
    // sweep costs (bvh.go:357-381)
    std::vector<float> lsa(nb), rsa(nb);
    {
      float lo_[3], hi_[3];
      init_bounds(lo_, hi_);
      int64_t cnt = 0;
      for (int b = 0; b < nb; ++b) {
        grow(lo_, hi_, &blo[3 * b], &bhi[3 * b]);
        cnt += bcount[b];
        lsa[b] = cnt ? surface_area(lo_, hi_) * cnt : 0.f;
      }
      init_bounds(lo_, hi_);
      cnt = 0;
      for (int b = nb - 1; b >= 0; --b) {
        grow(lo_, hi_, &blo[3 * b], &bhi[3 * b]);
        cnt += bcount[b];
        rsa[b] = cnt ? surface_area(lo_, hi_) * cnt : 0.f;
      }
      float best_cost = INFINITY;
      int best = -1;
      float inv_sa = 1.f / std::max(surface_area(nd.lo, nd.hi), 1e-20f);
      for (int b = 0; b < nb - 1; ++b) {
        float cost = 0.125f + (lsa[b] + rsa[b + 1]) * inv_sa;
        if (cost < best_cost) {
          best_cost = cost;
          best = b;
        }
      }
      // n > max_leaf here, so a split is mandatory (leaves are capped at
      // max_leaf — the device traversal unrolls exactly that many slots)
      if (best < 0) {
        mid = s;  // degenerate: forces the equal-counts fallback below
      } else {
        int32_t* split = std::partition(
            ids + s, ids + e, [&](int32_t id) {
              int b = std::min(
                  static_cast<int>((cent(c, axis, id) - clo[axis]) * inv),
                  nb - 1);
              return std::max(b, 0) <= best;
            });
        mid = split - ids;
      }
    }
  }
  if (mid == s || mid == e) {  // still degenerate: equal counts by centroid
    mid = s + n / 2;
    std::nth_element(ids + s, ids + mid, ids + e, [&](int32_t x, int32_t y) {
      return cent(c, axis, x) < cent(c, axis, y);
    });
  }

  int32_t l, r;
  // parallel subtrees near the top (the reference parallelises HLBVH
  // treelets, bvh.go:454-483; for SAH we fork the recursion itself)
  if (depth < 4 && n > 16384 && c.n_threads > 1) {
    auto fut = std::async(std::launch::async, [&]() {
      return build_sah(c, a, ids, s, mid, depth + 1);
    });
    r = build_sah(c, a, ids, mid, e, depth + 1);
    l = fut.get();
  } else {
    l = build_sah(c, a, ids, s, mid, depth + 1);
    r = build_sah(c, a, ids, mid, e, depth + 1);
  }
  Node& nd2 = a.nodes[node];  // re-ref (vector never resizes, but be tidy)
  nd2.left = l;
  nd2.right = r;
  return node;
}

// ---------------------------------------------------------------------------
// HLBVH: Morton + radix sort + treelets + upper SAH (bvh.go:413-630)
// ---------------------------------------------------------------------------

inline uint32_t left_shift3(uint32_t x) {  // bvh.go:89-99
  if (x == (1u << 10)) --x;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

inline uint32_t encode_morton3(float x, float y, float z) {  // bvh.go:101-108
  return (left_shift3(static_cast<uint32_t>(z)) << 2) |
         (left_shift3(static_cast<uint32_t>(y)) << 1) |
         left_shift3(static_cast<uint32_t>(x));
}

// emitLBVH: split on successive Morton bits (bvh.go:494-548)
int32_t emit_lbvh(const Ctx& c, Arena& a, int32_t* ids,
                  const std::vector<uint32_t>& morton, int64_t s, int64_t e,
                  int bit) {
  int64_t n = e - s;
  if (n <= c.max_leaf) {
    int32_t node = a.alloc();
    Node& nd = a.nodes[node];
    init_bounds(nd.lo, nd.hi);
    for (int64_t i = s; i < e; ++i)
      grow(nd.lo, nd.hi, c.lo + 3 * ids[i], c.hi + 3 * ids[i]);
    nd.first = s;
    nd.count = static_cast<int32_t>(n);
    return node;
  }
  if (bit < 0) {
    // identical Morton codes but too many prims for one leaf (the device
    // traversal unrolls max_leaf slots): equal-counts split
    int64_t mid = s + n / 2;
    int32_t node = a.alloc();
    int32_t l = emit_lbvh(c, a, ids, morton, s, mid, bit);
    int32_t r = emit_lbvh(c, a, ids, morton, mid, e, bit);
    Node& nd = a.nodes[node];
    init_bounds(nd.lo, nd.hi);
    grow(nd.lo, nd.hi, a.nodes[l].lo, a.nodes[l].hi);
    grow(nd.lo, nd.hi, a.nodes[r].lo, a.nodes[r].hi);
    nd.left = l;
    nd.right = r;
    nd.axis = 0;
    return node;
  }
  uint32_t mask = 1u << bit;
  if ((morton[ids[s]] & mask) == (morton[ids[e - 1]] & mask))
    return emit_lbvh(c, a, ids, morton, s, e, bit - 1);
  // binary search the split point (ids sorted by morton)
  int64_t lo = s, hi = e - 1;
  while (lo + 1 < hi) {
    int64_t mid = (lo + hi) / 2;
    if ((morton[ids[s]] & mask) == (morton[ids[mid]] & mask))
      lo = mid;
    else
      hi = mid;
  }
  int64_t split = hi;
  int32_t node = a.alloc();
  int32_t l = emit_lbvh(c, a, ids, morton, s, split, bit - 1);
  int32_t r = emit_lbvh(c, a, ids, morton, split, e, bit - 1);
  Node& nd = a.nodes[node];
  init_bounds(nd.lo, nd.hi);
  grow(nd.lo, nd.hi, a.nodes[l].lo, a.nodes[l].hi);
  grow(nd.lo, nd.hi, a.nodes[r].lo, a.nodes[r].hi);
  nd.left = l;
  nd.right = r;
  nd.axis = bit % 3;
  return node;
}

// upper SAH over treelet roots (bvh.go:550-630): recursive 12-bucket
// binned SAH with the treelet roots as "primitives" (bucket fill + cost
// sweep mirroring bvh.go:578-616); degenerate splits (all roots in one
// bucket) fall back to a median partition.
int32_t build_upper(const Ctx& c, Arena& a, std::vector<int32_t>& roots,
                    int64_t s, int64_t e) {
  if (e - s == 1) return roots[s];
  int32_t node = a.alloc();
  Node& nd = a.nodes[node];
  init_bounds(nd.lo, nd.hi);
  float clo[3], chi[3];
  init_bounds(clo, chi);
  for (int64_t i = s; i < e; ++i) {
    const Node& rn = a.nodes[roots[i]];
    grow(nd.lo, nd.hi, rn.lo, rn.hi);
    float cc[3] = {0.5f * (rn.lo[0] + rn.hi[0]), 0.5f * (rn.lo[1] + rn.hi[1]),
                   0.5f * (rn.lo[2] + rn.hi[2])};
    grow(clo, chi, cc, cc);
  }
  float ext[3] = {chi[0] - clo[0], chi[1] - clo[1], chi[2] - clo[2]};
  int axis = 0;
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;
  nd.axis = axis;

  constexpr int kBuckets = 12;
  auto centroid = [&](int32_t root) {
    const Node& rn = a.nodes[root];
    return 0.5f * (rn.lo[axis] + rn.hi[axis]);
  };
  auto bucket_of = [&](int32_t root) {
    float rel = (centroid(root) - clo[axis]) /
                (ext[axis] > 0.f ? ext[axis] : 1.f);
    int b = static_cast<int>(kBuckets * rel);
    return b < 0 ? 0 : (b >= kBuckets ? kBuckets - 1 : b);
  };
  struct Bucket {
    int64_t count = 0;
    float lo[3], hi[3];
  };
  Bucket buckets[kBuckets];
  for (auto& b : buckets) init_bounds(b.lo, b.hi);
  for (int64_t i = s; i < e; ++i) {
    Bucket& b = buckets[bucket_of(roots[i])];
    b.count++;
    const Node& rn = a.nodes[roots[i]];
    grow(b.lo, b.hi, rn.lo, rn.hi);
  }
  // SAH cost of splitting after bucket k: area-weighted child counts
  float best_cost = std::numeric_limits<float>::max();
  int best_split = -1;
  for (int k = 0; k < kBuckets - 1; ++k) {
    float llo[3], lhi[3], rlo[3], rhi[3];
    init_bounds(llo, lhi);
    init_bounds(rlo, rhi);
    int64_t nl = 0, nr = 0;
    for (int j = 0; j <= k; ++j)
      if (buckets[j].count) {
        nl += buckets[j].count;
        grow(llo, lhi, buckets[j].lo, buckets[j].hi);
      }
    for (int j = k + 1; j < kBuckets; ++j)
      if (buckets[j].count) {
        nr += buckets[j].count;
        grow(rlo, rhi, buckets[j].lo, buckets[j].hi);
      }
    if (nl == 0 || nr == 0) continue;
    float cost = 0.125f + (nl * surface_area(llo, lhi) +
                           nr * surface_area(rlo, rhi)) /
                              surface_area(nd.lo, nd.hi);
    if (cost < best_cost) {
      best_cost = cost;
      best_split = k;
    }
  }
  int64_t mid;
  if (best_split >= 0) {
    auto it = std::partition(roots.begin() + s, roots.begin() + e,
                             [&](int32_t x) {
                               return bucket_of(x) <= best_split;
                             });
    mid = it - roots.begin();
  } else {
    // every root landed in one bucket: median fallback
    mid = s + (e - s) / 2;
    std::nth_element(roots.begin() + s, roots.begin() + mid,
                     roots.begin() + e, [&](int32_t x, int32_t y) {
                       return centroid(x) < centroid(y);
                     });
  }
  int32_t l = build_upper(c, a, roots, s, mid);
  int32_t r = build_upper(c, a, roots, mid, e);
  Node& nd2 = a.nodes[node];
  nd2.left = l;
  nd2.right = r;
  return node;
}

int32_t build_hlbvh(const Ctx& c, Arena& a, int32_t* ids, int64_t n) {
  // centroid bounds -> 10-bit quantized morton codes (bvh.go:419-428)
  float clo[3], chi[3];
  init_bounds(clo, chi);
  for (int64_t i = 0; i < n; ++i) {
    float cc[3] = {c.cx[i], c.cy[i], c.cz[i]};
    grow(clo, chi, cc, cc);
  }
  const float scale = 1024.f;
  std::vector<uint32_t> morton(n);
  for (int64_t i = 0; i < n; ++i) {
    float inv[3];
    for (int k = 0; k < 3; ++k) {
      float d = chi[k] - clo[k];
      inv[k] = d > 0 ? scale / d : 0.f;
    }
    int32_t id = ids[i];
    morton[id] = encode_morton3(
        std::min((c.cx[id] - clo[0]) * inv[0], scale - 1),
        std::min((c.cy[id] - clo[1]) * inv[1], scale - 1),
        std::min((c.cz[id] - clo[2]) * inv[2], scale - 1));
  }
  // LSD radix sort by morton key, 8 bits/pass x 4 (bvh.go:110-161 uses 6x5)
  {
    std::vector<int32_t> tmp(n);
    int32_t* src = ids;
    int32_t* dst = tmp.data();
    for (int pass = 0; pass < 4; ++pass) {
      int shift = 8 * pass;
      int64_t count[257] = {0};
      for (int64_t i = 0; i < n; ++i)
        count[((morton[src[i]] >> shift) & 0xFF) + 1]++;
      for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
      for (int64_t i = 0; i < n; ++i)
        dst[count[(morton[src[i]] >> shift) & 0xFF]++] = src[i];
      std::swap(src, dst);
    }
    if (src != ids) std::memcpy(ids, src, n * sizeof(int32_t));
  }
  // treelets: group by top 12 bits (bvh.go:438-452), build in parallel
  struct Treelet {
    int64_t s, e;
    int32_t root = -1;
  };
  std::vector<Treelet> treelets;
  int64_t start = 0;
  for (int64_t i = 1; i <= n; ++i) {
    uint32_t maskbits = 0x3FFC0000u;
    if (i == n || ((morton[ids[start]] ^ morton[ids[i]]) & maskbits)) {
      treelets.push_back({start, i, -1});
      start = i;
    }
  }
  const int first_bit = 29 - 12;  // bits below the treelet prefix
  std::atomic<size_t> cursor{0};
  int nthreads = std::max(1, std::min<int>(c.n_threads,
                                           (int)treelets.size()));
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        size_t i = cursor.fetch_add(1);
        if (i >= treelets.size()) return;
        treelets[i].root = emit_lbvh(c, a, ids, morton, treelets[i].s,
                                     treelets[i].e, first_bit);
      }
    });
  }
  for (auto& th : pool) th.join();
  std::vector<int32_t> roots(treelets.size());
  for (size_t i = 0; i < treelets.size(); ++i) roots[i] = treelets[i].root;
  return build_upper(c, a, roots, 0, static_cast<int64_t>(roots.size()));
}

// ---------------------------------------------------------------------------
// Flatten (flattenBVHTree, bvh.go:632-651): depth-first, left = node+1
// ---------------------------------------------------------------------------

struct Flat {
  float* node_lo;
  float* node_hi;
  int32_t* node_right;
  int32_t* node_first;
  int32_t* node_count;
  int32_t* node_axis;
  int64_t next = 0;
};

int32_t flatten(const Arena& a, Flat& f, int32_t node) {
  const Node& nd = a.nodes[node];
  int32_t out = static_cast<int32_t>(f.next++);
  std::memcpy(f.node_lo + 3 * out, nd.lo, 3 * sizeof(float));
  std::memcpy(f.node_hi + 3 * out, nd.hi, 3 * sizeof(float));
  f.node_axis[out] = nd.axis;
  if (nd.count > 0) {
    f.node_right[out] = -1;
    f.node_first[out] = static_cast<int32_t>(nd.first);
    f.node_count[out] = nd.count;
  } else {
    f.node_count[out] = 0;
    f.node_first[out] = 0;
    flatten(a, f, nd.left);  // == out + 1
    f.node_right[out] = flatten(a, f, nd.right);
  }
  return out;
}

}  // namespace

extern "C" {

// Returns the node count written, or -1 on invalid input.
// Output arrays must have capacity 2*n nodes (node_lo/hi: 6*n floats).
int64_t gopbrt_bvh_build(const float* lo, const float* hi, int64_t n,
                         int32_t max_leaf, int32_t n_buckets,
                         int32_t n_threads, int32_t method, float* node_lo,
                         float* node_hi, int32_t* node_right,
                         int32_t* node_first, int32_t* node_count,
                         int32_t* node_axis, int32_t* prim_order) {
  if (n <= 0 || max_leaf < 1 || n_buckets < 2) return -1;
  Ctx c;
  c.lo = lo;
  c.hi = hi;
  c.max_leaf = max_leaf;
  c.n_buckets = n_buckets;
  c.n_threads = n_threads > 0
                    ? n_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  c.cx.resize(n);
  c.cy.resize(n);
  c.cz.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    c.cx[i] = 0.5f * (lo[3 * i] + hi[3 * i]);
    c.cy[i] = 0.5f * (lo[3 * i + 1] + hi[3 * i + 1]);
    c.cz[i] = 0.5f * (lo[3 * i + 2] + hi[3 * i + 2]);
  }
  for (int64_t i = 0; i < n; ++i) prim_order[i] = static_cast<int32_t>(i);

  Arena a(2 * n);
  int32_t root;
  if (method == 1 && n > 4) {
    root = build_hlbvh(c, a, prim_order, n);
  } else {
    root = build_sah(c, a, prim_order, 0, n, 0);
  }
  Flat f{node_lo, node_hi, node_right, node_first, node_count, node_axis};
  flatten(a, f, root);
  return f.next;
}

int32_t gopbrt_native_abi_version() { return 1; }

}  // extern "C"
