// CPU baseline tracer: a faithful reimplementation of the Go reference's
// demo workload (internal/render/server.go:30-164), which measures the CPU
// baseline the benchmarks divide by (BASELINE.md), and an independent
// tracer of any golden config's scene tables.  The code is a copy of
// gopbrt_tpu/native/cpu_baseline.cpp, built with the same flags by
// gopbrt_tpu_torch/native/baseline.py, so both packages are held against
// the same reference.
//
// Workload parity with the reference:
//   * scene: 21 matte spheres + 2 giant checker disks + sphere area light
//     (server.go:32-102), 4 lights (distant + 2 point + area,
//     server.go:106-130)
//   * BVH: binned/median build, maxPrims=2, iterative 64-deep-stack
//     traversal with near-child-first ordering (bvh.go:223-265, 659-765)
//   * integrator: depth-10 path, NEE with one uniformly picked light +
//     power-heuristic MIS on area-light hits, Russian roulette after 3
//     bounces with q = max(.05, 1-maxComp(beta)) (path.go:32-157,
//     integrator.go:48-195)
//   * camera: perspective raster->camera->world chain, matrices passed in
//     from the Python camera builder (camera.go:106-190)
//
// This is written as straightforward C++ (scalar, no SIMD intrinsics) so it
// measures the algorithm, not hand-tuning; per-core it is, if anything,
// FASTER than the Go original (no interface dispatch, no []float64 heap
// allocation per Spectrum op, no GC), i.e. the derived baseline is generous
// to the reference.
//
// Usage (demo mode):    cpu_baseline W H SPP DEPTH THREADS r2c[16] c2w[16]
// Usage (generic mode): cpu_baseline --scene DUMP W H SPP DEPTH THREADS
//                                    [path|direct]
//
// GENERIC MODE: loads a scene dump written by
// gopbrt_tpu_torch/native/baseline.export_scene (primitive/material/light
// tables flattened
// exactly as the renderer's own device tables) and traces it with an
// INDEPENDENT scalar implementation of the reference's algorithms — BVH
// (bvh.go:223-265,659-765), path/direct integrators with NEE + power-
// heuristic MIS (path.go:32-157, integrator.go:48-195,
// directlighting.go:62-101), matte/mirror/smooth-glass/plastic BSDFs
// (reflection.go:188-253,465-574; microfacet.go) — so every golden config
// (1-4) gets a cross-check that shares scene DATA but no renderer code.
// Prints one JSON line with rays/s + mean luminance; set
// GOPBRT_BASELINE_DUMP=<file> to dump raw radiance for region comparison.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

struct V3 {
  float x, y, z;
};
static inline V3 v3(float x, float y, float z) { return {x, y, z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float len(V3 a) { return std::sqrt(dot(a, a)); }
static inline V3 norm(V3 a) { float l = len(a); return a * (1.0f / l); }
static inline float maxc(V3 a) { return std::fmax(a.x, std::fmax(a.y, a.z)); }

// PCG32 (pkg/pbrt/rng.go:5-57)
struct Pcg32 {
  uint64_t state = 0x853c49e6748fea9bULL, inc = 0xda3e39cb94b95bdbULL;
  void seed(uint64_t s, uint64_t seq) {
    state = 0; inc = (seq << 1u) | 1u; next(); state += s; next();
  }
  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + inc;
    uint32_t xs = (uint32_t)(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = (uint32_t)(old >> 59u);
    return (xs >> rot) | (xs << ((~rot + 1u) & 31));
  }
  float uf() { return std::fmin((float)next() * 2.3283064365386963e-10f, 0.99999994f); }
};

// --- primitives: sphere (full) and z=h disk, matte only ------------------
enum PType { SPH = 0, DSK = 1 };
struct Prim {
  int type;
  V3 c;          // sphere center / disk center
  float radius;
  int axis;      // disk world plane axis: 1 = y-plane floor, 2 = z backdrop
  float plane;   // disk world plane offset along `axis`
  V3 kd;         // matte albedo (disks: checker evaluated at hit)
  bool checker;
  int area_light;  // -1 or light index
};

struct Hit {
  float t;
  int prim;
  V3 p, n;
};

static inline bool sphere_hit(const Prim& s, V3 o, V3 d, float tmax, float* t) {
  // recentred quadratic (same math class as sphere.go:64-96's EFloat solve)
  V3 oc = o - s.c;
  float b = dot(oc, d), c = dot(oc, oc) - s.radius * s.radius;
  float disc = b * b - c;
  if (disc < 0) return false;
  float sq = std::sqrt(disc);
  float t0 = -b - sq, t1 = -b + sq;
  float eps = 1e-3f;
  float tt = t0 > eps ? t0 : (t1 > eps ? t1 : -1.0f);
  if (tt <= eps || tt >= tmax) return false;
  *t = tt;
  return true;
}

// demo disks (server.go:86-102): one rotated into the XZ plane (floor,
// axis=1) and one left in the XY plane (vertical backdrop at z=-50, axis=2)
static inline bool disk_hit(const Prim& s, V3 o, V3 d, float tmax, float* t) {
  float dn = s.axis == 1 ? d.y : d.z;
  float on = s.axis == 1 ? o.y : o.z;
  if (std::fabs(dn) < 1e-9f) return false;
  float tt = (s.plane - on) / dn;
  if (tt <= 1e-3f || tt >= tmax) return false;
  V3 p = o + d * tt;
  float du, dv;
  if (s.axis == 1) { du = p.x - s.c.x; dv = p.z - s.c.z; }
  else { du = p.x - s.c.x; dv = p.y - s.c.y; }
  if (du * du + dv * dv > s.radius * s.radius) return false;
  *t = tt;
  return true;
}

// --- BVH (maxPrims=2, bvh.go:223-265 build / 659-765 traversal) ----------
struct BVHNode {
  V3 lo, hi;
  int left, right;   // children (-1 for leaf)
  int first, count;  // leaf prim range
};

struct Scene {
  std::vector<Prim> prims;
  std::vector<BVHNode> nodes;
  std::vector<int> order;
  int root;

  void prim_bounds(int i, V3* lo, V3* hi) const {
    const Prim& p = prims[i];
    if (p.type == SPH) {
      *lo = p.c - v3(p.radius, p.radius, p.radius);
      *hi = p.c + v3(p.radius, p.radius, p.radius);
    } else if (p.axis == 1) {
      *lo = v3(p.c.x - p.radius, p.plane - 1e-3f, p.c.z - p.radius);
      *hi = v3(p.c.x + p.radius, p.plane + 1e-3f, p.c.z + p.radius);
    } else {
      *lo = v3(p.c.x - p.radius, p.c.y - p.radius, p.plane - 1e-3f);
      *hi = v3(p.c.x + p.radius, p.c.y + p.radius, p.plane + 1e-3f);
    }
  }

  int build(int first, int count) {
    BVHNode n;
    n.lo = v3(1e30f, 1e30f, 1e30f);
    n.hi = v3(-1e30f, -1e30f, -1e30f);
    for (int i = 0; i < count; i++) {
      V3 lo, hi;
      prim_bounds(order[first + i], &lo, &hi);
      n.lo = v3(std::fmin(n.lo.x, lo.x), std::fmin(n.lo.y, lo.y), std::fmin(n.lo.z, lo.z));
      n.hi = v3(std::fmax(n.hi.x, hi.x), std::fmax(n.hi.y, hi.y), std::fmax(n.hi.z, hi.z));
    }
    if (count <= 2) {
      n.left = n.right = -1;
      n.first = first; n.count = count;
      nodes.push_back(n);
      return (int)nodes.size() - 1;
    }
    V3 ext = n.hi - n.lo;
    int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
    auto cen = [&](int pi) {
      V3 lo, hi; prim_bounds(pi, &lo, &hi);
      V3 c = (lo + hi) * 0.5f;
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    // median split (EqualCounts; adequate at 24 prims — same traversal cost
    // class as the reference's 12-bucket SAH at this scale)
    std::vector<int> tmp(order.begin() + first, order.begin() + first + count);
    std::sort(tmp.begin(), tmp.end(), [&](int a, int b) { return cen(a) < cen(b); });
    std::copy(tmp.begin(), tmp.end(), order.begin() + first);
    int mid = count / 2;
    int self = (int)nodes.size();
    nodes.push_back(n);  // placeholder
    int l = build(first, mid);
    int r = build(first + mid, count - mid);
    nodes[self].left = l; nodes[self].right = r;
    nodes[self].first = -1; nodes[self].count = 0;
    return self;
  }

  void finalize() {
    order.resize(prims.size());
    for (size_t i = 0; i < prims.size(); i++) order[i] = (int)i;
    root = build(0, (int)prims.size());
  }

  static inline bool slab(const BVHNode& n, V3 o, V3 inv, float tmax) {
    float t0 = 1e-4f, t1 = tmax;
    float a = (n.lo.x - o.x) * inv.x, b = (n.hi.x - o.x) * inv.x;
    if (a > b) std::swap(a, b);
    t0 = std::fmax(t0, a); t1 = std::fmin(t1, b);
    a = (n.lo.y - o.y) * inv.y; b = (n.hi.y - o.y) * inv.y;
    if (a > b) std::swap(a, b);
    t0 = std::fmax(t0, a); t1 = std::fmin(t1, b);
    a = (n.lo.z - o.z) * inv.z; b = (n.hi.z - o.z) * inv.z;
    if (a > b) std::swap(a, b);
    t0 = std::fmax(t0, a); t1 = std::fmin(t1, b);
    return t0 <= t1;
  }

  bool intersect(V3 o, V3 d, Hit* h, bool any, float tmax) const {
    V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    int stack[64];
    int sp = 0;
    stack[sp++] = root;
    float best = tmax;
    int best_prim = -1;
    while (sp > 0) {
      const BVHNode& n = nodes[stack[--sp]];
      if (!slab(n, o, inv, best)) continue;
      if (n.left < 0) {
        for (int i = 0; i < n.count; i++) {
          int pi = order[n.first + i];
          const Prim& p = prims[pi];
          float t;
          bool ok = p.type == SPH ? sphere_hit(p, o, d, best, &t)
                                  : disk_hit(p, o, d, best, &t);
          if (ok) {
            best = t; best_prim = pi;
            if (any) return true;
          }
        }
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    if (best_prim < 0) return false;
    h->t = best; h->prim = best_prim;
    h->p = o + d * best;
    const Prim& p = prims[best_prim];
    h->n = p.type == SPH ? norm(h->p - p.c)
                         : (p.axis == 1 ? v3(0, 1, 0) : v3(0, 0, 1));
    if (dot(h->n, d) > 0) h->n = h->n * -1.0f;
    return true;
  }
};

// --- lights (server.go:106-130) -------------------------------------------
enum LType { L_DISTANT = 0, L_POINT = 1, L_AREA = 2 };
struct Light {
  int type;
  V3 p_or_dir;  // point position / distant direction (toward light)
  V3 intensity; // I or L
  float radius; // area sphere radius
};

struct SceneLights {
  std::vector<Light> lights;
};

// ===========================================================================
// Generic scene-dump mode (configs 1-4 cross-validation)
// ===========================================================================

static inline V3 xf_p34(const float* m, V3 p) {
  return v3(m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
            m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
            m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]);
}
static inline V3 xf_v34(const float* m, V3 p) {
  return v3(m[0] * p.x + m[1] * p.y + m[2] * p.z,
            m[4] * p.x + m[5] * p.y + m[6] * p.z,
            m[8] * p.x + m[9] * p.y + m[10] * p.z);
}
static inline V3 xf_vT34(const float* m, V3 p) {  // w2o^T: normal to world
  return v3(m[0] * p.x + m[4] * p.y + m[8] * p.z,
            m[1] * p.x + m[5] * p.y + m[9] * p.z,
            m[2] * p.x + m[6] * p.y + m[10] * p.z);
}

// material record: mat_type + the 28 _MS_* columns of
// ops/pallas_mesh_megakernel._mat_shade_np (same flattening the TPU
// kernels consume; indices mirror the _MS_* constants)
struct GMat {
  int type;      // 0 matte, 1 mirror, 2 glass, 3 plastic
  float ms[28];
};
enum { MS_C1 = 0, MS_C2 = 3, MS_CHK = 6, MS_VS = 7, MS_VT = 10, MS_DS = 13,
       MS_MIR = 17, MS_KS = 18, MS_GLS = 21, MS_KT = 22, MS_ETA = 25,
       MS_PLA = 26, MS_ALPHA = 27 };

// light record: type + position/dir + intensity + the 8 _LA_* aux columns
// (two_sided, sphere center, radius, power weight)
struct GLight {
  int type;  // 0 point, 1 distant (p = incoming dir), 2 sphere area
  V3 p, I;
  float aux[8];
};
enum { LA_TWO = 0, LA_CX = 1, LA_RAD = 4 };

struct GPrim {
  int type;  // 0 sphere, 1 disk, 2 triangle
  float w2o[12];
  float par[9];
  int mat, alid;
  V3 lo, hi;  // world bounds (exported)
};

struct GHit {
  float t;
  int prim;
  V3 p, n;
};

struct GScene {
  std::vector<GPrim> prims;
  std::vector<GMat> mats;
  std::vector<GLight> lights;
  float r2c[16], c2w[16];
  float world_radius = 100.0f;

  std::vector<BVHNode> nodes;
  std::vector<int> order;
  int root = 0;

  // --- median-split BVH over exported world bounds (bvh.go:223-265) ----
  int build(int first, int count) {
    BVHNode n;
    n.lo = v3(1e30f, 1e30f, 1e30f);
    n.hi = v3(-1e30f, -1e30f, -1e30f);
    for (int i = 0; i < count; i++) {
      const GPrim& p = prims[order[first + i]];
      n.lo = v3(std::fmin(n.lo.x, p.lo.x), std::fmin(n.lo.y, p.lo.y),
                std::fmin(n.lo.z, p.lo.z));
      n.hi = v3(std::fmax(n.hi.x, p.hi.x), std::fmax(n.hi.y, p.hi.y),
                std::fmax(n.hi.z, p.hi.z));
    }
    if (count <= 2) {
      n.left = n.right = -1;
      n.first = first;
      n.count = count;
      nodes.push_back(n);
      return (int)nodes.size() - 1;
    }
    V3 ext = n.hi - n.lo;
    int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
    auto cen = [&](int pi) {
      V3 c = (prims[pi].lo + prims[pi].hi) * 0.5f;
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    std::vector<int> tmp(order.begin() + first, order.begin() + first + count);
    std::sort(tmp.begin(), tmp.end(),
              [&](int a, int b) { return cen(a) < cen(b); });
    std::copy(tmp.begin(), tmp.end(), order.begin() + first);
    int mid = count / 2;
    int self = (int)nodes.size();
    nodes.push_back(n);
    int l = build(first, mid);
    int r = build(first + mid, count - mid);
    nodes[self].left = l;
    nodes[self].right = r;
    nodes[self].first = -1;
    nodes[self].count = 0;
    return self;
  }

  void finalize() {
    order.resize(prims.size());
    for (size_t i = 0; i < prims.size(); i++) order[i] = (int)i;
    root = build(0, (int)prims.size());
  }

  bool prim_hit(const GPrim& p, V3 o, V3 d, float tmax, float* t) const {
    if (p.type == 2) {
      // Moller-Trumbore on world verts (triangle.go:79-130)
      V3 v0 = v3(p.par[0], p.par[1], p.par[2]);
      V3 e1 = v3(p.par[3], p.par[4], p.par[5]) - v0;
      V3 e2 = v3(p.par[6], p.par[7], p.par[8]) - v0;
      V3 pv = cross(d, e2);
      float det = dot(e1, pv);
      if (std::fabs(det) < 1e-12f) return false;
      float inv = 1.0f / det;
      V3 tv = o - v0;
      float u = dot(tv, pv) * inv;
      if (u < 0 || u > 1) return false;
      V3 qv = cross(tv, e1);
      float v = dot(d, qv) * inv;
      if (v < 0 || u + v > 1) return false;
      float tt = dot(e2, qv) * inv;
      if (tt <= 1e-4f || tt >= tmax) return false;
      *t = tt;
      return true;
    }
    V3 oo = xf_p34(p.w2o, o), od = xf_v34(p.w2o, d);
    if (p.type == 0) {
      // full sphere, radius par[0]: general quadratic in the world-t
      // parameterization (od unnormalized keeps t in world units)
      float r = p.par[0];
      float a = dot(od, od), b = dot(oo, od), c = dot(oo, oo) - r * r;
      float disc = b * b - a * c;
      if (disc < 0 || a == 0) return false;
      float sq = std::sqrt(disc);
      float t0 = (-b - sq) / a, t1 = (-b + sq) / a;
      float eps = 1e-3f;
      float tt = t0 > eps ? t0 : (t1 > eps ? t1 : -1.0f);
      if (tt <= eps || tt >= tmax) return false;
      *t = tt;
      return true;
    }
    // full disk: plane z = par[0] (height), radius par[1], inner par[2]
    if (std::fabs(od.z) < 1e-12f) return false;
    float tt = (p.par[0] - oo.z) / od.z;
    if (tt <= 1e-3f || tt >= tmax) return false;
    V3 ph = oo + od * tt;
    float r2 = ph.x * ph.x + ph.y * ph.y;
    if (r2 > p.par[1] * p.par[1] || r2 < p.par[2] * p.par[2]) return false;
    *t = tt;
    return true;
  }

  bool intersect(V3 o, V3 d, GHit* h, bool any, float tmax) const {
    V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    int stack[64];
    int sp = 0;
    stack[sp++] = root;
    float best = tmax;
    int best_prim = -1;
    while (sp > 0) {
      const BVHNode& n = nodes[stack[--sp]];
      if (!Scene::slab(n, o, inv, best)) continue;
      if (n.left < 0) {
        for (int i = 0; i < n.count; i++) {
          int pi = order[n.first + i];
          float t;
          if (prim_hit(prims[pi], o, d, best, &t)) {
            best = t;
            best_prim = pi;
            if (any) {
              h->t = t;
              h->prim = pi;
              return true;
            }
          }
        }
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    if (best_prim < 0) return false;
    const GPrim& p = prims[best_prim];
    h->t = best;
    h->prim = best_prim;
    h->p = o + d * best;
    if (p.type == 2) {
      V3 v0 = v3(p.par[0], p.par[1], p.par[2]);
      V3 e1 = v3(p.par[3], p.par[4], p.par[5]) - v0;
      V3 e2 = v3(p.par[6], p.par[7], p.par[8]) - v0;
      h->n = norm(cross(e1, e2));
    } else {
      V3 oo = xf_p34(p.w2o, o), od = xf_v34(p.w2o, d);
      V3 po = oo + od * best;
      V3 no = p.type == 0 ? po : v3(0, 0, 1);
      h->n = norm(xf_vT34(p.w2o, no));
    }
    return true;
  }
};

// --- BSDF/lighting math (independent reimplementation of the semantics
// in reflection.go / microfacet.go / sphere.go; NOT shared with the JAX
// renderer) ----------------------------------------------------------------

static inline float fresnel_diel(float ci, float eta) {
  ci = std::fmax(-1.0f, std::fmin(1.0f, ci));
  float ei = 1.0f, et = eta;
  if (ci <= 0) { std::swap(ei, et); ci = -ci; }
  float si = std::sqrt(std::fmax(0.0f, 1 - ci * ci));
  float st = ei / et * si;
  if (st >= 1) return 1.0f;
  float ct = std::sqrt(std::fmax(0.0f, 1 - st * st));
  float rp = (et * ci - ei * ct) / std::fmax(et * ci + ei * ct, 1e-20f);
  float rs = (ei * ci - et * ct) / std::fmax(ei * ci + et * ct, 1e-20f);
  return 0.5f * (rp * rp + rs * rs);
}

static inline float ggx_d(float c, float alpha) {
  float c2 = c * c;
  if (c2 <= 1e-16f) return 0.0f;
  float t2 = (1 - c2) / c2, a2 = alpha * alpha;
  float e = t2 / a2;
  return 1.0f / ((float)M_PI * a2 * c2 * c2 * (1 + e) * (1 + e) + 1e-20f);
}

static inline float ggx_lambda(float c, float alpha) {
  float c2 = std::fmax(c * c, 1e-20f);
  float at = std::sqrt(std::fmax(0.0f, 1 - c2) / c2);
  float a2t2 = alpha * at * alpha * at;
  return (-1 + std::sqrt(1 + a2t2)) / 2;
}

// GGX reflection term of the plastic lobe (reflection.go:670-736 class):
// returns spec scalar and half-vector pdf, both 0 when degenerate
static inline void plastic_spec(V3 wo, V3 wi, V3 n, float eta, float alpha,
                                float co, float ci, float* spec, float* mpdf) {
  V3 wh = wi + wo;
  float wh2 = dot(wh, wh);
  wh = wh * (1.0f / std::sqrt(std::fmax(wh2, 1e-20f)));
  float cwh = dot(wh, n);
  float sgn = cwh < 0 ? -1.0f : 1.0f;
  float fr = fresnel_diel(dot(wi, wh * sgn), eta);
  float dterm = ggx_d(cwh, alpha);
  float g = 1.0f / (1 + ggx_lambda(co, alpha) + ggx_lambda(ci, alpha));
  float aco = std::fabs(co), aci = std::fabs(ci);
  bool same = co * ci > 0;
  bool degen = aco < 1e-7f || aci < 1e-7f || wh2 < 1e-14f;
  *spec = (same && !degen)
              ? fr * dterm * g / std::fmax(4 * aco * aci, 1e-7f)
              : 0.0f;
  float doh = dot(wo, wh);
  *mpdf = same ? dterm * std::fabs(cwh) / std::fmax(4 * std::fabs(doh), 1e-7f)
               : 0.0f;
}

static inline float power_h(float a, float b) {
  return a * a / std::fmax(a * a + b * b, 1e-30f);
}

// cone pdf of a sphere emitter seen from p (sphere.go:346-365 PdfWi class)
static inline float sphere_pdf_li(V3 p, V3 c, float rad) {
  V3 to = c - p;
  float d2 = dot(to, to);
  if (d2 <= rad * rad * 1.0001f) {  // inside: not hit by the configs
    return 1.0f / (4 * (float)M_PI);
  }
  float st2 = rad * rad / d2;
  float ct = std::sqrt(std::fmax(0.0f, 1 - st2));
  return 1.0f / (2 * (float)M_PI * (1 - std::fmin(ct, 1.0f - 1e-7f)));
}

static inline void onb(V3 wz, V3* wx, V3* wy) {
  V3 a = std::fabs(wz.x) < 0.9f ? v3(1, 0, 0) : v3(0, 1, 0);
  *wx = norm(cross(a, wz));
  *wy = cross(wz, *wx);
}

// one path (or direct-lighting chain when `direct`): the scalar
// counterpart of models/integrators._li_jnp / li_direct semantics
static V3 g_trace(const GScene& S, V3 o, V3 d, int depth, bool direct,
                  Pcg32& rng) {
  V3 beta = v3(1, 1, 1), L = v3(0, 0, 0);
  bool spec = true;        // previous scatter was specular / camera
  bool dying = false;      // direct mode: emitter-MIS check only, then stop
  float prev_pdf = 0.0f;
  float es = 1.0f;         // etaScale (path.go:121-127)
  int nl = (int)S.lights.size();
  for (int b = 0; b < depth; b++) {
    GHit h;
    if (!S.intersect(o, d, &h, false, 1e30f)) break;
    const GPrim& pr = S.prims[h.prim];
    const GMat& mt = S.mats[pr.mat];
    V3 wo = norm(d * -1.0f);
    float cos_o = dot(wo, h.n);

    // emitted radiance (path.go:48-63 + MIS with the NEE estimate)
    if (pr.alid >= 0 && nl > 0) {
      const GLight& al = S.lights[pr.alid];
      bool on = al.aux[LA_TWO] > 0.5f || cos_o > 0;
      if (on) {
        float w = 1.0f;
        if (!spec) {
          float lpdf = sphere_pdf_li(
              o, v3(al.aux[LA_CX], al.aux[LA_CX + 1], al.aux[LA_CX + 2]),
              al.aux[LA_RAD]);
          w = power_h(prev_pdf, lpdf / nl);
        }
        L = L + beta * al.I * w;
      }
    }
    if (dying) break;

    // kd with planar checker (texture.go:9-46 + checkerboard.go)
    V3 kd = v3(mt.ms[MS_C1], mt.ms[MS_C1 + 1], mt.ms[MS_C1 + 2]);
    if (mt.ms[MS_CHK] > 0.5f) {
      float s = mt.ms[MS_DS] + h.p.x * mt.ms[MS_VS] +
                h.p.y * mt.ms[MS_VS + 1] + h.p.z * mt.ms[MS_VS + 2];
      float t = mt.ms[MS_DS + 1] + h.p.x * mt.ms[MS_VT] +
                h.p.y * mt.ms[MS_VT + 1] + h.p.z * mt.ms[MS_VT + 2];
      long long par = (long long)std::floor(s) + (long long)std::floor(t);
      if (((par % 2) + 2) % 2 != 0)
        kd = v3(mt.ms[MS_C2], mt.ms[MS_C2 + 1], mt.ms[MS_C2 + 2]);
    }
    bool is_mir = mt.type == 1, is_gls = mt.type == 2, is_pla = mt.type == 3;
    float eta = std::fmax(mt.ms[MS_ETA], 1e-3f);
    float alpha = std::fmax(mt.ms[MS_ALPHA], 1e-3f);
    V3 ks = v3(mt.ms[MS_KS], mt.ms[MS_KS + 1], mt.ms[MS_KS + 2]);

    // NEE: one uniformly picked light (integrator.go:48-195)
    if (nl > 0 && !is_mir && !is_gls) {
      int li = (int)(rng.uf() * nl);
      if (li >= nl) li = nl - 1;
      const GLight& lt = S.lights[li];
      V3 wi;
      float dist = 0, lpdf = 1;
      V3 Li = lt.I;
      bool delta = true, lok = true;
      if (lt.type == 0) {
        V3 to = lt.p - h.p;
        float d2 = dot(to, to);
        dist = std::sqrt(d2);
        wi = to * (1.0f / dist);
        Li = Li * (1.0f / std::fmax(d2, 1e-12f));
      } else if (lt.type == 1) {
        wi = lt.p;
        dist = 2 * S.world_radius;
      } else {
        delta = false;
        V3 c = v3(lt.aux[LA_CX], lt.aux[LA_CX + 1], lt.aux[LA_CX + 2]);
        float rad = lt.aux[LA_RAD];
        V3 to = c - h.p;
        float d2 = dot(to, to);
        if (d2 <= rad * rad * 1.0001f) {
          lok = false;  // inside the emitter: configs never reach this
        } else {
          // cone sampling via the point-on-sphere reconstruction
          // (sphere.go:287-344): wi/dist to the reconstructed point.  A
          // direct dist = dc*ct - sqrt(rad^2 - dc^2 sin^2) cancels
          // catastrophically at the cone edge (error ~1e-3*dist) and
          // made the emitter occlude its own edge samples — a measured
          // -1.5% systematic before this formulation.
          float u1 = rng.uf(), u2 = rng.uf();
          float st2 = rad * rad / d2;
          float ctm = std::sqrt(std::fmax(0.0f, 1 - st2));
          float ct = 1 - u1 * (1 - ctm);
          float phi = 2 * (float)M_PI * u2;
          V3 wz = norm(to), wx, wy;
          onb(wz, &wx, &wy);
          float dc = std::sqrt(d2);
          float ds = dc * ct -
                     std::sqrt(std::fmax(rad * rad - d2 * (1 - ct * ct), 0.0f));
          float cos_a = (d2 + rad * rad - ds * ds) /
                        std::fmax(2 * dc * rad, 1e-12f);
          // exact math guarantees cos_a >= rad/dc (the silhouette bound);
          // f32 rounding (FMA contraction) can land the reconstructed
          // point just BEHIND the silhouette, where the shadow ray then
          // secants the emitter and self-occludes (-1.5% measured).
          // Clamp to the bound with a 1-ulp-ish forward margin.
          cos_a = std::fmax(cos_a,
                            std::fmin(rad / dc * 1.000001f, 1.0f));
          float sin_a = std::sqrt(std::fmax(0.0f, 1 - cos_a * cos_a));
          V3 nl = (wx * (sin_a * std::cos(phi)) +
                   wy * (sin_a * std::sin(phi)) + wz * cos_a) * -1.0f;
          V3 pl = c + nl * rad;
          V3 tov = pl - h.p;
          dist = len(tov);
          wi = tov * (1.0f / std::fmax(dist, 1e-12f));
          lpdf = 1.0f / (2 * (float)M_PI * (1 - std::fmin(ctm, 1.0f - 1e-7f)));
          // one-sided emitter facing gate at the sampled point
          if (!(lt.aux[LA_TWO] > 0.5f) && dot(nl, wi * -1.0f) <= 0)
            lok = false;
        }
      }
      if (lok) {
        float cos_i = dot(wi, h.n);
        bool same = cos_o * cos_i > 0;
        float aci = std::fabs(cos_i);
        V3 f = v3(0, 0, 0);
        float bpdf = 0;
        if (same) {
          if (mt.type == 0) {
            f = kd * ((float)M_1_PI * aci);
            bpdf = aci * (float)M_1_PI;
          } else if (is_pla) {
            float sp, mp;
            plastic_spec(wo, wi, h.n, eta, alpha, cos_o, cos_i, &sp, &mp);
            f = (kd * (float)M_1_PI + ks * sp) * aci;
            bpdf = 0.5f * (aci * (float)M_1_PI + mp);
          }
        }
        if (maxc(f) > 0 && maxc(Li) > 0 && lpdf > 0) {
          // 2e-4 offset, matching the renderer's offset_ray_origin scale
          // (1e-4 + error bound): a 1e-3 lateral origin shift makes
          // oblique sphere-emitter samples secant the emitter EARLIER
          // than the shadow-tmax margin and self-occlude (-1.5% measured)
          float off = cos_i < 0 ? -2e-4f : 2e-4f;
          V3 so = h.p + h.n * off;
          GHit sh;
          bool occ = S.intersect(so, wi, &sh, true,
                                 std::fmax(dist * 0.999f - 1e-3f, 1e-4f));
          if (getenv("GOPBRT_DEBUG_NEE") && b == 0)
            std::fprintf(stderr,
                         "NEE b%d occ=%d oprim=%d ot=%.9g so=%.9g %.9g %.9g "
                         "wi=%.9g %.9g %.9g dist=%.9g\n",
                         b, (int)occ, occ ? sh.prim : -1, occ ? sh.t : 0.0f,
                         so.x, so.y, so.z, wi.x, wi.y, wi.z, dist);
          if (!occ) {
            float w = delta ? 1.0f : power_h(lpdf, bpdf);
            L = L + beta * f * Li * (w * (float)nl / lpdf);
          }
        }
      }
    }

    // BSDF sample
    V3 wi;
    if (is_mir) {
      if (maxc(ks) <= 0) break;
      wi = h.n * (2 * cos_o) - wo;
      beta = beta * ks;
      spec = true;
    } else if (is_gls) {
      float F = fresnel_diel(cos_o, eta);
      V3 kt = v3(mt.ms[MS_KT], mt.ms[MS_KT + 1], mt.ms[MS_KT + 2]);
      if (rng.uf() < F) {
        if (maxc(ks) <= 0 || F < 1e-9f) break;
        wi = h.n * (2 * cos_o) - wo;
        beta = beta * ks;  // F cancels against the lobe pdf
      } else {
        bool entering = cos_o > 0;
        float er = entering ? 1.0f / eta : eta;
        float ci = std::fabs(cos_o);
        float s2t = er * er * (1 - ci * ci);
        if (s2t >= 1 || maxc(kt) <= 0 || (1 - F) < 1e-9f) break;
        float ctt = std::sqrt(std::fmax(0.0f, 1 - s2t));
        float coef = (er * ci - ctt) * (entering ? 1.0f : -1.0f);
        wi = norm(h.n * coef - wo * er);
        float er2 = er * er;
        beta = beta * kt * er2;  // radiance transport eta^2 (bug #8 fixed)
        es = es / er2;
      }
      spec = true;
    } else {
      // matte / plastic: cosine-hemisphere on wo's side; plastic adds the
      // 0.5/0.5 GGX half-vector lobe (ops/bsdf.py bsdf_sample semantics)
      float u1 = rng.uf(), u2 = rng.uf();
      float ulobe = is_pla ? rng.uf() : 0.0f;
      V3 wx, wy;
      onb(h.n, &wx, &wy);
      float r = std::sqrt(u1), phi = 2 * (float)M_PI * u2;
      float lz = std::sqrt(std::fmax(0.0f, 1 - u1));
      if (cos_o < 0) lz = -lz;
      V3 wc = wx * (r * std::cos(phi)) + wy * (r * std::sin(phi)) + h.n * lz;
      if (!is_pla) {
        float pdf = std::fabs(lz) * (float)M_1_PI;
        if (pdf < 1e-9f || maxc(kd) <= 0 || cos_o * lz <= 0) break;
        wi = wc;
        beta = beta * kd;  // kd/pi * |cos| / (|cos|/pi)
        prev_pdf = pdf;
      } else {
        if (ulobe >= 0.5f) {
          // GGX NDF half-vector sample (microfacet.go:66-91)
          float t2w = alpha * alpha * u1 / std::fmax(1 - u1, 1e-7f);
          float ctw = 1.0f / std::sqrt(1 + t2w);
          float stw = std::sqrt(std::fmax(0.0f, 1 - ctw * ctw));
          float phw = 2 * (float)M_PI * u2;
          float flip = cos_o < 0 ? -1.0f : 1.0f;
          V3 wh = (wx * (stw * std::cos(phw)) + wy * (stw * std::sin(phw)) +
                   h.n * ctw) * flip;
          wi = norm(wh * (2 * dot(wo, wh)) - wo);
        } else {
          wi = wc;
        }
        float ci = dot(wi, h.n);
        bool same = cos_o * ci > 0;
        float sp, mp;
        plastic_spec(wo, wi, h.n, eta, alpha, cos_o, ci, &sp, &mp);
        float aci = std::fabs(ci);
        float cpdf = same ? aci * (float)M_1_PI : 0.0f;
        float pdf = 0.5f * (cpdf + mp);
        V3 f = kd * (same ? (float)M_1_PI : 0.0f) + ks * sp;
        if (pdf < 1e-9f || maxc(f) <= 0) break;
        beta = beta * f * (aci / pdf);
        prev_pdf = pdf;
      }
      spec = false;
      if (direct) dying = true;  // one MIS segment, then stop
    }
    float offsgn = dot(wi, h.n) < 0 ? -1e-3f : 1e-3f;
    o = h.p + h.n * offsgn;
    d = wi;

    // Russian roulette (path.go:143-153; rr_start = 3, threshold 1.0)
    float rrm = maxc(beta) * es;
    if (b >= 3 && rrm < 1.0f && !direct) {
      float q = std::fmax(0.05f, 1 - rrm);
      if (rng.uf() < q) break;
      beta = beta * (1.0f / (1 - q));
    }
  }
  return L;
}

static int generic_main(int argc, char** argv) {
  if (argc < 7) {
    std::fprintf(stderr,
                 "usage: cpu_baseline --scene DUMP W H SPP DEPTH THREADS "
                 "[path|direct]\n");
    return 2;
  }
  const char* dumpf = argv[1];
  int W = atoi(argv[2]), H = atoi(argv[3]), SPP = atoi(argv[4]);
  int DEPTH = atoi(argv[5]), THREADS = atoi(argv[6]);
  bool direct = argc > 7 && std::strcmp(argv[7], "direct") == 0;

  GScene S;
  {
    FILE* f = fopen(dumpf, "r");
    if (!f) { std::fprintf(stderr, "cannot open %s\n", dumpf); return 2; }
    char tag[32];
    if (fscanf(f, "%31s", tag) != 1 ||
        std::strcmp(tag, "GOPBRT-SCENE-1") != 0) {
      std::fprintf(stderr, "bad dump header\n");
      return 2;
    }
    auto rf = [&](float* dst, int n) {
      for (int i = 0; i < n; i++)
        if (fscanf(f, "%f", dst + i) != 1) { std::abort(); }
    };
    int n;
    fscanf(f, "%31s", tag);  // cam
    rf(S.r2c, 16);
    rf(S.c2w, 16);
    fscanf(f, "%31s %f", tag, &S.world_radius);  // wr
    fscanf(f, "%31s %d", tag, &n);  // nprims
    S.prims.resize(n);
    for (auto& p : S.prims) {
      fscanf(f, "%d", &p.type);
      rf(p.w2o, 12);
      rf(p.par, 9);
      fscanf(f, "%d %d", &p.mat, &p.alid);
      rf(&p.lo.x, 3);
      rf(&p.hi.x, 3);
    }
    fscanf(f, "%31s %d", tag, &n);  // nmats
    S.mats.resize(n);
    for (auto& m : S.mats) {
      fscanf(f, "%d", &m.type);
      rf(m.ms, 28);
    }
    fscanf(f, "%31s %d", tag, &n);  // nlights
    S.lights.resize(n);
    for (auto& l : S.lights) {
      fscanf(f, "%d", &l.type);
      rf(&l.p.x, 3);
      rf(&l.I.x, 3);
      rf(l.aux, 8);
    }
    fclose(f);
  }
  S.finalize();

  std::atomic<long long> ray_count{0};
  std::atomic<int> next_row{0};
  std::vector<double> lum_per_thread(THREADS, 0.0);
  const char* dump = getenv("GOPBRT_BASELINE_DUMP");
  std::vector<float> image(dump ? (size_t)W * H * 3 : 0);

  auto xform_p = [](const float* m, V3 p) {
    float w = m[12] * p.x + m[13] * p.y + m[14] * p.z + m[15];
    V3 r = v3(m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
              m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
              m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]);
    return r * (1.0f / w);
  };

  auto worker = [&](int tid) {
    Pcg32 rng;
    double lum = 0.0;
    long long rays = 0;
    for (;;) {
      int y = next_row.fetch_add(1);
      if (y >= H) break;
      for (int x = 0; x < W; x++) {
        rng.seed((uint64_t)(y * W + x) * 9781u + 1u, 7u);
        V3 Lpix = v3(0, 0, 0);
        for (int s = 0; s < SPP; s++) {
          float fx = x + rng.uf(), fy = y + rng.uf();
          V3 pc = xform_p(S.r2c, v3(fx, fy, 0));
          V3 o = xform_p(S.c2w, v3(0, 0, 0));
          V3 dirc = norm(pc);
          V3 d = norm(xf_v34(S.c2w, dirc));
          rays++;
          Lpix = Lpix + g_trace(S, o, d, DEPTH, direct, rng);
        }
        lum += (Lpix.x + Lpix.y + Lpix.z) / (3.0 * SPP);
        if (dump) {
          size_t i = ((size_t)y * W + x) * 3;
          image[i] = Lpix.x / SPP;
          image[i + 1] = Lpix.y / SPP;
          image[i + 2] = Lpix.z / SPP;
        }
      }
    }
    ray_count.fetch_add(rays);
    lum_per_thread[tid] = lum;
  };

  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> ts;
  for (int i = 0; i < THREADS; i++) ts.emplace_back(worker, i);
  for (auto& t : ts) t.join();
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  double lum_sum = 0.0;
  for (double l : lum_per_thread) lum_sum += l;

  if (dump) {
    FILE* f = fopen(dump, "wb");
    if (f) { fwrite(image.data(), 4, image.size(), f); fclose(f); }
  }
  long long rays = ray_count.load();
  std::printf(
      "{\"rays\": %lld, \"seconds\": %.4f, \"rays_per_s\": %.1f, "
      "\"threads\": %d, \"mean_luminance\": %.6f, \"mode\": \"%s\"}\n",
      rays, secs, rays / secs, THREADS, lum_sum / ((double)W * H),
      direct ? "direct" : "path");
  return 0;
}

int main(int argc, char** argv) {
  if (argc > 1 && std::strcmp(argv[1], "--scene") == 0)
    return generic_main(argc - 1, argv + 1);
  if (argc < 6 + 32) {
    std::fprintf(stderr, "usage: cpu_baseline W H SPP DEPTH THREADS r2c[16] c2w[16]\n");
    return 2;
  }
  int W = atoi(argv[1]), H = atoi(argv[2]), SPP = atoi(argv[3]);
  int DEPTH = atoi(argv[4]), THREADS = atoi(argv[5]);
  float r2c[16], c2w[16];
  for (int i = 0; i < 16; i++) r2c[i] = (float)atof(argv[6 + i]);
  for (int i = 0; i < 16; i++) c2w[i] = (float)atof(argv[22 + i]);

  // --- scene (server.go:30-130 / models/demo.py) ---
  Scene sc;
  for (int k = 1; k < 8; k++) {
    for (int axis = 0; axis < 3; axis++) {
      float x = 0, y = 0, z = 0;
      V3 col;
      if (axis == 0) { x = k / 8.0f * 100.0f; col = v3(1, 0, 0); }
      else if (axis == 1) { y = k / 8.0f * 100.0f; col = v3(0, 1, 0); }
      else { z = k / 8.0f * 100.0f; col = v3(0, 0, 1); }
      y = std::fmax(y, 1.0f);
      Prim p{}; p.type = SPH; p.c = v3(x, y, z); p.radius = 2.0f;
      p.kd = col; p.checker = false; p.area_light = -1;
      sc.prims.push_back(p);
    }
  }
  {
    // RotateX(90) floor disk: object z=0.01 -> world plane y = -0.01
    Prim p{}; p.type = DSK; p.c = v3(0, -0.01f, 0);
    p.radius = 10000.0f; p.axis = 1; p.plane = -0.01f;
    p.kd = v3(1, 1, 1); p.checker = true; p.area_light = -1;
    sc.prims.push_back(p);
    // untransformed second disk: vertical XY-plane backdrop at z = -49.99
    Prim q{}; q.type = DSK; q.c = v3(-50, 0, -49.99f);
    q.radius = 10000.0f; q.axis = 2; q.plane = -49.99f;
    q.kd = v3(1, 1, 1); q.checker = true; q.area_light = -1;
    sc.prims.push_back(q);
  }
  // area-light sphere
  {
    Prim p{}; p.type = SPH; p.c = v3(-10, 5, 20); p.radius = 5.0f;
    p.kd = v3(0, 0, 0); p.checker = false; p.area_light = 3;
    sc.prims.push_back(p);
  }
  sc.finalize();

  SceneLights L;
  L.lights.push_back({L_DISTANT, norm(v3(-1, 1, 1)), v3(0.05f, 0.05f, 0.05f), 0});
  L.lights.push_back({L_POINT, v3(50, 20, 50), v3(100, 100, 100), 0});
  L.lights.push_back({L_POINT, v3(-50, 30, -50), v3(50, 50, 50), 0});
  L.lights.push_back({L_AREA, v3(-10, 5, 20), v3(0.2f, 0.2f, 0.2f), 5.0f});

  auto xform_p = [](const float* m, V3 p) {
    float w = m[12] * p.x + m[13] * p.y + m[14] * p.z + m[15];
    V3 r = v3(m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
              m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
              m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]);
    return r * (1.0f / w);
  };
  auto xform_v = [](const float* m, V3 p) {
    return v3(m[0] * p.x + m[1] * p.y + m[2] * p.z,
              m[4] * p.x + m[5] * p.y + m[6] * p.z,
              m[8] * p.x + m[9] * p.y + m[10] * p.z);
  };

  std::atomic<long long> ray_count{0};
  std::atomic<int> next_row{0};
  double lum_sum = 0.0;
  std::vector<double> lum_per_thread(THREADS, 0.0);
  // optional raw-radiance dump for cross-validation vs the JAX renderer
  const char* dump = getenv("GOPBRT_BASELINE_DUMP");
  std::vector<float> image(dump ? (size_t)W * H * 3 : 0);

  auto worker = [&](int tid) {
    Pcg32 rng;
    double lum = 0.0;
    long long rays = 0;
    for (;;) {
      int y = next_row.fetch_add(1);
      if (y >= H) break;
      for (int x = 0; x < W; x++) {
        rng.seed((uint64_t)(y * W + x) * 9781u + 1u, 7u);
        V3 Lpix = v3(0, 0, 0);
        for (int s = 0; s < SPP; s++) {
          float fx = x + rng.uf(), fy = y + rng.uf();
          V3 pc = xform_p(r2c, v3(fx, fy, 0));
          V3 o = xform_p(c2w, v3(0, 0, 0));
          V3 d = norm(xform_v(c2w, norm(pc)));
          rays++;
          V3 beta = v3(1, 1, 1), Lr = v3(0, 0, 0);
          bool spec = true;
          float prev_pdf = 0.0f;
          for (int b = 0; b < DEPTH; b++) {
            Hit h;
            if (!sc.intersect(o, d, &h, false, 1e30f)) break;
            const Prim& pr = sc.prims[h.prim];
            // emitter hit: specular/first => full, else MIS vs NEE pdf
            if (pr.area_light >= 0) {
              const Light& al = L.lights[pr.area_light];
              if (dot(h.n, d * -1.0f) > 0) {
                float w = 1.0f;
                if (!spec) {
                  // PdfLi of the sphere light from the prev vertex (cone)
                  V3 oc = al.p_or_dir - o;
                  float d2 = dot(oc, oc);
                  float st2 = al.radius * al.radius / d2;
                  float ct = std::sqrt(std::fmax(0.0f, 1 - st2));
                  float lpdf = 1.0f / (2 * (float)M_PI * (1 - ct)) * 0.25f;
                  w = prev_pdf * prev_pdf / (prev_pdf * prev_pdf + lpdf * lpdf);
                }
                Lr = Lr + beta * al.intensity * w;
              }
            }
            // matte kd (checker floor: planar map, vs=.2 -> period 5)
            V3 kd = pr.kd;
            if (pr.checker) {
              int ix = (int)std::floor(h.p.x * 0.2f), iz = (int)std::floor(h.p.z * 0.2f);
              kd = ((ix + iz) & 1) == 0 ? v3(1, 1, 1) : v3(0.18f, 0.18f, 0.18f);
            }
            // NEE: one uniform light (integrator.go:48-77)
            int li = (int)(rng.uf() * 4.0f); if (li > 3) li = 3;
            const Light& lt = L.lights[li];
            V3 wi; float dist, lpdf = 1.0f; V3 Li = lt.intensity;
            bool delta = true;
            if (lt.type == L_DISTANT) { wi = lt.p_or_dir; dist = 1e6f; }
            else if (lt.type == L_POINT) {
              V3 to = lt.p_or_dir - h.p;
              float d2 = dot(to, to);
              dist = std::sqrt(d2); wi = to * (1.0f / dist);
              Li = Li * (1.0f / d2);
            } else {
              // sphere cone sampling (sphere.go:287-344)
              delta = false;
              V3 to = lt.p_or_dir - h.p;
              float d2 = dot(to, to);
              float st2 = lt.radius * lt.radius / d2;
              float ct_max = std::sqrt(std::fmax(0.0f, 1 - st2));
              float u1 = rng.uf(), u2 = rng.uf();
              float ct = 1 - u1 * (1 - ct_max);
              float stheta = std::sqrt(std::fmax(0.0f, 1 - ct * ct));
              float phi = 2 * (float)M_PI * u2;
              V3 wz = norm(to);
              V3 a = std::fabs(wz.x) < 0.9f ? v3(1, 0, 0) : v3(0, 1, 0);
              V3 wx = norm(cross(a, wz));
              V3 wy = cross(wz, wx);
              wi = wx * (stheta * std::cos(phi)) + wy * (stheta * std::sin(phi)) + wz * ct;
              lpdf = 1.0f / (2 * (float)M_PI * (1 - ct_max));
              // distance to the sampled point ON the sphere along wi
              // (shadow tmax must stop short of the emitter surface)
              float dc = std::sqrt(d2);
              float b_ = dc * ct;  // projection of center distance on wi
              float h2 = d2 - b_ * b_;
              float inside = lt.radius * lt.radius - h2;
              dist = b_ - std::sqrt(std::fmax(inside, 0.0f));
            }
            float cosw = dot(wi, h.n);
            if (cosw > 0 && maxc(Li) > 0) {
              Hit sh;
              V3 so = h.p + h.n * 1e-3f;
              if (!sc.intersect(so, wi, &sh, true, dist * 0.999f)) {
                float w = 1.0f;
                float bpdf = cosw * (float)M_1_PI;
                if (!delta) w = lpdf * lpdf / (lpdf * lpdf + bpdf * bpdf);
                V3 f = kd * (float)M_1_PI;
                Lr = Lr + beta * f * Li * (cosw * w * 4.0f / lpdf);
              }
            }
            // cosine-hemisphere BSDF sample (reflection.go:188-253 matte)
            float u1 = rng.uf(), u2 = rng.uf();
            float r = std::sqrt(u1), phi = 2 * (float)M_PI * u2;
            V3 wz = h.n;
            V3 a2 = std::fabs(wz.x) < 0.9f ? v3(1, 0, 0) : v3(0, 1, 0);
            V3 wx = norm(cross(a2, wz));
            V3 wy = cross(wz, wx);
            float lz = std::sqrt(std::fmax(0.0f, 1 - u1));
            V3 nd = wx * (r * std::cos(phi)) + wy * (r * std::sin(phi)) + wz * lz;
            float pdf = lz * (float)M_1_PI;
            if (pdf < 1e-7f) break;
            beta = beta * kd;  // f*cos/pdf = kd/pi * cos / (cos/pi) = kd
            prev_pdf = pdf;
            spec = false;
            o = h.p + h.n * 1e-3f;
            d = nd;
            // Russian roulette (path.go:143-153)
            if (b >= 3) {
              float q = std::fmax(0.05f, 1 - maxc(beta));
              if (rng.uf() < q) break;
              beta = beta * (1.0f / (1 - q));
            }
          }
          Lpix = Lpix + Lr;
        }
        lum += (Lpix.x + Lpix.y + Lpix.z) / (3.0 * SPP);
        if (dump) {
          size_t i = ((size_t)y * W + x) * 3;
          image[i] = Lpix.x / SPP; image[i + 1] = Lpix.y / SPP;
          image[i + 2] = Lpix.z / SPP;
        }
      }
    }
    ray_count.fetch_add(rays);
    lum_per_thread[tid] = lum;
  };

  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> ts;
  for (int i = 0; i < THREADS; i++) ts.emplace_back(worker, i);
  for (auto& t : ts) t.join();
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  for (double l : lum_per_thread) lum_sum += l;

  if (dump) {
    FILE* f = fopen(dump, "wb");
    if (f) { fwrite(image.data(), 4, image.size(), f); fclose(f); }
  }
  long long rays = ray_count.load();
  std::printf(
      "{\"rays\": %lld, \"seconds\": %.4f, \"rays_per_s\": %.1f, "
      "\"threads\": %d, \"mean_luminance\": %.5f}\n",
      rays, secs, rays / secs, THREADS, lum_sum / (W * H));
  return 0;
}
