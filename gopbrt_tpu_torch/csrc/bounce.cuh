// The bounce skeleton: a path's state, one bounce of it, and the persistent
// loop that runs paths on a card's lanes, templated over the scene's
// intersector.
//
// The loop of gopbrt_tpu/ops/pallas_megakernel.py::_mega_kernel (lines
// 364-986) and of gopbrt_tpu/ops/pallas_mesh_megakernel.py::_mesh_kernel
// (:671-1245), written once.  Per bounce: closest hit, winner attributes
// (sphere reprojection, disk plane, or a world-space triangle's geometric
// normal N from the policy with dpdu = e1), constant or planar-checker kd
// with the ray-cone box filter, emitter hit with MIS, light pick from the
// CDF, point / distant / sphere-cone NEE with a shadow ray, BSDF sample
// (Lambert, plastic = Lambert + GGX reflection, mirror, FresnelSpecular,
// GGX R+T rough glass with etaScale), Russian roulette.  The math follows
// the TPU kernels op for op and consumes the same counter-hash RNG
// dimensions, so all trace the same paths.  The plain PyTorch twin is
// gopbrt_tpu_torch/ops/megakernel.py::path_li_plain; tests/host_kernels.cpp
// runs path_init / path_step / path_finish on the host.
//
// The scene policy S provides
//   float trace(const Ray& r, int& idx): r.shadow false, the nearest hit
//     closer than r.t_max; true, an any hit closer than r.t_max; idx -1 on
//     a miss;
//   Winner winner(idx): shape, transform (a triangle: its planes, N first),
//     params, shade row, area light;
//   static constexpr bool kTriangles: whether winners can be triangles;
//   static constexpr bool kPlastic: whether the shade rows carry SH_PLA;
//   static constexpr bool kShadowAtOnce: whether a bounce's shadow ray is
//     traced right after its closest hit (run_paths).
// Two instances: the brute sweep over tables in shared memory
// (csrc/megakernel.cu) and the BVH walk of csrc/bvh.cuh
// (csrc/mesh_megakernel.cu).
//
// Design.  The TPU kernels work on blocks of lanes: every lane runs every
// branch and a select keeps one, the winner's attributes come from masked
// sweeps, and a block-level alive count skips bounces once the block is
// dead.  Here one thread runs one path at a time: the winner's attributes
// are one indexed read, the shadow ray stops at its first occluder, only
// the selected light type's and material's branch runs.  Paths end after 1
// to max_depth bounces, and in an open scene their lengths vary widely, so
// the kernels run run_paths: a resident grid whose lanes take the next path
// the moment theirs ends (csrc/lanes.cuh), after each block has copied its
// tables to shared memory once.  What limits a lane is the walk: its
// registers, and a warp's lanes waiting on each other's traces.  So a
// bounce is two traces: the closest hit, after which the whole shading
// runs, BSDF sample included (path_hit); then the shadow ray, after which
// only its contribution is added (path_shadow).  Across a trace only its
// ray and the path state (PathState) are live, no shading value.  Where
// the path state lives, and whether the shadow ray waits for the next
// iteration of the loop, is each kernel's choice, as measured on the H100
// (PERF.md §6): the BVH instance keeps the state in shared memory and
// walks both rays from one call site, so a lane at its shadow ray walks
// beside one at its next closest hit; the brute instance, whose sweeps
// cost every lane alike, keeps the state in registers and sweeps the
// shadow ray at once.
#pragma once

#include "lanes.cuh"
#include "prim_test.cuh"

namespace gopbrt {

constexpr int MAX_LIGHTS = 16;
constexpr int SH_K = 30;
constexpr int LA_K = 8;

// shade-row columns (pallas_megakernel.py:70-88; ops/megakernel.py SH_*),
// and the plastic flag of the material rows of the mesh instance
constexpr int SH_C1 = 0, SH_C2 = 3, SH_CHK = 6, SH_VS = 7, SH_VT = 10,
              SH_DS = 13, SH_ALID = 15, SH_SCALE2 = 16, SH_TSS = 17,
              SH_TST = 18, SH_MIR = 19, SH_KR = 20, SH_GLS = 23, SH_KT = 24,
              SH_ETA = 27, SH_RGL = 28, SH_ALPHA = 29, SH_PLA = 30;
// light aux columns
constexpr int LA_TWO = 0, LA_CX = 1, LA_RAD = 4, LA_FUNC = 5;

// RNG dimension layout (gopbrt_tpu/ops/rng.py:36-52)
constexpr uint32_t DIM_BOUNCE_BASE = 5, DIMS_PER_BOUNCE = 16;
constexpr uint32_t D_LIGHT_PICK = 0, D_LIGHT_UV = 1, D_BSDF_UV = 3,
                   D_BSDF_LOBE = 5, D_RR = 6;

constexpr int FLAG_FULL_SPH = 1, FLAG_FULL_DISK = 2, FLAG_USE_CONE = 4,
              FLAG_ANY_GLASS = 8, FLAG_ANY_ROUGH = 16;

constexpr int LIGHT_POINT = 0, LIGHT_DISTANT = 1;

// Python-double constants of the TPU kernel, rounded to f32 as JAX does
constexpr float INV_PI_F = (float)(1.0 / PI_D);
constexpr float PI_4_F = (float)(PI_D / 4.0);
constexpr float PI_2_F = (float)(PI_D / 2.0);
constexpr float TWO_PI_F = (float)(2.0 * PI_D);
constexpr float ONE_M_1EM7 = (float)(1.0 - 1e-7);
constexpr float G7 = (float)(7.0 * 5.96e-08 / (1.0 - 7.0 * 5.96e-08));
constexpr float SHADOW_SCALE = (float)(1.0 - 1e-4);  // 1 - SHADOW_EPSILON

// The light tables, all f32, in the order of ops/megakernel.py TABLE_LAYOUT.
struct LightTables {
  float ltype[MAX_LIGHTS];
  float lpos[MAX_LIGHTS][3];
  float lint[MAX_LIGHTS][3];
  float laux[MAX_LIGHTS][LA_K];
  float lcdf[MAX_LIGHTS + 1];
};

struct Params {
  int n, n_prims, n_lights;
  uint32_t seed;
  float func_int, world_radius, cone_w0, cone_sp;
  int max_depth, rr_start;
  float rr_threshold;
  int flags;
};

// What the policy tells about a winner.
struct Winner {
  int ptype;
  const float* m;   // 12 world->object entries; a triangle's planes (N first)
  const float* pr;  // 9 params (a triangle's world-space vertices)
  const float* sh;  // the shade row
  int alid;         // area-light id, -1 none
  float scale2;     // sigma^2 of the uniform scale
};

// ---- RNG (lowbias32 chain, bit-exact with ops/rng.py) --------------------

GOPBRT_HD uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

GOPBRT_HD uint32_t hash_combine(uint32_t h, uint32_t v) {
  return hash_u32(h ^ (v + 0x9E3779B9u + (h << 6) + (h >> 2)));
}

GOPBRT_HD float bits_to_float(uint32_t b) {
#ifdef __CUDACC__
  return __uint_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}

GOPBRT_HD float rsqrt_f(float x) {
#ifdef __CUDACC__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

GOPBRT_HD float to_unit(uint32_t x) {
  return bits_to_float(0x3F800000u | (x >> 9)) - 1.0f;
}

// ---- small math (pallas_megakernel.py:124-247) ---------------------------

GOPBRT_HD float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

GOPBRT_HD float max3(float a, float b, float c) { return fmaxf(a, fmaxf(b, c)); }

GOPBRT_HD void normalize3(float& x, float& y, float& z, float eps) {
  const float n2 = x * x + y * y + z * z;
  const float inv = (n2 > eps ? 1.0f : 0.0f) / sqrtf(fmaxf(n2, fmaxf(eps, 1e-30f)));
  x *= inv;
  y *= inv;
  z *= inv;
}

// branch-free Duff frame around v: (u, w)
GOPBRT_HD void coord_system(float vx, float vy, float vz, float& ux, float& uy,
                            float& uz, float& wx, float& wy, float& wz) {
  const float sign = vz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + vz);
  const float b = vx * vy * a;
  ux = 1.0f + sign * vx * vx * a;
  uy = sign * b;
  uz = -sign * vx;
  wx = b;
  wy = sign + vy * vy * a;
  wz = -vy;
}

GOPBRT_HD float fresnel_diel(float cos_i, float eta) {
  const float ci0 = fminf(fmaxf(cos_i, -1.0f), 1.0f);
  const bool entering = ci0 > 0.0f;
  const float ei = entering ? 1.0f : eta;
  const float et = entering ? eta : 1.0f;
  const float ci = fabsf(ci0);
  const float sin_i = sqrtf(fmaxf(1.0f - ci * ci, 0.0f));
  const float sin_t = ei / et * sin_i;
  if (sin_t >= 1.0f) return 1.0f;
  const float ct = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
  const float r_parl = (et * ci - ei * ct) / fmaxf(et * ci + ei * ct, 1e-20f);
  const float r_perp = (ei * ci - et * ct) / fmaxf(ei * ci + et * ct, 1e-20f);
  return 0.5f * (r_parl * r_parl + r_perp * r_perp);
}

GOPBRT_HD float ggx_d(float c_wh, float alpha) {
  const float c2 = c_wh * c_wh;
  if (!(c2 > 1e-16f)) return 0.0f;
  const float t2 = (1.0f - c2) / fmaxf(c2, 1e-20f);
  const float a2 = alpha * alpha;
  const float e = t2 / fmaxf(a2, 1e-12f);
  const float sq = (1.0f + e) * (1.0f + e);
  return 1.0f / (PI_F * a2 * c2 * c2 * sq + 1e-20f);
}

GOPBRT_HD float ggx_lambda(float c_w, float alpha) {
  const float c2 = fmaxf(c_w * c_w, 1e-20f);
  const float abs_tan = sqrtf(fmaxf(1.0f - c2, 0.0f) / c2);
  const float at = alpha * abs_tan;
  return (-1.0f + sqrtf(1.0f + at * at)) / 2.0f;
}

GOPBRT_HD float power_heuristic(float f, float g) {
  const float f2 = f * f;
  const float denom = f2 + g * g;
  return denom > 0.0f ? f2 / denom : 0.0f;
}

GOPBRT_HD void concentric_disk(float u0, float u1, float& dx, float& dy) {
  const float ox = 2.0f * u0 - 1.0f;
  const float oy = 2.0f * u1 - 1.0f;
  if (ox == 0.0f && oy == 0.0f) {
    dx = 0.0f;
    dy = 0.0f;
    return;
  }
  const bool use_x = fabsf(ox) > fabsf(oy);
  const float r = use_x ? ox : oy;
  const float theta =
      use_x ? PI_4_F * (oy / (ox == 0.0f ? 1.0f : ox))
            : PI_2_F - PI_4_F * (ox / (oy == 0.0f ? 1.0f : oy));
  dx = r * cosf(theta);
  dy = r * sinf(theta);
}

// spawn offset: dot(|n|, p_err + 1e-4), p_err ~ gamma7 * |p|
GOPBRT_HD float offset_dist(float nx, float ny, float nz, float px, float py, float pz) {
  const float err = G7 * (fabsf(px) + fabsf(py) + fabsf(pz));
  const float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);
  return (ax + ay + az) * 1e-4f + (ax * err + ay * err + az * err);
}

// solid-angle pdf of sphere-cone sampling generating w from r
GOPBRT_HD float sphere_area_pdf_li(float rx, float ry, float rz, float wx, float wy,
                                   float wz, float cx, float cy, float cz, float rad) {
  const float tcx = cx - rx, tcy = cy - ry, tcz = cz - rz;
  const float dc2 = tcx * tcx + tcy * tcy + tcz * tcz;
  if (dc2 > rad * rad * 1.00002f) {
    const float sin2_tmax = fminf(fmaxf(rad * rad / fmaxf(dc2, 1e-20f), 0.0f), 1.0f);
    const float cos_tmax = sqrtf(fmaxf(1.0f - sin2_tmax, 0.0f));
    float ncx = tcx, ncy = tcy, ncz = tcz;
    normalize3(ncx, ncy, ncz, 1e-20f);
    const float cos_w = dot3(ncx, ncy, ncz, wx, wy, wz);
    if (!(cos_w >= cos_tmax - 1e-6f)) return 0.0f;
    return 1.0f / (TWO_PI_F * (1.0f - fminf(cos_tmax, ONE_M_1EM7)));
  }
  const float ocx = -tcx, ocy = -tcy, ocz = -tcz;
  const float b_half = dot3(ocx, ocy, ocz, wx, wy, wz);
  const float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
  const float disc = fmaxf(rad * rad - (oc2 - b_half * b_half), 0.0f);
  const float t_hit = -b_half + sqrtf(disc);
  float nhx = ocx + wx * t_hit, nhy = ocy + wy * t_hit, nhz = ocz + wz * t_hit;
  normalize3(nhx, nhy, nhz, 1e-20f);
  const float cos_hit = fabsf(dot3(nhx, nhy, nhz, wx, wy, wz));
  return (t_hit * t_hit) / fmaxf(cos_hit * 4.0f * PI_F * rad * rad, 1e-12f);
}

// ---- GGX lobes (pallas_megakernel.py:522-599, pallas_mesh_megakernel.py
// :891-925) ------------------------------------------------------------------

struct Frame {
  float nx, ny, nz, wox, woy, woz, cos_o;
};

struct GgxReflection {
  float refl;    // F D G / (4 |cos_o| |cos_i|), 0 off the same hemisphere
  float mf_pdf;  // the half-vector pdf of the reflection toward wi
  float g;       // the Smith G term
};

// the GGX reflection lobe toward wi (ci = wi . n)
GOPBRT_HD GgxReflection ggx_reflection(const Frame& f, float alpha, float eta, float wix,
                                       float wiy, float wiz, float ci) {
  const float aco = fabsf(f.cos_o);
  const bool same = f.cos_o * ci > 0.0f;
  const float aci = fabsf(ci);
  float hx = wix + f.wox, hy = wiy + f.woy, hz = wiz + f.woz;
  const float h2 = hx * hx + hy * hy + hz * hz;
  normalize3(hx, hy, hz, 1e-20f);
  const float c_wh = dot3(hx, hy, hz, f.nx, f.ny, f.nz);
  const float sgn_h = c_wh < 0.0f ? -1.0f : 1.0f;
  const float fr_r = fresnel_diel(dot3(wix, wiy, wiz, sgn_h * hx, sgn_h * hy, sgn_h * hz), eta);
  const float d_r = ggx_d(c_wh, alpha);
  GgxReflection r;
  r.g = 1.0f / (1.0f + ggx_lambda(f.cos_o, alpha) + ggx_lambda(ci, alpha));
  const bool degen_r = (aco < 1e-7f) || (aci < 1e-7f) || (h2 < 1e-14f);
  r.refl = (same && !degen_r) ? fr_r * d_r * r.g / fmaxf(4.0f * aco * aci, 1e-7f) : 0.0f;
  const float doh_r = dot3(f.wox, f.woy, f.woz, hx, hy, hz);
  r.mf_pdf = same ? d_r * fabsf(c_wh) / fmaxf(4.0f * fabsf(doh_r), 1e-7f) : 0.0f;
  return r;
}

// (refl, trans, pdf) of the rough-glass lobes toward wi
GOPBRT_HD void rough_glass_eval(const Frame& f, float alpha, float eta, float F_o,
                                float wix, float wiy, float wiz, float& refl,
                                float& trans, float& pdf) {
  const float aco = fabsf(f.cos_o);
  const float ci = dot3(wix, wiy, wiz, f.nx, f.ny, f.nz);
  const bool same = f.cos_o * ci > 0.0f;
  const float aci = fabsf(ci);
  const GgxReflection r = ggx_reflection(f, alpha, eta, wix, wiy, wiz, ci);
  refl = r.refl;
  // transmission half-vector: wh ~ wo + eta*wi, +n oriented
  const float eta_t = f.cos_o > 0.0f ? eta : 1.0f / eta;
  float thx = f.wox + wix * eta_t, thy = f.woy + wiy * eta_t, thz = f.woz + wiz * eta_t;
  normalize3(thx, thy, thz, 1e-20f);
  float c_th = dot3(thx, thy, thz, f.nx, f.ny, f.nz);
  const float sgn_t = c_th < 0.0f ? -1.0f : 1.0f;
  thx = sgn_t * thx;
  thy = sgn_t * thy;
  thz = sgn_t * thz;
  c_th = sgn_t * c_th;
  const float do_h = dot3(f.wox, f.woy, f.woz, thx, thy, thz);
  const float di_h = dot3(wix, wiy, wiz, thx, thy, thz);
  const float denom = do_h + eta_t * di_h;
  const float fr_t = fresnel_diel(do_h, eta);
  const float d_t = ggx_d(c_th, alpha);
  const bool degen_t = same || (aci < 1e-7f) || (aco < 1e-7f);
  trans = degen_t ? 0.0f
                  : (1.0f - fr_t) *
                        fabsf(d_t * r.g * fabsf(di_h) * fabsf(do_h) /
                              fmaxf(fabsf(ci * f.cos_o) * denom * denom, 1e-10f));
  const float dwh_dwi = fabsf(eta_t * eta_t * di_h) / fmaxf(denom * denom, 1e-10f);
  const float mf_pdf_t = d_t * fabsf(c_th) * dwh_dwi;
  pdf = same ? F_o * r.mf_pdf : (1.0f - F_o) * mf_pdf_t;
}

// a GGX half-vector about n, into wo's hemisphere (microfacet Sample_wh)
GOPBRT_HD void ggx_half_vector(float alpha, float ub0, float ub1, float cos_o, float ssx,
                               float ssy, float ssz, float tsx, float tsy, float tsz,
                               float nx, float ny, float nz, float& whx, float& why,
                               float& whz) {
  const float tan2w = alpha * alpha * ub0 / fmaxf(1.0f - ub0, 1e-7f);
  const float ctw = 1.0f / sqrtf(1.0f + tan2w);
  const float stw = sqrtf(fmaxf(1.0f - ctw * ctw, 0.0f));
  const float phiw = TWO_PI_F * ub1;
  const float cpw = stw * cosf(phiw);
  const float spw = stw * sinf(phiw);
  const float flip_h = cos_o < 0.0f ? -1.0f : 1.0f;
  whx = (ssx * cpw + tsx * spw + nx * ctw) * flip_h;
  why = (ssy * cpw + tsy * spw + ny * ctw) * flip_h;
  whz = (ssz * cpw + tsz * spw + nz * ctw) * flip_h;
}

// ---- one path ------------------------------------------------------------

// The next trace of a lane: its path's ray (the closest hit below t_max =
// BIG) or the bounce's shadow ray (any hit below t_max).  It lives in
// registers, the walk's inputs.
struct Ray {
  float ox, oy, oz, dx, dy, dz, t_max;
  bool shadow;
};

// A path between its traces: the throughput, the radiance so far, the
// previous BSDF pdf, the ray-cone width, etaScale; the NEE contribution
// that waits on the shadow ray and the ray that follows it; the RNG hash of
// its pixel and sample, its bounce index, its lane; whether the last lobe
// was specular and whether the path goes on after its shadow ray.  No walk
// reads any of it, so a kernel may keep it in shared memory, one per
// thread: 23 words, an odd stride, so a warp's reads of one field fall in
// 32 banks.
struct PathState {
  float bR, bG, bB, LR, LG, LB;
  float prev_pdf, cw, es;
  float pR, pG, pB;
  float nox, noy, noz, ndx, ndy, ndz;
  uint32_t h_ps;
  int b, lane, spec, more;
};
static_assert(sizeof(PathState) == 23 * 4, "PathState: an odd number of words");

GOPBRT_HD void path_init(PathState& s, Ray& r, const Params& P, const float* o,
                         const float* d, const int* pixel, const int* sample, int lane) {
  r.ox = o[3 * lane];
  r.oy = o[3 * lane + 1];
  r.oz = o[3 * lane + 2];
  r.dx = d[3 * lane];
  r.dy = d[3 * lane + 1];
  r.dz = d[3 * lane + 2];
  r.t_max = BIG;
  r.shadow = false;
  s.h_ps = hash_combine(hash_combine(P.seed, (uint32_t)pixel[lane]), (uint32_t)sample[lane]);
  s.bR = s.bG = s.bB = 1.0f;
  s.LR = s.LG = s.LB = 0.0f;
  s.spec = 1;
  s.prev_pdf = 0.0f;
  s.cw = (P.flags & FLAG_USE_CONE) ? P.cone_w0 : 0.0f;
  s.es = 1.0f;
  s.b = 0;
  s.lane = lane;
}

// The rest of the path's bounce s.b once its ray r met its closest hit (t,
// the policy's winner idx, -1 on a miss): the emission, NEE up to its
// shadow ray, the BSDF sample, roulette.  False when nothing is left to
// trace (an escape; or no shadow ray and the path ends: a failed sample, a
// black throughput, roulette, or the last bounce).  True with r the next
// trace: the shadow ray, its contribution waiting in s and the path's next
// ray in s (path_shadow), or else the path's next ray.  The BSDF sample
// does not depend on the shadow ray, so it runs first and the shadow walk
// ends the bounce with only its own ray live.  The RNG dimensions follow
// s.b, so a path's answer does not depend on when or where its bounces run.
template <class S>
GOPBRT_HD bool path_hit(const S& scene, const LightTables& LT, const Params& P,
                        PathState& s, Ray& r, float t, int idx) {
  if (idx < 0) return false;  // escaped: the fast-path sets have no infinite light
  const bool use_cone = P.flags & FLAG_USE_CONE;
  const bool any_glass = P.flags & FLAG_ANY_GLASS;
  const bool any_rough = P.flags & FLAG_ANY_ROUGH;
  const int n_lights = P.n_lights;
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  float &bR = s.bR, &bG = s.bG, &bB = s.bB, &LR = s.LR, &LG = s.LG, &LB = s.LB;
  float &prev_pdf = s.prev_pdf, &cw = s.cw, &es = s.es;
  int& spec = s.spec;
  const uint32_t h_ps = s.h_ps;
  const int b = s.b;
  {
    const uint32_t dim0 = DIM_BOUNCE_BASE + (uint32_t)b * DIMS_PER_BOUNCE;
#define U1(off) to_unit(hash_combine(h_ps, dim0 + (uint32_t)(off)))

    // ---- winner geometry ------------------------------------------------
    const Winner w = scene.winner(idx);
    const float* sh = w.sh;
    float px, py, pz, nx, ny, nz, dux, duy, duz;
    if (S::kTriangles && w.ptype == TRIANGLE) {
      // world space: p = o + t d, n ~ N (the record's plane, no cross
      // product, as the TPU kernel resolves _RC_N), dpdu = e1
      const float* v = w.pr;
      nx = w.m[0];
      ny = w.m[1];
      nz = w.m[2];
      normalize3(nx, ny, nz, 1e-30f);
      px = ox + dx * t;
      py = oy + dy * t;
      pz = oz + dz * t;
      dux = v[3] - v[0];
      duy = v[4] - v[1];
      duz = v[5] - v[2];
    } else {  // sphere / disk: object space, then the uniform-scale transform
      const float* m = w.m;
      const float radius = w.pr[0];
      const bool is_sph = w.ptype == SPHERE;
      const float oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
      const float ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
      const float ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
      const float odx = m[0] * dx + m[1] * dy + m[2] * dz;
      const float ody = m[4] * dx + m[5] * dy + m[6] * dz;
      const float odz = m[8] * dx + m[9] * dy + m[10] * dz;
      float pox = oox + odx * t, poy = ooy + ody * t, poz = ooz + odz * t;
      const float plen = sqrtf(fmaxf(pox * pox + poy * poy + poz * poz, 1e-20f));
      const float s_rep = is_sph ? radius / plen : 1.0f;
      pox *= s_rep;
      poy *= s_rep;
      poz *= s_rep;
      const float inv_r = 1.0f / fmaxf(radius, 1e-20f);
      const float nx_o = is_sph ? pox * inv_r : 0.0f;
      const float ny_o = is_sph ? poy * inv_r : 0.0f;
      const float nz_o = is_sph ? poz * inv_r : 1.0f;
      // object -> world for directions: w2o_lin^T (uniform scale)
      nx = m[0] * nx_o + m[4] * ny_o + m[8] * nz_o;
      ny = m[1] * nx_o + m[5] * ny_o + m[9] * nz_o;
      nz = m[2] * nx_o + m[6] * ny_o + m[10] * nz_o;
      normalize3(nx, ny, nz, 1e-30f);
      // dpdu ~ (-y, x, 0) in object space
      dux = m[0] * -poy + m[4] * pox + m[8] * 0.0f;
      duy = m[1] * -poy + m[5] * pox + m[9] * 0.0f;
      duz = m[2] * -poy + m[6] * pox + m[10] * 0.0f;
      const float qx = pox - m[3], qy = poy - m[7], qz = poz - m[11];
      const float scale2 = w.scale2;
      px = scale2 * (m[0] * qx + m[4] * qy + m[8] * qz);
      py = scale2 * (m[1] * qx + m[5] * qy + m[9] * qz);
      pz = scale2 * (m[2] * qx + m[6] * qy + m[10] * qz);
    }
    float wox = -dx, woy = -dy, woz = -dz;
    normalize3(wox, woy, woz, 1e-30f);

    // ---- emitted radiance at emitter hits (path.go:48-63 + MIS) ---------
    const int alid = w.alid;
    if (alid >= 0) {
      const float* eaux = LT.laux[alid];
      const bool facing = dot3(nx, ny, nz, wox, woy, woz) > 0.0f;
      if (eaux[LA_TWO] > 0.5f || facing) {
        float w_bsdf = 1.0f;
        if (!spec) {
          const float l_pdf = sphere_area_pdf_li(ox, oy, oz, dx, dy, dz, eaux[LA_CX],
                                                 eaux[LA_CX + 1], eaux[LA_CX + 2],
                                                 eaux[LA_RAD]);
          const float pick_pmf =
              P.func_int > 0.0f
                  ? eaux[LA_FUNC] / fmaxf(P.func_int * (float)n_lights, 1e-20f)
                  : 1.0f / (float)n_lights;
          w_bsdf = power_heuristic(prev_pdf, l_pdf * pick_pmf);
        }
        LR = LR + bR * LT.lint[alid][0] * w_bsdf;
        LG = LG + bG * LT.lint[alid][1] * w_bsdf;
        LB = LB + bB * LT.lint[alid][2] * w_bsdf;
      }
    }

    // ---- kd at hit (constant or planar checker; box filter over the
    // ray-cone footprint) -------------------------------------------------
    float kdr = sh[SH_C1], kdg = sh[SH_C1 + 1], kdb = sh[SH_C1 + 2];
    float fw_hit = cw;
    if (use_cone) fw_hit = cw + P.cone_sp * fabsf(t);
    if (sh[SH_CHK] > 0.5f) {
      const float s_t = sh[SH_DS] + dot3(px, py, pz, sh[SH_VS], sh[SH_VS + 1], sh[SH_VS + 2]);
      const float t_t = sh[SH_DS + 1] + dot3(px, py, pz, sh[SH_VT], sh[SH_VT + 1], sh[SH_VT + 2]);
      if (use_cone) {
        const float fw_surf =
            fw_hit * rsqrt_f(fmaxf(fabsf(dot3(nx, ny, nz, wox, woy, woz)), 0.05f));
        auto bump_int = [](float x) {
          const float h = x * 0.5f;
          const float fh = floorf(h);
          return fh + 2.0f * fmaxf(h - fh - 0.5f, 0.0f);
        };
        const float ds_ = fmaxf(fw_surf * sh[SH_TSS], 1e-8f);
        const float dt_ = fmaxf(fw_surf * sh[SH_TST], 1e-8f);
        const float s_int = (bump_int(s_t + ds_) - bump_int(s_t - ds_)) / (2.0f * ds_);
        const float t_int = (bump_int(t_t + dt_) - bump_int(t_t - dt_)) / (2.0f * dt_);
        const float a2 = fminf(fmaxf(s_int + t_int - 2.0f * s_int * t_int, 0.0f), 1.0f);
        kdr = kdr + a2 * (sh[SH_C2] - kdr);
        kdg = kdg + a2 * (sh[SH_C2 + 1] - kdg);
        kdb = kdb + a2 * (sh[SH_C2 + 2] - kdb);
      } else {
        float par = floorf(s_t) + floorf(t_t);
        par = par - 2.0f * floorf(par * 0.5f);
        if (par > 0.5f) {
          kdr = sh[SH_C2];
          kdg = sh[SH_C2 + 1];
          kdb = sh[SH_C2 + 2];
        }
      }
    }

    // ---- shading frame (reflection.go:120-145) --------------------------
    const float nd = dot3(nx, ny, nz, dux, duy, duz);
    float ssx = dux - nx * nd, ssy = duy - ny * nd, ssz = duz - nz * nd;
    if (ssx * ssx + ssy * ssy + ssz * ssz < 1e-12f) {
      float wx, wy, wz;
      coord_system(nx, ny, nz, ssx, ssy, ssz, wx, wy, wz);
    }
    normalize3(ssx, ssy, ssz, 1e-30f);
    const float tsx = ny * ssz - nz * ssy;
    const float tsy = nz * ssx - nx * ssz;
    const float tsz = nx * ssy - ny * ssx;
    const float cos_o = dot3(wox, woy, woz, nx, ny, nz);
    const float d_off = offset_dist(nx, ny, nz, px, py, pz);
    const Frame fr{nx, ny, nz, wox, woy, woz, cos_o};

    const bool is_mir = sh[SH_MIR] > 0.5f;
    const bool is_gls = any_glass && sh[SH_GLS] > 0.5f;
    const bool is_rgl = any_rough && sh[SH_RGL] > 0.5f;
    const bool is_pla = S::kPlastic && sh[SH_PLA] > 0.5f;
    const float alpha_g = fmaxf(sh[SH_ALPHA], 1e-3f);
    const float eta_g = fmaxf(sh[SH_ETA], 1e-3f);
    const float F_o_rgl = is_rgl ? fresnel_diel(cos_o, eta_g) : 0.0f;

    // ---- NEE: one-light estimate (integrator.go:48-77, 79-195) ----------
    if (!is_mir && !is_gls) {
      const float u_pick = U1(D_LIGHT_PICK);
      int cnt = 0;
      for (int i = 0; i <= n_lights; ++i) cnt += LT.lcdf[i] <= u_pick ? 1 : 0;
      const int li = min(max(cnt - 1, 0), n_lights - 1);
      const int lt = (int)LT.ltype[li];
      const float* lp = LT.lpos[li];
      const float* la = LT.laux[li];
      const float pick_pmf = P.func_int > 0.0f
                                 ? la[LA_FUNC] / (fmaxf(P.func_int, 1e-30f) * (float)n_lights)
                                 : 1.0f / (float)n_lights;
      float wix, wiy, wiz, li_gain, ls_pdf, dist;
      if (lt == LIGHT_POINT) {  // Li = I/d^2 (point.go:44-49)
        const float tlx = lp[0] - px, tly = lp[1] - py, tlz = lp[2] - pz;
        const float d2 = tlx * tlx + tly * tly + tlz * tlz;
        dist = sqrtf(d2);
        wix = tlx;
        wiy = tly;
        wiz = tlz;
        normalize3(wix, wiy, wiz, 1e-20f);
        li_gain = 1.0f / fmaxf(d2, 1e-12f);
        ls_pdf = 1.0f;
      } else if (lt == LIGHT_DISTANT) {
        wix = lp[0];
        wiy = lp[1];
        wiz = lp[2];
        li_gain = 1.0f;
        ls_pdf = 1.0f;
        dist = 2.0f * P.world_radius;
      } else {  // sphere area light: cone / inside sampling (sphere.go:287-344)
        const float ul0 = U1(D_LIGHT_UV);
        const float ul1 = U1(D_LIGHT_UV + 1);
        const float cx = la[1], cy = la[2], cz = la[3], rad = la[4];
        const float tcx = cx - px, tcy = cy - py, tcz = cz - pz;
        const float dc2 = tcx * tcx + tcy * tcy + tcz * tcz;
        const float dc = sqrtf(dc2);
        const float phi = TWO_PI_F * ul1;
        float nlx, nly, nlz, plx, ply, plz;
        if (dc > rad * 1.00001f) {
          const float inv_dc = 1.0f / fmaxf(dc, 1e-12f);
          const float wcx = tcx * inv_dc, wcy = tcy * inv_dc, wcz = tcz * inv_dc;
          float v2x, v2y, v2z, v3x, v3y, v3z;
          coord_system(wcx, wcy, wcz, v2x, v2y, v2z, v3x, v3y, v3z);
          const float sin2_tmax = fminf(fmaxf(rad * rad / fmaxf(dc2, 1e-20f), 0.0f), 1.0f);
          const float cos_tmax = sqrtf(fmaxf(1.0f - sin2_tmax, 0.0f));
          const float cos_t = (1.0f - ul0) + ul0 * cos_tmax;
          const float sin2_t = fmaxf(1.0f - cos_t * cos_t, 0.0f);
          const float ds_ = dc * cos_t - sqrtf(fmaxf(rad * rad - dc2 * sin2_t, 0.0f));
          const float cos_a = (dc2 + rad * rad - ds_ * ds_) / fmaxf(2.0f * dc * rad, 1e-12f);
          const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
          const float sa_cp = sin_a * cosf(phi);
          const float sa_sp = sin_a * sinf(phi);
          nlx = -v2x * sa_cp - v3x * sa_sp - wcx * cos_a;
          nly = -v2y * sa_cp - v3y * sa_sp - wcy * cos_a;
          nlz = -v2z * sa_cp - v3z * sa_sp - wcz * cos_a;
          plx = cx + rad * nlx;
          ply = cy + rad * nly;
          plz = cz + rad * nlz;
          wix = plx - px;
          wiy = ply - py;
          wiz = plz - pz;
          normalize3(wix, wiy, wiz, 1e-20f);
          ls_pdf = 1.0f / (TWO_PI_F * (1.0f - fminf(cos_tmax, ONE_M_1EM7)));
        } else {  // inside: uniform area + conversion
          const float z_in = 1.0f - 2.0f * ul0;
          const float r_in = sqrtf(fmaxf(1.0f - z_in * z_in, 0.0f));
          nlx = r_in * cosf(phi);
          nly = r_in * sinf(phi);
          nlz = z_in;
          plx = cx + rad * nlx;
          ply = cy + rad * nly;
          plz = cz + rad * nlz;
          const float wvx = plx - px, wvy = ply - py, wvz = plz - pz;
          const float d2i = wvx * wvx + wvy * wvy + wvz * wvz;
          wix = wvx;
          wiy = wvy;
          wiz = wvz;
          normalize3(wix, wiy, wiz, 1e-20f);
          const float cos_li = fabsf(dot3(nlx, nly, nlz, -wix, -wiy, -wiz));
          ls_pdf = d2i / fmaxf(cos_li * 4.0f * PI_F * rad * rad, 1e-12f);
        }
        const float ex = plx - px, ey = ply - py, ez = plz - pz;
        dist = sqrtf(ex * ex + ey * ey + ez * ez);
        const bool facing_l = dot3(nlx, nly, nlz, -wix, -wiy, -wiz) > 0.0f;
        li_gain = ((la[LA_TWO] > 0.5f || facing_l) && ls_pdf > 0.0f) ? 1.0f : 0.0f;
      }
      const float lir = LT.lint[li][0] * li_gain;
      const float lig = LT.lint[li][1] * li_gain;
      const float lib = LT.lint[li][2] * li_gain;
      const bool is_delta = lt == LIGHT_POINT || lt == LIGHT_DISTANT;

      // f toward the light: Lambert (plastic: + GGX reflection), or the
      // rough-glass lobes
      const float cos_i = dot3(wix, wiy, wiz, nx, ny, nz);
      float fR_n, fG_n, fB_n, b_pdf;
      if (is_rgl) {
        float r_e, t_e, p_e;
        rough_glass_eval(fr, alpha_g, eta_g, F_o_rgl, wix, wiy, wiz, r_e, t_e, p_e);
        const float aci = fabsf(cos_i);
        fR_n = (sh[SH_KR] * r_e + sh[SH_KT] * t_e) * aci;
        fG_n = (sh[SH_KR + 1] * r_e + sh[SH_KT + 1] * t_e) * aci;
        fB_n = (sh[SH_KR + 2] * r_e + sh[SH_KT + 2] * t_e) * aci;
        b_pdf = p_e;
      } else {
        const bool same = cos_o * cos_i > 0.0f;
        const float f_gain = same ? INV_PI_F * fabsf(cos_i) : 0.0f;
        b_pdf = same ? fabsf(cos_i) * INV_PI_F : 0.0f;
        fR_n = kdr * f_gain;
        fG_n = kdg * f_gain;
        fB_n = kdb * f_gain;
        if (is_pla) {  // pallas_mesh_megakernel.py:1032-1039
          const GgxReflection g = ggx_reflection(fr, alpha_g, eta_g, wix, wiy, wiz, cos_i);
          const float cos_gain = same ? fabsf(cos_i) : 0.0f;
          fR_n = fR_n + sh[SH_KR] * g.refl * cos_gain;
          fG_n = fG_n + sh[SH_KR + 1] * g.refl * cos_gain;
          fB_n = fB_n + sh[SH_KR + 2] * g.refl * cos_gain;
          b_pdf = 0.5f * (b_pdf + g.mf_pdf);
        }
      }
      if (ls_pdf > 0.0f && max3(lir, lig, lib) > 0.0f && max3(fR_n, fG_n, fB_n) > 0.0f) {
        // the shadow ray (VisibilityTester.Unoccluded, light.go:46-48),
        // traced at the end of the bounce; what it adds if unoccluded
        const float sgn = cos_i < 0.0f ? -1.0f : 1.0f;
        r.ox = px + sgn * d_off * nx;
        r.oy = py + sgn * d_off * ny;
        r.oz = pz + sgn * d_off * nz;
        r.dx = wix;
        r.dy = wiy;
        r.dz = wiz;
        r.t_max = fmaxf(dist * SHADOW_SCALE - 1e-3f, 1e-4f);
        r.shadow = true;
        const float weight = is_delta ? 1.0f : power_heuristic(ls_pdf, b_pdf);
        const float gain = weight / fmaxf(ls_pdf, 1e-20f) / fmaxf(pick_pmf, 1e-20f);
        s.pR = bR * fR_n * lir * gain;
        s.pG = bG * fG_n * lig * gain;
        s.pB = bB * fB_n * lib * gain;
      }
    }

    // ---- BSDF sample ----------------------------------------------------
    const float ub0 = U1(D_BSDF_UV);
    const float ub1 = U1(D_BSDF_UV + 1);
    const float kr_max = max3(sh[SH_KR], sh[SH_KR + 1], sh[SH_KR + 2]);
    float wix_n, wiy_n, wiz_n, pdf_b, fR, fG, fB;
    bool ok;
    if (is_mir) {  // delta reflection (mirror.go:21-32)
      wix_n = 2.0f * cos_o * nx - wox;
      wiy_n = 2.0f * cos_o * ny - woy;
      wiz_n = 2.0f * cos_o * nz - woz;
      pdf_b = 1.0f;
      fR = sh[SH_KR];
      fG = sh[SH_KR + 1];
      fB = sh[SH_KR + 2];
      ok = kr_max > 0.0f;
    } else if (is_gls || is_rgl) {
      const float u_lobe = U1(D_BSDF_LOBE);
      const bool entering = cos_o > 0.0f;
      const float eta_ratio = entering ? 1.0f / eta_g : eta_g;
      const float ci = fabsf(fminf(fmaxf(cos_o, -1.0f), 1.0f));
      const float er2 = eta_ratio * eta_ratio;
      const float ktr = sh[SH_KT], ktg = sh[SH_KT + 1], ktb = sh[SH_KT + 2];
      if (is_gls) {  // FresnelSpecular (reflection.go:465-536)
        const float ei = entering ? 1.0f : eta_g;
        const float et = entering ? eta_g : 1.0f;
        const float sin_i = sqrtf(fmaxf(1.0f - ci * ci, 0.0f));
        const float sin_t = ei / et * sin_i;
        const float ct_f = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
        const float r_parl = (et * ci - ei * ct_f) / fmaxf(et * ci + ei * ct_f, 1e-20f);
        const float r_perp = (ei * ci - et * ct_f) / fmaxf(ei * ci + et * ct_f, 1e-20f);
        const float F = sin_t >= 1.0f ? 1.0f : 0.5f * (r_parl * r_parl + r_perp * r_perp);
        if (u_lobe < F) {  // reflect
          wix_n = 2.0f * cos_o * nx - wox;
          wiy_n = 2.0f * cos_o * ny - woy;
          wiz_n = 2.0f * cos_o * nz - woz;
          pdf_b = F;
          fR = sh[SH_KR];
          fG = sh[SH_KR + 1];
          fB = sh[SH_KR + 2];
          ok = F > 1e-9f && kr_max > 0.0f;
        } else {  // refract about the oriented normal (reflection.go:106-118)
          const float sgn_e = entering ? 1.0f : -1.0f;
          const float sin2_tt = eta_ratio * eta_ratio * (1.0f - ci * ci);
          const bool ok_t = sin2_tt < 1.0f;
          const float cos_tt = sqrtf(fmaxf(1.0f - sin2_tt, 0.0f));
          const float coef = (eta_ratio * ci - cos_tt) * sgn_e;
          wix_n = coef * nx - eta_ratio * wox;
          wiy_n = coef * ny - eta_ratio * woy;
          wiz_n = coef * nz - eta_ratio * woz;
          normalize3(wix_n, wiy_n, wiz_n, 1e-20f);
          pdf_b = 1.0f - F;
          fR = er2 * ktr;
          fG = er2 * ktg;
          fB = er2 * ktb;
          ok = (1.0f - F) > 1e-9f && ok_t && max3(ktr, ktg, ktb) > 0.0f;
          if (ok_t) es = es / fmaxf(er2, 1e-20f);  // etaScale (path.go:105)
        }
      } else {  // rough glass: GGX NDF half-vector, Fresnel R/T choice
        float whx, why, whz;
        ggx_half_vector(alpha_g, ub0, ub1, cos_o, ssx, ssy, ssz, tsx, tsy, tsz, nx, ny, nz,
                        whx, why, whz);
        const float doh = dot3(wox, woy, woz, whx, why, whz);
        const float fr_wh = fresnel_diel(doh, eta_g);
        const bool choose_rg = u_lobe < fr_wh;
        if (choose_rg) {  // reflection about wh
          wix_n = 2.0f * doh * whx - wox;
          wiy_n = 2.0f * doh * why - woy;
          wiz_n = 2.0f * doh * whz - woz;
        } else {  // refraction about wh oriented toward wo
          const float sgn_o = doh < 0.0f ? -1.0f : 1.0f;
          const float ci_h = fabsf(doh);
          const float sin2_h = er2 * (1.0f - ci_h * ci_h);
          const float cth_h = sqrtf(fmaxf(1.0f - sin2_h, 0.0f));
          const float coef_h = eta_ratio * ci_h - cth_h;
          wix_n = coef_h * sgn_o * whx - eta_ratio * wox;
          wiy_n = coef_h * sgn_o * why - eta_ratio * woy;
          wiz_n = coef_h * sgn_o * whz - eta_ratio * woz;
          if (sin2_h < 1.0f) es = es / fmaxf(er2, 1e-20f);
        }
        normalize3(wix_n, wiy_n, wiz_n, 1e-20f);
        float r_s, t_s;
        rough_glass_eval(fr, alpha_g, eta_g, F_o_rgl, wix_n, wiy_n, wiz_n, r_s, t_s, pdf_b);
        const float aci_s = fabsf(dot3(wix_n, wiy_n, wiz_n, nx, ny, nz));
        const float thr_rg = pdf_b > 1e-9f ? aci_s / fmaxf(pdf_b, 1e-20f) : 0.0f;
        fR = (sh[SH_KR] * r_s + ktr * t_s) * thr_rg;
        fG = (sh[SH_KR + 1] * r_s + ktg * t_s) * thr_rg;
        fB = (sh[SH_KR + 2] * r_s + ktb * t_s) * thr_rg;
        ok = pdf_b > 1e-9f && max3(fR, fG, fB) > 0.0f;
      }
    } else if (is_pla && !(U1(D_BSDF_LOBE) < 0.5f)) {
      // plastic, the GGX half of the lobe choice (pallas_mesh_megakernel.py
      // :1104-1140): reflect wo about a GGX half-vector, then the two-lobe
      // f and the averaged pdf toward it
      float whx, why, whz;
      ggx_half_vector(alpha_g, ub0, ub1, cos_o, ssx, ssy, ssz, tsx, tsy, tsz, nx, ny, nz,
                      whx, why, whz);
      const float doh = dot3(wox, woy, woz, whx, why, whz);
      wix_n = 2.0f * doh * whx - wox;
      wiy_n = 2.0f * doh * why - woy;
      wiz_n = 2.0f * doh * whz - woz;
      normalize3(wix_n, wiy_n, wiz_n, 1e-20f);
      ok = true;
    } else {  // Lambert (and plastic's diffuse half): cosine hemisphere (path.go:91-101)
      float dxl, dyl;
      concentric_disk(ub0, ub1, dxl, dyl);
      float zl = sqrtf(fmaxf(1.0f - dxl * dxl - dyl * dyl, 0.0f));
      if (cos_o < 0.0f) zl = -zl;  // sample on wo's side
      wix_n = ssx * dxl + tsx * dyl + nx * zl;
      wiy_n = ssy * dxl + tsy * dyl + ny * zl;
      wiz_n = ssz * dxl + tsz * dyl + nz * zl;
      pdf_b = fabsf(zl) * INV_PI_F;
      const float cos_n = fabsf(dot3(wix_n, wiy_n, wiz_n, nx, ny, nz));
      ok = pdf_b > 1e-9f && max3(kdr, kdg, kdb) * INV_PI_F > 0.0f && cos_o * zl > 0.0f;
      const float thr = ok ? (INV_PI_F * cos_n) / fmaxf(pdf_b, 1e-20f) : 0.0f;
      fR = kdr * thr;
      fG = kdg * thr;
      fB = kdb * thr;
    }
    if (is_pla) {  // plastic: f and pdf of both lobes toward the sample
      const float cos_ip = dot3(wix_n, wiy_n, wiz_n, nx, ny, nz);
      const bool same_p = cos_o * cos_ip > 0.0f;
      const GgxReflection g = ggx_reflection(fr, alpha_g, eta_g, wix_n, wiy_n, wiz_n, cos_ip);
      const float acip = fabsf(cos_ip);
      pdf_b = 0.5f * ((same_p ? acip * INV_PI_F : 0.0f) + g.mf_pdf);
      const float diff_p = same_p ? INV_PI_F : 0.0f;
      fR = kdr * diff_p + sh[SH_KR] * g.refl;
      fG = kdg * diff_p + sh[SH_KR + 1] * g.refl;
      fB = kdb * diff_p + sh[SH_KR + 2] * g.refl;
      ok = pdf_b > 1e-9f && max3(fR, fG, fB) > 0.0f;
      const float thr_p = ok ? acip / fmaxf(pdf_b, 1e-20f) : 0.0f;
      fR = fR * thr_p;
      fG = fG * thr_p;
      fB = fB * thr_p;
    }
    bool more = ok;
    if (more) {
      bR = bR * fR;
      bG = bG * fG;
      bB = bB * fB;
      more = max3(bR, bG, bB) > 0.0f;
    }
    float nox = 0.0f, noy = 0.0f, noz = 0.0f;
    if (more) {
      const float sgn_n = dot3(wix_n, wiy_n, wiz_n, nx, ny, nz) < 0.0f ? -1.0f : 1.0f;
      nox = px + sgn_n * d_off * nx;
      noy = py + sgn_n * d_off * ny;
      noz = pz + sgn_n * d_off * nz;
      spec = is_mir || is_gls;  // rough glass and plastic are not delta lobes
      prev_pdf = pdf_b;
      cw = fw_hit;

      // ---- Russian roulette (path.go:143-153), beta weighted by etaScale
      const float rr_max = max3(bR, bG, bB) * es;
      if (b >= P.rr_start && rr_max < P.rr_threshold) {
        const float q = fmaxf(0.05f, 1.0f - rr_max);
        if (U1(D_RR) < q) {
          more = false;
        } else {
          const float surv = 1.0f / (1.0f - q);
          bR = bR * surv;
          bG = bG * surv;
          bB = bB * surv;
        }
      }
      more = more && ++s.b < P.max_depth;
    }
#undef U1
    if (r.shadow) {  // the shadow ray first; the path's next ray waits in s
      s.more = more;
      s.nox = nox;
      s.noy = noy;
      s.noz = noz;
      s.ndx = wix_n;
      s.ndy = wiy_n;
      s.ndz = wiz_n;
      return true;
    }
    r = Ray{nox, noy, noz, wix_n, wiy_n, wiz_n, BIG, false};
    return more;
  }
}

// After the bounce's shadow ray (r, occluded or not): its contribution, then
// the path's next ray into r.  False when the path ends.
GOPBRT_HD bool path_shadow(PathState& s, Ray& r, bool occluded) {
  if (!occluded) {
    s.LR = s.LR + s.pR;
    s.LG = s.LG + s.pG;
    s.LB = s.LB + s.pB;
  }
  r = Ray{s.nox, s.noy, s.noz, s.ndx, s.ndy, s.ndz, BIG, false};
  return s.more;
}

// Writes the path's radiance, NaN/Inf sanitized (renderWorker,
// integrator.go:256-262).
GOPBRT_HD void path_finish(const PathState& s, float* L_out) {
  const bool finite = isfinite(s.LR) && isfinite(s.LG) && isfinite(s.LB);
  L_out[3 * s.lane] = finite ? fmaxf(s.LR, 0.0f) : 0.0f;
  L_out[3 * s.lane + 1] = finite ? fmaxf(s.LG, 0.0f) : 0.0f;
  L_out[3 * s.lane + 2] = finite ? fmaxf(s.LB, 0.0f) : 0.0f;
}

// One step of a path: one trace of its ray r, a closest hit then the rest
// of the bounce (path_hit), or a shadow ray then its contribution
// (path_shadow), from one call site of the policy's trace, so lanes at
// either kind of trace walk together; with S::kShadowAtOnce the shadow ray
// follows its closest hit in the same step.  False when the path has
// ended.
template <class S>
GOPBRT_HD bool path_step(const S& scene, const LightTables& LT, const Params& P,
                         PathState& s, Ray& r) {
  int idx;
  const float t = scene.trace(r, idx);
  bool active = r.shadow ? path_shadow(s, r, idx >= 0) : path_hit(scene, LT, P, s, r, t, idx);
  if (S::kShadowAtOnce && active && r.shadow) {
    scene.trace(r, idx);
    active = path_shadow(s, r, idx >= 0);
  }
  return active;
}

#ifdef __CUDACC__

// The persistent loop of both instances (csrc/lanes.cuh): each lane makes
// one step of its path per iteration (path_step).  A lane whose path has
// ended writes its radiance and takes the next path.  s: this thread's
// path state, where its kernel keeps it.  All threads of the block enter.
template <class S>
__device__ void run_paths(const S& scene, const LightTables& LT, const Params& P,
                          const float* o, const float* d, const int* pixel,
                          const int* sample, float* L, int* next, PathState& s) {
  Ray r;
  bool active = false, drained = false;
  for (;;) {
    const int i = take_next(!active, P.n, next, drained);
    if (i >= 0) {
      path_init(s, r, P, o, d, pixel, sample, i);
      active = P.max_depth > 0;
      if (!active) path_finish(s, L);
    }
    if (!__any_sync(FULL_MASK, active)) {
      if (drained) break;
      continue;
    }
    if (active) {
      active = path_step(scene, LT, P, s, r);
      if (!active) path_finish(s, L);
    }
  }
}

#endif  // __CUDACC__

}  // namespace gopbrt
