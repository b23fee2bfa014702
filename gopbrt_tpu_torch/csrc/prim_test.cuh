// Ray vs one primitive: the candidate hit distance, BIG on a miss.
//
// Replaces the math of gopbrt_tpu/ops/pallas_intersect.py::_prim_test
// (lines 40-169): sphere (recentred quadratic, z/phi clips on the
// reprojected hit), disk (annulus and phi wedge), world-space
// Moller-Trumbore triangle.  The plain PyTorch twin is
// gopbrt_tpu_torch/ops/brute_intersect.py::prim_test.
//
// On the TPU one primitive is tested against a whole block of rays and
// every shape's math runs on every lane, selected by tag.  Here one thread
// holds one ray and branches on the tag; all threads of a warp test the
// same primitive, so the branch does not diverge.  The wedge test replaces
// atan2 by the sign of a 2D cross product, as the TPU kernel does.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define GOPBRT_HD __device__ __forceinline__
#else
#define GOPBRT_HD inline  // the same math as plain C++ on the host
#endif

namespace gopbrt {

constexpr float BIG = 1e30f;
constexpr int SPHERE = 0;
constexpr int DISK = 1;
constexpr int TRIANGLE = 2;
constexpr double PI_D = 3.14159265358979323846;
constexpr float PI_F = (float)PI_D;
// full-phi threshold of the clip tests (2*pi - 1e-6, rounded to f32)
constexpr float TWO_PI_CLIP = (float)(2.0 * PI_D - 1e-6);

// phi(x, y) <= phi_max, without atan2 (pallas_intersect.py:59-70)
GOPBRT_HD bool in_wedge(float x, float y, float phi_max) {
  const float sin_pm = sinf(phi_max);
  const float cos_pm = cosf(phi_max);
  const float cross = x * sin_pm - y * cos_pm;
  if (phi_max <= PI_F) return (y >= 0.0f) && (cross >= 0.0f);
  return !((y < 0.0f) && (cross < 0.0f));
}

// Reprojected sphere hit at t inside the z range and the phi wedge.
GOPBRT_HD bool sphere_clip_ok(const float* pr, float oox, float ooy, float ooz,
                              float odx, float ody, float odz, float t) {
  const float radius = pr[0];
  const float px = oox + odx * t;
  const float py = ooy + ody * t;
  float pz = ooz + odz * t;
  const float norm = sqrtf(fmaxf(px * px + py * py + pz * pz, 1e-20f));
  const float s = radius / norm;
  pz = pz * s;
  return (pz >= pr[1]) && (pz <= pr[2]) && in_wedge(px * s, py * s, pr[3]);
}

// m: 12 world->object entries (row-major 3x4); pr: 9 params
// (sphere: radius, zmin, zmax, phimax; disk: height, radius, inner,
// phimax; triangle: three world-space vertices).
GOPBRT_HD float prim_test(int ptype, const float* m, const float* pr,
                          float ox, float oy, float oz,
                          float dx, float dy, float dz, float t_limit,
                          bool full_sph, bool full_disk) {
  if (ptype == TRIANGLE) {
    const float e1x = pr[3] - pr[0], e1y = pr[4] - pr[1], e1z = pr[5] - pr[2];
    const float e2x = pr[6] - pr[0], e2y = pr[7] - pr[1], e2z = pr[8] - pr[2];
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool degen = fabsf(det) < 1e-12f;
    const float inv_det = 1.0f / (degen ? 1.0f : det);
    const float tvx = ox - pr[0], tvy = oy - pr[1], tvz = oz - pr[2];
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    const bool hit = !degen && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                     tt > 1e-4f && tt < t_limit;
    return hit ? tt : BIG;
  }
  // world -> object
  const float oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
  const float ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
  const float ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
  const float odx = m[0] * dx + m[1] * dy + m[2] * dz;
  const float ody = m[4] * dx + m[5] * dy + m[6] * dz;
  const float odz = m[8] * dx + m[9] * dy + m[10] * dz;
  if (ptype == SPHERE) {
    const float radius = pr[0];
    const float a = odx * odx + ody * ody + odz * odz;
    const float safe_a = (a == 0.0f) ? 1.0f : a;
    const float t_foot = -(oox * odx + ooy * ody + ooz * odz) / safe_a;
    const float fx = oox + odx * t_foot;
    const float fy = ooy + ody * t_foot;
    const float fz = ooz + odz * t_foot;
    const float disc_core = radius * radius - (fx * fx + fy * fy + fz * fz);
    if (!(disc_core >= 0.0f && a > 0.0f)) return BIG;
    const float delta = sqrtf(fmaxf(disc_core, 0.0f) / safe_a);
    const float lo = t_foot - delta;
    const float hi = t_foot + delta;
    const float olen = sqrtf(fmaxf(oox * oox + ooy * ooy + ooz * ooz, 1.0f));
    const float dlen = sqrtf(fmaxf(a, 1e-20f));
    const float t_eps = 1e-4f * olen / dlen;
    const bool full = full_sph || ((pr[1] <= -radius) && (pr[2] >= radius) &&
                                   (pr[3] >= TWO_PI_CLIP));
    if (lo > t_eps && lo < t_limit &&
        (full || sphere_clip_ok(pr, oox, ooy, ooz, odx, ody, odz, lo)))
      return lo;
    if (hi > t_eps && hi < t_limit &&
        (full || sphere_clip_ok(pr, oox, ooy, ooz, odx, ody, odz, hi)))
      return hi;
    return BIG;
  }
  // DISK
  const bool parallel = fabsf(odz) < 1e-12f;
  const float t_pl = (pr[0] - ooz) / (parallel ? 1.0f : odz);
  const float pxd = oox + odx * t_pl;
  const float pyd = ooy + ody * t_pl;
  const float d2 = pxd * pxd + pyd * pyd;
  bool hit = !parallel && t_pl > 1e-4f && t_pl < t_limit && d2 <= pr[1] * pr[1];
  if (hit && !full_disk)
    hit = d2 >= pr[2] * pr[2] && (pr[3] >= TWO_PI_CLIP || in_wedge(pxd, pyd, pr[3]));
  return hit ? t_pl : BIG;
}

}  // namespace gopbrt
