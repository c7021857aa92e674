// One bounce of the inline parity trace, and its adjoint, shared by the
// forward megakernel (megakernel.cu) and the backward one (megakernel_vjp.cu).
//
// The forward functions are the TPU kernels' `_nearest_hit_fold`,
// `_draw_vec` and `_brdf_sample_from_vec`
// (haskell_path_tracer_tpu/ops/pallas_megakernel.py), op for op, so that the
// backward kernel's replay takes the forward kernel's decisions bit for bit.
// `bounce_vjp` is the hand-written reverse mode of one live bounce with the
// decisions detached (the winner, the BRDF branch, the Fresnel choice, the
// dead mask): it is what the TPU backward kernel got from `jax.vjp` of
// `_bounce_core`.  Where a function has a kink (min, max, clamp, abs), the
// adjoint takes the branch that PyTorch's autograd takes, so it matches the
// plain version's gradients on ties too.
//
// HPT_HD makes every function callable on the device under nvcc and on the
// host under a plain C++ compiler, so the adjoint can be checked on a
// machine without a GPU (tests/test_torch_adjoint_host.py).

#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define HPT_HD __host__ __device__ __forceinline__
#else
#define HPT_HD inline
#endif

namespace hpt {

constexpr float kInfinite = 3.40282347e+38f;  // f32 max: a miss
constexpr float kEpsilon = 0.002f;            // next-ray origin offset
constexpr float kPlaneDenomEps = 1e-6f;
constexpr float kNearZeroEps = 1e-6f;
constexpr float kPi = 3.14159274f;            // float32(pi)
constexpr float kInvPi = 0.318309873f;        // used only by the adjoint
constexpr float kInvTwoPi = 0.159154937f;     // float32(1 / (2 pi))
constexpr float kInv2Pow24 = 5.96046448e-08f; // 2^-24
constexpr float kBoxTiny = 1e-12f;

enum Kind { kSphere = 0, kPlane = 1, kBox = 2, kTriangle = 3 };

struct Rng {
  uint32_t a, b, c, ctr;
};

HPT_HD float uniform(Rng& r) {
  uint32_t t = r.a + r.b + r.ctr;
  r.ctr = r.ctr + 1u;
  r.a = r.b ^ (r.b >> 9);
  r.b = r.c + (r.c << 3);
  r.c = ((r.c << 21) | (r.c >> 11)) + t;
  // (t >> 8) < 2^24, so the int -> float conversion is exact.
  return (float)(int)(t >> 8) * kInv2Pow24;
}

// genVec: three uniforms mapped to [-1, 1].
HPT_HD void draw_vec(Rng& r, float* v) {
  v[0] = uniform(r) * 2.0f - 1.0f;
  v[1] = uniform(r) * 2.0f - 1.0f;
  v[2] = uniform(r) * 2.0f - 1.0f;
}

// The scene tables of ops/megakernel.py:scene_tables, with the per-kind
// row ranges spheres ++ planes ++ boxes ++ triangles.
struct Tables {
  const float* geom;  // [P, gcols]
  const float* mat;   // [P, 8]
  int gcols, ns, np, nb, nt;

  HPT_HD int count() const { return ns + np + nb + nt; }
  HPT_HD int kind(int p) const {
    return p < ns ? kSphere : (p < ns + np ? kPlane : (p < ns + np + nb ? kBox : kTriangle));
  }
  HPT_HD const float* row(int p) const { return geom + p * gcols; }
};

// The cosines and sines of the half angles of a rotation by Euler angles
// (roll rx, pitch ry, yaw rz): what angles_to_quat and its adjoint share.
// sincosf gives the bits of sinf and cosf with one range reduction.
struct HalfAngles {
  float cy, sy, cp, sp, cr, sr;
};

HPT_HD HalfAngles half_angles(float rx, float ry, float rz) {
  HalfAngles a;
  sincosf(rz * 0.5f, &a.sy, &a.cy);
  sincosf(ry * 0.5f, &a.sp, &a.cp);
  sincosf(rx * 0.5f, &a.sr, &a.cr);
  return a;
}

HPT_HD void quat_from(const HalfAngles& a, float* q) {
  q[0] = a.cy * a.cp * a.cr + a.sy * a.sp * a.sr;
  q[1] = a.cy * a.cp * a.sr - a.sy * a.sp * a.cr;
  q[2] = a.sy * a.cp * a.sr + a.cy * a.sp * a.cr;
  q[3] = a.sy * a.cp * a.cr - a.cy * a.sp * a.sr;
}

HPT_HD void angles_to_quat(float rx, float ry, float rz, float* q) {
  quat_from(half_angles(rx, ry, rz), q);
}

// v + w t + u x t with t = 2 (u x v), u = (q1, q2, q3).
HPT_HD void quat_rotate(const float* q, const float* v, float* o) {
  float tx = 2.0f * (q[2] * v[2] - q[3] * v[1]);
  float ty = 2.0f * (q[3] * v[0] - q[1] * v[2]);
  float tz = 2.0f * (q[1] * v[1] - q[2] * v[0]);
  o[0] = v[0] + q[0] * tx + (q[2] * tz - q[3] * ty);
  o[1] = v[1] + q[0] * ty + (q[3] * tx - q[1] * tz);
  o[2] = v[2] + q[0] * tz + (q[1] * ty - q[2] * tx);
}

HPT_HD float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

HPT_HD float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

HPT_HD void slab(float lo, float hi, float o, float d, float& tmin,
                 float& tmax) {
  float d_safe = fabsf(d) < kBoxTiny ? (d < 0.0f ? -kBoxTiny : kBoxTiny) : d;
  float inv = 1.0f / d_safe;
  float t1 = (lo - o) * inv;
  float t2 = (hi - o) * inv;
  tmin = fminf(t1, t2);
  tmax = fmaxf(t1, t2);
}

// Distances along the ray to one primitive; kInfinite on a miss.

HPT_HD float sphere_t(const float* g, const float* o, const float* d) {
  float lx = g[0] - o[0], ly = g[1] - o[1], lz = g[2] - o[2];
  float tca = lx * d[0] + ly * d[1] + lz * d[2];
  float d2 = lx * lx + ly * ly + lz * lz - tca * tca;
  float r2 = g[3] * g[3];
  bool outside = d2 > r2;
  float thc = outside ? 0.0f : sqrtf(fmaxf(r2 - d2, 1e-12f));
  float t = tca - thc;
  bool miss = (tca < 0.0f) || outside || (t < 0.0f);
  return miss ? kInfinite : t;
}

HPT_HD float plane_t(const float* g, const float* o, const float* d) {
  float denom = d[0] * g[3] + d[1] * g[4] + d[2] * g[5];
  float num = (g[0] - o[0]) * g[3] + (g[1] - o[1]) * g[4] + (g[2] - o[2]) * g[5];
  float denom_safe = denom == 0.0f ? kPlaneDenomEps * 0.5f : denom;
  float dist = num / denom_safe;
  bool miss = (denom > kPlaneDenomEps) || (dist < 0.0f);
  return miss ? kInfinite : dist;
}

HPT_HD float box_t(const float* g, const float* o, const float* d) {
  float xl, xh, yl, yh, zl, zh;
  slab(g[0], g[3], o[0], d[0], xl, xh);
  slab(g[1], g[4], o[1], d[1], yl, yh);
  slab(g[2], g[5], o[2], d[2], zl, zh);
  float t_near = fmaxf(xl, fmaxf(yl, zl));
  float t_far = fminf(xh, fminf(yh, zh));
  bool miss = (t_near > t_far) || (t_near <= 0.0f);
  return miss ? kInfinite : t_near;
}

HPT_HD float triangle_t(const float* g, const float* o, const float* d) {
  float e1x = g[3], e1y = g[4], e1z = g[5];
  float e2x = g[6], e2y = g[7], e2z = g[8];
  float pvx = d[1] * e2z - d[2] * e2y;
  float pvy = d[2] * e2x - d[0] * e2z;
  float pvz = d[0] * e2y - d[1] * e2x;
  float det = e1x * pvx + e1y * pvy + e1z * pvz;
  float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  float tvx = o[0] - g[0], tvy = o[1] - g[1], tvz = o[2] - g[2];
  float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  float qvx = tvy * e1z - tvz * e1y;
  float qvy = tvz * e1x - tvx * e1z;
  float qvz = tvx * e1y - tvy * e1x;
  float v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * inv_det;
  float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  bool miss = (det <= kPlaneDenomEps * g[12]) || (u < 0.0f) || (v < 0.0f) ||
              (u + v > 1.0f) || (t < 0.0f);
  return miss ? kInfinite : t;
}

// Nearest hit over all rows: strict `<` keeps the first index on ties.
// Returns the winner's row, or -1 when every primitive misses.
HPT_HD int nearest_hit(const Tables& T, const float* o, const float* d,
                       float& best_t) {
  best_t = kInfinite;
  int best = -1;
  const int plane_end = T.ns + T.np, box_end = plane_end + T.nb,
            P = box_end + T.nt;
  for (int p = 0; p < T.ns; ++p) {
    float t = sphere_t(T.row(p), o, d);
    if (t < best_t) { best_t = t; best = p; }
  }
  for (int p = T.ns; p < plane_end; ++p) {
    float t = plane_t(T.row(p), o, d);
    if (t < best_t) { best_t = t; best = p; }
  }
  for (int p = plane_end; p < box_end; ++p) {
    float t = box_t(T.row(p), o, d);
    if (t < best_t) { best_t = t; best = p; }
  }
  for (int p = box_end; p < P; ++p) {
    float t = triangle_t(T.row(p), o, d);
    if (t < best_t) { best_t = t; best = p; }
  }
  return best;
}

// The winner's distance, recomputed in closed form: the same bits as the
// fold gave it.
HPT_HD float winner_t(const Tables& T, int best, const float* o,
                      const float* d) {
  const float* g = T.row(best);
  switch (T.kind(best)) {
    case kSphere: return sphere_t(g, o, d);
    case kPlane: return plane_t(g, o, d);
    case kBox: return box_t(g, o, d);
    default: return triangle_t(g, o, d);
  }
}

// Hit point h = o + d t and the winner's normal there.
HPT_HD void hit_normal(const Tables& T, int best, float t, const float* o,
                       const float* d, float* h, float* n) {
  h[0] = o[0] + d[0] * t;
  h[1] = o[1] + d[1] * t;
  h[2] = o[2] + d[2] * t;
  const float* g = T.row(best);
  switch (T.kind(best)) {
    case kSphere: {
      float sx = h[0] - g[0], sy = h[1] - g[1], sz = h[2] - g[2];
      float sq = sx * sx + sy * sy + sz * sz;
      float inv = sq > 1e-20f ? 1.0f / sqrtf(sq) : 1e20f;
      n[0] = sx * inv; n[1] = sy * inv; n[2] = sz * inv;
      break;
    }
    case kPlane:
      n[0] = g[3]; n[1] = g[4]; n[2] = g[5];
      break;
    case kBox: {
      // Dominant axis of the centered, half-size-normalized hit offset;
      // x wins ties, then y.
      float qx = (o[0] + d[0] * t - (g[0] + g[3]) * 0.5f) /
                 fmaxf((g[3] - g[0]) * 0.5f, 1e-12f);
      float qy = (o[1] + d[1] * t - (g[1] + g[4]) * 0.5f) /
                 fmaxf((g[4] - g[1]) * 0.5f, 1e-12f);
      float qz = (o[2] + d[2] * t - (g[2] + g[5]) * 0.5f) /
                 fmaxf((g[5] - g[2]) * 0.5f, 1e-12f);
      float aqx = fabsf(qx), aqy = fabsf(qy), aqz = fabsf(qz);
      bool takex = (aqx >= aqy) && (aqx >= aqz);
      bool takey = !takex && (aqy >= aqz);
      n[0] = takex ? sign(qx) : 0.0f;
      n[1] = takey ? sign(qy) : 0.0f;
      n[2] = (takex || takey) ? 0.0f : sign(qz);
      break;
    }
    default:
      n[0] = g[9]; n[1] = g[10]; n[2] = g[11];
  }
}

// The dielectric's quantities that both the sample and its adjoint need.
struct Glass {
  bool inside, take_refl;
  float cos_i, fn[3], aci, eta, cl, sin2, cos_t, k, t[3], tq, tinv;
};

HPT_HD void glass(const float* d, const float* n, float p, float vx,
                  Glass& G) {
  // Snell refraction or reflection, chosen by Schlick-Fresnel with
  // u = (vx + 1) / 2.
  G.cos_i = -(d[0] * n[0] + d[1] * n[1] + d[2] * n[2]);
  G.inside = G.cos_i < 0.0f;
  for (int i = 0; i < 3; ++i) G.fn[i] = G.inside ? -n[i] : n[i];
  G.aci = fabsf(G.cos_i);
  G.eta = G.inside ? p : 1.0f / fmaxf(p, 1e-6f);
  G.cl = fmaxf(1.0f - G.aci * G.aci, 0.0f);
  G.sin2 = G.eta * G.eta * G.cl;
  bool tir = G.sin2 > 1.0f;
  G.cos_t = tir ? 0.0f : sqrtf(fmaxf(1.0f - G.sin2, 1e-12f));
  float r0 = (1.0f - p) / (1.0f + p);
  r0 = r0 * r0;
  float c1 = 1.0f - G.aci;
  float c2 = c1 * c1;
  float fres = r0 + (1.0f - r0) * (c1 * (c2 * c2));
  float refl_p = tir ? 1.0f : fres;
  float u = (vx + 1.0f) * 0.5f;
  G.take_refl = u < refl_p;
  G.k = G.eta * G.aci - G.cos_t;
  for (int i = 0; i < 3; ++i) G.t[i] = G.eta * d[i] + G.k * G.fn[i];
  G.tq = G.t[0] * G.t[0] + G.t[1] * G.t[1] + G.t[2] * G.t[2];
  G.tinv = G.tq > 1e-20f ? 1.0f / sqrtf(G.tq) : 1e20f;
}

// The angles and the vector of the one rotation a matte or glossy sample
// takes: matte turns the normal n by quat(pi v), glossy the mirror
// direction r = d - 2 (d . n) n by quat((1 - p) v).  `ia` is d . n.
HPT_HD void rotation_args(const float* n, const float* d, float ia, float p,
                          bool is_g, const float* v, float* x, float* ang) {
  const float sp = 1.0f - p;
  for (int i = 0; i < 3; ++i) {
    x[i] = is_g ? d[i] - 2.0f * ia * n[i] : n[i];
    ang[i] = is_g ? sp * v[i] : kPi * v[i];
  }
}

// The BRDF sample of `_brdf_sample_from_vec`: the next direction `nd` and
// the throughput scale, from the normal, the incoming direction, the
// winner's brdf_param `p` and kind `kd`, and the random vector `v`.  The
// TPU kernel computes the matte and the glossy sample and selects one; a
// thread computes only its winner's, with the same float operations on the
// value that is used, so the bits are the same.  Matte and glossy lanes of
// a warp share one rotation (its inputs are selected), so they do not
// diverge.
template <bool HAS_DIELECTRIC>
HPT_HD void brdf_sample(const float* n, const float* d, float p, float kd,
                        const float* v, float* nd, float& scale) {
  const float ia = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
  if (HAS_DIELECTRIC && kd == 2.0f) {
    Glass G;
    glass(d, n, p, v[0], G);
    for (int i = 0; i < 3; ++i)
      nd[i] = G.take_refl ? d[i] - 2.0f * ia * n[i] : G.t[i] * G.tinv;
    scale = 1.0f;
    return;
  }
  const bool is_g = kd == 1.0f;
  float x[3], ang[3], q[4];
  rotation_args(n, d, ia, p, is_g, v, x, ang);
  angles_to_quat(ang[0], ang[1], ang[2], q);
  quat_rotate(q, x, nd);
  const float dt = nd[0] * x[0] + nd[1] * x[1] + nd[2] * x[2];
  scale = (is_g ? fmaxf(0.0f, dt) : p / kPi * dt) * kInvTwoPi;
}

// The deterministic Fresnel split of the splitting kernel (split.cu): the
// reflected direction r, the refracted direction t and the reflection
// weight f (1 under total internal reflection, where t carries no weight).
// Op for op `_dielectric_split_planes` of
// haskell_path_tracer_tpu/ops/pallas_split.py, which differs from `glass`
// above: eta = 1 / ior with no clamp, and the refracted direction divided
// by max(|t|, 1e-20) rather than multiplied by a guarded reciprocal.
HPT_HD void dielectric_split(const float* d, const float* n, float ior,
                             float* r, float* t, float& f) {
  const float cos_i = -(d[0] * n[0] + d[1] * n[1] + d[2] * n[2]);
  const bool inside = cos_i < 0.0f;
  float fn[3];
  for (int i = 0; i < 3; ++i) fn[i] = inside ? -n[i] : n[i];
  const float aci = fabsf(cos_i);
  const float eta = inside ? ior : 1.0f / ior;
  const float sin2 = eta * eta * fmaxf(1.0f - aci * aci, 0.0f);
  const bool tir = sin2 > 1.0f;
  const float cos_t = tir ? 0.0f : sqrtf(fmaxf(1.0f - sin2, 1e-12f));
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  const float c1 = 1.0f - aci;
  const float c2 = c1 * c1;
  const float fres = r0 + (1.0f - r0) * (c1 * (c2 * c2));
  f = tir ? 1.0f : fres;
  const float ia = d[0] * fn[0] + d[1] * fn[1] + d[2] * fn[2];
  for (int i = 0; i < 3; ++i) r[i] = d[i] - 2.0f * ia * fn[i];
  const float k = eta * aci - cos_t;
  for (int i = 0; i < 3; ++i) t[i] = eta * d[i] + k * fn[i];
  const float tn = fmaxf(sqrtf(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]), 1e-20f);
  for (int i = 0; i < 3; ++i) t[i] = t[i] / tn;
}

// One live bounce after the fold: from the ray (o, d), the throughput th,
// the winner `best` at distance t and the random vector v, the next ray
// (no, nd), the next throughput nth and the emission em.
template <bool HAS_DIELECTRIC>
HPT_HD void shade(const Tables& T, int best, float t, const float* o,
                  const float* d, const float* th, const float* v, float* no,
                  float* nd, float* nth, float* em) {
  float h[3], n[3];
  hit_normal(T, best, t, o, d, h, n);
  const float* m = T.mat + best * 8;
  float scale;
  brdf_sample<HAS_DIELECTRIC>(n, d, m[4], m[5], v, nd, scale);
  for (int i = 0; i < 3; ++i) {
    em[i] = m[i] * m[3] * th[i];
    nth[i] = th[i] * (m[i] * scale);
    no[i] = h[i] + nd[i] * kEpsilon;
  }
}

// Adjoint helpers -----------------------------------------------------------

// c = a x b
HPT_HD void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// Reverse of c = a x b: ga += b x gc, gb += gc x a.
HPT_HD void cross3_vjp(const float* a, const float* b, const float* gc,
                       float* ga, float* gb) {
  float t[3];
  cross3(b, gc, t);
  for (int i = 0; i < 3; ++i) ga[i] += t[i];
  cross3(gc, a, t);
  for (int i = 0; i < 3; ++i) gb[i] += t[i];
}

// Reverse of z = max(x, y) (or min with `is_min`), split evenly on a tie
// as torch.maximum / torch.minimum do.
HPT_HD void maxmin_vjp(float x, float y, float gz, bool is_min, float& gx,
                       float& gy) {
  if (x == y) {
    gx = gz * 0.5f;
    gy = gz * 0.5f;
  } else {
    bool x_wins = is_min ? x < y : x > y;
    gx = x_wins ? gz : 0.0f;
    gy = x_wins ? 0.0f : gz;
  }
}

// Reverse of n = s / |s| (with the sq > 1e-20 guard): gs += ...
HPT_HD void normalize_vjp(const float* s, float sq, float inv,
                          const float* gn, float* gs) {
  if (sq > 1e-20f) {
    float k = dot3(gn, s) * inv * inv * inv;
    for (int i = 0; i < 3; ++i) gs[i] += gn[i] * inv - k * s[i];
  } else {
    for (int i = 0; i < 3; ++i) gs[i] += gn[i] * inv;
  }
}

// Reverse of quat_rotate: gv += d o / d v, and gq += d o / d q when gq.
HPT_HD void quat_rotate_vjp(const float* q, const float* v, const float* go,
                            float* gv, float* gq) {
  const float u[3] = {q[1], q[2], q[3]};
  float c[3], t[3];
  cross3(u, v, c);
  for (int i = 0; i < 3; ++i) t[i] = 2.0f * c[i];
  // o = v + w t + u x t
  float gt[3], gu[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 3; ++i) {
    gv[i] += go[i];
    gt[i] = q[0] * go[i];
  }
  cross3_vjp(u, t, go, gu, gt);
  // t = 2 (u x v)
  float gc[3] = {2.0f * gt[0], 2.0f * gt[1], 2.0f * gt[2]};
  cross3_vjp(u, v, gc, gu, gv);
  if (gq) {
    gq[0] += dot3(go, t);
    for (int i = 0; i < 3; ++i) gq[i + 1] += gu[i];
  }
}

// Reverse of angles_to_quat: the angles' cotangents from the quaternion's,
// at the half angles `a` the forward computed.
HPT_HD void angles_to_quat_vjp(const HalfAngles& a, const float* gq,
                               float* gang) {
  const float cy = a.cy, sy = a.sy, cp = a.cp, sp = a.sp, cr = a.cr, sr = a.sr;
  const float gw = gq[0], gx = gq[1], gy = gq[2], gz = gq[3];
  float g_cy = gw * cp * cr + gx * cp * sr + gy * sp * cr - gz * sp * sr;
  float g_sy = gw * sp * sr - gx * sp * cr + gy * cp * sr + gz * cp * cr;
  float g_cp = gw * cy * cr + gx * cy * sr + gy * sy * sr + gz * sy * cr;
  float g_sp = gw * sy * sr - gx * sy * cr + gy * cy * cr - gz * cy * sr;
  float g_cr = gw * cy * cp - gx * sy * sp + gy * cy * sp + gz * sy * cp;
  float g_sr = gw * sy * sp + gx * cy * cp + gy * sy * cp - gz * cy * sp;
  gang[0] = 0.5f * (cr * g_sr - sr * g_cr);
  gang[1] = 0.5f * (cp * g_sp - sp * g_cp);
  gang[2] = 0.5f * (cy * g_sy - sy * g_cy);
}

// Reverse of the winner's distance t(g, o, d): adds the cotangent `gt` of t
// into the row's geometry cotangents dg and into go, gd.
HPT_HD void winner_t_vjp(const Tables& T, int best, const float* o,
                         const float* d, float t, float gt, float* dg,
                         float* go, float* gd) {
  const float* g = T.row(best);
  switch (T.kind(best)) {
    case kSphere: {
      // t = tca - sqrt(max(r^2 - d2, 1e-12)), l = c - o, tca = l.d,
      // d2 = l.l - tca^2.
      float l[3] = {g[0] - o[0], g[1] - o[1], g[2] - o[2]};
      float tca = l[0] * d[0] + l[1] * d[1] + l[2] * d[2];
      float d2 = l[0] * l[0] + l[1] * l[1] + l[2] * l[2] - tca * tca;
      float arg = g[3] * g[3] - d2;
      float thc = sqrtf(fmaxf(arg, 1e-12f));
      float g_tca = gt;
      float g_arg = arg >= 1e-12f ? -gt * 0.5f / thc : 0.0f;
      float g_d2 = -g_arg;
      g_tca += g_d2 * (-2.0f * tca);
      for (int i = 0; i < 3; ++i) {
        float g_l = g_d2 * 2.0f * l[i] + g_tca * d[i];
        gd[i] += g_tca * l[i];
        dg[i] += g_l;
        go[i] -= g_l;
      }
      dg[3] += g_arg * 2.0f * g[3];
      break;
    }
    case kPlane: {
      // t = num / denom, num = (p - o).n, denom = d.n (0 displaced to a
      // constant, which carries no cotangent).
      float denom = d[0] * g[3] + d[1] * g[4] + d[2] * g[5];
      float denom_safe = denom == 0.0f ? kPlaneDenomEps * 0.5f : denom;
      float g_num = gt / denom_safe;
      float g_den = denom == 0.0f ? 0.0f : -gt * t / denom_safe;
      for (int i = 0; i < 3; ++i) {
        float po = g[i] - o[i];
        dg[i] += g_num * g[3 + i];
        go[i] -= g_num * g[3 + i];
        dg[3 + i] += g_num * po + g_den * d[i];
        gd[i] += g_den * g[3 + i];
      }
      break;
    }
    case kBox: {
      // t = max(xl, max(yl, zl)), each slab's low end min(t1, t2) with
      // t1 = (lo - o) inv, t2 = (hi - o) inv, inv = 1 / d_safe.
      float tl[3], inv[3], t1[3], t2[3];
      for (int a = 0; a < 3; ++a) {
        float d_safe = fabsf(d[a]) < kBoxTiny ? (d[a] < 0.0f ? -kBoxTiny : kBoxTiny) : d[a];
        inv[a] = 1.0f / d_safe;
        t1[a] = (g[a] - o[a]) * inv[a];
        t2[a] = (g[3 + a] - o[a]) * inv[a];
        tl[a] = fminf(t1[a], t2[a]);
      }
      float g_l[3], g_yz;
      maxmin_vjp(tl[0], fmaxf(tl[1], tl[2]), gt, false, g_l[0], g_yz);
      maxmin_vjp(tl[1], tl[2], g_yz, false, g_l[1], g_l[2]);
      for (int a = 0; a < 3; ++a) {
        float g1, g2;
        maxmin_vjp(t1[a], t2[a], g_l[a], true, g1, g2);
        float g_inv = g1 * (g[a] - o[a]) + g2 * (g[3 + a] - o[a]);
        dg[a] += g1 * inv[a];
        dg[3 + a] += g2 * inv[a];
        go[a] -= (g1 + g2) * inv[a];
        if (!(fabsf(d[a]) < kBoxTiny)) gd[a] -= g_inv * inv[a] * inv[a];
      }
      break;
    }
    default: {
      // Möller–Trumbore: t = (e2 . qv) inv_det, qv = tv x e1, tv = o - v0,
      // det = e1 . pv, pv = d x e2.
      const float* e1 = g + 3;
      const float* e2 = g + 6;
      float pv[3], tv[3], qv[3];
      cross3(d, e2, pv);
      float det = dot3(e1, pv);
      float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
      for (int i = 0; i < 3; ++i) tv[i] = o[i] - g[i];
      cross3(tv, e1, qv);
      float s = dot3(e2, qv);
      float g_s = gt * inv_det;
      float g_det = fabsf(det) < 1e-30f ? 0.0f : -gt * s * inv_det * inv_det;
      float g_qv[3], g_pv[3], g_tv[3] = {0.0f, 0.0f, 0.0f};
      float g_e1[3] = {0.0f, 0.0f, 0.0f}, g_e2[3] = {0.0f, 0.0f, 0.0f};
      for (int i = 0; i < 3; ++i) {
        g_e2[i] += g_s * qv[i];
        g_qv[i] = g_s * e2[i];
        g_e1[i] += g_det * pv[i];
        g_pv[i] = g_det * e1[i];
      }
      cross3_vjp(tv, e1, g_qv, g_tv, g_e1);
      cross3_vjp(d, e2, g_pv, gd, g_e2);
      for (int i = 0; i < 3; ++i) {
        go[i] += g_tv[i];
        dg[i] -= g_tv[i];
        dg[3 + i] += g_e1[i];
        dg[6 + i] += g_e2[i];
      }
    }
  }
}

// Reverse of one live bounce (`shade` after the fold), the random vector v
// and every decision held constant.  In: the cotangents of the next origin
// g_no, next direction g_nd, next throughput g_nth and emission g_em.
// Out (overwritten): the cotangents of the bounce's ray go, gd and
// throughput gth, of the winner's geometry row dg[0..11] and of its
// material row dm[0..4] (color, illuminance, brdf_param).
template <bool HAS_DIELECTRIC>
HPT_HD void bounce_vjp(const Tables& T, int best, const float* o,
                       const float* d, const float* th, const float* v,
                       const float* g_no, const float* g_nd,
                       const float* g_nth, const float* g_em, float* go,
                       float* gd, float* gth, float* dg, float* dm) {
  for (int i = 0; i < 3; ++i) { go[i] = 0.0f; gd[i] = 0.0f; }
  for (int i = 0; i < 12; ++i) dg[i] = 0.0f;
  for (int i = 0; i < 5; ++i) dm[i] = 0.0f;

  // Forward, with the intermediates the reverse needs.
  const float t = winner_t(T, best, o, d);
  float h[3], n[3];
  hit_normal(T, best, t, o, d, h, n);
  const float* m = T.mat + best * 8;
  const float p = m[4], kd = m[5], il = m[3];
  const int kind = T.kind(best);

  // The winner's one rotation (brdf_sample), with the half angles its
  // adjoint reuses.
  const bool is_d = HAS_DIELECTRIC && kd == 2.0f;
  const bool is_g = kd == 1.0f;
  const float ia = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
  float x[3], q[4], rot[3], rdot = 0.0f;
  HalfAngles ha{};
  if (!is_d) {
    float ang[3];
    rotation_args(n, d, ia, p, is_g, v, x, ang);
    ha = half_angles(ang[0], ang[1], ang[2]);
    quat_from(ha, q);
    quat_rotate(q, x, rot);
    rdot = rot[0] * x[0] + rot[1] * x[1] + rot[2] * x[2];
  }
  const float scale = is_d ? 1.0f : (is_g ? fmaxf(0.0f, rdot) : p / kPi * rdot) * kInvTwoPi;

  // Emission em = (c il) th and next throughput nth = th (c scale).
  float G_scale = 0.0f, G_il = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float c = m[i];
    gth[i] = g_em[i] * (c * il) + g_nth[i] * (c * scale);
    dm[i] = g_em[i] * il * th[i] + g_nth[i] * th[i] * scale;
    G_il += g_em[i] * c * th[i];
    G_scale += g_nth[i] * th[i] * c;
  }
  dm[3] = G_il;

  // Next origin no = h + nd eps.
  float G_h[3], G_nd[3], G_n[3] = {0.0f, 0.0f, 0.0f}, G_r[3] = {0.0f, 0.0f, 0.0f};
  float G_p = 0.0f;
  for (int i = 0; i < 3; ++i) {
    G_h[i] = g_no[i];
    G_nd[i] = g_nd[i] + g_no[i] * kEpsilon;
  }

  if (is_d) {
    Glass G;
    glass(d, n, p, v[0], G);
    if (G.take_refl) {
      for (int i = 0; i < 3; ++i) G_r[i] += G_nd[i];
    } else {
      // nd = t tinv, t = eta d + k fn, k = eta aci - cos_t,
      // cos_t = sqrt(max(1 - sin2, 1e-12)), sin2 = eta^2 max(1 - aci^2, 0).
      float G_t[3] = {0.0f, 0.0f, 0.0f};
      normalize_vjp(G.t, G.tq, G.tinv, G_nd, G_t);
      float G_eta = dot3(G_t, d), G_k = dot3(G_t, G.fn);
      for (int i = 0; i < 3; ++i) gd[i] += G.eta * G_t[i];
      G_eta += G_k * G.aci;
      float G_aci = G_k * G.eta;
      float G_cost = -G_k;
      float xs = 1.0f - G.sin2;
      float G_sin2 = xs >= 1e-12f ? -G_cost * 0.5f / G.cos_t : 0.0f;
      G_eta += G_sin2 * (2.0f * G.eta * G.cl);
      float G_cl = G_sin2 * G.eta * G.eta;
      if (1.0f - G.aci * G.aci >= 0.0f) G_aci += G_cl * (-2.0f * G.aci);
      float G_cosi = G_aci * sign(G.cos_i);
      for (int i = 0; i < 3; ++i) {
        gd[i] -= G_cosi * n[i];
        G_n[i] -= G_cosi * d[i];
        G_n[i] += (G.inside ? -G.k : G.k) * G_t[i];
      }
      if (G.inside) {
        G_p += G_eta;
      } else if (p >= 1e-6f) {
        float pc = fmaxf(p, 1e-6f);
        G_p -= G_eta / (pc * pc);
      }
    }
  } else {
    // nd = rotate(q, x), x = r (glossy) or n (matte).  Glossy: scale =
    // max(0, nd . r) / (2 pi), q = quat((1 - p) v).  Matte: scale =
    // p / pi (nd . n) / (2 pi), q = quat(pi v), which p does not move.
    float G_rdot;
    if (is_g) {
      G_rdot = rdot >= 0.0f ? G_scale * kInvTwoPi : 0.0f;
    } else {
      const float G_mb = G_scale * kInvTwoPi;
      G_rdot = G_mb * (p / kPi);
      G_p += G_mb * rdot * kInvPi;
    }
    float G_rot[3], G_x[3] = {0.0f, 0.0f, 0.0f}, G_q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < 3; ++i) {
      G_rot[i] = G_nd[i] + G_rdot * x[i];
      G_x[i] += G_rdot * rot[i];
    }
    quat_rotate_vjp(q, x, G_rot, G_x, G_q);
    if (is_g) {
      float G_ang[3];
      angles_to_quat_vjp(ha, G_q, G_ang);
      G_p -= G_ang[0] * v[0] + G_ang[1] * v[1] + G_ang[2] * v[2];
    }
    for (int i = 0; i < 3; ++i) (is_g ? G_r : G_n)[i] = G_x[i];
  }
  dm[4] = G_p;

  // Reflection r = d - 2 (d . n) n.
  {
    float G_ia = -2.0f * dot3(G_r, n);
    for (int i = 0; i < 3; ++i) {
      gd[i] += G_r[i] + G_ia * n[i];
      G_n[i] += -2.0f * ia * G_r[i] + G_ia * d[i];
    }
  }

  // The normal.
  const float* g = T.row(best);
  if (kind == kSphere) {
    float s[3] = {h[0] - g[0], h[1] - g[1], h[2] - g[2]};
    float sq = s[0] * s[0] + s[1] * s[1] + s[2] * s[2];
    float inv = sq > 1e-20f ? 1.0f / sqrtf(sq) : 1e20f;
    float G_s[3] = {0.0f, 0.0f, 0.0f};
    normalize_vjp(s, sq, inv, G_n, G_s);
    for (int i = 0; i < 3; ++i) {
      G_h[i] += G_s[i];
      dg[i] -= G_s[i];
    }
  } else if (kind == kPlane) {
    for (int i = 0; i < 3; ++i) dg[3 + i] += G_n[i];
  } else if (kind == kTriangle) {
    for (int i = 0; i < 3; ++i) dg[9 + i] += G_n[i];
  }  // A box's normal is sign(): no cotangent.

  // Hit point h = o + d t.
  float G_t = 0.0f;
  for (int i = 0; i < 3; ++i) {
    go[i] += G_h[i];
    gd[i] += G_h[i] * t;
    G_t += G_h[i] * d[i];
  }
  winner_t_vjp(T, best, o, d, t, G_t, dg, go, gd);
}

// Per-bounce state the backward replay keeps for the reverse sweep: the
// bounce's ray, throughput, random vector and winner (13 words).
struct Residual {
  float o[3], d[3], th[3], v[3];
  int best;
};

// The backward of one sample: replay its live bounces from the primary ray
// (po, pd) and `rng` (storing their residuals in `st`, which holds at least
// `num_bounces`), then sweep them in reverse with the radiance cotangent
// `g_rad` as the emission cotangent of every bounce.  Adds the primary
// ray's cotangents into g_o, g_d and hands each bounce's row cotangents to
// acc(b, best, dg, dm); leaves `rng` where the sample left it.
template <bool HAS_DIELECTRIC, class Acc>
HPT_HD void sample_backward(const Tables& T, const float* po, const float* pd,
                            Rng& rng, const float* g_rad, int num_bounces,
                            Residual* st, float* g_o, float* g_d, Acc& acc) {
  float o[3] = {po[0], po[1], po[2]}, d[3] = {pd[0], pd[1], pd[2]};
  float th[3] = {1.0f, 1.0f, 1.0f};
  int live = 0;
  for (int b = 0; b < num_bounces; ++b) {
    float best_t;
    int best = nearest_hit(T, o, d, best_t);
    const float q = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
    // A dead bounce passes its ray through and zeroes the throughput, so
    // every later bounce is dead and all their cotangents are zero.
    if (q <= kNearZeroEps || !(best_t < kInfinite)) break;
    Residual& r = st[b];
    for (int i = 0; i < 3; ++i) { r.o[i] = o[i]; r.d[i] = d[i]; r.th[i] = th[i]; }
    r.best = best;
    draw_vec(rng, r.v);
    float no[3], nd[3], nth[3], em[3];
    shade<HAS_DIELECTRIC>(T, best, best_t, o, d, th, r.v, no, nd, nth, em);
    for (int i = 0; i < 3; ++i) { o[i] = no[i]; d[i] = nd[i]; th[i] = nth[i]; }
    live = b + 1;
  }
  // Reverse sweep from the last live bounce.
  float c_o[3] = {0.0f, 0.0f, 0.0f}, c_d[3] = {0.0f, 0.0f, 0.0f},
        c_t[3] = {0.0f, 0.0f, 0.0f};
  for (int b = live - 1; b >= 0; --b) {
    const Residual& r = st[b];
    float go[3], gd[3], gth[3], dg[12], dm[5];
    bounce_vjp<HAS_DIELECTRIC>(T, r.best, r.o, r.d, r.th, r.v, c_o, c_d, c_t,
                               g_rad, go, gd, gth, dg, dm);
    acc(b, r.best, dg, dm);
    for (int i = 0; i < 3; ++i) { c_o[i] = go[i]; c_d[i] = gd[i]; c_t[i] = gth[i]; }
  }
  for (int i = 0; i < 3; ++i) { g_o[i] += c_o[i]; g_d[i] += c_d[i]; }
}

// The whole backward of one pixel: its `spp` samples one after another,
// each from the rng the one before it left.  Returns the final rng (as the
// forward leaves it).
template <bool HAS_DIELECTRIC, class Acc>
HPT_HD Rng pixel_backward(const Tables& T, const float* po, const float* pd,
                          Rng rng, const float* g_rad, int spp,
                          int num_bounces, Residual* st, float* g_o, float* g_d,
                          Acc& acc) {
  for (int s = 0; s < spp; ++s)
    sample_backward<HAS_DIELECTRIC>(T, po, pd, rng, g_rad, num_bounces, st,
                                    g_o, g_d, acc);
  return rng;
}

#if defined(__CUDACC__)
// Where the parity kernels (megakernel.cu, megakernel_vjp.cu, split.cu)
// keep the scene tables: in dynamic shared memory up to the card's opt-in
// limit per block (227 KB on an H100: 4 B x P x (gcols + 8), so about 3600
// primitives with 8 geometry columns), read from device memory through the
// L1 cache beyond it.

// The dynamic shared memory a block of the current device may opt in to.
inline size_t smem_optin_bytes() {
  int device = 0, bytes = 48 * 1024;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (size_t)bytes;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` (a launch above
// 48 KB is refused without it).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// One template instance of a kernel, named for the resource report.
struct KernelInstance {
  const char* name;
  const void* fn;
};

// Launches `kernel` (an instance's fn, whose dynamic shared memory the
// caller allowed) with `args`.
inline cudaError_t launch_instance(const void* kernel, int blocks, int threads,
                                   size_t smem, void** args, cudaStream_t stream) {
  const cudaError_t err =
      cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What the compiler gave `kernel` and what fits on an SM at a launch of
// `threads` threads with `smem` bytes of dynamic shared memory: out =
// {registers per thread, local (stack) bytes per thread, static shared
// bytes, max threads per block, dynamic shared bytes, resident blocks per
// SM, threads per block}.  Raises the kernel's dynamic shared-memory limit
// to `smem` where it is lower, and never lowers it, so that a later launch
// on larger tables is not refused.
inline void kernel_resources(const void* kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (smem > (size_t)a.maxDynamicSharedSizeBytes) allow_smem(kernel, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = (int)smem;
  out[5] = blocks;
  out[6] = threads;
}

// The tables the fold reads: copied into `smem` by the whole block when
// IN_SMEM (call before any thread returns), else the device-memory ones.
// A template parameter, so that the compiler knows which memory the fold's
// loads address.
template <bool IN_SMEM>
__device__ __forceinline__ Tables stage_tables(const float* geom_g, const float* mat_g,
                                               int gcols, int ns, int np, int nb, int nt,
                                               float* smem) {
  Tables T{geom_g, mat_g, gcols, ns, np, nb, nt};
  if (IN_SMEM) {
    const int P = T.count();
    float* geom = smem;
    float* mat = smem + P * gcols;
    for (int i = threadIdx.x; i < P * gcols; i += blockDim.x) geom[i] = geom_g[i];
    for (int i = threadIdx.x; i < P * 8; i += blockDim.x) mat[i] = mat_g[i];
    __syncthreads();
    T.geom = geom;
    T.mat = mat;
  }
  return T;
}
#endif

}  // namespace hpt
