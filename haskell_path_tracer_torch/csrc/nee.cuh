// One pixel of the physical/NEE estimator, shared by the NEE megakernel and
// the primary-hit probe (nee_megakernel.cu).
//
// The functions are haskell_path_tracer_torch/render/nee.py's plain version
// (the JAX package's render/nee.py:trace_physical(nee=True)) op for op, in
// the f32 sequence of the TPU kernel's folds (ops/pallas_nee.py:_sphere_fold,
// _merge_*_ref): the same rounding at every step, so that the kernel takes
// the plain version's decisions lane for lane.  Built with -fmad=false and
// without fast math; normals and directions divide by the norm.
//
// Shade frame: a bounce's queries start AT the hit point and accept
// t >= EPSILON; only the primary fold accepts t >= 0.  (The parity family in
// bounce.cuh shifts the origin instead, so its fold is not reused here; only
// its RNG, constants and slab test are.)
//
// HPT_HD makes every function callable on the host too, so
// tests/test_torch_nee_host.py can run the per-pixel code with g++.

#pragma once

#include "bounce.cuh"

namespace hpt {
namespace nee {

constexpr float kTwoPi = 6.28318548f;         // float32(2 pi)
constexpr float kMinD2 = 0x1.0c6f7cp-16f;     // float32((2 EPSILON)^2)

// The tables of ops/nee.py:nee_scene_tables.
struct Scene {
  const float* fold;     // spheres [ns, 4] ++ planes [np, 8] ++ boxes [nb, 8]
                         // ++ triangles [nt, 12], one flat f32 array
  const float* payload;  // [P, 12]: aux(3) aux2(3) color(3) il param kind
  const float* lights;   // [nl, 16]: kind gidx emit(3) c|v0(3) r e1(3) e2(3) 0
  int ns, np, nb, nt, nl;

  HPT_HD const float* sphere(int p) const { return fold + 4 * p; }
  HPT_HD const float* plane(int j) const { return fold + 4 * ns + 8 * j; }
  HPT_HD const float* box(int k) const { return fold + 4 * ns + 8 * np + 8 * k; }
  HPT_HD const float* tri(int k) const {
    return fold + 4 * ns + 8 * np + 8 * nb + 12 * k;
  }
  HPT_HD int fold_floats() const { return 4 * ns + 8 * np + 8 * nb + 12 * nt; }
};

HPT_HD void load4(const float* p, float* g) {
#if defined(__CUDA_ARCH__)
  const float4 v = *reinterpret_cast<const float4*>(p);
  g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
#else
  g[0] = p[0]; g[1] = p[1]; g[2] = p[2]; g[3] = p[3];
#endif
}

HPT_HD void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// The raw distances of one row along the ray (o, d), with no acceptance
// test: the folds' expressions, which the NEE backward (nee_vjp.cuh:
// winner_t) shares so that the distance it recomputes for a fold's winner
// is the fold's own bit for bit.

// The parts of `sphere_root`, for a fold that takes the rare branch
// (h >= 0) itself (sphere_fold.cuh): l = c - o and tca = l.d; ll = l.l and
// h; the near root.
HPT_HD float sphere_tca(const float* g, const float* o, const float* d, float* l) {
  l[0] = g[0] - o[0];
  l[1] = g[1] - o[1];
  l[2] = g[2] - o[2];
  return l[0] * d[0] + l[1] * d[1] + l[2] * d[2];
}

HPT_HD float sphere_h(const float* g, const float* l, float tca, float& ll) {
  ll = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
  return g[3] - (ll - tca * tca);
}

HPT_HD float sphere_near(float tca, float h) { return tca - sqrtf(fmaxf(h, 1e-12f)); }

// A sphere row g = [c, r^2]: the near root tca - sqrt(max(h, 1e-12)), with
// l = c - o, ll = l.l and the discriminant h = r^2 - (ll - tca^2).  Where
// h < 0 (or NaN) the row misses, every caller rejects it, and no square
// root is taken: kInfinite.  At 1000 spheres nearly every row misses.
HPT_HD float sphere_root(const float* g, const float* o, const float* d, float* l,
                         float& ll, float& h) {
  const float tca = sphere_tca(g, o, d, l);
  h = sphere_h(g, l, tca, ll);
  if (!(h >= 0.0f)) return kInfinite;
  return sphere_near(tca, h);
}

// The halves of `sphere_blocks`, for a fold that takes the rare branch
// (h2 >= 0) itself (sphere_fold.cuh): tca2 = l.b and h2; the test.
HPT_HD float sphere_shadow_h(const float* g, const float* l, float ll, const float* b,
                             float& tca2) {
  tca2 = l[0] * b[0] + l[1] * b[1] + l[2] * b[2];
  return g[3] - (ll - tca2 * tca2);
}

HPT_HD bool sphere_blocks_from(float tca2, float h2, float t_l) {
  float a1 = tca2 - kEpsilon;
  float a2 = tca2 - t_l;
  return h2 >= 0.0f && a1 >= 0.0f && a1 * a1 >= h2 && (a2 < 0.0f || a2 * a2 < h2);
}

// Whether the sphere row g blocks [EPSILON, t_l) along the unit b from the
// origin o of `sphere_root`'s ray, from its l = c - o and ll = l.l: the
// sqrt-free shadow test, a1 = tca2 - EPSILON >= 0 with a1^2 >= h2 (the near
// root at or past EPSILON) and the near root before t_l.  The NEE folds
// (`fold<true>`) and the dual fold (sphere_fold.cuh) share it.
HPT_HD bool sphere_blocks(const float* g, const float* l, float ll, const float* b,
                          float t_l) {
  float tca2;
  const float h2 = sphere_shadow_h(g, l, ll, b, tca2);
  return sphere_blocks_from(tca2, h2, t_l);
}

// A plane row [p, n]: (p - o).n / d.n, a zero denominator displaced.
HPT_HD float plane_t(const float* g, const float* o, const float* d, float& denom) {
  denom = d[0] * g[3] + d[1] * g[4] + d[2] * g[5];
  float num = (g[0] - o[0]) * g[3] + (g[1] - o[1]) * g[4] + (g[2] - o[2]) * g[5];
  return num / (denom == 0.0f ? kPlaneDenomEps * 0.5f : denom);
}

// Möller–Trumbore on a row [v0(3), e1(3), e2(3), |e1 x e2|]; tv = origin - v0.
struct Barycentric {
  float det, u, v, t;
};

HPT_HD Barycentric moller_trumbore(const float* g, const float* tv, const float* d) {
  const float* e1 = g + 3;
  const float* e2 = g + 6;
  float pv[3];
  cross3(d, e2, pv);
  Barycentric r;
  r.det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
  float inv_det = 1.0f / (fabsf(r.det) < 1e-30f ? 1e-30f : r.det);
  r.u = dot3(tv, pv) * inv_det;
  float qv[3];
  cross3(tv, e1, qv);
  r.v = dot3(d, qv) * inv_det;
  r.t = dot3(e2, qv) * inv_det;
  return r;
}

// Distances along the ray, kInfinite on a miss, accepting t >= rej
// (ops/intersect.py's plane_distances, box_distances, triangle_distances).

HPT_HD float plane_dist(const float* g, const float* o, const float* d,
                        float rej) {
  float denom;
  float dist = plane_t(g, o, d, denom);
  return (denom > kPlaneDenomEps || dist < rej) ? kInfinite : dist;
}

HPT_HD float box_dist(const float* g, const float* o, const float* d,
                      float rej) {
  float xl, xh, yl, yh, zl, zh;
  slab(g[0], g[3], o[0], d[0], xl, xh);
  slab(g[1], g[4], o[1], d[1], yl, yh);
  slab(g[2], g[5], o[2], d[2], zl, zh);
  float t_near = fmaxf(xl, fmaxf(yl, zl));
  float t_far = fminf(xh, fminf(yh, zh));
  return (t_near > t_far || t_near <= 0.0f || t_near < rej) ? kInfinite : t_near;
}

HPT_HD float tri_dist(const float* g, const float* tv, const float* d,
                      float rej) {
  const Barycentric r = moller_trumbore(g, tv, d);
  bool miss = (r.det <= kPlaneDenomEps * g[9]) || (r.u < 0.0f) || (r.v < 0.0f) ||
              (r.u + r.v > 1.0f) || (r.t < rej);
  return miss ? kInfinite : r.t;
}

// The nearest (t, prim) of the ray (o, d) over spheres ++ planes ++ boxes ++
// triangles, accepting t >= eps, strict `<` so the first index wins ties,
// prim 0 when everything misses.  With SHADOW it also answers, in the same
// pass over the tables, whether anything but primitive `lgi` blocks
// [EPSILON, t_l) along b from the same origin: spheres by the sqrt-free
// test sharing the `center - o` vector, planes, boxes and triangles by their
// distances in that window.
template <bool SHADOW>
HPT_HD void fold(const Scene& S, const float* o, const float* d, float eps,
                 float& best_t, int& best_p, const float* b, float t_l, int lgi,
                 bool& occ) {
#ifdef HPT_FOLD_COUNTER
  ++HPT_FOLD_COUNTER;  // the host harness counts the folds a function runs
#endif
  best_t = kInfinite;
  best_p = 0;
  for (int p = 0; p < S.ns; ++p) {
    float g[4];
    load4(S.sphere(p), g);
    float l[3], ll, h;
    float t = sphere_root(g, o, d, l, ll, h);
    // tca >= eps is implied: t >= eps with thc > 0.
    if (h >= 0.0f && t >= eps && t < best_t) {
      best_t = t;
      best_p = p;
    }
    if (SHADOW) {
      const bool blocks = sphere_blocks(g, l, ll, b, t_l);
      occ = occ || (blocks && p != lgi);
    }
  }
  int base = S.ns;
  for (int j = 0; j < S.np; ++j) {
    const float* g = S.plane(j);
    float t = plane_dist(g, o, d, eps);
    if (t < best_t) { best_t = t; best_p = base + j; }
    if (SHADOW) {
      float sd = plane_dist(g, o, b, 0.0f);
      occ = occ || (sd >= kEpsilon && sd < t_l);
    }
  }
  base += S.np;
  for (int k = 0; k < S.nb; ++k) {
    const float* g = S.box(k);
    float t = box_dist(g, o, d, eps);
    if (t < best_t) { best_t = t; best_p = base + k; }
    if (SHADOW) occ = occ || box_dist(g, o, b, kEpsilon) < t_l;
  }
  base += S.nb;
  for (int k = 0; k < S.nt; ++k) {
    const float* g = S.tri(k);
    float tv[3] = {o[0] - g[0], o[1] - g[1], o[2] - g[2]};
    float t = tri_dist(g, tv, d, eps);
    if (t < best_t) { best_t = t; best_p = base + k; }
    if (SHADOW)
      occ = occ || (tri_dist(g, tv, b, kEpsilon) < t_l && base + k != lgi);
  }
}

// The camera ray's nearest hit, eps = 0: the probe's function.
HPT_HD void primary_hit(const Scene& S, const float* o, const float* d,
                        float& t, int& prim) {
  bool unused = false;
  fold<false>(S, o, d, 0.0f, t, prim, nullptr, 0.0f, -1, unused);
}

// Branchless ONB around the unit vector w (Duff et al. 2017).
HPT_HD void onb(const float* w, float* b1, float* b2) {
  float sign = w[2] >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + w[2]);
  float b = w[0] * w[1] * a;
  b1[0] = 1.0f + sign * (w[0] * w[0]) * a;
  b1[1] = sign * b;
  b1[2] = -sign * w[0];
  b2[0] = b;
  b2[1] = sign + (w[1] * w[1]) * a;
  b2[2] = -w[1];
}

HPT_HD void cosine_hemisphere(const float* n, float u1, float u2, float* dir) {
  float r = sqrtf(u1);
  float phi = kTwoPi * u2;
  float x = r * cosf(phi);
  float y = r * sinf(phi);
  float z = sqrtf(fmaxf(1.0f - u1, 1e-12f));
  float b1[3], b2[3];
  onb(n, b1, b2);
  for (int i = 0; i < 3; ++i) dir[i] = b1[i] * x + b2[i] * y + n[i] * z;
}

// ops/brdf.py:dielectric_split and the choice of its branch by u3.
HPT_HD void dielectric(const float* d, const float* n, float ior, float u3,
                       float* dir) {
  float cos_i = -dot3(d, n);
  bool inside = cos_i < 0.0f;
  float fn[3];
  for (int i = 0; i < 3; ++i) fn[i] = inside ? -n[i] : n[i];
  cos_i = fabsf(cos_i);
  float eta = inside ? ior : 1.0f / ior;
  float sin2 = eta * eta * fmaxf(1.0f - cos_i * cos_i, 0.0f);
  bool tir = sin2 > 1.0f;
  float cos_t = tir ? 0.0f : sqrtf(fmaxf(1.0f - sin2, 1e-12f));
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  float c = 1.0f - cos_i;
  float c2 = c * c;
  float fresnel = r0 + (1.0f - r0) * (c * (c2 * c2));
  if (u3 < (tir ? 1.0f : fresnel)) {
    float ia = dot3(d, fn);
    for (int i = 0; i < 3; ++i) dir[i] = d[i] - 2.0f * ia * fn[i];
  } else {
    float k = eta * cos_i - cos_t;
    float t[3];
    for (int i = 0; i < 3; ++i) t[i] = eta * d[i] + k * fn[i];
    float tn = fmaxf(sqrtf(dot3(t, t)), 1e-20f);
    for (int i = 0; i < 3; ++i) dir[i] = t[i] / tn;
  }
}

// Outward normal of the box face holding h: the dominant axis of the
// centered, half-size-normalized offset (x wins ties, then y).
HPT_HD void box_normal(const float* h, const float* lo, const float* hi,
                       float* n) {
  float q[3];
  for (int i = 0; i < 3; ++i)
    q[i] = (h[i] - (lo[i] + hi[i]) * 0.5f) / fmaxf((hi[i] - lo[i]) * 0.5f, 1e-12f);
  float ax = fabsf(q[0]), ay = fabsf(q[1]), az = fabsf(q[2]);
  int axis = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  float s = sign(q[axis]);
  for (int i = 0; i < 3; ++i) n[i] = (i == axis ? 1.0f : 0.0f) * s;
}

// Uniform direction in the cone a sphere subtends from p, with the robust
// one-minus forms (render/nee.py:_cone_sample); returns the solid angle.
HPT_HD float cone_sample(const float* c, float radius, const float* p,
                         float u1, float u2, float* dir) {
  float to_c[3] = {c[0] - p[0], c[1] - p[1], c[2] - p[2]};
  float dc2 = dot3(to_c, to_c);
  float dc = sqrtf(fmaxf(dc2, 1e-12f));
  float sin2_max = fminf(fmaxf(radius * radius / fmaxf(dc2, 1e-12f), 0.0f), 1.0f);
  bool on_sphere = sin2_max >= 1.0f;
  float cos_max = on_sphere ? 0.0f : sqrtf(1.0f - sin2_max);
  float omc = on_sphere ? 1.0f : sin2_max / (1.0f + cos_max);
  float x = u1 * omc;
  float cos_t = 1.0f - x;
  float st2 = x * (1.0f + cos_t);
  float sin_t = st2 > 0.0f ? sqrtf(st2) : 0.0f;
  float phi = kTwoPi * u2;
  float w[3] = {to_c[0] / dc, to_c[1] / dc, to_c[2] / dc};
  float b1[3], b2[3];
  onb(w, b1, b2);
  float sc = sin_t * cosf(phi), ss = sin_t * sinf(phi);
  for (int i = 0; i < 3; ++i) dir[i] = b1[i] * sc + b2[i] * ss + w[i] * cos_t;
  return kTwoPi * omc;
}

// Distance from p to one sphere along dir, shade frame (tca, t >= EPSILON).
HPT_HD float sphere_t_single(const float* p, const float* dir, const float* c,
                             float radius) {
  float l[3] = {c[0] - p[0], c[1] - p[1], c[2] - p[2]};
  float tca = dot3(l, dir);
  float d2 = dot3(l, l) - tca * tca;
  float r2 = radius * radius;
  bool outside = d2 > r2;
  float thc = outside ? 0.0f : sqrtf(fmaxf(r2 - d2, 1e-12f));
  float t = tca - thc;
  return (tca < kEpsilon || outside || t < kEpsilon) ? kInfinite : t;
}

// One emitter of the light table, chosen by us0, sampled towards from the
// shade point p (render/nee.py:sample_light): the direction b, inv_pdf
// (with the 1/L selection, 0 for an invalid sample), the emitter's global
// index, the distance t_l to it along b and its emission.
HPT_HD void sample_light(const Scene& S, const float* p, float us0, float us1,
                         float us2, float* b, float& inv_pdf, int& lgi,
                         float& t_l, float* emit) {
  const float L = (float)S.nl;
  const int k = (int)fminf(fmaxf(floorf(us0 * L), 0.0f), L - 1.0f);
  const float* row = S.lights + 16 * k;
  lgi = (int)row[1];
  for (int i = 0; i < 3; ++i) emit[i] = row[2 + i];
  const float* c = row + 5;
  float inv_pdf_dir;
  if (row[0] == 0.0f) {
    inv_pdf_dir = cone_sample(c, row[8], p, us1, us2, b);
    t_l = sphere_t_single(p, b, c, row[8]);
  } else {
    // Triangle area sampling (render/nee.py:_tri_area_sample), then the
    // distance to it with the unclamped |e1 x e2| (_tri_t_single).
    float g[10];
    for (int i = 0; i < 3; ++i) {
      g[i] = c[i];
      g[3 + i] = row[9 + i];
      g[6 + i] = row[12 + i];
    }
    float nv[3];
    cross3(g + 3, g + 6, nv);
    float nq = dot3(nv, nv);
    float n_norm = sqrtf(fmaxf(nq, 1e-20f));
    float nu[3] = {nv[0] / n_norm, nv[1] / n_norm, nv[2] / n_norm};
    float area = 0.5f * n_norm;
    float r1s = sqrtf(fmaxf(us1, 1e-12f));
    float bu = 1.0f - r1s;
    float bv = us2 * r1s;
    float tq[3];
    for (int i = 0; i < 3; ++i) tq[i] = g[i] + g[3 + i] * bu + g[6 + i] * bv - p[i];
    float d2 = fmaxf(dot3(tq, tq), 1e-12f);
    float sd = sqrtf(d2);
    for (int i = 0; i < 3; ++i) b[i] = tq[i] / sd;
    float cos_l = -dot3(b, nu);
    inv_pdf_dir = (cos_l > 1e-6f && d2 >= kMinD2) ? area * cos_l / d2 : 0.0f;
    g[9] = sqrtf(nq);
    float tv[3] = {p[0] - g[0], p[1] - g[1], p[2] - g[2]};
    t_l = tri_dist(g, tv, b, kEpsilon);
  }
  inv_pdf = inv_pdf_dir > 1e-9f ? inv_pdf_dir * L : 0.0f;
}

// The draws and the shadow decision of one live bounce: what the backward
// replay (nee_vjp.cuh) keeps for the bounce's reverse.
struct Draws {
  float u[3];   // BSDF sample
  float us[3];  // light choice and light sample
  bool occ;     // the shadow ray is blocked (false with no emitter)
};

// The winner's hit point and normal: a sphere's normal is the normalised
// offset from the center its payload row holds, a box's the face's, a
// plane's and a triangle's the row's own.
HPT_HD void hit_normal(const Scene& S, int prim, const float* m, const float* o,
                       const float* d, float t, float* h, float* n) {
  for (int i = 0; i < 3; ++i) h[i] = o[i] + d[i] * t;
  if (prim < S.ns) {
    float sv[3] = {h[0] - m[0], h[1] - m[1], h[2] - m[2]};
    float nrm = fmaxf(sqrtf(dot3(sv, sv)), 1e-20f);
    for (int i = 0; i < 3; ++i) n[i] = sv[i] / nrm;
  } else if (prim >= S.ns + S.np && prim < S.ns + S.np + S.nb) {
    box_normal(h, m, m + 3, n);
  } else {
    for (int i = 0; i < 3; ++i) n[i] = m[i];
  }
}

// The BSDF direction nd from the incoming d, the normal n and the three
// uniforms u: the cosine-weighted hemisphere, a glossy mirror or the
// dielectric's Fresnel choice by kind.  Returns whether it is specular.
template <bool HAS_GLOSSY, bool HAS_DIEL>
HPT_HD bool bsdf_sample(const float* d, const float* n, float param, float kind,
                        const float* u, float* nd) {
  cosine_hemisphere(n, u[0], u[1], nd);
  bool is_spec = false;
  if (HAS_GLOSSY && kind == 1.0f) {
    float ia = dot3(d, n);
    for (int i = 0; i < 3; ++i) nd[i] = d[i] - 2.0f * ia * n[i];
    is_spec = true;
  }
  if (HAS_DIEL && kind == 2.0f) {
    dielectric(d, n, param, u[2], nd);
    is_spec = true;
  }
  return is_spec;
}

// One live bounce from the ray (o, d) and its winner (t, prim): adds the
// bounce's emission and NEE term into res, and moves the state (o, d, t,
// prim, th, prev_spec, rng) on to the next bounce.  Records the draws and
// the shadow decision in dr.
template <bool HAS_GLOSSY, bool HAS_DIEL>
HPT_HD void live_bounce(const Scene& S, float* o, float* d, float& t, int& prim,
                        float* th, bool& prev_spec, Rng& rng, float* res,
                        Draws& dr) {
  // The winner's payload row, the hit point and the normal.
  const float* m = S.payload + 12 * prim;
  const float* color = m + 6;
  const float il = m[9], param = m[10], kind = m[11];
  float h[3], n[3];
  hit_normal(S, prim, m, o, d, t, h, n);

  // Emission: off a specular chain, or from a plane or box (never
  // light-sampled).
  if (prev_spec || (prim >= S.ns && prim < S.ns + S.np + S.nb))
    for (int i = 0; i < 3; ++i) res[i] = res[i] + color[i] * il * th[i];

  // BSDF sample: 3 draws.
  for (int i = 0; i < 3; ++i) dr.u[i] = uniform(rng);
  float nd[3];
  const bool is_spec = bsdf_sample<HAS_GLOSSY, HAS_DIEL>(d, n, param, kind, dr.u, nd);

  // Light sample: 3 draws, taken even with no emitter.
  for (int i = 0; i < 3; ++i) dr.us[i] = uniform(rng);
  dr.occ = false;
  float t2;
  int prim2;
  if (S.nl > 0) {
    float b[3], inv_pdf, t_l, emit[3];
    int lgi;
    sample_light(S, h, dr.us[0], dr.us[1], dr.us[2], b, inv_pdf, lgi, t_l, emit);
    fold<true>(S, h, nd, kEpsilon, t2, prim2, b, t_l, lgi, dr.occ);
    float cos_i = dot3(b, n);
    if (!dr.occ && t_l < kInfinite && kind == 0.0f && cos_i > 0.0f) {
      float w = cos_i * inv_pdf;
      for (int i = 0; i < 3; ++i)
        res[i] = res[i] + th[i] * (color[i] / kPi) * emit[i] * w;
    }
  } else {
    bool unused = false;
    fold<false>(S, h, nd, kEpsilon, t2, prim2, nullptr, 0.0f, -1, unused);
  }

  for (int i = 0; i < 3; ++i) {
    th[i] = th[i] * color[i];
    o[i] = h[i];
    d[i] = nd[i];
  }
  t = t2;
  prim = prim2;
  prev_spec = is_spec;
}

// Whether a bounce is dead: near-zero throughput or a miss.
HPT_HD bool dead_bounce(const float* th, float t) {
  return dot3(th, th) <= kNearZeroEps || !(t < kInfinite);
}

// The residual word of one (sample, bounce) that the recording forward
// writes for the NEE backward (ops/nee_vjp.py, fold-free replay): the
// bounce's winner prim (the fold's, entering the bounce) and three flags.
// Bits 0 and 1 are the TPU kernel's flags word (ops/pallas_nee.py
// grad_residuals: bit 0 the shadow ray is blocked, bit 1 the ray hit);
// bit 2 says the bounce was live, so the word of the bounce where a path
// ends (a miss, or near-zero throughput) carries a clear bit 2.
constexpr int kOccBit = 1, kHitBit = 2, kLiveBit = 4, kPrimShift = 3;

HPT_HD int residual_word(int prim, bool hit, bool live, bool occ) {
  return (prim << kPrimShift) | (live ? kLiveBit : 0) | (hit ? kHitBit : 0) |
         (occ ? kOccBit : 0);
}

// One lane of the flat sample loop (nee_pixel): its primary ray and hit,
// the path in flight (ray, winner, throughput, radiance, whether the last
// bounce was specular), the sample s and bounce b it is at, the radiance
// banked from the samples it finished, its live bounces and its RNG stream.
struct Lane {
  float po[3], pd[3], t0;
  int prim0;
  float o[3], d[3], t, th[3], res[3], acc[3];
  int prim;
  bool prev_spec;
  int s, b, steps;
  Rng rng;
};

// Starts the lane's current sample at its primary hit.
HPT_HD void restart(Lane& L) {
  for (int i = 0; i < 3; ++i) {
    L.o[i] = L.po[i];
    L.d[i] = L.pd[i];
    L.th[i] = 1.0f;
    L.res[i] = 0.0f;
  }
  L.t = L.t0;
  L.prim = L.prim0;
  L.prev_spec = true;  // camera rays see lights
  L.b = 0;
}

// The residual word of (sample s, bounce b) of the lane whose words start
// at rec, `stride` apart (nee_megakernel.cu's [spp * bounces, n] layout).
HPT_HD int* word_at(int* rec, int s, int b, int num_bounces, int stride) {
  return rec + (size_t)(s * num_bounces + b) * stride;
}

// Sets a lane up at its first sample, from the primary hit (t0, prim0).
// Returns whether it has a live bounce to trace: a lane whose primary ray
// misses completes all its samples here (each adds nothing and draws
// nothing; with RECORD each writes its dead bounce-0 word), as does a lane
// with no samples or no bounces.
template <bool RECORD>
HPT_HD bool lane_start(Lane& L, const float* po, const float* pd, float t0, int prim0,
                       const Rng& rng, int spp, int num_bounces, int* rec, int stride) {
  for (int i = 0; i < 3; ++i) {
    L.po[i] = po[i];
    L.pd[i] = pd[i];
    L.acc[i] = 0.0f;
  }
  L.t0 = t0;
  L.prim0 = prim0;
  L.rng = rng;
  L.steps = 0;
  L.s = 0;
  restart(L);
  if (spp <= 0 || num_bounces <= 0) return false;
  if (t0 < kInfinite) return true;
  if (RECORD)
    for (int s = 0; s < spp; ++s)
      *word_at(rec, s, 0, num_bounces, stride) = residual_word(prim0, false, false, false);
  return false;
}

// The first half of a step of the flat loop: a path that has ended (a
// dead bounce, or its bounce budget used up) banks its sample's radiance
// and restarts the next sample from the primary hit, whose bounce 0 is
// live.  Returns whether the lane has a live bounce to run: false once it
// has banked its last sample.  With RECORD the path's dead word is written
// at the bounce where it ends; a path that uses its whole budget writes
// none.
template <bool RECORD>
HPT_HD bool lane_next(Lane& L, int spp, int num_bounces, int* rec, int stride) {
  if (L.b < num_bounces && !dead_bounce(L.th, L.t)) return true;
  if (RECORD && L.b < num_bounces)
    *word_at(rec, L.s, L.b, num_bounces, stride) =
        residual_word(L.prim, L.t < kInfinite, false, false);
  for (int i = 0; i < 3; ++i) L.acc[i] = L.acc[i] + L.res[i];
  if (++L.s == spp) return false;
  restart(L);
  return true;
}

// The second half: the lane's live bounce, its word (live) with RECORD.
template <bool HAS_GLOSSY, bool HAS_DIEL, bool RECORD>
HPT_HD void lane_bounce(const Scene& S, Lane& L, int num_bounces, int* rec, int stride) {
  ++L.steps;
  Draws dr;
  const int winner = L.prim;
  live_bounce<HAS_GLOSSY, HAS_DIEL>(S, L.o, L.d, L.t, L.prim, L.th, L.prev_spec, L.rng,
                                    L.res, dr);
  if (RECORD)
    *word_at(rec, L.s, L.b, num_bounces, stride) = residual_word(winner, true, true, dr.occ);
  ++L.b;
}

// One step of the flat loop: lane_next, then lane_bounce.  Returns false,
// with nothing run, once the lane has banked its last sample.
template <bool HAS_GLOSSY, bool HAS_DIEL, bool RECORD>
HPT_HD bool lane_step(const Scene& S, Lane& L, int spp, int num_bounces, int* rec,
                      int stride) {
  if (!lane_next<RECORD>(L, spp, num_bounces, rec, stride)) return false;
  lane_bounce<HAS_GLOSSY, HAS_DIEL, RECORD>(S, L, num_bounces, rec, stride);
  return true;
}

// Starts a lane on pixel q (lane_start): its primary ray, its primary hit
// (from the probe's t0_in and prim0_in when given, else folded here) and its
// rng; with RECORD its residual words at rec, `stride` apart.
template <bool RECORD>
HPT_HD bool pixel_start(const Scene& S, Lane& L, int q, const float* origin,
                        const float* direction, const uint32_t* rng_in, const float* t0_in,
                        const int* prim0_in, int spp, int num_bounces, int* rec, int stride) {
  const float po[3] = {origin[3 * q], origin[3 * q + 1], origin[3 * q + 2]};
  const float pd[3] = {direction[3 * q], direction[3 * q + 1], direction[3 * q + 2]};
  float t0;
  int prim0;
  if (t0_in != nullptr) {
    t0 = t0_in[q];
    prim0 = prim0_in[q];
  } else {
    primary_hit(S, po, pd, t0, prim0);
  }
  const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
  return lane_start<RECORD>(L, po, pd, t0, prim0, rng, spp, num_bounces, rec, stride);
}

// Writes a lane's outputs, all its samples banked, as pixel q's.
HPT_HD void pixel_store(const Lane& L, int q, float* radiance, uint32_t* rng_out, int* steps) {
  for (int i = 0; i < 3; ++i) radiance[3 * q + i] = L.acc[i];
  rng_out[4 * q] = L.rng.a;
  rng_out[4 * q + 1] = L.rng.b;
  rng_out[4 * q + 2] = L.rng.c;
  rng_out[4 * q + 3] = L.rng.ctr;
  if (steps != nullptr) steps[q] = L.steps;
}

// One pixel q of the NEE kernel: `spp` samples from its primary hit, each
// restarting there, their radiance summed, as one flat loop of lane_step,
// the TPU kernel's path-regeneration discipline (ops/pallas_nee.py:
// 938-1016) for one lane.  Every step runs one live bounce, so a warp pays
// for the live bounces of its longest lane over all its samples (the max
// over lanes of the sum over samples), where a loop over samples with the
// bounces nested inside pays, sample by sample, for the longest path among
// its lanes (the sum over samples of the max over lanes): on suite config
// 4's scene, where most paths end after a bounce or two and a few lanes of
// a warp still run a fourth, the flat loop's warps cost about two thirds
// of the nested loop's.
// Each lane draws its RNG stream and banks its samples in the nested
// loop's order, so radiance, rng, `steps` (the live bounces) and, with
// RECORD, the residual word of each (sample s, bounce b) the path reaches,
// the bounce where it ends included, at rec[(s * num_bounces + b) * stride],
// are the nested loop's bit for bit; later words are not written.
template <bool HAS_GLOSSY, bool HAS_DIEL, bool RECORD = false>
HPT_HD void nee_pixel(const Scene& S, int q, const float* origin,
                      const float* direction, const uint32_t* rng_in,
                      const float* t0_in, const int* prim0_in, float* radiance,
                      uint32_t* rng_out, int* steps, int spp, int num_bounces,
                      int* rec = nullptr, int stride = 0) {
  Lane L;
  if (pixel_start<RECORD>(S, L, q, origin, direction, rng_in, t0_in, prim0_in, spp,
                          num_bounces, rec, stride))
    while (lane_step<HAS_GLOSSY, HAS_DIEL, RECORD>(S, L, spp, num_bounces, rec, stride)) {
    }
  pixel_store(L, q, radiance, rng_out, steps);
}

}  // namespace nee
}  // namespace hpt
