// The reverse of the physical/NEE estimator: one live bounce's adjoint and a
// pixel's replay and reverse sweep, for the NEE backward megakernel
// (nee_megakernel_vjp.cu).
//
// The TPU backward kernel (haskell_path_tracer_tpu/ops/pallas_nee_vjp.py:
// _nee_bwd_kernel) took `jax.vjp` of `_continuous_bounce`; here the reverse
// is written by hand.  Every decision is detached, as there: the winner
// `prim`, the shadow decision, the hit and dead masks, the BRDF branch, the
// Fresnel choice and all six uniforms of a bounce.  Cotangents flow through
// the winner's distance (recomputed in closed form from its fold row: the
// sphere's tca - thc, the plane's t, Möller–Trumbore), the hit point, the
// normal, the BSDF direction, the emission, the throughput and the NEE term
// with its light sample (the sphere cone and the triangle area sample).
// Where a function has a kink (min, max, clamp, abs) the adjoint takes the
// branch PyTorch's autograd takes, so it matches the plain version
// (ops/nee_vjp.py:bounce_reference) on ties as well.  Only the branch a lane
// took is reversed, so no guard against an infinite Jacobian of a branch
// not taken is needed.
//
// The reverse replays each sample from the recording forward's residual
// words and runs no fold (replay_bounce), the winner's distance recomputed
// by the fold's own expression (winner_t).  The words come from the
// gradient's recording forward (the residual mode) or, in the replay mode,
// from the forward's own flat loop run again one chunk of samples at a time
// just before the chunk's reverse (pixel_backward_chunked).  The folded
// replay (pixel_backward without RESID, nee.cuh:live_bounce) is the host
// harnesses' oracle of the fold-free one; no kernel runs it.
//
// Cotangents of the tables (ops/nee.py:nee_scene_tables): the winner's fold
// row (a sphere's [c, r^2], a plane's [p, n], a triangle's [v0, e1, e2]), its
// payload row (aux = sphere center or unit normal, color, illuminance,
// brdf_param) and the sampled emitter's light row (color * illuminance,
// center or v0, radius, e1, e2).  Boxes are not differentiated here.
//
// HPT_HD makes every function callable on the host too, so
// tests/test_torch_nee_adjoint_host.py can check the adjoint with g++.

#pragma once

#include "nee.cuh"

// A function that nvcc compiles as a call of its own, not inlined into its
// caller, so that it allocates its registers alone; inline on the host.
#if defined(__CUDACC__)
#define HPT_CALL __host__ __device__ __noinline__
#else
#define HPT_CALL inline
#endif

namespace hpt {
namespace nee {

// What the reverse of one live bounce needs besides the tables.
struct Residual {
  float o[3], d[3], th[3];
  Draws dr;
  int prim;
  bool prev_spec;
};

// One live bounce's row cotangents: fold[0..fold_cols) of the winner's fold
// row (from float offset fold_at), payload[0..11] of its payload row
// `prim`, and light[0..15] of light row `light_row` (-1: none).
struct RowGrads {
  int fold_at, fold_cols, prim, light_row;
  float fold[9], payload[12], light[16];
};

// Reverse of c = a x b: ga += b x gc, gb += gc x a.
HPT_HD void cross3_vjp(const float* a, const float* b, const float* gc,
                       float* ga, float* gb) {
  float t[3];
  cross3(b, gc, t);
  for (int i = 0; i < 3; ++i) ga[i] += t[i];
  cross3(gc, a, t);
  for (int i = 0; i < 3; ++i) gb[i] += t[i];
}

// Reverse of n = s / max(sqrt(s.s), 1e-20): gs += dn/ds^T gn.
HPT_HD void normalize_vjp(const float* s, const float* gn, float* gs) {
  const float q = dot3(s, s);
  const float len = sqrtf(q);
  const float nrm = fmaxf(len, 1e-20f);
  for (int i = 0; i < 3; ++i) gs[i] += gn[i] / nrm;
  if (len >= 1e-20f) {
    const float g_nrm = -dot3(gn, s) / (nrm * nrm);
    const float g_q = g_nrm * 0.5f / len;
    for (int i = 0; i < 3; ++i) gs[i] += 2.0f * s[i] * g_q;
  }
}

// Reverse of onb(w) -> (b1, b2): gw += the cotangents g1, g2 pulled back.
HPT_HD void onb_vjp(const float* w, const float* g1, const float* g2, float* gw) {
  const float s = w[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + w[2]);
  // b1 = [1 + s w0^2 a, s b, -s w0], b2 = [b, s + w1^2 a, -w1], b = w0 w1 a.
  float g_a = g1[0] * s * (w[0] * w[0]) + g2[1] * (w[1] * w[1]);
  const float g_b = g1[1] * s + g2[0];
  gw[0] += g1[0] * s * a * 2.0f * w[0] - s * g1[2] + g_b * w[1] * a;
  gw[1] += g2[1] * a * 2.0f * w[1] - g2[2] + g_b * w[0] * a;
  g_a += g_b * w[0] * w[1];
  gw[2] += g_a * a * a;  // a = -1 / (s + w2)
}

// Reverse of cosine_hemisphere(n, u1, u2): gn += ...
HPT_HD void cosine_hemisphere_vjp(const float* n, float u1, float u2,
                                  const float* gdir, float* gn) {
  const float r = sqrtf(u1);
  const float phi = kTwoPi * u2;
  const float x = r * cosf(phi), y = r * sinf(phi);
  const float z = sqrtf(fmaxf(1.0f - u1, 1e-12f));
  float g1[3], g2[3];
  for (int i = 0; i < 3; ++i) {
    g1[i] = gdir[i] * x;
    g2[i] = gdir[i] * y;
    gn[i] += gdir[i] * z;
  }
  onb_vjp(n, g1, g2, gn);
}

// Reverse of r = v - 2 (v . n) n: gv += ..., gn += ...
HPT_HD void reflect_vjp(const float* v, const float* n, const float* gr,
                        float* gv, float* gn) {
  const float k = 2.0f * dot3(v, n);
  const float g_k = -dot3(gr, n);
  const float g_ia = 2.0f * g_k;
  for (int i = 0; i < 3; ++i) {
    gv[i] += gr[i] + g_ia * n[i];
    gn[i] += -k * gr[i] + g_ia * v[i];
  }
}

// Reverse of the dielectric branch that u3 chose (nee.cuh:dielectric): gd,
// gn and g_ior (the brdf_param) += ...
HPT_HD void dielectric_vjp(const float* d, const float* n, float ior, float u3,
                           const float* gdir, float* gd, float* gn,
                           float& g_ior) {
  const float cos_i0 = -dot3(d, n);
  const bool inside = cos_i0 < 0.0f;
  float fn[3];
  for (int i = 0; i < 3; ++i) fn[i] = inside ? -n[i] : n[i];
  const float aci = fabsf(cos_i0);
  const float eta = inside ? ior : 1.0f / ior;
  const float cl = fmaxf(1.0f - aci * aci, 0.0f);
  const float sin2 = eta * eta * cl;
  const bool tir = sin2 > 1.0f;
  const float x = 1.0f - sin2;
  const float cos_t = tir ? 0.0f : sqrtf(fmaxf(x, 1e-12f));
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  const float c = 1.0f - aci;
  const float c2 = c * c;
  const float fresnel = r0 + (1.0f - r0) * (c * (c2 * c2));
  float g_fn[3] = {0.0f, 0.0f, 0.0f};
  if (u3 < (tir ? 1.0f : fresnel)) {
    reflect_vjp(d, fn, gdir, gd, g_fn);
  } else {
    // dir = T / |T|, T = eta d + k fn, k = eta aci - cos_t.
    const float k = eta * aci - cos_t;
    float T[3], g_T[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < 3; ++i) T[i] = eta * d[i] + k * fn[i];
    normalize_vjp(T, gdir, g_T);
    float g_eta = dot3(g_T, d);
    const float g_k = dot3(g_T, fn);
    for (int i = 0; i < 3; ++i) {
      gd[i] += eta * g_T[i];
      g_fn[i] += k * g_T[i];
    }
    g_eta += g_k * aci;
    float g_aci = g_k * eta;
    const float g_cost = -g_k;
    // cos_t = sqrt(max(1 - sin2, 1e-12)), sin2 = eta^2 max(1 - aci^2, 0).
    const float g_sin2 = x >= 1e-12f ? -g_cost * 0.5f / cos_t : 0.0f;
    g_eta += g_sin2 * cl * 2.0f * eta;
    const float g_cl = g_sin2 * (eta * eta);
    if (1.0f - aci * aci >= 0.0f) g_aci += g_cl * (-2.0f * aci);
    const float g_cosi = g_aci * sign(cos_i0);  // cos_i0 = -(d . n)
    for (int i = 0; i < 3; ++i) {
      gd[i] -= g_cosi * n[i];
      gn[i] -= g_cosi * d[i];
    }
    g_ior += inside ? g_eta : -g_eta / (ior * ior);
  }
  for (int i = 0; i < 3; ++i) gn[i] += inside ? -g_fn[i] : g_fn[i];
}

// Reverse of cone_sample(c, radius, p, u1, u2) -> (dir, solid angle): gc,
// g_r and gp += ..., from the cotangents gdir and g_sa.
HPT_HD void cone_sample_vjp(const float* c, float radius, const float* p,
                            float u1, float u2, const float* gdir, float g_sa,
                            float* gc, float& g_r, float* gp) {
  float to_c[3] = {c[0] - p[0], c[1] - p[1], c[2] - p[2]};
  const float dc2 = dot3(to_c, to_c);
  const float dc = sqrtf(fmaxf(dc2, 1e-12f));
  const float rr = radius * radius;
  const float dd = fmaxf(dc2, 1e-12f);
  const float sin2 = fminf(fmaxf(rr / dd, 0.0f), 1.0f);
  const bool on_sphere = sin2 >= 1.0f;
  const float cos_max = on_sphere ? 0.0f : sqrtf(1.0f - sin2);
  const float omc = on_sphere ? 1.0f : sin2 / (1.0f + cos_max);
  const float x = u1 * omc;
  const float cos_t = 1.0f - x;
  const float st2 = x * (1.0f + cos_t);
  const float sin_t = st2 > 0.0f ? sqrtf(st2) : 0.0f;
  const float phi = kTwoPi * u2;
  const float cphi = cosf(phi), sphi = sinf(phi);
  const float w[3] = {to_c[0] / dc, to_c[1] / dc, to_c[2] / dc};
  float b1[3], b2[3];
  onb(w, b1, b2);
  const float sc = sin_t * cphi, ss = sin_t * sphi;

  // dir = b1 sc + b2 ss + w cos_t, solid angle = 2 pi omc.
  float g_omc = kTwoPi * g_sa;
  float g1[3], g2[3], g_w[3];
  for (int i = 0; i < 3; ++i) {
    g1[i] = gdir[i] * sc;
    g2[i] = gdir[i] * ss;
    g_w[i] = gdir[i] * cos_t;
  }
  const float g_sint = dot3(gdir, b1) * cphi + dot3(gdir, b2) * sphi;
  float g_cost = dot3(gdir, w);
  onb_vjp(w, g1, g2, g_w);
  const float g_st2 = st2 > 0.0f ? g_sint * 0.5f / sin_t : 0.0f;
  float g_x = g_st2 * (1.0f + cos_t);
  g_cost += g_st2 * x;
  g_x -= g_cost;
  g_omc += g_x * u1;
  float g_dc2 = 0.0f;
  if (!on_sphere) {
    // omc = sin2 / (1 + cos_max), cos_max = sqrt(1 - sin2),
    // sin2 = clamp(rr / dd, 0, 1), rr = r^2, dd = max(dc2, 1e-12).
    const float den = 1.0f + cos_max;
    float g_sin2 = g_omc / den;
    const float g_cm = -g_omc * sin2 / (den * den);
    g_sin2 -= g_cm * 0.5f / cos_max;
    if (rr / dd >= 0.0f) {
      const float g_rr = g_sin2 / dd;
      const float g_dd = -g_sin2 * rr / (dd * dd);
      g_r += 2.0f * radius * g_rr;
      if (dc2 >= 1e-12f) g_dc2 += g_dd;
    }
  }
  // w = to_c / dc, dc = sqrt(max(dc2, 1e-12)).
  float g_toc[3];
  float g_dc = 0.0f;
  for (int i = 0; i < 3; ++i) {
    g_toc[i] = g_w[i] / dc;
    g_dc -= g_w[i] * to_c[i] / (dc * dc);
  }
  if (dc2 >= 1e-12f) g_dc2 += g_dc * 0.5f / dc;
  for (int i = 0; i < 3; ++i) {
    g_toc[i] += 2.0f * to_c[i] * g_dc2;
    gc[i] += g_toc[i];
    gp[i] -= g_toc[i];
  }
}

// Reverse of the triangle-area sample (nee.cuh:sample_light's triangle
// branch) -> (dir, inv_pdf_dir): gv0, ge1, ge2 and gp += ...
HPT_HD void tri_area_vjp(const float* v0, const float* e1, const float* e2,
                         const float* p, float u1, float u2, const float* gdir,
                         float g_ip, float* gv0, float* ge1, float* ge2,
                         float* gp) {
  float nv[3];
  cross3(e1, e2, nv);
  const float nq = dot3(nv, nv);
  const float n_norm = sqrtf(fmaxf(nq, 1e-20f));
  const float nu[3] = {nv[0] / n_norm, nv[1] / n_norm, nv[2] / n_norm};
  const float area = 0.5f * n_norm;
  const float r1s = sqrtf(fmaxf(u1, 1e-12f));
  const float bu = 1.0f - r1s;
  const float bv = u2 * r1s;
  float tq[3];
  for (int i = 0; i < 3; ++i) tq[i] = v0[i] + e1[i] * bu + e2[i] * bv - p[i];
  const float q2 = dot3(tq, tq);
  const float d2 = fmaxf(q2, 1e-12f);
  const float sd = sqrtf(d2);
  const float dir[3] = {tq[0] / sd, tq[1] / sd, tq[2] / sd};
  const float cos_l = -dot3(dir, nu);

  float g_area = 0.0f, g_cosl = 0.0f, g_d2 = 0.0f;
  if (cos_l > 1e-6f && d2 >= kMinD2) {
    // inv_pdf_dir = (area cos_l) / d2.
    g_area = g_ip * cos_l / d2;
    g_cosl = g_ip * area / d2;
    g_d2 = -g_ip * (area * cos_l) / (d2 * d2);
  }
  float g_dir[3], g_nu[3];
  for (int i = 0; i < 3; ++i) {
    g_dir[i] = gdir[i] - g_cosl * nu[i];
    g_nu[i] = -g_cosl * dir[i];
  }
  // dir = tq / sd, sd = sqrt(d2), d2 = max(tq . tq, 1e-12).
  float g_tq[3], g_sd = 0.0f;
  for (int i = 0; i < 3; ++i) {
    g_tq[i] = g_dir[i] / sd;
    g_sd -= g_dir[i] * tq[i] / (sd * sd);
  }
  g_d2 += g_sd * 0.5f / sd;
  if (q2 >= 1e-12f)
    for (int i = 0; i < 3; ++i) g_tq[i] += 2.0f * tq[i] * g_d2;
  for (int i = 0; i < 3; ++i) {
    gp[i] -= g_tq[i];
    gv0[i] += g_tq[i];
    ge1[i] += g_tq[i] * bu;
    ge2[i] += g_tq[i] * bv;
  }
  // nu = nv / n_norm, area = n_norm / 2, n_norm = sqrt(max(nv . nv, 1e-20)).
  float g_nv[3], g_nn = 0.5f * g_area;
  for (int i = 0; i < 3; ++i) {
    g_nv[i] = g_nu[i] / n_norm;
    g_nn -= g_nu[i] * nv[i] / (n_norm * n_norm);
  }
  if (nq >= 1e-20f) {
    const float g_nq = g_nn * 0.5f / n_norm;
    for (int i = 0; i < 3; ++i) g_nv[i] += 2.0f * nv[i] * g_nq;
  }
  cross3_vjp(e1, e2, g_nv, ge1, ge2);
}

// The winner's distance from its fold row, without the acceptance tests
// (the fold already took them): the fold's own device functions
// (nee.cuh:sphere_root, plane_t, moller_trumbore), so the distance is the
// fold's bit for bit and the fold-free replay's rays are the forward's.
HPT_HD float winner_t(const Scene& S, int prim, const float* o, const float* d) {
  if (prim < S.ns) {
    float g[4], l[3], ll, h;
    load4(S.sphere(prim), g);
    return sphere_root(g, o, d, l, ll, h);
  }
  if (prim < S.ns + S.np) {
    float denom;
    return plane_t(S.plane(prim - S.ns), o, d, denom);
  }
  const float* g = S.tri(prim - S.ns - S.np - S.nb);
  const float tv[3] = {o[0] - g[0], o[1] - g[1], o[2] - g[2]};
  return moller_trumbore(g, tv, d).t;
}

// Reverse of winner_t: gf (the fold row's cotangent), go and gd += ...
HPT_HD void winner_t_vjp(const Scene& S, int prim, const float* o,
                         const float* d, float gt, float* gf, float* go,
                         float* gd) {
  if (prim < S.ns) {
    // t = tca - sqrt(max(r2 - (l.l - tca^2), 1e-12)), l = c - o, tca = l.d.
    const float* g = S.sphere(prim);
    float l[3] = {g[0] - o[0], g[1] - o[1], g[2] - o[2]};
    float ll = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
    float tca = l[0] * d[0] + l[1] * d[1] + l[2] * d[2];
    float h = g[3] - (ll - tca * tca);
    float thc = sqrtf(fmaxf(h, 1e-12f));
    float g_tca = gt, g_ll = 0.0f;
    if (h >= 1e-12f) {
      float g_h = -gt * 0.5f / thc;
      gf[3] += g_h;
      g_ll = -g_h;
      g_tca += g_h * 2.0f * tca;
    }
    for (int i = 0; i < 3; ++i) {
      float g_l = 2.0f * l[i] * g_ll + d[i] * g_tca;
      gd[i] += l[i] * g_tca;
      gf[i] += g_l;
      go[i] -= g_l;
    }
  } else if (prim < S.ns + S.np) {
    // t = num / denom, num = (p - o).n, denom = d.n (0 displaced to a
    // constant, which carries no cotangent).
    const float* g = S.plane(prim - S.ns);
    float denom = d[0] * g[3] + d[1] * g[4] + d[2] * g[5];
    float num = (g[0] - o[0]) * g[3] + (g[1] - o[1]) * g[4] + (g[2] - o[2]) * g[5];
    float denom_safe = denom == 0.0f ? kPlaneDenomEps * 0.5f : denom;
    float g_num = gt / denom_safe;
    float g_den = denom == 0.0f ? 0.0f : -gt * num / (denom_safe * denom_safe);
    for (int i = 0; i < 3; ++i) {
      float po = g[i] - o[i];
      gf[i] += g_num * g[3 + i];
      go[i] -= g_num * g[3 + i];
      gf[3 + i] += g_num * po + g_den * d[i];
      gd[i] += g_den * g[3 + i];
    }
  } else {
    // Möller–Trumbore: t = (e2 . qv) inv_det, qv = tv x e1, tv = o - v0,
    // det = e1 . pv, pv = d x e2.
    const float* g = S.tri(prim - S.ns - S.np - S.nb);
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
      gf[i] -= g_tv[i];
      gf[3 + i] += g_e1[i];
      gf[6 + i] += g_e2[i];
    }
  }
}

// Reverse of one live bounce (live_bounce with its decisions r.dr held).
// In: the cotangents of the next origin c_o, next direction c_d, next
// throughput c_th and of the radiance the bounce adds, g_rad.  Out
// (overwritten): the cotangents of the bounce's ray go, gd and throughput
// gth, and its row cotangents rg.
template <bool HAS_GLOSSY, bool HAS_DIEL>
HPT_HD void bounce_vjp(const Scene& S, const Residual& r, const float* c_o,
                       const float* c_d, const float* c_th, const float* g_rad,
                       float* go, float* gd, float* gth, RowGrads& rg) {
  const int prim = r.prim;
  const float *o = r.o, *d = r.d, *th = r.th;
  const bool is_sphere = prim < S.ns;
  const bool is_plane = !is_sphere && prim < S.ns + S.np;
  for (int i = 0; i < 3; ++i) { go[i] = 0.0f; gd[i] = 0.0f; }
  for (int i = 0; i < 9; ++i) rg.fold[i] = 0.0f;
  for (int i = 0; i < 12; ++i) rg.payload[i] = 0.0f;
  for (int i = 0; i < 16; ++i) rg.light[i] = 0.0f;
  rg.fold_at = is_sphere ? 4 * prim
               : is_plane ? 4 * S.ns + 8 * (prim - S.ns)
                          : 4 * S.ns + 8 * S.np + 8 * S.nb + 12 * (prim - S.ns - S.np - S.nb);
  rg.fold_cols = is_sphere ? 4 : (is_plane ? 6 : 9);
  rg.prim = prim;
  rg.light_row = -1;

  // Forward, with what the reverse needs.
  const float t = winner_t(S, prim, o, d);
  const float* m = S.payload + 12 * prim;
  const float* color = m + 6;
  const float il = m[9], param = m[10], kind = m[11];
  float h[3], n[3];
  hit_normal(S, prim, m, o, d, t, h, n);
  float* g_pay = rg.payload;  // aux 0..2, color 6..8, il 9, param 10

  float g_h[3], g_nd[3], g_n[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 3; ++i) {
    g_h[i] = c_o[i];
    g_nd[i] = c_d[i];
    // Next throughput th * color.
    gth[i] = c_th[i] * color[i];
    g_pay[6 + i] = c_th[i] * th[i];
  }

  // Emission (color il) th.
  if (r.prev_spec || is_plane) {
    for (int i = 0; i < 3; ++i) {
      const float g_e = g_rad[i] * th[i];
      gth[i] += g_rad[i] * (color[i] * il);
      g_pay[6 + i] += g_e * il;
      g_pay[9] += g_e * color[i];
    }
  }

  // The NEE term th (color / pi) emit (cos_i inv_pdf).
  if (S.nl > 0) {
    float b[3], inv_pdf, t_l, emit[3];
    int lgi;
    sample_light(S, h, r.dr.us[0], r.dr.us[1], r.dr.us[2], b, inv_pdf, lgi, t_l, emit);
    const float cos_i = dot3(b, n);
    if (!r.dr.occ && t_l < kInfinite && kind == 0.0f && cos_i > 0.0f) {
      const float L = (float)S.nl;
      const int k = (int)fminf(fmaxf(floorf(r.dr.us[0] * L), 0.0f), L - 1.0f);
      const float* row = S.lights + 16 * k;
      rg.light_row = k;
      const float s = cos_i * inv_pdf;
      float g_s = 0.0f;
      for (int i = 0; i < 3; ++i) {
        const float cp = color[i] / kPi;
        const float A = th[i] * cp;
        const float g_B = g_rad[i] * s;
        g_s += g_rad[i] * (A * emit[i]);
        const float g_A = g_B * emit[i];
        rg.light[2 + i] += g_B * A;
        gth[i] += g_A * cp;
        g_pay[6 + i] += (g_A * th[i]) / kPi;
      }
      const float g_cosi = g_s * inv_pdf;
      // inv_pdf = inv_pdf_dir L where inv_pdf_dir > 1e-9, else 0.
      const float g_ip = inv_pdf != 0.0f ? g_s * cos_i * L : 0.0f;
      float g_b[3];
      for (int i = 0; i < 3; ++i) {
        g_b[i] = g_cosi * n[i];
        g_n[i] += g_cosi * b[i];
      }
      if (row[0] == 0.0f) {
        cone_sample_vjp(row + 5, row[8], h, r.dr.us[1], r.dr.us[2], g_b,
                        g_ip, rg.light + 5, rg.light[8], g_h);
      } else {
        tri_area_vjp(row + 5, row + 9, row + 12, h, r.dr.us[1], r.dr.us[2],
                     g_b, g_ip, rg.light + 5, rg.light + 9, rg.light + 12, g_h);
      }
    }
  }

  // The BSDF direction.
  if (HAS_DIEL && kind == 2.0f) {
    dielectric_vjp(d, n, param, r.dr.u[2], g_nd, gd, g_n, g_pay[10]);
  } else if (HAS_GLOSSY && kind == 1.0f) {
    reflect_vjp(d, n, g_nd, gd, g_n);
  } else {
    cosine_hemisphere_vjp(n, r.dr.u[0], r.dr.u[1], g_nd, g_n);
  }

  // The normal: a sphere's normalised offset from its center, else the
  // payload row's own.
  if (is_sphere) {
    float sv[3] = {h[0] - m[0], h[1] - m[1], h[2] - m[2]}, g_sv[3] = {0.0f, 0.0f, 0.0f};
    normalize_vjp(sv, g_n, g_sv);
    for (int i = 0; i < 3; ++i) {
      g_h[i] += g_sv[i];
      g_pay[i] -= g_sv[i];
    }
  } else {
    for (int i = 0; i < 3; ++i) g_pay[i] += g_n[i];
  }

  // Hit point h = o + d t, then the winner's distance.
  float g_t = 0.0f;
  for (int i = 0; i < 3; ++i) {
    go[i] += g_h[i];
    gd[i] += g_h[i] * t;
    g_t += g_h[i] * d[i];
  }
  winner_t_vjp(S, prim, o, d, g_t, rg.fold, go, gd);
}

// One live bounce of the fold-free replay: the winner prim and the shadow
// decision come from the recording forward's residual word, the distance
// from the winner's fold row (winner_t, the fold's value bit for bit), so
// the replay runs no fold and no light sample.  Draws the bounce's six
// uniforms into dr and moves (o, d, th, prev_spec, rng) on as live_bounce
// does.
template <bool HAS_GLOSSY, bool HAS_DIEL>
HPT_HD void replay_bounce(const Scene& S, float* o, float* d, int prim, bool occ,
                          float* th, bool& prev_spec, Rng& rng, Draws& dr) {
  const float t = winner_t(S, prim, o, d);
  const float* m = S.payload + 12 * prim;
  float h[3], n[3];
  hit_normal(S, prim, m, o, d, t, h, n);
  for (int i = 0; i < 3; ++i) dr.u[i] = uniform(rng);
  float nd[3];
  const bool is_spec = bsdf_sample<HAS_GLOSSY, HAS_DIEL>(d, n, m[10], m[11], dr.u, nd);
  for (int i = 0; i < 3; ++i) dr.us[i] = uniform(rng);
  dr.occ = occ;
  for (int i = 0; i < 3; ++i) {
    th[i] = th[i] * m[6 + i];
    o[i] = h[i];
    d[i] = nd[i];
  }
  prev_spec = is_spec;
}

// The whole backward of one pixel: for each of `spp` samples, replay the
// live bounces (storing their residuals in `st`, which holds at least
// `num_bounces`), then sweep them in reverse with the radiance cotangent
// g_rad.  Adds the primary ray's cotangents into g_o, g_d and hands each
// bounce's row cotangents to acc(rg).
//
// Two replays.  Without RESID, from the primary hit (t0, prim0) through the
// forward's own live_bounce, folds included: the nested sample x bounce
// loop, kept as the host harnesses' oracle.  With RESID, from the recording
// forward's residual words rec[(s * num_bounces + b) * stride] (nee.cuh:
// residual_word): the replay runs replay_bounce, no fold at all, the
// primary one included (t0 and prim0 are not read), and a path ends at the
// first word without the live bit.  Both take the same decisions, the
// forward kernel's, and store the same residuals bit for bit.
template <bool HAS_GLOSSY, bool HAS_DIEL, bool RESID, class Acc>
HPT_HD void pixel_backward(const Scene& S, const float* po, const float* pd,
                           float t0, int prim0, const int* rec, int stride, Rng rng,
                           const float* g_rad, int spp, int num_bounces, Residual* st,
                           float* g_o, float* g_d, Acc& acc) {
  for (int s = 0; s < spp; ++s) {
    float o[3] = {po[0], po[1], po[2]}, d[3] = {pd[0], pd[1], pd[2]};
    float th[3] = {1.0f, 1.0f, 1.0f}, res[3] = {0.0f, 0.0f, 0.0f};
    float t = t0;
    int prim = prim0;
    bool prev_spec = true;
    int live = 0;
    for (int b = 0; b < num_bounces; ++b) {
      Residual& r = st[b];
      if constexpr (RESID) {
        const int w = rec[(size_t)(s * num_bounces + b) * stride];
        if (!(w & kLiveBit)) break;
        for (int i = 0; i < 3; ++i) { r.o[i] = o[i]; r.d[i] = d[i]; r.th[i] = th[i]; }
        r.prim = w >> kPrimShift;
        r.prev_spec = prev_spec;
        Draws dr;
        replay_bounce<HAS_GLOSSY, HAS_DIEL>(S, o, d, r.prim, (w & kOccBit) != 0, th,
                                            prev_spec, rng, dr);
        r.dr = dr;
      } else {
        // A dead bounce passes its ray through and zeroes the throughput, so
        // every later bounce is dead and all their cotangents are zero.
        if (dead_bounce(th, t)) break;
        for (int i = 0; i < 3; ++i) { r.o[i] = o[i]; r.d[i] = d[i]; r.th[i] = th[i]; }
        r.prim = prim;
        r.prev_spec = prev_spec;
        // The fold updates the shadow decision at every sphere: a local, held
        // in a register, not the residual array's slot in local memory.
        Draws dr;
        live_bounce<HAS_GLOSSY, HAS_DIEL>(S, o, d, t, prim, th, prev_spec, rng, res, dr);
        r.dr = dr;
      }
      live = b + 1;
    }
    // Reverse sweep from the last live bounce.
    float c_o[3] = {0.0f, 0.0f, 0.0f}, c_d[3] = {0.0f, 0.0f, 0.0f},
          c_t[3] = {0.0f, 0.0f, 0.0f};
    for (int b = live - 1; b >= 0; --b) {
      float go[3], gd[3], gth[3];
      RowGrads rg;
      bounce_vjp<HAS_GLOSSY, HAS_DIEL>(S, st[b], c_o, c_d, c_t, g_rad, go, gd, gth, rg);
      acc(S, rg);
      for (int i = 0; i < 3; ++i) { c_o[i] = go[i]; c_d[i] = gd[i]; c_t[i] = gth[i]; }
    }
    for (int i = 0; i < 3; ++i) { g_o[i] += c_o[i]; g_d[i] += c_d[i]; }
  }
}

// The two halves of a replay-mode chunk (pixel_backward_chunked), each a
// function of its own under nvcc (HPT_CALL, not inlined), so that the
// flat loop's fold allocates its registers apart from the pixel's other
// state: 1-3% faster than inlined at suite config 7 on an H100 (PERF.md).

// The fold half: the forward's own flat loop (lane_step with RECORD) over
// the lane's next `n` samples, from the lane as restart left it, writing
// their residual words at rec[(s * num_bounces + b) * stride] for the
// chunk's samples s = 0 .. n - 1.
template <bool HAS_GLOSSY, bool HAS_DIEL>
HPT_CALL void record_chunk(Scene S, Lane& lane, int n, int num_bounces, int* rec, int stride) {
  Lane L = lane;
  // L.s counts the chunk's samples, so lane_next ends the loop at its last
  // one and its words land at the chunk's rows of rec.
  L.s = 0;
  while (lane_step<HAS_GLOSSY, HAS_DIEL, true>(S, L, n, num_bounces, rec, stride)) {
  }
  lane = L;
}

// The reverse half: the fold-free pixel_backward (RESID) over the chunk's
// words, from the rng the chunk started at.
template <bool HAS_GLOSSY, bool HAS_DIEL, class Acc>
HPT_CALL void reverse_chunk(Scene S, const float* po, const float* pd, const int* rec,
                            int stride, Rng start, const float* g_rad, int n, int num_bounces,
                            Residual* st, float* g_o, float* g_d, Acc acc) {
  pixel_backward<HAS_GLOSSY, HAS_DIEL, true>(S, po, pd, 0.0f, 0, rec, stride, start, g_rad, n,
                                             num_bounces, st, g_o, g_d, acc);
}

// The replay mode's backward of one pixel, `chunk` samples at a time, with
// no word from the forward: for each chunk, the forward's own flat loop
// (record_chunk, from the chunk's rng) writes the chunk's residual words
// into rec, which must hold chunk * num_bounces words `stride` apart; then
// the fold-free reverse (reverse_chunk) sweeps the chunk from the same rng;
// the next chunk starts from the rng the flat loop left.  The words are the
// recording forward's bit for bit, so the rays, throughputs, winners and
// draws the reverse stores are the residual mode's, and the ray cotangents
// are added in the same sample order: g_o and g_d come out as the residual
// mode's, bit for bit.  A pixel whose primary ray misses (t0 = kInfinite)
// adds nothing.  sync() runs after each half of every chunk, whether the
// pixel has anything to trace or not, so that a kernel can make the lanes
// of a warp, which leave the flat loop at different steps, meet before the
// reverse and run it together.
template <bool HAS_GLOSSY, bool HAS_DIEL, class Acc, class Sync>
HPT_HD void pixel_backward_chunked(const Scene& S, const float* po, const float* pd,
                                   float t0, int prim0, const Rng& rng, const float* g_rad,
                                   int spp, int num_bounces, int chunk, int* rec, int stride,
                                   Residual* st, float* g_o, float* g_d, const Acc& acc,
                                   const Sync& sync) {
  Lane L;
  const bool live = lane_start<false>(L, po, pd, t0, prim0, rng, spp, num_bounces, nullptr, 0);
  for (int s0 = 0; s0 < spp; s0 += chunk) {
    const int n = spp - s0 < chunk ? spp - s0 : chunk;
    const Rng start = L.rng;
    if (live) record_chunk<HAS_GLOSSY, HAS_DIEL>(S, L, n, num_bounces, rec, stride);
    sync();
    if (live)
      reverse_chunk<HAS_GLOSSY, HAS_DIEL>(S, po, pd, rec, stride, start, g_rad, n, num_bounces, st,
                                          g_o, g_d, acc);
    sync();
    restart(L);
  }
}

}  // namespace nee
}  // namespace hpt
