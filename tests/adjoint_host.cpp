// Host harness for the hand-written adjoint of the CUDA kernels: compiles
// haskell_path_tracer_torch/csrc/bounce.cuh with a plain C++ compiler, so
// tests/test_torch_adjoint_host.py can hold `bounce_vjp` and
// `pixel_backward` against torch.autograd of the plain version, and
// `brdf_sample` and `bounce_vjp` bit for bit against their branchless
// forms (below), on a machine without a GPU.  A test tool only: nothing in
// the package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libadjoint_host.so adjoint_host.cpp

#include "bounce.cuh"

using namespace hpt;

// The BRDF sample and the bounce's adjoint as they were before the kernels
// computed only the winner's rotation: both rotations, the matte and the
// glossy one, with sinf and cosf, then a select by kind (the TPU kernel's
// branchless form).  The references that the branch-free bounce.cuh is
// held to bit for bit.
namespace branchless {

inline void angles_to_quat(float rx, float ry, float rz, float* q) {
  float cy = cosf(rz * 0.5f), sy = sinf(rz * 0.5f);
  float cp = cosf(ry * 0.5f), sp = sinf(ry * 0.5f);
  float cr = cosf(rx * 0.5f), sr = sinf(rx * 0.5f);
  q[0] = cy * cp * cr + sy * sp * sr;
  q[1] = cy * cp * sr - sy * sp * cr;
  q[2] = sy * cp * sr + cy * sp * cr;
  q[3] = sy * cp * cr - cy * sp * sr;
}


template <bool HAS_DIELECTRIC>
inline void brdf_sample(const float* n, const float* d, float p, float kd,
                        const float* v, float* nd, float& scale) {
  // Matte.
  float q[4], ang[3];
  for (int i = 0; i < 3; ++i) ang[i] = kPi * v[i];
  angles_to_quat(ang[0], ang[1], ang[2], q);
  float mv[3];
  quat_rotate(q, n, mv);
  float m_b = p / kPi * (mv[0] * n[0] + mv[1] * n[1] + mv[2] * n[2]);

  // Glossy.
  float ia = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
  float r[3];
  for (int i = 0; i < 3; ++i) r[i] = d[i] - 2.0f * ia * n[i];
  float sp = 1.0f - p;
  angles_to_quat(sp * v[0], sp * v[1], sp * v[2], q);
  float gv[3];
  quat_rotate(q, r, gv);
  float g_b = fmaxf(0.0f, gv[0] * r[0] + gv[1] * r[1] + gv[2] * r[2]);

  const bool is_g = kd == 1.0f;
  for (int i = 0; i < 3; ++i) nd[i] = is_g ? gv[i] : mv[i];
  scale = (is_g ? g_b : m_b) * kInvTwoPi;

  if (HAS_DIELECTRIC && kd == 2.0f) {
    Glass G;
    glass(d, n, p, v[0], G);
    for (int i = 0; i < 3; ++i) nd[i] = G.take_refl ? r[i] : G.t[i] * G.tinv;
    scale = 1.0f;
  }
}


// Reverse of angles_to_quat: the angles' cotangents from the quaternion's.
inline void angles_to_quat_vjp(const float* ang, const float* gq,
                               float* gang) {
  float cy = cosf(ang[2] * 0.5f), sy = sinf(ang[2] * 0.5f);
  float cp = cosf(ang[1] * 0.5f), sp = sinf(ang[1] * 0.5f);
  float cr = cosf(ang[0] * 0.5f), sr = sinf(ang[0] * 0.5f);
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


// Reverse of one live bounce (`shade` after the fold), the random vector v
// and every decision held constant.  In: the cotangents of the next origin
// g_no, next direction g_nd, next throughput g_nth and emission g_em.
// Out (overwritten): the cotangents of the bounce's ray go, gd and
// throughput gth, of the winner's geometry row dg[0..11] and of its
// material row dm[0..4] (color, illuminance, brdf_param).
template <bool HAS_DIELECTRIC>
inline void bounce_vjp(const Tables& T, int best, const float* o,
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

  float qm[4], angm[3];
  for (int i = 0; i < 3; ++i) angm[i] = kPi * v[i];
  angles_to_quat(angm[0], angm[1], angm[2], qm);
  float mv[3];
  quat_rotate(qm, n, mv);
  const float mdot = mv[0] * n[0] + mv[1] * n[1] + mv[2] * n[2];
  const float m_b = p / kPi * mdot;

  const float ia = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
  float r[3];
  for (int i = 0; i < 3; ++i) r[i] = d[i] - 2.0f * ia * n[i];
  const float sp = 1.0f - p;
  float angg[3] = {sp * v[0], sp * v[1], sp * v[2]};
  float qg[4];
  angles_to_quat(angg[0], angg[1], angg[2], qg);
  float gv[3];
  quat_rotate(qg, r, gv);
  const float gdot = gv[0] * r[0] + gv[1] * r[1] + gv[2] * r[2];
  const float g_b = fmaxf(0.0f, gdot);

  const bool is_g = kd == 1.0f;
  const bool is_d = HAS_DIELECTRIC && kd == 2.0f;
  float scale = is_d ? 1.0f : (is_g ? g_b : m_b) * kInvTwoPi;

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
      float x = 1.0f - G.sin2;
      float G_sin2 = x >= 1e-12f ? -G_cost * 0.5f / G.cos_t : 0.0f;
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
  } else if (is_g) {
    // nd = rotate(quat((1 - p) v), r), scale = max(0, nd . r) / (2 pi).
    float G_gv[3] = {G_nd[0], G_nd[1], G_nd[2]};
    float G_gdot = gdot >= 0.0f ? G_scale * kInvTwoPi : 0.0f;
    for (int i = 0; i < 3; ++i) {
      G_gv[i] += G_gdot * r[i];
      G_r[i] += G_gdot * gv[i];
    }
    float G_q[4] = {0.0f, 0.0f, 0.0f, 0.0f}, G_ang[3];
    quat_rotate_vjp(qg, r, G_gv, G_r, G_q);
    angles_to_quat_vjp(angg, G_q, G_ang);
    G_p -= G_ang[0] * v[0] + G_ang[1] * v[1] + G_ang[2] * v[2];
  } else {
    // nd = rotate(quat(pi v), n), scale = p / pi (nd . n) / (2 pi).
    float G_mb = G_scale * kInvTwoPi;
    float G_mdot = G_mb * (p / kPi);
    G_p += G_mb * mdot * kInvPi;
    float G_mv[3];
    for (int i = 0; i < 3; ++i) {
      G_mv[i] = G_nd[i] + G_mdot * n[i];
      G_n[i] += G_mdot * mv[i];
    }
    quat_rotate_vjp(qm, n, G_mv, G_n, nullptr);
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


}  // namespace branchless

namespace {

// Sums each bounce's row cotangents into [P, gcols] and [P, 8] tables.
struct HostAcc {
  float* dgeom;
  float* dmat;
  int gcols;

  void operator()(int, int row, const float* dg, const float* dm) {
    const int ncols = gcols < 12 ? gcols : 12;
    for (int i = 0; i < ncols; ++i) dgeom[row * gcols + i] += dg[i];
    for (int i = 0; i < 5; ++i) dmat[row * 8 + i] += dm[i];
  }
};

template <bool D, bool BRANCHLESS>
void bounce_states(const Tables& T, int n, const float* state, const float* cot,
                   float* g_state, float* dgeom, float* dmat, int* winner) {
  const int P = T.count();
  for (int k = 0; k < n; ++k) {
    const float* s = state + 12 * k;  // o, d, th, v
    const float* c = cot + 12 * k;    // g_no, g_nd, g_nth, g_em
    float* g = g_state + 9 * k;       // go, gd, gth
    float best_t;
    const int best = nearest_hit(T, s, s + 3, best_t);
    const float q = s[6] * s[6] + s[7] * s[7] + s[8] * s[8];
    if (q <= kNearZeroEps || !(best_t < kInfinite)) {
      // A dead bounce passes its ray through and zeroes the throughput.
      for (int i = 0; i < 3; ++i) {
        g[i] = c[i];
        g[3 + i] = c[3 + i];
        g[6 + i] = 0.0f;
      }
      winner[k] = -1;
      continue;
    }
    float dg[12], dm[5];
    if (BRANCHLESS)
      branchless::bounce_vjp<D>(T, best, s, s + 3, s + 6, s + 9, c, c + 3, c + 6,
                                c + 9, g, g + 3, g + 6, dg, dm);
    else
      bounce_vjp<D>(T, best, s, s + 3, s + 6, s + 9, c, c + 3, c + 6, c + 9, g,
                    g + 3, g + 6, dg, dm);
    HostAcc acc{dgeom + (size_t)k * P * T.gcols, dmat + (size_t)k * P * 8,
                T.gcols};
    acc(0, best, dg, dm);
    winner[k] = best;
  }
}

// Discards the row cotangents.
struct NullAcc {
  void operator()(int, int, const float*, const float*) {}
};

// The rng of every pixel at the start of every sample, as the backward's
// replay draws it: [num_pixels, spp, 4].
template <bool D>
void sample_states(const Tables& T, int num_pixels, const float* origin,
                   const float* direction, const uint32_t* rng_in, int spp,
                   int num_bounces, uint32_t* states) {
  Residual st[64];
  NullAcc acc;
  const float g_rad[3] = {0.0f, 0.0f, 0.0f};
  for (int pix = 0; pix < num_pixels; ++pix) {
    Rng rng{rng_in[4 * pix], rng_in[4 * pix + 1], rng_in[4 * pix + 2],
            rng_in[4 * pix + 3]};
    float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < spp; ++s) {
      uint32_t* w = states + 4 * ((size_t)pix * spp + s);
      w[0] = rng.a; w[1] = rng.b; w[2] = rng.c; w[3] = rng.ctr;
      sample_backward<D>(T, origin + 3 * pix, direction + 3 * pix, rng, g_rad,
                         num_bounces, st, go, gd, acc);
    }
  }
}

// The per-sample backward kernel's work on the host: each (pixel, sample)
// replayed from its recorded state, the samples of a pixel summed in order.
template <bool D>
void backward_samples(const Tables& T, int num_pixels, const float* origin,
                      const float* direction, const uint32_t* states,
                      const float* g_rad, int spp, int num_bounces,
                      float* dgeom, float* dmat, float* d_origin,
                      float* d_direction) {
  Residual st[64];
  HostAcc acc{dgeom, dmat, T.gcols};
  for (int pix = 0; pix < num_pixels; ++pix) {
    float* go = d_origin + 3 * pix;
    float* gd = d_direction + 3 * pix;
    for (int i = 0; i < 3; ++i) go[i] = gd[i] = 0.0f;
    for (int s = 0; s < spp; ++s) {
      const uint32_t* w = states + 4 * ((size_t)pix * spp + s);
      Rng rng{w[0], w[1], w[2], w[3]};
      float so[3] = {0.0f, 0.0f, 0.0f}, sd[3] = {0.0f, 0.0f, 0.0f};
      sample_backward<D>(T, origin + 3 * pix, direction + 3 * pix, rng,
                         g_rad + 3 * pix, num_bounces, st, so, sd, acc);
      for (int i = 0; i < 3; ++i) { go[i] += so[i]; gd[i] += sd[i]; }
    }
  }
}

template <bool D>
void backward(const Tables& T, int num_pixels, const float* origin,
              const float* direction, const uint32_t* rng_in,
              const float* g_rad, int spp, int num_bounces, float* dgeom,
              float* dmat, float* d_origin, float* d_direction) {
  Residual st[64];
  HostAcc acc{dgeom, dmat, T.gcols};
  for (int pix = 0; pix < num_pixels; ++pix) {
    const Rng rng{rng_in[4 * pix], rng_in[4 * pix + 1], rng_in[4 * pix + 2],
                  rng_in[4 * pix + 3]};
    float* go = d_origin + 3 * pix;
    float* gd = d_direction + 3 * pix;
    for (int i = 0; i < 3; ++i) go[i] = gd[i] = 0.0f;
    pixel_backward<D>(T, origin + 3 * pix, direction + 3 * pix, rng,
                      g_rad + 3 * pix, spp, num_bounces, st, go, gd, acc);
  }
}

}  // namespace

// One bounce's adjoint at n states [n, 12] = (o, d, th, v) with output
// cotangents [n, 12] = (g_no, g_nd, g_nth, g_em).  Writes the input
// cotangents [n, 9] = (go, gd, gth), each state's table cotangents
// [n, P, gcols] and [n, P, 8] (zeroed by the caller) and its winner (-1 for
// a dead bounce).
extern "C" void hpt_bounce_vjp_host(const float* geom, int gcols,
                                    const float* mat, int ns, int np, int nb,
                                    int nt, int has_dielectric, int n,
                                    const float* state, const float* cot,
                                    float* g_state, float* dgeom, float* dmat,
                                    int* winner) {
  const Tables T{geom, mat, gcols, ns, np, nb, nt};
  if (has_dielectric)
    bounce_states<true, false>(T, n, state, cot, g_state, dgeom, dmat, winner);
  else
    bounce_states<false, false>(T, n, state, cot, g_state, dgeom, dmat, winner);
}

// The same with the branchless reference adjoint (namespace branchless).
extern "C" void hpt_bounce_vjp_branchless_host(
    const float* geom, int gcols, const float* mat, int ns, int np, int nb,
    int nt, int has_dielectric, int n, const float* state, const float* cot,
    float* g_state, float* dgeom, float* dmat, int* winner) {
  const Tables T{geom, mat, gcols, ns, np, nb, nt};
  if (has_dielectric)
    bounce_states<true, true>(T, n, state, cot, g_state, dgeom, dmat, winner);
  else
    bounce_states<false, true>(T, n, state, cot, g_state, dgeom, dmat, winner);
}

// The BRDF sample at n states: normal [n, 3], direction [n, 3], brdf_param
// [n], kind [n] and random vector [n, 3]; the next direction [n, 3] and
// throughput scale [n] of bounce.cuh's brdf_sample into nd, scale and of
// the branchless reference into nd_ref, scale_ref.
extern "C" void hpt_brdf_sample_host(int has_dielectric, int n, const float* nrm,
                                     const float* dir, const float* p,
                                     const float* kd, const float* v, float* nd,
                                     float* scale, float* nd_ref,
                                     float* scale_ref) {
  for (int k = 0; k < n; ++k) {
    const float* a = nrm + 3 * k;
    const float* d = dir + 3 * k;
    const float* r = v + 3 * k;
    if (has_dielectric) {
      brdf_sample<true>(a, d, p[k], kd[k], r, nd + 3 * k, scale[k]);
      branchless::brdf_sample<true>(a, d, p[k], kd[k], r, nd_ref + 3 * k, scale_ref[k]);
    } else {
      brdf_sample<false>(a, d, p[k], kd[k], r, nd + 3 * k, scale[k]);
      branchless::brdf_sample<false>(a, d, p[k], kd[k], r, nd_ref + 3 * k, scale_ref[k]);
    }
  }
}

// The backward kernel's per-pixel work, pixel after pixel on the host:
// table cotangents summed into dgeom / dmat (zeroed by the caller), ray
// cotangents per pixel.  Returns 1 when num_bounces exceeds the harness's
// residual array, 0 otherwise.
extern "C" int hpt_backward_host(const float* geom, int gcols,
                                 const float* mat, int ns, int np, int nb,
                                 int nt, int has_dielectric, int num_pixels,
                                 const float* origin, const float* direction,
                                 const uint32_t* rng_in, const float* g_rad,
                                 int spp, int num_bounces, float* dgeom,
                                 float* dmat, float* d_origin,
                                 float* d_direction) {
  if (num_bounces > 64) return 1;
  const Tables T{geom, mat, gcols, ns, np, nb, nt};
  if (has_dielectric)
    backward<true>(T, num_pixels, origin, direction, rng_in, g_rad, spp,
                   num_bounces, dgeom, dmat, d_origin, d_direction);
  else
    backward<false>(T, num_pixels, origin, direction, rng_in, g_rad, spp,
                    num_bounces, dgeom, dmat, d_origin, d_direction);
  return 0;
}

// sample_states above, for the recording forward's layout.  Returns 1 when
// num_bounces exceeds the harness's residual array, 0 otherwise.
extern "C" int hpt_sample_states_host(const float* geom, int gcols,
                                      const float* mat, int ns, int np, int nb,
                                      int nt, int has_dielectric, int num_pixels,
                                      const float* origin, const float* direction,
                                      const uint32_t* rng_in, int spp,
                                      int num_bounces, uint32_t* states) {
  if (num_bounces > 64) return 1;
  const Tables T{geom, mat, gcols, ns, np, nb, nt};
  if (has_dielectric)
    sample_states<true>(T, num_pixels, origin, direction, rng_in, spp, num_bounces, states);
  else
    sample_states<false>(T, num_pixels, origin, direction, rng_in, spp, num_bounces, states);
  return 0;
}

// The per-sample backward from recorded states [num_pixels, spp, 4], with
// hpt_backward_host's outputs.
extern "C" int hpt_backward_samples_host(
    const float* geom, int gcols, const float* mat, int ns, int np, int nb,
    int nt, int has_dielectric, int num_pixels, const float* origin,
    const float* direction, const uint32_t* states, const float* g_rad,
    int spp, int num_bounces, float* dgeom, float* dmat, float* d_origin,
    float* d_direction) {
  if (num_bounces > 64) return 1;
  const Tables T{geom, mat, gcols, ns, np, nb, nt};
  if (has_dielectric)
    backward_samples<true>(T, num_pixels, origin, direction, states, g_rad, spp,
                           num_bounces, dgeom, dmat, d_origin, d_direction);
  else
    backward_samples<false>(T, num_pixels, origin, direction, states, g_rad, spp,
                            num_bounces, dgeom, dmat, d_origin, d_direction);
  return 0;
}
