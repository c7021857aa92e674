// Host harness for the NEE backward kernel's hand-written adjoint: compiles
// haskell_path_tracer_torch/csrc/nee_vjp.cuh with a plain C++ compiler, so
// tests/test_torch_nee_adjoint_host.py can hold `bounce_vjp`,
// `pixel_backward` and the replay mode's `pixel_backward_chunked` against
// torch.autograd of the plain version, and the chunked replay against the
// residual mode, on a machine without a GPU.  A test tool only: nothing in
// the package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libnee_adjoint_host.so nee_adjoint_host.cpp

#include <vector>

#include "nee_vjp.cuh"

using namespace hpt;
using namespace hpt::nee;

namespace {

// Sums each bounce's row cotangents into the three cotangent tables.
struct HostAcc {
  float* d_fold;
  float* d_payload;
  float* d_lights;

  void operator()(const Scene&, const RowGrads& rg) {
    for (int i = 0; i < rg.fold_cols; ++i) d_fold[rg.fold_at + i] += rg.fold[i];
    for (int i = 0; i < 12; ++i) d_payload[12 * rg.prim + i] += rg.payload[i];
    if (rg.light_row >= 0)
      for (int i = 0; i < 16; ++i) d_lights[16 * rg.light_row + i] += rg.light[i];
  }
};

template <bool G, bool D>
void bounce_states(const Scene& S, int n, const float* state, const int* decisions,
                   const float* cot, float* g_state, float* d_fold,
                   float* d_payload, float* d_lights) {
  HostAcc acc{d_fold, d_payload, d_lights};
  for (int k = 0; k < n; ++k) {
    const float* s = state + 15 * k;    // o, d, th, u, us
    const int* c = decisions + 3 * k;   // prim, prev_spec, occ
    const float* g = cot + 12 * k;      // c_o, c_d, c_th, g_rad
    nee::Residual r;
    for (int i = 0; i < 3; ++i) {
      r.o[i] = s[i];
      r.d[i] = s[3 + i];
      r.th[i] = s[6 + i];
      r.dr.u[i] = s[9 + i];
      r.dr.us[i] = s[12 + i];
    }
    r.prim = c[0];
    r.prev_spec = c[1] != 0;
    r.dr.occ = c[2] != 0;
    float* out = g_state + 9 * k;  // go, gd, gth
    RowGrads rg;
    bounce_vjp<G, D>(S, r, g, g + 3, g + 6, g + 9, out, out + 3, out + 6, rg);
    acc(S, rg);
  }
}

template <bool G, bool D>
void backward(const Scene& S, int num_pixels, const float* origin,
              const float* direction, const uint32_t* rng_in, const float* g_rad,
              int spp, int num_bounces, float* d_fold, float* d_payload,
              float* d_lights, float* d_origin, float* d_direction) {
  nee::Residual st[64];
  HostAcc acc{d_fold, d_payload, d_lights};
  for (int q = 0; q < num_pixels; ++q) {
    float t0;
    int prim0;
    primary_hit(S, origin + 3 * q, direction + 3 * q, t0, prim0);
    const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    float* go = d_origin + 3 * q;
    float* gd = d_direction + 3 * q;
    for (int i = 0; i < 3; ++i) go[i] = gd[i] = 0.0f;
    pixel_backward<G, D, false>(S, origin + 3 * q, direction + 3 * q, t0, prim0, nullptr, 0,
                                rng, g_rad + 3 * q, spp, num_bounces, st, go, gd, acc);
  }
}

// The replay-mode kernel's per-pixel work (nee_megakernel_vjp.cu:
// nee_vjp_replay_kernel), lane after lane: lane i on pixel order[i] (order
// null: i), from the probe's (t0, prim0) when given, else its own primary
// fold, `chunk` samples at a time through a buffer of chunk * num_bounces
// words.
template <bool G, bool D>
void backward_chunked(const Scene& S, int num_pixels, const float* origin,
                      const float* direction, const uint32_t* rng_in, const float* g_rad,
                      const int* order, const float* t0_in, const int* prim0_in, int spp,
                      int num_bounces, int chunk, float* d_fold, float* d_payload,
                      float* d_lights, float* d_origin, float* d_direction) {
  nee::Residual st[64];
  std::vector<int> rec((size_t)chunk * num_bounces);
  HostAcc acc{d_fold, d_payload, d_lights};
  for (int i = 0; i < num_pixels; ++i) {
    const int q = order != nullptr ? order[i] : i;
    float t0;
    int prim0;
    if (t0_in != nullptr) {
      t0 = t0_in[q];
      prim0 = prim0_in[q];
    } else {
      primary_hit(S, origin + 3 * q, direction + 3 * q, t0, prim0);
    }
    const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    float* go = d_origin + 3 * q;
    float* gd = d_direction + 3 * q;
    for (int k = 0; k < 3; ++k) go[k] = gd[k] = 0.0f;
    pixel_backward_chunked<G, D>(S, origin + 3 * q, direction + 3 * q, t0, prim0, rng,
                                 g_rad + 3 * q, spp, num_bounces, chunk, rec.data(), 1, st, go,
                                 gd, acc, [] {});
  }
}

// The residual mode's per-pixel work, in raster order: the recording
// forward (nee_pixel with RECORD) writes a pixel's words, then the
// fold-free pixel_backward reverses them.
template <bool G, bool D>
void backward_residual(const Scene& S, int num_pixels, const float* origin,
                       const float* direction, const uint32_t* rng_in, const float* g_rad,
                       int spp, int num_bounces, float* d_fold, float* d_payload,
                       float* d_lights, float* d_origin, float* d_direction) {
  nee::Residual st[64];
  std::vector<int> rec((size_t)spp * num_bounces);
  HostAcc acc{d_fold, d_payload, d_lights};
  for (int q = 0; q < num_pixels; ++q) {
    float radiance[3];
    uint32_t rng_out[4];
    const uint32_t* r = rng_in + 4 * q;
    nee_pixel<G, D, true>(S, 0, origin + 3 * q, direction + 3 * q, r, nullptr, nullptr,
                          radiance, rng_out, nullptr, spp, num_bounces, rec.data(), 1);
    float* go = d_origin + 3 * q;
    float* gd = d_direction + 3 * q;
    for (int k = 0; k < 3; ++k) go[k] = gd[k] = 0.0f;
    pixel_backward<G, D, true>(S, origin + 3 * q, direction + 3 * q, 0.0f, 0, rec.data(), 1,
                               Rng{r[0], r[1], r[2], r[3]}, g_rad + 3 * q, spp, num_bounces,
                               st, go, gd, acc);
  }
}

#define DISPATCH(fn, ...)                                   \
  do {                                                      \
    if (has_glossy && has_diel) fn<true, true>(__VA_ARGS__);        \
    else if (has_glossy) fn<true, false>(__VA_ARGS__);      \
    else if (has_diel) fn<false, true>(__VA_ARGS__);        \
    else fn<false, false>(__VA_ARGS__);                     \
  } while (0)

}  // namespace

// One live bounce's adjoint at n states: state [n, 15] = (o, d, th, u, us),
// decisions [n, 3] int = (prim, prev_spec, occ), output cotangents [n, 12] =
// (c_o, c_d, c_th, g_rad).  Writes the input cotangents [n, 9] = (go, gd,
// gth) and adds the row cotangents of all states into d_fold, d_payload and
// d_lights (zeroed by the caller).
extern "C" void hpt_nee_bounce_vjp_host(
    const float* fold, const float* payload, const float* lights, int ns, int np,
    int nb, int nt, int nl, int has_glossy, int has_diel, int n,
    const float* state, const int* decisions, const float* cot, float* g_state,
    float* d_fold, float* d_payload, float* d_lights) {
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  DISPATCH(bounce_states, S, n, state, decisions, cot, g_state, d_fold, d_payload, d_lights);
}

// The backward kernel's per-pixel work, pixel after pixel on the host, in
// raster order: table cotangents summed into d_fold, d_payload and d_lights
// (zeroed by the caller), ray cotangents per pixel.  Returns 1 when
// num_bounces exceeds the harness's residual array, 0 otherwise.
extern "C" int hpt_nee_backward_host(
    const float* fold, const float* payload, const float* lights, int ns, int np,
    int nb, int nt, int nl, int has_glossy, int has_diel, int num_pixels,
    const float* origin, const float* direction, const uint32_t* rng_in,
    const float* g_rad, int spp, int num_bounces, float* d_fold, float* d_payload,
    float* d_lights, float* d_origin, float* d_direction) {
  if (num_bounces > 64) return 1;
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  DISPATCH(backward, S, num_pixels, origin, direction, rng_in, g_rad, spp, num_bounces,
           d_fold, d_payload, d_lights, d_origin, d_direction);
  return 0;
}

// The replay mode's chunked backward (backward_chunked): order, t0_in and
// prim0_in may be null.  Returns 1 when num_bounces exceeds the harness's
// residual array or chunk < 1, 0 otherwise.
extern "C" int hpt_nee_backward_chunked_host(
    const float* fold, const float* payload, const float* lights, int ns, int np,
    int nb, int nt, int nl, int has_glossy, int has_diel, int num_pixels,
    const float* origin, const float* direction, const uint32_t* rng_in,
    const float* g_rad, const int* order, const float* t0_in, const int* prim0_in, int spp,
    int num_bounces, int chunk, float* d_fold, float* d_payload, float* d_lights,
    float* d_origin, float* d_direction) {
  if (num_bounces > 64 || chunk < 1) return 1;
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  DISPATCH(backward_chunked, S, num_pixels, origin, direction, rng_in, g_rad, order, t0_in,
           prim0_in, spp, num_bounces, chunk, d_fold, d_payload, d_lights, d_origin,
           d_direction);
  return 0;
}

// The residual mode's backward over the host forward's words
// (backward_residual).  Returns 1 when num_bounces exceeds the harness's
// residual array, 0 otherwise.
extern "C" int hpt_nee_backward_residual_host(
    const float* fold, const float* payload, const float* lights, int ns, int np,
    int nb, int nt, int nl, int has_glossy, int has_diel, int num_pixels,
    const float* origin, const float* direction, const uint32_t* rng_in,
    const float* g_rad, int spp, int num_bounces, float* d_fold, float* d_payload,
    float* d_lights, float* d_origin, float* d_direction) {
  if (num_bounces > 64) return 1;
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  DISPATCH(backward_residual, S, num_pixels, origin, direction, rng_in, g_rad, spp,
           num_bounces, d_fold, d_payload, d_lights, d_origin, d_direction);
  return 0;
}
