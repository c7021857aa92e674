// Host harness for the NEE gradient's residual mode: compiles
// haskell_path_tracer_torch/csrc/nee.cuh and nee_vjp.cuh with a plain C++
// compiler, so tests/test_torch_nee_residual_host.py can check on a machine
// without a GPU that the recording forward writes the plain version's
// residual words, that the fold-free replay stores the folded replay's
// residuals bit for bit without running a fold, and that the two backwards
// agree.  A test tool only: nothing in the package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libnee_residual_host.so nee_residual_host.cpp

static long g_folds = 0;
#define HPT_FOLD_COUNTER g_folds

#include "nee_vjp.cuh"

using namespace hpt;
using namespace hpt::nee;

namespace {

constexpr int kMaxBounces = 64;

// Sums each bounce's row cotangents into the three cotangent tables and
// counts the bounces.
struct HostAcc {
  float* d_fold;
  float* d_payload;
  float* d_lights;
  int calls = 0;

  void operator()(const Scene&, const RowGrads& rg) {
    ++calls;
    if (d_fold == nullptr) return;
    for (int i = 0; i < rg.fold_cols; ++i) d_fold[rg.fold_at + i] += rg.fold[i];
    for (int i = 0; i < 12; ++i) d_payload[12 * rg.prim + i] += rg.payload[i];
    if (rg.light_row >= 0)
      for (int i = 0; i < 16; ++i) d_lights[16 * rg.light_row + i] += rg.light[i];
  }
};

template <bool G, bool D>
void record(const Scene& S, int n, const float* origin, const float* direction,
            const uint32_t* rng_in, float* radiance, uint32_t* rng_out, int* words,
            int spp, int num_bounces) {
  for (int q = 0; q < n; ++q)
    nee_pixel<G, D, true>(S, q, origin, direction, rng_in, nullptr, nullptr, radiance,
                          rng_out, nullptr, spp, num_bounces, words + q, n);
}

// Each sample's replay alone (pixel_backward at spp = 1, from the rng the
// samples before it left): its live bounces and their stored rays,
// throughputs and winners.
template <bool G, bool D, bool RESID>
void replay(const Scene& S, int n, const float* origin, const float* direction,
            const uint32_t* rng_in, const int* words, int spp, int num_bounces,
            float* states, int* prims, int* live) {
  nee::Residual st[kMaxBounces];
  const float g_rad[3] = {1.0f, 1.0f, 1.0f};
  for (int q = 0; q < n; ++q) {
    const float* po = origin + 3 * q;
    const float* pd = direction + 3 * q;
    float t0 = 0.0f;
    int prim0 = 0;
    if (!RESID) primary_hit(S, po, pd, t0, prim0);
    Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    for (int s = 0; s < spp; ++s) {
      HostAcc acc{nullptr, nullptr, nullptr};
      float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
      const int* rec = RESID ? words + (size_t)s * num_bounces * n + q : nullptr;
      pixel_backward<G, D, RESID>(S, po, pd, t0, prim0, rec, n, rng, g_rad, 1, num_bounces,
                                  st, g_o, g_d, acc);
      const int k = q * spp + s;
      live[k] = acc.calls;
      for (int b = 0; b < acc.calls; ++b) {
        float* out = states + 9 * ((size_t)k * num_bounces + b);
        for (int i = 0; i < 3; ++i) {
          out[i] = st[b].o[i];
          out[3 + i] = st[b].d[i];
          out[6 + i] = st[b].th[i];
        }
        prims[(size_t)k * num_bounces + b] = st[b].prim;
      }
      for (int i = 0; i < 6 * acc.calls; ++i) uniform(rng);  // the sample's draws
    }
  }
}

template <bool G, bool D, bool RESID>
void backward(const Scene& S, int n, const float* origin, const float* direction,
              const uint32_t* rng_in, const int* words, const float* g_rad, int spp,
              int num_bounces, float* d_fold, float* d_payload, float* d_lights,
              float* d_origin, float* d_direction) {
  nee::Residual st[kMaxBounces];
  HostAcc acc{d_fold, d_payload, d_lights};
  for (int q = 0; q < n; ++q) {
    float t0 = 0.0f;
    int prim0 = 0;
    if (!RESID) primary_hit(S, origin + 3 * q, direction + 3 * q, t0, prim0);
    const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    float* go = d_origin + 3 * q;
    float* gd = d_direction + 3 * q;
    for (int i = 0; i < 3; ++i) go[i] = gd[i] = 0.0f;
    pixel_backward<G, D, RESID>(S, origin + 3 * q, direction + 3 * q, t0, prim0,
                                RESID ? words + q : nullptr, n, rng, g_rad + 3 * q, spp,
                                num_bounces, st, go, gd, acc);
  }
}

#define DISPATCH(fn, ...)                                           \
  do {                                                              \
    if (has_glossy && has_diel) fn<true, true>(__VA_ARGS__);        \
    else if (has_glossy) fn<true, false>(__VA_ARGS__);              \
    else if (has_diel) fn<false, true>(__VA_ARGS__);                \
    else fn<false, false>(__VA_ARGS__);                             \
  } while (0)

template <bool G, bool D>
void replay_either(bool resid, const Scene& S, int n, const float* origin,
                   const float* direction, const uint32_t* rng_in, const int* words,
                   int spp, int num_bounces, float* states, int* prims, int* live) {
  if (resid)
    replay<G, D, true>(S, n, origin, direction, rng_in, words, spp, num_bounces, states,
                       prims, live);
  else
    replay<G, D, false>(S, n, origin, direction, rng_in, words, spp, num_bounces, states,
                        prims, live);
}

template <bool G, bool D>
void backward_either(bool resid, const Scene& S, int n, const float* origin,
                     const float* direction, const uint32_t* rng_in, const int* words,
                     const float* g_rad, int spp, int num_bounces, float* d_fold,
                     float* d_payload, float* d_lights, float* d_origin,
                     float* d_direction) {
  if (resid)
    backward<G, D, true>(S, n, origin, direction, rng_in, words, g_rad, spp, num_bounces,
                         d_fold, d_payload, d_lights, d_origin, d_direction);
  else
    backward<G, D, false>(S, n, origin, direction, rng_in, words, g_rad, spp, num_bounces,
                          d_fold, d_payload, d_lights, d_origin, d_direction);
}

}  // namespace

// The folds run since the last call (the host build counts them in fold()).
extern "C" long hpt_take_fold_count() {
  const long n = g_folds;
  g_folds = 0;
  return n;
}

// The recording instance's work, pixel after pixel in raster order:
// radiance, rng and the residual words [spp * num_bounces, n] (a word past
// the bounce where its path ended is left as the caller filled it).
extern "C" void hpt_nee_record_host(
    const float* fold, const float* payload, const float* lights, int ns, int np,
    int nb, int nt, int nl, int has_glossy, int has_diel, int n, const float* origin,
    const float* direction, const uint32_t* rng_in, float* radiance, uint32_t* rng_out,
    int* words, int spp, int num_bounces) {
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  DISPATCH(record, S, n, origin, direction, rng_in, radiance, rng_out, words, spp, num_bounces);
}

// Each (pixel, sample)'s replay, folded (resid = 0) or from the words:
// live [n, spp] bounces, their states [n, spp, num_bounces, 9] = (o, d, th)
// and winners [n, spp, num_bounces].  Returns 1 when num_bounces exceeds
// the harness's residual array, 0 otherwise.
extern "C" int hpt_nee_replay_host(
    const float* fold, const float* payload, const float* lights, int ns, int np,
    int nb, int nt, int nl, int has_glossy, int has_diel, int n, const float* origin,
    const float* direction, const uint32_t* rng_in, const int* words, int resid, int spp,
    int num_bounces, float* states, int* prims, int* live) {
  if (num_bounces > kMaxBounces) return 1;
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  DISPATCH(replay_either, resid != 0, S, n, origin, direction, rng_in, words, spp,
           num_bounces, states, prims, live);
  return 0;
}

// The backward kernel's per-pixel work, folded (resid = 0) or from the
// words, pixel after pixel: table cotangents summed into d_fold, d_payload
// and d_lights (zeroed by the caller), ray cotangents per pixel.  Returns 1
// when num_bounces exceeds the harness's residual array, 0 otherwise.
extern "C" int hpt_nee_backward_host(
    const float* fold, const float* payload, const float* lights, int ns, int np,
    int nb, int nt, int nl, int has_glossy, int has_diel, int n, const float* origin,
    const float* direction, const uint32_t* rng_in, const int* words, int resid,
    const float* g_rad, int spp, int num_bounces, float* d_fold, float* d_payload,
    float* d_lights, float* d_origin, float* d_direction) {
  if (num_bounces > kMaxBounces) return 1;
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  DISPATCH(backward_either, resid != 0, S, n, origin, direction, rng_in, words, g_rad, spp,
           num_bounces, d_fold, d_payload, d_lights, d_origin, d_direction);
  return 0;
}
