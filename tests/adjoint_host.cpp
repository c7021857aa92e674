// Host harness for the hand-written adjoint of the CUDA kernels: compiles
// haskell_path_tracer_torch/csrc/bounce.cuh with a plain C++ compiler, so
// tests/test_torch_adjoint_host.py can hold `bounce_vjp` and
// `pixel_backward` against torch.autograd of the plain version on a machine
// without a GPU.  A test tool only: nothing in the package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libadjoint_host.so adjoint_host.cpp

#include "bounce.cuh"

using namespace hpt;

namespace {

// Sums each bounce's row cotangents into [P, gcols] and [P, 8] tables.
struct HostAcc {
  float* dgeom;
  float* dmat;
  int gcols;

  void operator()(int row, const float* dg, const float* dm) {
    const int ncols = gcols < 12 ? gcols : 12;
    for (int i = 0; i < ncols; ++i) dgeom[row * gcols + i] += dg[i];
    for (int i = 0; i < 5; ++i) dmat[row * 8 + i] += dm[i];
  }
};

template <bool D>
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
    bounce_vjp<D>(T, best, s, s + 3, s + 6, s + 9, c, c + 3, c + 6, c + 9, g,
                  g + 3, g + 6, dg, dm);
    HostAcc acc{dgeom + (size_t)k * P * T.gcols, dmat + (size_t)k * P * 8,
                T.gcols};
    acc(best, dg, dm);
    winner[k] = best;
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
    bounce_states<true>(T, n, state, cot, g_state, dgeom, dmat, winner);
  else
    bounce_states<false>(T, n, state, cot, g_state, dgeom, dmat, winner);
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
