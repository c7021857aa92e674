// Host harness for the NEE megakernel's per-pixel code: compiles
// haskell_path_tracer_torch/csrc/nee.cuh with a plain C++ compiler, so
// tests/test_torch_nee_host.py can run the kernel's arithmetic, pixel by
// pixel, on a machine without a GPU and hold it against the plain PyTorch
// version.  A test tool only: nothing in the package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libnee_host.so nee_host.cpp

#include "nee.cuh"

using namespace hpt;

// nee_kernel's work, one pixel after the other (order, t0_in, prim0_in and
// steps may be null, as there).
extern "C" void hpt_nee_host(
    const float* fold, const float* payload, const float* lights, int ns,
    int np, int nb, int nt, int nl, const float* origin, const float* direction,
    const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
    const int* order, float* radiance, uint32_t* rng_out, int* steps,
    int num_pixels, int spp, int num_bounces, int has_glossy, int has_diel) {
  const nee::Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  for (int i = 0; i < num_pixels; ++i) {
    const int q = order != nullptr ? order[i] : i;
    if (has_glossy && has_diel)
      nee::nee_pixel<true, true>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                 radiance, rng_out, steps, spp, num_bounces);
    else if (has_glossy)
      nee::nee_pixel<true, false>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                  radiance, rng_out, steps, spp, num_bounces);
    else if (has_diel)
      nee::nee_pixel<false, true>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                  radiance, rng_out, steps, spp, num_bounces);
    else
      nee::nee_pixel<false, false>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                   radiance, rng_out, steps, spp, num_bounces);
  }
}

// probe_kernel's work.
extern "C" void hpt_probe_host(const float* fold, int ns, int np, int nb,
                               int nt, const float* origin,
                               const float* direction, float* t0, int* prim0,
                               int num_rays) {
  const nee::Scene S{fold, nullptr, nullptr, ns, np, nb, nt, 0};
  for (int i = 0; i < num_rays; ++i)
    nee::primary_hit(S, origin + 3 * i, direction + 3 * i, t0[i], prim0[i]);
}
