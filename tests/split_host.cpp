// Host harness for the deterministic-splitting kernel's per-pixel code:
// compiles haskell_path_tracer_torch/csrc/split.cuh with a plain C++
// compiler, so tests/test_torch_split_host.py can run the kernel's
// traversal, pixel by pixel, on a machine without a GPU and hold it
// against the plain PyTorch version.  A test tool only: nothing in the
// package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libsplit_host.so split_host.cpp

#include "split.cuh"

using namespace hpt;

// split_kernel's work, one pixel after the other, with the stack `cap`
// names (stack_capacity's choice, or 0 for the local-memory stack).
extern "C" void hpt_split_host(
    const float* geom, int gcols, const float* mat, int ns, int np, int nb,
    int nt, const float* origin, const float* direction,
    const uint32_t* rng_in, float* radiance, uint32_t* rng_out,
    int num_pixels, int spp, int num_bounces, int stack_depth, int cap) {
  const Tables T{geom, mat, gcols, ns, np, nb, nt};
  for (int i = 0; i < num_pixels; ++i) {
    Rng rng{rng_in[4 * i], rng_in[4 * i + 1], rng_in[4 * i + 2], rng_in[4 * i + 3]};
    split_pixel_cap(cap, T, origin + 3 * i, direction + 3 * i, rng, spp,
                    num_bounces, stack_depth, radiance + 3 * i);
    rng_out[4 * i] = rng.a;
    rng_out[4 * i + 1] = rng.b;
    rng_out[4 * i + 2] = rng.c;
    rng_out[4 * i + 3] = rng.ctr;
  }
}

// stack_capacity, for the test to name the kernel's choice.
extern "C" int hpt_stack_capacity(int stack_depth) { return stack_capacity(stack_depth); }
