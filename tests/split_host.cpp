// Host harness for the deterministic-splitting kernel's per-pixel code:
// compiles haskell_path_tracer_torch/csrc/split.cuh with a plain C++
// compiler, so tests/test_torch_split_host.py can run the kernel's
// traversal on a machine without a GPU and hold it against the plain
// PyTorch version: pixel by pixel, one lane alone, and in emulated warps
// of 32 lanes that step in turn, as split_kernel's warps run.  A test tool
// only: nothing in the package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libsplit_host.so split_host.cpp

#include <cstdint>

#include "split.cuh"

using namespace hpt;

namespace {

constexpr int kWarp = 32;

// split_kernel's warps, their lanes run one after the other at each step:
// lane k of warp w works on queue entry 32 w + k, pixel order[32 w + k].
// Without `barrier` every lane with work left steps, as in the kernel;
// with it a lane steps only while its sample is the warp's earliest (the
// nested loop's order of samples).  Returns the steps the warps ran (their
// rounds).
template <int CAP>
long warp_run(const Tables& T, const float* origin, const float* direction,
              const uint32_t* rng_in, const int* order, float* radiance, uint32_t* rng_out,
              int num_pixels, int spp, int num_bounces, int stack_depth, bool barrier) {
  const int max_steps = num_bounces * (1 + stack_depth);
  SplitLane<CAP>* lanes = new SplitLane<CAP>[kWarp];
  long rounds = 0;
  for (int base = 0; base < num_pixels; base += kWarp) {
    const int m = num_pixels - base < kWarp ? num_pixels - base : kWarp;
    bool busy[kWarp];
    for (int k = 0; k < kWarp; ++k) {
      busy[k] = false;
      if (k >= m) continue;
      const int p = order[base + k];
      const Rng rng{rng_in[4 * p], rng_in[4 * p + 1], rng_in[4 * p + 2], rng_in[4 * p + 3]};
      busy[k] = split_start(T, lanes[k], origin + 3 * p, direction + 3 * p, rng, spp, num_bounces);
    }
    for (;;) {
      int s = spp;
      for (int k = 0; k < kWarp; ++k)
        if (busy[k] && lanes[k].s < s) s = lanes[k].s;
      if (s == spp) break;
      for (int k = 0; k < kWarp; ++k)
        if (busy[k] && (!barrier || lanes[k].s == s))
          busy[k] = split_step(T, lanes[k], spp, num_bounces, stack_depth, max_steps);
      ++rounds;
    }
    for (int k = 0; k < m; ++k) split_store(lanes[k], order[base + k], radiance, rng_out);
  }
  delete[] lanes;
  return rounds;
}

}  // namespace

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

// The kernel's warps emulated (warp_run), with the stack `cap` names,
// over the queue `order` (a permutation of the pixels), free or with the
// sample barrier: the warps' steps.
extern "C" long hpt_split_warp_host(
    const float* geom, int gcols, const float* mat, int ns, int np, int nb,
    int nt, const float* origin, const float* direction,
    const uint32_t* rng_in, const int* order, float* radiance, uint32_t* rng_out,
    int num_pixels, int spp, int num_bounces, int stack_depth, int cap, int barrier) {
  const Tables T{geom, mat, gcols, ns, np, nb, nt};
  switch (cap) {
    case 1: return warp_run<1>(T, origin, direction, rng_in, order, radiance, rng_out,
                               num_pixels, spp, num_bounces, stack_depth, barrier != 0);
    case 2: return warp_run<2>(T, origin, direction, rng_in, order, radiance, rng_out,
                               num_pixels, spp, num_bounces, stack_depth, barrier != 0);
    case 4: return warp_run<4>(T, origin, direction, rng_in, order, radiance, rng_out,
                               num_pixels, spp, num_bounces, stack_depth, barrier != 0);
    default: return warp_run<0>(T, origin, direction, rng_in, order, radiance, rng_out,
                                num_pixels, spp, num_bounces, stack_depth, barrier != 0);
  }
}
