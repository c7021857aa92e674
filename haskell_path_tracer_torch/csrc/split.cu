// The deterministic-splitting kernel for Hopper (sm_90a): every sample's
// dielectric split tree of a pixel, walked depth first, one thread per
// pixel.
//
// Replaces haskell_path_tracer_tpu/ops/pallas_split.py:_split_kernel_body
// (launched there by trace_split_pallas).  Semantics are that kernel's,
// step for step (split.cuh): at a glass hit the lane continues as the
// Fresnel reflection with weight F and pushes the refraction child,
// weight 1 - F, on a stack of `stack_depth` slots; a dead segment pops the
// deepest child; three draws per alive segment; at most
// bounces x (1 + stack_depth) steps per sample.  On a scene without glass
// it is the inline megakernel's trace (megakernel.cu with HAS_DIELECTRIC
// off), rng and radiance.
//
// What bounds it: fp32 ALU and SFU work, as the inline megakernel.  Per
// processed segment a thread folds over every primitive and runs one BRDF
// sample (about 6 sin/cos) or one Fresnel split; the only device-memory
// traffic is 40 B read (origin, direction, rng) and 28 B written
// (radiance, rng) per pixel per launch, whatever spp, the bounces and the
// splits are.  The design follows:
//   * the loop state (ray, throughput, depth, rng, radiance) and the
//     stack live in registers: stack depths of 1, 2 and 4 take a stack of
//     that many slots addressed by unrolled compares (split.cuh:Stack), so
//     nothing spills; deeper stacks go to thread-local memory;
//   * the scene tables sit in shared memory up to the card's opt-in limit
//     and are read from device memory beyond it (bounce.cuh:stage_tables);
//   * the fold, the hit, the BRDF sample and the Fresnel split are
//     bounce.cuh's device functions, those of the inline kernel;
//   * a thread leaves the step loop when its lane is dead and its stack
//     empty (exact: such a lane never revives), where the TPU kernel
//     skipped a whole block only once all its lanes had drained;
//   * any H x W: ceil(H*W / 128) blocks, the ragged tail masked.
// Not carried over from the TPU kernel: its row tiles, the rolled or
// unrolled sample loop, the early_exit flag and the width % 128 gate.
//
// Floating point: built with -fmad=false and without fast math, as the
// other kernels, so it agrees with the PyTorch plain version
// (ops/split.py:trace_split_reference) lane for lane.
//
// Layout: origin and direction [H, W, 3] f32, rng [H, W, 4] u32 (the
// int32 tensors' bits), radiance [H, W, 3] f32; geom [P, gcols] (gcols 8
// or 16) and mat [P, 8] f32 are the tables of ops/megakernel.py:scene_tables.

#include <cstdint>
#include <cuda_runtime.h>

#include "split.cuh"

namespace {

using namespace hpt;

constexpr int kThreads = 128;

template <int CAP, bool IN_SMEM>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ geom_g, int gcols,
             const float* __restrict__ mat_g, int ns, int np, int nb, int nt,
             const float* __restrict__ origin,
             const float* __restrict__ direction,
             const uint32_t* __restrict__ rng_in, float* __restrict__ radiance,
             uint32_t* __restrict__ rng_out, int num_pixels, int spp,
             int num_bounces, int stack_depth) {
  extern __shared__ float smem[];
  const Tables T = stage_tables<IN_SMEM>(geom_g, mat_g, gcols, ns, np, nb, nt, smem);

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= num_pixels) return;

  const float po[3] = {origin[3 * pix], origin[3 * pix + 1], origin[3 * pix + 2]};
  const float pd[3] = {direction[3 * pix], direction[3 * pix + 1],
                       direction[3 * pix + 2]};
  Rng rng{rng_in[4 * pix], rng_in[4 * pix + 1], rng_in[4 * pix + 2],
          rng_in[4 * pix + 3]};
  float acc[3];
  split_pixel<CAP>(T, po, pd, rng, spp, num_bounces, stack_depth, acc);
  radiance[3 * pix] = acc[0];
  radiance[3 * pix + 1] = acc[1];
  radiance[3 * pix + 2] = acc[2];
  rng_out[4 * pix] = rng.a;
  rng_out[4 * pix + 1] = rng.b;
  rng_out[4 * pix + 2] = rng.c;
  rng_out[4 * pix + 3] = rng.ctr;
}

template <int CAP>
cudaError_t launch(const float* geom, int gcols, const float* mat, int ns,
                   int np, int nb, int nt, const float* origin,
                   const float* direction, const uint32_t* rng_in,
                   float* radiance, uint32_t* rng_out, int num_pixels, int spp,
                   int num_bounces, int stack_depth, cudaStream_t stream) {
  const int P = ns + np + nb + nt;
  const size_t bytes = sizeof(float) * (size_t)P * (gcols + 8);
  const bool in_smem = bytes <= smem_optin_bytes();
  const size_t smem = in_smem ? bytes : 0;
  const auto kernel = in_smem ? split_kernel<CAP, true> : split_kernel<CAP, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (num_pixels + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      geom, gcols, mat, ns, np, nb, nt, origin, direction, rng_in, radiance,
      rng_out, num_pixels, spp, num_bounces, stack_depth);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns the launch's error (0 = launched), or
// cudaErrorInvalidValue when stack_depth is outside 1 .. kMaxStack.
extern "C" int hpt_split_launch(
    const float* geom, int gcols, const float* mat, int num_spheres,
    int num_planes, int num_boxes, int num_triangles, const float* origin,
    const float* direction, const uint32_t* rng_in, float* radiance,
    uint32_t* rng_out, int num_pixels, int spp, int num_bounces,
    int stack_depth, void* stream) {
  if (stack_depth < 1 || stack_depth > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_pixels <= 0) return static_cast<int>(cudaGetLastError());
  auto go = [&](auto fn) {
    return static_cast<int>(fn(geom, gcols, mat, num_spheres, num_planes,
                               num_boxes, num_triangles, origin, direction,
                               rng_in, radiance, rng_out, num_pixels, spp,
                               num_bounces, stack_depth,
                               static_cast<cudaStream_t>(stream)));
  };
  switch (stack_capacity(stack_depth)) {
    case 1: return go(launch<1>);
    case 2: return go(launch<2>);
    case 4: return go(launch<4>);
    default: return go(launch<0>);
  }
}
