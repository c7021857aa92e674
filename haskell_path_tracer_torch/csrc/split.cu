// The deterministic-splitting kernel for Hopper (sm_90a): every sample's
// dielectric split tree of a pixel, walked depth first, one thread per
// pixel, its samples one flat loop of steps.
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
// splits are.  Measured on an H100 (PERF.md), the time goes to the issue
// slots of each step's IEEE divisions, square roots and sin/cos, and to
// the branches a warp's lanes take apart, not to lanes idling.  The design
// follows:
//   * each lane runs its pixel's samples as one flat loop of steps
//     (split.cuh:split_step), each sample restarting from the primary hit
//     when the last one ends.  A step shades the segment whose hit the
//     step before folded (or pops a child), then folds the next one, and a
//     sample whose next segment is dead with no child left ends in the
//     same step: a sample takes as many steps as it has alive and popping
//     steps, where the TPU kernel's loop over samples, steps nested inside,
//     took one more to find each sample's end, and a warp waited, sample by
//     sample, for its longest lane;
//   * no work whose result is thrown away: the primary ray is folded once
//     per pixel, a segment dead whatever it hits (throughput near zero, or
//     depth == bounces) is not folded, and a glass hit runs the Fresnel
//     split alone, without the BRDF sample the TPU kernel discarded;
//   * no warp-wide operation: lanes run free, and a vote per step to keep
//     the warp converged, or holding lanes to the warp's earliest sample,
//     measured slower;
//   * the loop state (ray, throughput, depth, rng, radiance) and the
//     stack live in registers: stack depths of 1, 2 and 4 take a stack of
//     that many slots addressed by unrolled compares (split.cuh:Stack), so
//     nothing spills; deeper stacks go to thread-local memory;
//   * the scene tables sit in shared memory up to the card's opt-in limit
//     and are read from device memory beyond it (bounce.cuh:stage_tables);
//   * the fold, the hit, the BRDF sample and the Fresnel split are
//     bounce.cuh's device functions, those of the inline kernel;
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
// The resident blocks per SM a launch of one sample asks of the compiler:
// 6 (at most 80 registers, 24 warps).  Above one sample the kernel asks for
// none (0) and takes 96 registers (20 warps).  Measured on an H100
// (PERF.md): the cap cost 10% at 64 samples and gained 4-5% at one, a
// launch of tens of microseconds whose tail of blocks the occupancy
// shortens.
constexpr int kOneSampleBlocks = 6;

// One thread per pixel, in raster order: each runs its pixel's flat loop
// (split.cuh:split_step) until it has banked its last sample.
template <int CAP, bool IN_SMEM, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
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

  const int max_steps = num_bounces * (1 + stack_depth);
  const Rng rng{rng_in[4 * pix], rng_in[4 * pix + 1], rng_in[4 * pix + 2],
                rng_in[4 * pix + 3]};
  SplitLane<CAP> L;
  if (split_start(T, L, origin + 3 * pix, direction + 3 * pix, rng, spp, num_bounces))
    while (split_step(T, L, spp, num_bounces, stack_depth, max_steps)) {
    }
  split_store(L, pix, radiance, rng_out);
}

template <int CAP, int MIN_BLOCKS>
const void* instance(bool in_smem) {
  return in_smem ? reinterpret_cast<const void*>(split_kernel<CAP, true, MIN_BLOCKS>)
                 : reinterpret_cast<const void*>(split_kernel<CAP, false, MIN_BLOCKS>);
}

template <int CAP>
const void* instance(bool in_smem, int spp) {
  return spp == 1 ? instance<CAP, kOneSampleBlocks>(in_smem) : instance<CAP, 0>(in_smem);
}

// The instance of a launch of `spp` samples with the stack `cap` names
// (stack_capacity), the tables in shared memory or not.
const void* pick(int cap, bool in_smem, int spp) {
  switch (cap) {
    case 1: return instance<1>(in_smem, spp);
    case 2: return instance<2>(in_smem, spp);
    case 4: return instance<4>(in_smem, spp);
    default: return instance<0>(in_smem, spp);
  }
}

// The tables' bytes in shared memory: all of them up to the card's opt-in
// limit, else none (read from device memory).
size_t table_smem(int gcols, int num_primitives) {
  const size_t bytes = sizeof(float) * (size_t)num_primitives * (gcols + 8);
  return bytes <= smem_optin_bytes() ? bytes : 0;
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
  const size_t smem =
      table_smem(gcols, num_spheres + num_planes + num_boxes + num_triangles);
  const void* kernel = pick(stack_capacity(stack_depth), smem > 0, spp);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (num_pixels + kThreads - 1) / kThreads;
  void* args[] = {&geom, &gcols, &mat, &num_spheres, &num_planes, &num_boxes,
                  &num_triangles, &origin, &direction, &rng_in, &radiance, &rng_out,
                  &num_pixels, &spp, &num_bounces, &stack_depth};
  return static_cast<int>(launch_instance(kernel, blocks, kThreads, smem, args,
                                          static_cast<cudaStream_t>(stream)));
}

// What the card gives the instance that a launch of `spp` samples on these
// tables and this stack takes (bounce.cuh:kernel_resources): out[7], and
// its name.  Returns cudaGetLastError() (0 = answered).
extern "C" int hpt_split_resources(int gcols, int num_primitives, int stack_depth, int spp,
                                   int* out, const char** name) {
  const size_t smem = table_smem(gcols, num_primitives);
  const int cap = stack_capacity(stack_depth);
  static const char* kNames[2][4] = {
      {"split_kernel<local stack>", "split_kernel<1>", "split_kernel<2>", "split_kernel<4>"},
      {"split_kernel<local stack, 6 blocks>", "split_kernel<1, 6 blocks>",
       "split_kernel<2, 6 blocks>", "split_kernel<4, 6 blocks>"}};
  *name = kNames[spp == 1][cap == 4 ? 3 : cap];
  kernel_resources(pick(cap, smem > 0, spp), kThreads, smem, out);
  return static_cast<int>(cudaGetLastError());
}
