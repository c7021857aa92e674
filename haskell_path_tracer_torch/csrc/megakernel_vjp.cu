// The backward of the inline parity megakernel for Hopper (sm_90a): the
// cotangents of the scene tables and of the primary rays, given the
// cotangent of the radiance sum: one thread per (pixel, sample), or one
// per pixel.
//
// Replaces haskell_path_tracer_tpu/ops/pallas_megakernel_vjp.py:_bwd_kernel
// (launched there by _bwd_call).  Semantics are that kernel's: for each
// sample, replay the bounce loop (the same SFC32 draws and decisions as the
// forward kernel, megakernel.cu, through the shared functions of
// bounce.cuh), then sweep the bounces in reverse with every decision
// detached — the winner, the BRDF branch, the Fresnel choice and the dead
// mask — and the radiance cotangent as the emission cotangent of every
// bounce.  The TPU kernel took `jax.vjp` of its bounce; here the adjoint is
// written by hand (bounce.cuh:bounce_vjp).
//
// What bounds it: fp32 ALU and SFU work.  A live bounce costs the forward
// bounce in the replay (the fold over every primitive, one rotation of 3
// sincosf, 1-2 sqrt), then the winner's distance and its one rotation again
// and about twice their operations in the adjoint, which reuses the
// rotation's half angles: some 2-3x the forward kernel's work per live
// segment.  The device-memory traffic is 52 B read (origin, direction, rng,
// radiance cotangent) and 24 B written (ray cotangents) per pixel, 16 B
// more read per pixel and sample in the per-sample mode, plus one atomic
// add per nonzero table entry per block.  The design follows:
//   * one thread per (pixel, sample) (PER_SAMPLE): each replays its sample
//     from the rng the recording forward wrote at the sample's start, so a
//     pixel's samples run in parallel and a block's work is one sample
//     long, not spp samples; at 512x512 / 64 spp / 8 bounces this halves
//     the kernel's time against one thread per pixel (PERF.md).  A warp
//     holds consecutive samples of one pixel: they share the primary ray,
//     so the first bounce's winner too, and the warp sums that bounce's row
//     cotangents before one thread adds them; the ray cotangents are summed
//     over each run of lanes of one pixel with shuffles and added with one
//     atomic per run.  One thread per pixel, replaying its samples in turn,
//     is the mode at one sample (the same work, without the sums: 4.5%
//     faster at 3840x2160 / 1 / 4) and where the states would take more
//     than half the free device memory (ops/megakernel_vjp.py:per_sample);
//   * per live bounce the replay keeps the ray, throughput, random vector
//     and winner (13 words, `Residual`) in a thread-local array bounded by
//     kMaxBounces; the array lives in local memory, which the L1 cache
//     holds, and the reverse sweep reads it back without a fold.  Residuals
//     in shared memory, laid out [bounce][word][thread] and sized by the
//     launch, measured slower (4% at 8 bounces, 36% at 15: they cap the
//     resident blocks);
//   * 256-thread blocks with at least 3 per SM: the compiler holds each
//     thread to 80 registers and spills about 90 B into the stack frame,
//     and an SM keeps 24 warps (12 at the 134 registers of no minimum),
//     the fastest of 128 and 256 threads with 1-4 blocks (PERF.md);
//   * the sweep starts at the last live bounce: a dead bounce passes its
//     ray through and zeroes the throughput, so every cotangent after the
//     first dead bounce is zero;
//   * the tables in shared memory up to the card's opt-in limit and in
//     device memory beyond it, as in the forward kernel.  Per bounce only
//     the winner's row receives a cotangent.  Where the tables and a
//     cotangent tile of the same size both fit the block's shared memory
//     (about 1800 primitives with 8 geometry columns), each block sums its
//     rows in a shared tile [P, gcols + 8] with shared atomics, and adds
//     the tile's nonzero entries to the output with one global atomicAdd
//     each; beyond that every nonzero row entry is one global atomicAdd,
//     as in the NEE backward.  The order of these float sums changes from
//     run to run, so the table cotangents (and in the per-sample mode the
//     ray cotangents) are not bitwise reproducible (the tolerance that
//     covers it is in ops/megakernel_vjp.py);
//   * any H x W: ceil(lanes / 256) blocks, the ragged tail masked.
//
// Floating point: like the forward kernel, built with -fmad=false and
// without fast math, so the replay's decisions are the forward's.
//
// Layout: origin, direction [H, W, 3] f32; rng [H, W, 4] u32 (the int32
// tensors' bits), or the recorded states [H, W, spp, 4] u32; g_rad
// [H, W, 3] f32; d_origin, d_direction [H, W, 3] f32 (zeroed by the caller
// in the per-sample mode); geom / d_geom [P, gcols], mat / d_mat [P, 8]
// f32, d_geom and d_mat zeroed by the caller.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

using namespace hpt;

// Block shape: threads per block, and the blocks per SM the compiler must
// leave room for (it caps the registers at 65536 / (threads x blocks)).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;
constexpr int kMaxBounces = 16;
constexpr unsigned kFullMask = 0xffffffffu;

// Adds one bounce's row cotangents into the block's shared tile, or into
// the output tables in device memory.  With `hold_first` (one thread per
// sample) the first bounce's are kept in `dg0`, `dm0`, for the warp to sum.
struct SharedAcc {
  float* dgeom;  // [P, gcols]
  float* dmat;   // [P, 8]
  int gcols;
  bool hold_first;
  int best0 = -1;
  float dg0[12] = {}, dm0[5] = {};

  // Host and device, as sample_backward is; it only ever runs on the device.
  __host__ __device__ __forceinline__ void add(int row, const float* dg,
                                               const float* dm) {
#if defined(__CUDA_ARCH__)
    const int ncols = gcols < 12 ? gcols : 12;
    for (int i = 0; i < ncols; ++i)
      if (dg[i] != 0.0f) atomicAdd(&dgeom[row * gcols + i], dg[i]);
    for (int i = 0; i < 5; ++i)
      if (dm[i] != 0.0f) atomicAdd(&dmat[row * 8 + i], dm[i]);
#endif
  }

  __host__ __device__ __forceinline__ void operator()(int b, int row,
                                                      const float* dg,
                                                      const float* dm) {
    if (hold_first && b == 0) {
      best0 = row;
      for (int i = 0; i < 12; ++i) dg0[i] = dg[i];
      for (int i = 0; i < 5; ++i) dm0[i] = dm[i];
    } else {
      add(row, dg, dm);
    }
  }
};

// The sum over a warp's lanes, in every lane.
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// TABLES_IN_SMEM: the tables in shared memory; ACC_IN_SMEM (which implies
// it): the cotangent tile too.  Template parameters, so that the compiler
// knows which memory the loads and atomics address.
//
// PER_SAMPLE: one thread per (pixel, sample), `rng` the recorded rng of
// every pixel at the start of every sample [num_pixels, spp, 4]; else one
// thread per pixel, `rng` the pixel's rng [num_pixels, 4].
template <bool HAS_DIELECTRIC, bool TABLES_IN_SMEM, bool ACC_IN_SMEM, bool PER_SAMPLE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
megakernel_vjp(const float* __restrict__ geom_g, int gcols,
               const float* __restrict__ mat_g, int ns, int np, int nb,
               int nt, const float* __restrict__ origin,
               const float* __restrict__ direction,
               const uint32_t* __restrict__ rng,
               const float* __restrict__ g_rad, float* __restrict__ d_geom,
               float* __restrict__ d_mat, float* __restrict__ d_origin,
               float* __restrict__ d_direction, int num_pixels, int spp,
               int num_bounces) {
  extern __shared__ float smem[];
  const int P = ns + np + nb + nt;
  // The cotangent tile follows the tables when both sit in shared memory
  // (the tables' staging synchronises).
  float* acc_geom = ACC_IN_SMEM ? smem + P * (gcols + 8) : d_geom;
  float* acc_mat = ACC_IN_SMEM ? acc_geom + P * gcols : d_mat;
  if (ACC_IN_SMEM) {
    for (int i = threadIdx.x; i < P * gcols; i += blockDim.x) acc_geom[i] = 0.0f;
    for (int i = threadIdx.x; i < P * 8; i += blockDim.x) acc_mat[i] = 0.0f;
  }
  const Tables T = stage_tables<TABLES_IN_SMEM>(geom_g, mat_g, gcols, ns, np, nb, nt, smem);

  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long lanes = PER_SAMPLE ? (long long)num_pixels * spp : num_pixels;
  const bool valid = tid < lanes;
  const int pix = valid ? (int)(PER_SAMPLE ? tid / spp : tid) : -1;
  SharedAcc acc{acc_geom, acc_mat, gcols, PER_SAMPLE};
  float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    const float po[3] = {origin[3 * pix], origin[3 * pix + 1],
                         origin[3 * pix + 2]};
    const float pd[3] = {direction[3 * pix], direction[3 * pix + 1],
                         direction[3 * pix + 2]};
    const float gr[3] = {g_rad[3 * pix], g_rad[3 * pix + 1],
                         g_rad[3 * pix + 2]};
    const uint4 r4 = reinterpret_cast<const uint4*>(rng)[tid];
    Rng state{r4.x, r4.y, r4.z, r4.w};
    Residual st[kMaxBounces];
    if constexpr (PER_SAMPLE)
      sample_backward<HAS_DIELECTRIC>(T, po, pd, state, gr, num_bounces, st, g_o,
                                      g_d, acc);
    else
      pixel_backward<HAS_DIELECTRIC>(T, po, pd, state, gr, spp, num_bounces, st,
                                     g_o, g_d, acc);
  }

  if constexpr (PER_SAMPLE) {
    // The first bounce's row cotangents: one warp sum and one add where
    // every lane of the warp has the same winner, as the samples of one
    // pixel do (they start from the same primary ray).
    const int lane = threadIdx.x & 31;
    const int best0 = acc.best0;
    const int lead = __shfl_sync(kFullMask, best0, 0);
    if (__all_sync(kFullMask, best0 == lead)) {
      if (lead >= 0) {
        float dg[12], dm[5];
        for (int i = 0; i < 12; ++i) dg[i] = warp_sum(acc.dg0[i]);
        for (int i = 0; i < 5; ++i) dm[i] = warp_sum(acc.dm0[i]);
        if (lane == 0) acc.add(lead, dg, dm);
      }
    } else if (best0 >= 0) {
      acc.add(best0, acc.dg0, acc.dm0);
    }
    // The ray cotangents of the warp's samples of one pixel: suffix sums
    // within each run of lanes of one pixel; the run's first lane adds them.
    float g[6] = {g_o[0], g_o[1], g_o[2], g_d[0], g_d[1], g_d[2]};
    for (int off = 1; off < 32; off <<= 1) {
      const int other = __shfl_down_sync(kFullMask, pix, off);
      for (int i = 0; i < 6; ++i) {
        const float y = __shfl_down_sync(kFullMask, g[i], off);
        if (lane + off < 32 && other == pix) g[i] += y;
      }
    }
    const int before = __shfl_up_sync(kFullMask, pix, 1);
    if (valid && (lane == 0 || before != pix)) {
      for (int i = 0; i < 3; ++i) {
        atomicAdd(&d_origin[3 * pix + i], g[i]);
        atomicAdd(&d_direction[3 * pix + i], g[3 + i]);
      }
    }
  } else if (valid) {
    for (int i = 0; i < 3; ++i) {
      d_origin[3 * pix + i] = g_o[i];
      d_direction[3 * pix + i] = g_d[i];
    }
  }
  if (!ACC_IN_SMEM) return;
  __syncthreads();

  for (int i = threadIdx.x; i < P * gcols; i += blockDim.x)
    if (acc_geom[i] != 0.0f) atomicAdd(&d_geom[i], acc_geom[i]);
  for (int i = threadIdx.x; i < P * 8; i += blockDim.x)
    if (acc_mat[i] != 0.0f) atomicAdd(&d_mat[i], acc_mat[i]);
}

// Every instance, in the order of their index: (per sample, dielectric,
// placement), the placements being global, tables, tables + tile in shared
// memory.
template <bool D, bool T, bool A, bool S>
KernelInstance instance(const char* name) {
  return {name, reinterpret_cast<const void*>(megakernel_vjp<D, T, A, S>)};
}
const KernelInstance kInstances[] = {
    instance<false, false, false, false>("megakernel_vjp<pixel, global>"),
    instance<false, true, false, false>("megakernel_vjp<pixel, tables>"),
    instance<false, true, true, false>("megakernel_vjp<pixel, tables+tile>"),
    instance<true, false, false, false>("megakernel_vjp<pixel, dielectric, global>"),
    instance<true, true, false, false>("megakernel_vjp<pixel, dielectric, tables>"),
    instance<true, true, true, false>("megakernel_vjp<pixel, dielectric, tables+tile>"),
    instance<false, false, false, true>("megakernel_vjp<sample, global>"),
    instance<false, true, false, true>("megakernel_vjp<sample, tables>"),
    instance<false, true, true, true>("megakernel_vjp<sample, tables+tile>"),
    instance<true, false, false, true>("megakernel_vjp<sample, dielectric, global>"),
    instance<true, true, false, true>("megakernel_vjp<sample, dielectric, tables>"),
    instance<true, true, true, true>("megakernel_vjp<sample, dielectric, tables+tile>"),
};

// The instance a launch takes, and its dynamic shared memory.
int choose(int gcols, int P, int has_dielectric, bool per_sample, size_t& smem) {
  const size_t bytes = sizeof(float) * (size_t)P * (gcols + 8);
  const size_t optin = smem_optin_bytes();
  const bool tables_in_smem = bytes <= optin;
  const bool acc_in_smem = 2 * bytes <= optin;
  smem = acc_in_smem ? 2 * bytes : (tables_in_smem ? bytes : 0);
  return 6 * per_sample + 3 * (has_dielectric != 0) + acc_in_smem + tables_in_smem;
}

int launch(const float* geom, int gcols, const float* mat, int ns, int np,
           int nb, int nt, const float* origin, const float* direction,
           const uint32_t* rng, const float* g_rad, float* d_geom,
           float* d_mat, float* d_origin, float* d_direction, int num_pixels,
           int spp, int num_bounces, int has_dielectric, bool per_sample,
           void* stream) {
  if (num_bounces > kMaxBounces) return static_cast<int>(cudaErrorInvalidValue);
  if (num_pixels <= 0 || spp <= 0) return static_cast<int>(cudaGetLastError());
  size_t smem;
  const void* kernel =
      kInstances[choose(gcols, ns + np + nb + nt, has_dielectric, per_sample, smem)].fn;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lanes = per_sample ? (long long)num_pixels * spp : num_pixels;
  void* args[] = {&geom, &gcols, &mat, &ns, &np, &nb, &nt, &origin, &direction,
                  &rng, &g_rad, &d_geom, &d_mat, &d_origin, &d_direction,
                  &num_pixels, &spp, &num_bounces};
  return static_cast<int>(launch_instance(kernel, (int)((lanes + kThreads - 1) / kThreads),
                                          kThreads, smem, args,
                                          static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` without
// synchronising and returns the launch's error (0 = launched), or
// cudaErrorInvalidValue when num_bounces exceeds the replay's kMaxBounces.
//
// One thread per pixel: rng_in [num_pixels, 4], the rng the forward began
// with; d_origin and d_direction are written.
extern "C" int hpt_megakernel_vjp_launch(
    const float* geom, int gcols, const float* mat, int num_spheres,
    int num_planes, int num_boxes, int num_triangles, const float* origin,
    const float* direction, const uint32_t* rng_in, const float* g_rad,
    float* d_geom, float* d_mat, float* d_origin, float* d_direction,
    int num_pixels, int spp, int num_bounces, int has_dielectric,
    void* stream) {
  return launch(geom, gcols, mat, num_spheres, num_planes, num_boxes,
                num_triangles, origin, direction, rng_in, g_rad, d_geom, d_mat,
                d_origin, d_direction, num_pixels, spp, num_bounces,
                has_dielectric, false, stream);
}

// One thread per (pixel, sample): rng_samples [num_pixels, spp, 4], the rng
// of every pixel at the start of every sample (the recording forward's, or
// rng_in when spp is 1); d_origin and d_direction are added to, so the
// caller zeroes them.
extern "C" int hpt_megakernel_vjp_samples_launch(
    const float* geom, int gcols, const float* mat, int num_spheres,
    int num_planes, int num_boxes, int num_triangles, const float* origin,
    const float* direction, const uint32_t* rng_samples, const float* g_rad,
    float* d_geom, float* d_mat, float* d_origin, float* d_direction,
    int num_pixels, int spp, int num_bounces, int has_dielectric,
    void* stream) {
  return launch(geom, gcols, mat, num_spheres, num_planes, num_boxes,
                num_triangles, origin, direction, rng_samples, g_rad, d_geom,
                d_mat, d_origin, d_direction, num_pixels, spp, num_bounces,
                has_dielectric, true, stream);
}

// Resource use of the instance a launch with these operands takes
// (kernel_resources in bounce.cuh): out[7], and its name.
extern "C" void hpt_megakernel_vjp_resources(int gcols, int num_primitives,
                                             int has_dielectric, int per_sample,
                                             int* out, const char** name) {
  size_t smem = 0;
  const int index = choose(gcols, num_primitives, has_dielectric, per_sample != 0, smem);
  *name = kInstances[index].name;
  kernel_resources(kInstances[index].fn, kThreads, smem, out);
}
