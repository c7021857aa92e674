// The backward of the inline parity megakernel for Hopper (sm_90a): the
// cotangents of the scene tables and of the primary rays, given the
// cotangent of the radiance sum, one thread per pixel.
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
// bounce (the fold over every primitive, 6 sin/cos, 1-2 sqrt) in the
// replay, then again the winner's distance and BRDF and about twice their
// operations in the adjoint (6 more sin/cos for the glossy rotation): some
// 2-3x the forward kernel's work per live segment.  The only device-memory
// traffic is 52 B read (origin, direction, rng, radiance cotangent) and
// 24 B written (ray cotangents) per pixel, plus one atomic add per nonzero
// table entry per block.  The design follows:
//   * one thread per pixel, tables in shared memory up to the card's
//     opt-in limit and in device memory beyond it, as in the forward
//     kernel;
//   * per live bounce the replay keeps the ray, throughput, random vector
//     and winner (13 words, `Residual`) in a thread-local array bounded by
//     kMaxBounces; the array lives in local memory, which the L1 cache
//     holds, and the reverse sweep reads it back without a fold.  A
//     [bounces, 13, H*W] buffer in device memory would cost 52 B per pixel
//     per bounce each way for nothing;
//   * the sweep starts at the last live bounce: a dead bounce passes its
//     ray through and zeroes the throughput, so every cotangent after the
//     first dead bounce is zero;
//   * per bounce only the winner's row receives a cotangent.  Where the
//     tables and a cotangent tile of the same size both fit the block's
//     shared memory (about 1800 primitives with 8 geometry columns), each
//     block sums its rows in a shared tile [P, gcols + 8] with shared
//     atomics, and adds the tile's nonzero entries to the output with one
//     global atomicAdd each; beyond that every nonzero row entry is one
//     global atomicAdd, as in the NEE backward.  The order of these float
//     sums changes from run to run, so the table cotangents are not
//     bitwise reproducible (the tolerance that covers it is in
//     ops/megakernel_vjp.py);
//   * any H x W: ceil(H*W / 128) blocks, the ragged tail masked.
//
// Floating point: like the forward kernel, built with -fmad=false and
// without fast math, so the replay's decisions are the forward's.
//
// Layout: origin, direction [H, W, 3] f32; rng [H, W, 4] u32 (the int32
// tensors' bits); g_rad [H, W, 3] f32; d_origin, d_direction [H, W, 3] f32;
// geom / d_geom [P, gcols], mat / d_mat [P, 8] f32, d_geom and d_mat zeroed
// by the caller.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

using namespace hpt;

constexpr int kThreads = 128;
constexpr int kMaxBounces = 16;

// Adds one bounce's row cotangents into the block's shared tile, or into
// the output tables in device memory.
struct SharedAcc {
  float* dgeom;  // [P, gcols]
  float* dmat;   // [P, 8]
  int gcols;

  // Host and device, as pixel_backward is; it only ever runs on the device.
  __host__ __device__ __forceinline__ void operator()(int row, const float* dg,
                                                      const float* dm) {
#if defined(__CUDA_ARCH__)
    const int ncols = gcols < 12 ? gcols : 12;
    for (int i = 0; i < ncols; ++i)
      if (dg[i] != 0.0f) atomicAdd(&dgeom[row * gcols + i], dg[i]);
    for (int i = 0; i < 5; ++i)
      if (dm[i] != 0.0f) atomicAdd(&dmat[row * 8 + i], dm[i]);
#endif
  }
};

// TABLES_IN_SMEM: the tables in shared memory; ACC_IN_SMEM (which implies
// it): the cotangent tile too.  Template parameters, so that the compiler
// knows which memory the loads and atomics address.
template <bool HAS_DIELECTRIC, bool TABLES_IN_SMEM, bool ACC_IN_SMEM>
__global__ void __launch_bounds__(kThreads)
megakernel_vjp(const float* __restrict__ geom_g, int gcols,
               const float* __restrict__ mat_g, int ns, int np, int nb,
               int nt, const float* __restrict__ origin,
               const float* __restrict__ direction,
               const uint32_t* __restrict__ rng_in,
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

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < num_pixels) {
    const float po[3] = {origin[3 * pix], origin[3 * pix + 1],
                         origin[3 * pix + 2]};
    const float pd[3] = {direction[3 * pix], direction[3 * pix + 1],
                         direction[3 * pix + 2]};
    const float gr[3] = {g_rad[3 * pix], g_rad[3 * pix + 1],
                         g_rad[3 * pix + 2]};
    const Rng rng{rng_in[4 * pix], rng_in[4 * pix + 1], rng_in[4 * pix + 2],
                  rng_in[4 * pix + 3]};
    Residual st[kMaxBounces];
    float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
    SharedAcc acc{acc_geom, acc_mat, gcols};
    pixel_backward<HAS_DIELECTRIC>(T, po, pd, rng, gr, spp, num_bounces, st,
                                   g_o, g_d, acc);
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

template <bool D>
cudaError_t launch(const float* geom, int gcols, const float* mat, int ns,
                   int np, int nb, int nt, const float* origin,
                   const float* direction, const uint32_t* rng_in,
                   const float* g_rad, float* d_geom, float* d_mat,
                   float* d_origin, float* d_direction, int num_pixels,
                   int spp, int num_bounces, cudaStream_t stream) {
  const int P = ns + np + nb + nt;
  const size_t bytes = sizeof(float) * (size_t)P * (gcols + 8);
  const size_t optin = smem_optin_bytes();
  const bool tables_in_smem = bytes <= optin;
  const bool acc_in_smem = 2 * bytes <= optin;
  const size_t smem = acc_in_smem ? 2 * bytes : (tables_in_smem ? bytes : 0);
  const auto kernel = acc_in_smem      ? megakernel_vjp<D, true, true>
                      : tables_in_smem ? megakernel_vjp<D, true, false>
                                       : megakernel_vjp<D, false, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (num_pixels + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      geom, gcols, mat, ns, np, nb, nt, origin, direction, rng_in, g_rad,
      d_geom, d_mat, d_origin, d_direction, num_pixels, spp, num_bounces);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns the launch's error (0 = launched), or
// cudaErrorInvalidValue when num_bounces exceeds the replay's kMaxBounces.
extern "C" int hpt_megakernel_vjp_launch(
    const float* geom, int gcols, const float* mat, int num_spheres,
    int num_planes, int num_boxes, int num_triangles, const float* origin,
    const float* direction, const uint32_t* rng_in, const float* g_rad,
    float* d_geom, float* d_mat, float* d_origin, float* d_direction,
    int num_pixels, int spp, int num_bounces, int has_dielectric,
    void* stream) {
  if (num_bounces > kMaxBounces) return static_cast<int>(cudaErrorInvalidValue);
  if (num_pixels <= 0) return static_cast<int>(cudaGetLastError());
  auto go = [&](auto fn) {
    return static_cast<int>(fn(geom, gcols, mat, num_spheres, num_planes,
                               num_boxes, num_triangles, origin, direction,
                               rng_in, g_rad, d_geom, d_mat, d_origin,
                               d_direction, num_pixels, spp, num_bounces,
                               static_cast<cudaStream_t>(stream)));
  };
  return has_dielectric ? go(launch<true>) : go(launch<false>);
}
