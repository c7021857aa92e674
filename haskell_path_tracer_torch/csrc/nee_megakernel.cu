// The physical/NEE megakernel and the primary-hit probe for Hopper (sm_90a).
//
// nee_kernel replaces haskell_path_tracer_tpu/ops/pallas_nee.py:_nee_kernel
// (launched there by _trace_nee_from_tables): `spp` samples of the
// physical/NEE estimator per pixel, summed, one thread per pixel.  Per live
// bounce: the winner's payload row, emission pickup, the BSDF sample (3
// draws), the light sample (3 draws, taken even with no emitter), one pass
// over the tables that answers both the BSDF ray's nearest hit and the
// shadow ray's occlusion, and the NEE contribution.  probe_kernel replaces
// _primary_kernel (launched by primary_probe and the presort): the camera
// rays' nearest (t0, prim0) over all four kinds, eps = 0, through the same
// device function as nee_kernel's primary fold, so feeding the probe's
// output back in (t0_in, prim0_in) gives nee_kernel's results bit for bit.
// The per-pixel code is in nee.cuh.
//
// What bounds it: fp32 work.  Per live bounce a thread runs the pair test
// of every sphere twice (nearest and shadow, one shared `center - point`
// vector): about 45 operations per sphere, against ~300 for the shading and
// the light sample, so at 1000 spheres the fold is >99% of the work.  The
// device-memory traffic is 40 B read and 28 B written per pixel per launch.
// The design follows:
//   * the loop state stays in registers for all samples and bounces;
//   * the primary fold runs once per thread, outside the sample loop: the
//     primary rays are deterministic and the fold draws nothing;
//   * the fold tables (spheres, planes, boxes, triangles; 16-byte rows) are
//     copied into shared memory once per block when they fit in 48 KB
//     (about 3000 spheres), before any thread can leave, so no barrier sits
//     inside the loops.  Larger tables are read from device memory through
//     the L1 cache: all lanes of a warp read the same row, one broadcast;
//   * the winner's payload and the chosen emitter's row are read by index
//     (no one-hot gather: that existed for the TPU's matrix unit);
//   * a path leaves the bounce loop at its first dead bounce (exact: a dead
//     lane stays dead), so a thread's work is its live bounces;
//   * `order` (optional) maps thread i to pixel order[i], the presort's
//     depth order, with the probe's (t0, prim0) read instead of folded;
//   * the recording instance (RECORD, the forward of the NEE gradient,
//     ops/nee_vjp.py) also writes one int32 residual word per (sample,
//     bounce) that the lane reaches (nee.cuh:residual_word: the winner,
//     and the occlusion, hit and live bits), the TPU kernel's two
//     grad_residuals planes packed into one.  Layout [spp * bounces, n] by
//     thread lane i, not by pixel: a warp writes 32 adjacent words, and the
//     backward, launched with the same lane order, reads them back
//     adjacent, so neither frame permutes them.  Radiance and rng are the
//     production instance's bit for bit; RECORD is a template parameter,
//     so the production instance's code is as it was.
//
// Floating point: built without --use_fast_math and with -fmad=false, so
// each a*b+c rounds twice, as PyTorch's separate ops do; sinf/cosf, sqrtf
// and `/` are the IEEE-accurate versions.
//
// Layout: origin, direction [n, 3] f32; rng [n, 4] u32 (the int32 tensors'
// bits); radiance [n, 3] f32; t0 [n] f32, prim0 [n] i32, order [n] i32,
// steps [n] i32; words [spp * bounces, n] i32; tables as
// ops/nee.py:nee_scene_tables packs them.

#include <cstdint>
#include <cuda_runtime.h>

#include "nee.cuh"

namespace {

using namespace hpt;

constexpr int kThreads = 128;
constexpr int kSmemTableBytes = 48 * 1024;

// Copies the fold tables into shared memory when they fit; returns the
// tables the block reads.  Called by every thread before any returns.
__device__ nee::Scene stage_tables(nee::Scene S, bool in_smem) {
  extern __shared__ float4 smem[];
  if (in_smem) {
    const float4* src = reinterpret_cast<const float4*>(S.fold);
    const int n4 = S.fold_floats() / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) smem[i] = src[i];
    __syncthreads();
    S.fold = reinterpret_cast<const float*>(smem);
  }
  return S;
}

template <bool HAS_GLOSSY, bool HAS_DIEL, bool RECORD>
__global__ void __launch_bounds__(kThreads)
nee_kernel(nee::Scene S, bool in_smem, const float* __restrict__ origin,
           const float* __restrict__ direction,
           const uint32_t* __restrict__ rng_in, const float* __restrict__ t0_in,
           const int* __restrict__ prim0_in, const int* __restrict__ order,
           float* __restrict__ radiance, uint32_t* __restrict__ rng_out,
           int* __restrict__ steps, int* __restrict__ words, int num_pixels,
           int spp, int num_bounces) {
  S = stage_tables(S, in_smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_pixels) return;
  const int q = order != nullptr ? order[i] : i;
  nee::nee_pixel<HAS_GLOSSY, HAS_DIEL, RECORD>(S, q, origin, direction, rng_in, t0_in,
                                               prim0_in, radiance, rng_out, steps, spp,
                                               num_bounces, RECORD ? words + i : nullptr,
                                               num_pixels);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(nee::Scene S, bool in_smem, const float* __restrict__ origin,
             const float* __restrict__ direction, float* __restrict__ t0,
             int* __restrict__ prim0, int num_rays) {
  S = stage_tables(S, in_smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const float o[3] = {origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]};
  const float d[3] = {direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]};
  float t;
  int prim;
  nee::primary_hit(S, o, d, t, prim);
  t0[i] = t;
  prim0[i] = prim;
}

size_t smem_bytes(const nee::Scene& S) {
  const size_t bytes = sizeof(float) * (size_t)S.fold_floats();
  return bytes <= (size_t)kSmemTableBytes ? bytes : 0;
}

template <bool G, bool D>
void launch_nee(const nee::Scene& S, const float* origin, const float* direction,
                const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
                const int* order, float* radiance, uint32_t* rng_out, int* steps,
                int* words, int num_pixels, int spp, int num_bounces,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  const int blocks = (num_pixels + kThreads - 1) / kThreads;
  auto kernel = words != nullptr ? nee_kernel<G, D, true> : nee_kernel<G, D, false>;
  kernel<<<blocks, kThreads, smem, stream>>>(
      S, smem > 0, origin, direction, rng_in, t0_in, prim0_in, order, radiance,
      rng_out, steps, words, num_pixels, spp, num_bounces);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).  t0_in,
// prim0_in, order and steps may be null; words null launches the
// production instance, else the recording one.
extern "C" int hpt_nee_launch(
    const float* fold, const float* payload, const float* lights,
    int num_spheres, int num_planes, int num_boxes, int num_triangles,
    int num_lights, const float* origin, const float* direction,
    const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
    const int* order, float* radiance, uint32_t* rng_out, int* steps,
    int* words, int num_pixels, int spp, int num_bounces, int has_glossy,
    int has_diel, void* stream) {
  const nee::Scene S{fold, payload, lights, num_spheres, num_planes,
                     num_boxes, num_triangles, num_lights};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pixels > 0) {
    if (has_glossy && has_diel)
      launch_nee<true, true>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                             radiance, rng_out, steps, words, num_pixels, spp, num_bounces, s);
    else if (has_glossy)
      launch_nee<true, false>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                              radiance, rng_out, steps, words, num_pixels, spp, num_bounces, s);
    else if (has_diel)
      launch_nee<false, true>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                              radiance, rng_out, steps, words, num_pixels, spp, num_bounces, s);
    else
      launch_nee<false, false>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                               radiance, rng_out, steps, words, num_pixels, spp, num_bounces, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hpt_probe_launch(const float* fold, int num_spheres,
                                int num_planes, int num_boxes,
                                int num_triangles, const float* origin,
                                const float* direction, float* t0, int* prim0,
                                int num_rays, void* stream) {
  const nee::Scene S{fold, nullptr, nullptr, num_spheres, num_planes,
                     num_boxes, num_triangles, 0};
  if (num_rays > 0) {
    const size_t smem = smem_bytes(S);
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    probe_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        S, smem > 0, origin, direction, t0, prim0, num_rays);
  }
  return static_cast<int>(cudaGetLastError());
}
