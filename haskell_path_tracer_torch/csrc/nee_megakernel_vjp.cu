// The backward of the physical/NEE megakernel for Hopper (sm_90a): the
// cotangents of the NEE tables and of the primary rays, given the cotangent
// of the radiance sum, one thread per pixel.
//
// Replaces haskell_path_tracer_tpu/ops/pallas_nee_vjp.py:_nee_bwd_kernel
// (launched there by _nee_bwd_call).  Semantics are that kernel's with its
// folds replayed (fold_residuals=False): for each sample, replay the bounce
// loop through the forward kernel's own device functions
// (nee.cuh:live_bounce, so every decision is the forward's bit for bit),
// keeping each live bounce's ray, throughput, winner, shadow decision and
// six uniforms, then sweep the bounces in reverse with every decision
// detached (nee_vjp.cuh:bounce_vjp, written by hand where the TPU kernel
// took jax.vjp).  Left out, as TPU scaffolding: the one-hot [16, P] x [P, R]
// gather on the matrix unit (rows are read by index), the [8, R] blocking,
// the scalar tables in SMEM, the residual-plane cap and the accumulation of
// the table cotangents across grid programs that run in sequence.
//
// What bounds it: fp32 work.  A live bounce costs the forward bounce again
// in the replay (the dual fold over every primitive: ~31 operations per
// sphere), then the adjoint: the winner's distance, normal, BSDF and light
// sample again and their reverse (some 400 operations, against the fold's
// 31 000 at 1000 spheres).  The device
// memory traffic is 52 B read (rays, rng, radiance cotangent) and 24 B
// written (ray cotangents) per pixel, 12 B more read with a probe's
// (t0, prim0) and the lane order, plus the table cotangents' atomic adds.
// The design follows:
//   * a grid of at most as many blocks as are resident at once (128
//     threads, at least 6 per SM), each thread striding over pixels; the
//     thread at lane i works on pixel order[i] when a lane order (the
//     sorted gradient frame) is given, with the probe's (t0, prim0) read
//     instead of folded;
//   * per live bounce the replay keeps a Residual (18 words) in a
//     thread-local array of kMaxBounces, in local memory that the L1 cache
//     holds; the reverse sweep reads it back without a fold;
//   * per bounce only three table rows receive cotangents: the winner's
//     fold row, its payload row and the sampled emitter's light row.  When
//     the three cotangent tables fit in kSmemAccBytes = 16 KB of shared
//     memory (fold + payload + lights: 4 (4 S + 12 S + 16 L) bytes for a
//     scene of S spheres, about 250 spheres), each block sums them there
//     with shared atomics and adds the nonzero entries to the output once,
//     with one global atomicAdd each; larger tables (config 7's 1000
//     spheres, the 20000-sphere case) take one global atomicAdd per
//     nonzero row entry per bounce.  The float sums' order changes from run
//     to run, so the table cotangents are not bitwise reproducible;
//   * the fold tables are staged in shared memory when they fit in 48 KB,
//     as in the forward kernel, else read through the L1 cache.
//
// Floating point: built with -fmad=false and without fast math, like the
// forward kernel, so the replay's decisions are the forward's.
//
// Layout: origin, direction [n, 3] f32; rng [n, 4] u32 (the int32 tensors'
// bits); g_rad [n, 3] f32; t0 [n] f32, prim0 [n] i32, order [n] i32;
// d_origin, d_direction [n, 3] f32; tables and their cotangents as
// ops/nee.py:nee_scene_tables packs them, the cotangents zeroed by the
// caller.

#include <cstdint>
#include <cuda_runtime.h>

#include "nee_vjp.cuh"

namespace {

using namespace hpt;

// 128 threads and at least 6 resident blocks per SM (80 registers): the
// fastest of six shapes measured on an H100 at suite config 7 (PERF.md).
// The cotangent tiles get shared memory only within kSmemAccBytes: at
// config 7's 1000 spheres (a 16 KB fold table, tiles in device memory) 6
// blocks stay resident, and larger tiles cost more in occupancy than their
// shared atomics save.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;
constexpr int kMaxBounces = 16;
constexpr int kSmemTableBytes = 48 * 1024;
constexpr int kSmemAccBytes = 16 * 1024;

// Adds one bounce's row cotangents into the cotangent tables (in shared or
// device memory), skipping zeros.
struct AtomicAcc {
  float* d_fold;
  float* d_payload;
  float* d_lights;

  __host__ __device__ __forceinline__ void add(float* dst, const float* v, int n) {
#if defined(__CUDA_ARCH__)
    for (int i = 0; i < n; ++i)
      if (v[i] != 0.0f) atomicAdd(dst + i, v[i]);
#endif
  }

  // Host and device, as pixel_backward is; it only ever runs on the device.
  __host__ __device__ __forceinline__ void operator()(const nee::Scene&,
                                                      const nee::RowGrads& rg) {
    add(d_fold + rg.fold_at, rg.fold, rg.fold_cols);
    add(d_payload + 12 * rg.prim, rg.payload, 11);
    if (rg.light_row >= 0) add(d_lights + 16 * rg.light_row + 2, rg.light + 2, 13);
  }
};

template <bool HAS_GLOSSY, bool HAS_DIEL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
nee_vjp_kernel(nee::Scene S, bool fold_in_smem, bool acc_in_smem,
               const float* __restrict__ origin,
               const float* __restrict__ direction,
               const uint32_t* __restrict__ rng_in,
               const float* __restrict__ t0_in, const int* __restrict__ prim0_in,
               const int* __restrict__ order, const float* __restrict__ g_rad,
               float* __restrict__ d_fold, float* __restrict__ d_payload,
               float* __restrict__ d_lights, float* __restrict__ d_origin,
               float* __restrict__ d_direction, int num_pixels, int spp,
               int num_bounces) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nf = S.fold_floats();
  const int npay = 12 * (S.ns + S.np + S.nb + S.nt);
  const int nlight = 16 * (S.nl > 0 ? S.nl : 1);
  float* next = smem;
  if (fold_in_smem) {
    const float4* src = reinterpret_cast<const float4*>(S.fold);
    for (int i = threadIdx.x; i < nf / 4; i += blockDim.x) smem4[i] = src[i];
    S.fold = next;
    next += nf;
  }
  AtomicAcc acc{d_fold, d_payload, d_lights};
  if (acc_in_smem) {
    acc = AtomicAcc{next, next + nf, next + nf + npay};
    for (int i = threadIdx.x; i < nf + npay + nlight; i += blockDim.x) next[i] = 0.0f;
  }
  __syncthreads();

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < num_pixels;
       i += gridDim.x * blockDim.x) {
    const int q = order != nullptr ? order[i] : i;
    const float po[3] = {origin[3 * q], origin[3 * q + 1], origin[3 * q + 2]};
    const float pd[3] = {direction[3 * q], direction[3 * q + 1], direction[3 * q + 2]};
    const float gr[3] = {g_rad[3 * q], g_rad[3 * q + 1], g_rad[3 * q + 2]};
    float t0;
    int prim0;
    if (t0_in != nullptr) {
      t0 = t0_in[q];
      prim0 = prim0_in[q];
    } else {
      nee::primary_hit(S, po, pd, t0, prim0);
    }
    const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    nee::Residual st[kMaxBounces];
    float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
    nee::pixel_backward<HAS_GLOSSY, HAS_DIEL>(S, po, pd, t0, prim0, rng, gr, spp,
                                              num_bounces, st, g_o, g_d, acc);
    for (int k = 0; k < 3; ++k) {
      d_origin[3 * q + k] = g_o[k];
      d_direction[3 * q + k] = g_d[k];
    }
  }

  if (acc_in_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < nf; i += blockDim.x)
      if (acc.d_fold[i] != 0.0f) atomicAdd(&d_fold[i], acc.d_fold[i]);
    for (int i = threadIdx.x; i < npay; i += blockDim.x)
      if (acc.d_payload[i] != 0.0f) atomicAdd(&d_payload[i], acc.d_payload[i]);
    for (int i = threadIdx.x; i < nlight; i += blockDim.x)
      if (acc.d_lights[i] != 0.0f) atomicAdd(&d_lights[i], acc.d_lights[i]);
  }
}

template <bool G, bool D>
int launch(const nee::Scene& S, const float* origin, const float* direction,
           const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
           const int* order, const float* g_rad, float* d_fold, float* d_payload,
           float* d_lights, float* d_origin, float* d_direction, int num_pixels,
           int spp, int num_bounces, cudaStream_t stream) {
  const size_t fold_bytes = sizeof(float) * (size_t)S.fold_floats();
  const size_t acc_bytes =
      sizeof(float) * ((size_t)S.fold_floats() + 12 * (size_t)(S.ns + S.np + S.nb + S.nt) +
                       16 * (size_t)(S.nl > 0 ? S.nl : 1));
  const bool fold_in_smem = fold_bytes <= (size_t)kSmemTableBytes;
  const bool acc_in_smem = acc_bytes <= (size_t)kSmemAccBytes;
  const size_t smem = (fold_in_smem ? fold_bytes : 0) + (acc_in_smem ? acc_bytes : 0);
  auto kernel = nee_vjp_kernel<G, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int needed = (num_pixels + kThreads - 1) / kThreads;
  const int blocks = needed < sms * per_sm ? needed : sms * per_sm;
  kernel<<<blocks, kThreads, smem, stream>>>(
      S, fold_in_smem, acc_in_smem, origin, direction, rng_in, t0_in, prim0_in,
      order, g_rad, d_fold, d_payload, d_lights, d_origin, d_direction,
      num_pixels, spp, num_bounces);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns the CUDA error (0 = launched), or
// cudaErrorInvalidValue when num_bounces exceeds the replay's kMaxBounces or
// the scene has boxes.  t0_in, prim0_in and order may be null.
extern "C" int hpt_nee_vjp_launch(
    const float* fold, const float* payload, const float* lights,
    int num_spheres, int num_planes, int num_boxes, int num_triangles,
    int num_lights, const float* origin, const float* direction,
    const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
    const int* order, const float* g_rad, float* d_fold, float* d_payload,
    float* d_lights, float* d_origin, float* d_direction, int num_pixels,
    int spp, int num_bounces, int has_glossy, int has_diel, void* stream) {
  if (num_bounces > kMaxBounces || num_boxes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_pixels <= 0) return static_cast<int>(cudaGetLastError());
  const nee::Scene S{fold, payload, lights, num_spheres, num_planes,
                     num_boxes, num_triangles, num_lights};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_glossy && has_diel)
    return launch<true, true>(S, origin, direction, rng_in, t0_in, prim0_in, order, g_rad,
                              d_fold, d_payload, d_lights, d_origin, d_direction,
                              num_pixels, spp, num_bounces, s);
  if (has_glossy)
    return launch<true, false>(S, origin, direction, rng_in, t0_in, prim0_in, order, g_rad,
                               d_fold, d_payload, d_lights, d_origin, d_direction,
                               num_pixels, spp, num_bounces, s);
  if (has_diel)
    return launch<false, true>(S, origin, direction, rng_in, t0_in, prim0_in, order, g_rad,
                               d_fold, d_payload, d_lights, d_origin, d_direction,
                               num_pixels, spp, num_bounces, s);
  return launch<false, false>(S, origin, direction, rng_in, t0_in, prim0_in, order, g_rad,
                              d_fold, d_payload, d_lights, d_origin, d_direction,
                              num_pixels, spp, num_bounces, s);
}
