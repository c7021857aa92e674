// The backward of the physical/NEE megakernel for Hopper (sm_90a): the
// cotangents of the NEE tables and of the primary rays, given the cotangent
// of the radiance sum, one thread per pixel.
//
// Replaces haskell_path_tracer_tpu/ops/pallas_nee_vjp.py:_nee_bwd_kernel
// (launched there by _nee_bwd_call), in both of that kernel's modes: for
// each sample, replay the bounce loop, keeping each live bounce's ray,
// throughput, winner, shadow decision and six uniforms, then sweep the
// bounces in reverse with every decision detached (nee_vjp.cuh:bounce_vjp,
// written by hand where the TPU kernel took jax.vjp).  Left out, as TPU
// scaffolding: the one-hot [16, P] x [P, R] gather on the matrix unit (rows
// are read by index), the [8, R] blocking, the scalar tables in SMEM, the
// residual-plane cap (a byte budget in ops/nee_vjp.py instead) and the
// accumulation of the table cotangents across grid programs that run in
// sequence.
//
// Residual mode (nee_vjp_resid_kernel, the TPU's fold_residuals=True): the
// recording forward (nee_megakernel.cu, RECORD) wrote each (sample,
// bounce)'s winner and shadow decision, so the replay runs no fold, the
// primary one included (nee_vjp.cuh:replay_bounce).  What bounds it then:
// the adjoint, some 400 fp32 operations per live bounce with the replay's
// hit point, normal and BSDF sample, and the row cotangents' atomic adds,
// 4 + 11 + 13 per live bounce onto the winner's fold, payload and sampled
// light rows (at suite config 7 onto 1000 sphere rows and only 10 light
// rows).  Its design:
//   * no table is staged: a bounce reads one fold row, one payload row and
//     one light row by index, through the L1 cache;
//   * the shared memory holds the cotangent tiles instead.  The light tile
//     (L x 16 floats) always: its rows are few and every lit bounce adds to
//     one, each lane with its own shared atomics (ops/nee_vjp.py takes this
//     mode only when the tile fits in the shared memory any block may
//     take).  The fold and payload tiles (64 B per sphere) when the caller
//     allows them (TILES_IN_SMEM; ops/nee_vjp.py's budget) and all three
//     tiles fit in the card's opt-in shared memory per block: shared atomics
//     per bounce, then one global atomicAdd per nonzero entry per block,
//     2.4x faster than global atomics per bounce at config 7;
//   * blocks of kResidThreads = 256 threads, at least 3 resident per SM
//     (80 registers a thread);
//   * the words are read as written, [spp * bounces, n] by lane, so a warp
//     reads 32 adjacent words.
//
// Replay mode (nee_vjp_kernel, fold_residuals=False, the fallback above the
// byte budget): the replay runs the forward kernel's own device functions
// (nee.cuh:live_bounce, so every decision is the forward's bit for bit),
// folds included.  What bounds it: fp32 work.  A live bounce costs the
// forward bounce again (the dual fold over every primitive: ~31 operations
// per sphere), then the adjoint (some 400 operations, against the fold's
// 31 000 at 1000 spheres).  Its design:
//   * per live bounce only three table rows receive cotangents.  When the
//     three cotangent tables fit in kSmemAccBytes = 16 KB of shared memory
//     (about 250 spheres), each block sums them there with shared atomics
//     and adds the nonzero entries to the output once; larger tables take
//     one global atomicAdd per nonzero row entry per bounce;
//   * the fold tables are staged in shared memory when they fit in 48 KB,
//     as in the forward kernel, else read through the L1 cache.
//
// Both: a grid of at most as many blocks as are resident at once (the
// replay mode 128 threads, at least 6 per SM), each thread striding over
// pixels; the thread
// at lane i works on pixel order[i] when a lane order (the sorted gradient
// frame) is given, the replay mode then reading the probe's (t0, prim0)
// instead of folding; per live bounce a Residual (18 words) in a
// thread-local array of kMaxBounces, in local memory that the L1 cache
// holds, which the reverse sweep reads back.  Device memory traffic: 52 B
// read (rays, rng, radiance cotangent) and 24 B written (ray cotangents) per
// pixel, 12 B more read with a lane order and the probe's (t0, prim0), 4 B
// per residual word, plus the table cotangents' atomic adds.  The float
// sums' order changes from run to run, so the table cotangents are not
// bitwise reproducible.
//
// Floating point: built with -fmad=false and without fast math, like the
// forward kernel, so the replay's decisions are the forward's.
//
// Layout: origin, direction [n, 3] f32; rng [n, 4] u32 (the int32 tensors'
// bits); g_rad [n, 3] f32; t0 [n] f32, prim0 [n] i32, order [n] i32; words
// [spp * bounces, n] i32; d_origin, d_direction [n, 3] f32; tables and their
// cotangents as ops/nee.py:nee_scene_tables packs them, the cotangents
// zeroed by the caller.

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

// Adds a block's nonzero tile entries to the output, one global atomicAdd
// each.  Called by every thread of the block after a barrier.
__device__ __forceinline__ void flush(const float* tile, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (tile[i] != 0.0f) atomicAdd(out + i, tile[i]);
}

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
    nee::pixel_backward<HAS_GLOSSY, HAS_DIEL, false>(S, po, pd, t0, prim0, nullptr, 0, rng, gr,
                                                     spp, num_bounces, st, g_o, g_d, acc);
    for (int k = 0; k < 3; ++k) {
      d_origin[3 * q + k] = g_o[k];
      d_direction[3 * q + k] = g_d[k];
    }
  }

  if (acc_in_smem) {
    __syncthreads();
    flush(acc.d_fold, d_fold, nf);
    flush(acc.d_payload, d_payload, npay);
    flush(acc.d_lights, d_lights, nlight);
  }
}

// The residual mode's accumulator: the fold and payload cotangents by
// shared atomics into the block's tiles (TILES_IN_SMEM) or by global ones
// into the outputs, the light cotangents by shared atomics into the block's
// light tile.
struct ResidAcc {
  float* d_fold;
  float* d_payload;
  float* light_tile;

  __host__ __device__ __forceinline__ void operator()(const nee::Scene&,
                                                      const nee::RowGrads& rg) {
#if defined(__CUDA_ARCH__)
    for (int i = 0; i < rg.fold_cols; ++i)
      if (rg.fold[i] != 0.0f) atomicAdd(d_fold + rg.fold_at + i, rg.fold[i]);
    for (int i = 0; i < 11; ++i)
      if (rg.payload[i] != 0.0f) atomicAdd(d_payload + 12 * rg.prim + i, rg.payload[i]);
    if (rg.light_row >= 0)
      for (int i = 2; i < 15; ++i)
        if (rg.light[i] != 0.0f) atomicAdd(light_tile + 16 * rg.light_row + i, rg.light[i]);
#endif
  }
};

// The residual mode's block shape: 256 threads and at least 3 resident
// blocks per SM (80 registers a thread).  On an H100 at suite config 7,
// 4-9% faster than 128 threads and 6 blocks (PERF.md).
constexpr int kResidThreads = 256;
constexpr int kResidMinBlocks = 3;

template <bool HAS_GLOSSY, bool HAS_DIEL, bool TILES_IN_SMEM>
__global__ void __launch_bounds__(kResidThreads, kResidMinBlocks)
nee_vjp_resid_kernel(nee::Scene S, const int* __restrict__ words,
                     const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const uint32_t* __restrict__ rng_in,
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
  const int ntile = nlight + (TILES_IN_SMEM ? nf + npay : 0);
  for (int i = threadIdx.x; i < ntile; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  ResidAcc acc{TILES_IN_SMEM ? smem + nlight : d_fold,
                          TILES_IN_SMEM ? smem + nlight + nf : d_payload, smem};

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < num_pixels;
       i += gridDim.x * blockDim.x) {
    const int q = order != nullptr ? order[i] : i;
    const float po[3] = {origin[3 * q], origin[3 * q + 1], origin[3 * q + 2]};
    const float pd[3] = {direction[3 * q], direction[3 * q + 1], direction[3 * q + 2]};
    const float gr[3] = {g_rad[3 * q], g_rad[3 * q + 1], g_rad[3 * q + 2]};
    const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    nee::Residual st[kMaxBounces];
    float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
    nee::pixel_backward<HAS_GLOSSY, HAS_DIEL, true>(S, po, pd, 0.0f, 0, words + i, num_pixels,
                                                    rng, gr, spp, num_bounces, st, g_o, g_d,
                                                    acc);
    for (int k = 0; k < 3; ++k) {
      d_origin[3 * q + k] = g_o[k];
      d_direction[3 * q + k] = g_d[k];
    }
  }

  __syncthreads();
  flush(smem, d_lights, nlight);
  if (TILES_IN_SMEM) {
    flush(smem + nlight, d_fold, nf);
    flush(smem + nlight + nf, d_payload, npay);
  }
}

// The blocks of `kernel` resident at once with `threads` threads and
// `smem` bytes each, capped at those the pixels need; 0 on an error,
// returned in err.
template <class Kernel>
int grid_blocks(Kernel kernel, int threads, size_t smem, int num_pixels, cudaError_t& err) {
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return 0;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return 0;
  if (per_sm < 1) {
    err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const int needed = (num_pixels + threads - 1) / threads;
  return needed < sms * per_sm ? needed : sms * per_sm;
}

// The operands of one backward launch.
struct Operands {
  nee::Scene S;
  const float *origin, *direction;
  const uint32_t* rng_in;
  const float* t0_in;
  const int *prim0_in, *order;
  const float* g_rad;
  const int* words;
  float *d_fold, *d_payload, *d_lights, *d_origin, *d_direction;
  int num_pixels, spp, num_bounces;
};

template <bool G, bool D, bool TILES>
int launch_resid(const Operands& a, size_t smem, cudaStream_t stream) {
  auto kernel = nee_vjp_resid_kernel<G, D, TILES>;
  cudaError_t err;
  const int blocks = grid_blocks(kernel, kResidThreads, smem, a.num_pixels, err);
  if (blocks == 0) return (int)err;
  kernel<<<blocks, kResidThreads, smem, stream>>>(
      a.S, a.words, a.origin, a.direction, a.rng_in, a.order, a.g_rad, a.d_fold, a.d_payload,
      a.d_lights, a.d_origin, a.d_direction, a.num_pixels, a.spp, a.num_bounces);
  return (int)cudaGetLastError();
}

template <bool G, bool D>
int launch(const Operands& a, bool tiles_in_smem, cudaStream_t stream) {
  const nee::Scene& S = a.S;
  const size_t fold_bytes = sizeof(float) * (size_t)S.fold_floats();
  const size_t pay_bytes = sizeof(float) * 12 * (size_t)(S.ns + S.np + S.nb + S.nt);
  const size_t light_bytes = sizeof(float) * 16 * (size_t)(S.nl > 0 ? S.nl : 1);
  if (a.words != nullptr) {
    const size_t tiled = light_bytes + fold_bytes + pay_bytes;
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (tiles_in_smem && tiled <= (size_t)optin) return launch_resid<G, D, true>(a, tiled, stream);
    return launch_resid<G, D, false>(a, light_bytes, stream);
  }
  const bool fold_in_smem = fold_bytes <= (size_t)kSmemTableBytes;
  const bool acc_in_smem = fold_bytes + pay_bytes + light_bytes <= (size_t)kSmemAccBytes;
  const size_t smem = (fold_in_smem ? fold_bytes : 0) +
                      (acc_in_smem ? fold_bytes + pay_bytes + light_bytes : 0);
  auto kernel = nee_vjp_kernel<G, D>;
  cudaError_t err;
  const int blocks = grid_blocks(kernel, kThreads, smem, a.num_pixels, err);
  if (blocks == 0) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      S, fold_in_smem, acc_in_smem, a.origin, a.direction, a.rng_in, a.t0_in, a.prim0_in,
      a.order, a.g_rad, a.d_fold, a.d_payload, a.d_lights, a.d_origin, a.d_direction,
      a.num_pixels, a.spp, a.num_bounces);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns the CUDA error (0 = launched), or
// cudaErrorInvalidValue when num_bounces exceeds the replay's kMaxBounces or
// the scene has boxes.  words null launches the replay mode (t0_in,
// prim0_in and order may be null), else the residual mode on the recording
// forward's words (order as that forward took it; t0_in and prim0_in are
// not read), with the fold and payload cotangent tiles in shared memory
// when tiles_in_smem and the three tiles fit in the card's opt-in shared
// memory per block.
extern "C" int hpt_nee_vjp_launch(
    const float* fold, const float* payload, const float* lights,
    int num_spheres, int num_planes, int num_boxes, int num_triangles,
    int num_lights, const float* origin, const float* direction,
    const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
    const int* order, const float* g_rad, const int* words, int tiles_in_smem,
    float* d_fold, float* d_payload, float* d_lights, float* d_origin, float* d_direction, int num_pixels, int spp,
    int num_bounces, int has_glossy, int has_diel, void* stream) {
  if (num_bounces > kMaxBounces || num_boxes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_pixels <= 0) return static_cast<int>(cudaGetLastError());
  const Operands a{{fold, payload, lights, num_spheres, num_planes, num_boxes, num_triangles,
                    num_lights},
                   origin, direction, rng_in, t0_in, prim0_in, order, g_rad, words,
                   d_fold, d_payload, d_lights, d_origin, d_direction,
                   num_pixels, spp, num_bounces};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tiles = tiles_in_smem != 0;
  if (has_glossy && has_diel) return launch<true, true>(a, tiles, s);
  if (has_glossy) return launch<true, false>(a, tiles, s);
  if (has_diel) return launch<false, true>(a, tiles, s);
  return launch<false, false>(a, tiles, s);
}
