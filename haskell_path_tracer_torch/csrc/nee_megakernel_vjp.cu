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
//     (80 registers a thread), each thread striding over the pixels;
//   * the words are read as written, [spp * bounces, n] by lane, so a warp
//     reads 32 adjacent words.
//
// Replay mode (nee_vjp_replay_kernel, fold_residuals=False: above the
// byte budget or above 768 emitters): no word comes from the forward, so
// the backward runs the forward's folds again.  What bounds it: the folds,
// ~31 fp32 operations per sphere per live bounce (the recording forward
// #3r's work), against ~400 for the adjoint.  Its design: record, then
// reverse, one chunk of samples at a time (nee_vjp.cuh:
// pixel_backward_chunked):
//   * for each chunk, the lane runs the forward kernel's own flat loop
//     (nee.cuh:lane_step with RECORD, path regeneration: a warp pays its
//     longest lane's live bounces over the chunk, not each sample's longest
//     path) and writes the chunk's residual words, the recording forward's
//     bit for bit, into a thread-local array of kReplayChunkWords words
//     (local memory, laid out by the compiler so that a warp's lanes touch
//     adjacent words); then it reverses the chunk from those words with the
//     residual mode's fold-free pixel_backward; the next chunk starts from
//     the rng the flat loop left.  So the fold half is #3r's loop and the
//     reverse half #5r's, and the ray cotangents are the residual mode's
//     bit for bit.  chunk = kReplayChunkWords / num_bounces samples (at
//     most spp);
//   * the lanes of a warp leave the flat loop at different steps, and
//     nothing else makes them meet again: without a __syncwarp between the
//     halves each lane ran its reverse on its own, 6.6x slower at suite
//     config 7 on an H100 (PERF.md).  So the pixel loop is warp-uniform
//     and the warp meets after each half (WarpSync);
//   * each half is a function of its own (nee_vjp.cuh: HPT_CALL), so the
//     fold keeps its registers while the pixel's other state waits;
//   * each warp takes 32 lanes at a time from a counter in device memory
//     until they run out, so warps that drew short paths take more pixels;
//   * the fold and payload cotangents are summed in shared-memory tiles
//     where the residual mode would (the caller allows them and all three
//     tiles fit), unless the tiles cost a resident block per SM; then by
//     global atomics.  The light tile sits in shared memory when it fits
//     in 48 KB (768 emitters), else the light rows take global atomics
//     too.  The fold table is staged in shared memory when it fits in 48 KB
//     and beside the tiles.
//
// Both: a grid of at most as many blocks as are resident at once; the
// thread at lane i works on pixel order[i] when a lane order (the sorted
// gradient frame) is given, the replay mode then reading the probe's (t0,
// prim0) instead of folding; per live bounce a Residual (18 words) in a
// thread-local array of kMaxBounces, in local memory, which the reverse
// sweep reads back.  Device memory traffic: 52 B read (rays, rng, radiance
// cotangent) and 24 B written (ray cotangents) per pixel, 12 B more read
// with a lane order and the probe's (t0, prim0), 4 B per residual word in
// the residual mode, plus the table cotangents' atomic adds.  The float
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

constexpr int kMaxBounces = 16;
constexpr int kSmemTableBytes = 48 * 1024;
// The largest light tile a block keeps in shared memory: the 48 KB any
// block may take without opting in for more, 768 emitters.
constexpr int kLightTileBytes = 48 * 1024;

// Adds a block's nonzero tile entries to the output, one global atomicAdd
// each.  Called by every thread of the block after a barrier.
__device__ __forceinline__ void flush(const float* tile, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (tile[i] != 0.0f) atomicAdd(out + i, tile[i]);
}

// Which of the cotangent tiles a block keeps in shared memory: none, the
// light tile, or all three (light, fold, payload).
enum Tiles { kNoTiles = 0, kLightTile = 1, kAllTiles = 2 };

// The accumulator of both modes: one bounce's nonzero row cotangents added
// by atomics into the block's tiles, addressed through the kernel's
// dynamic shared array at float offsets, or into the outputs in device
// memory.  TILES is a template parameter and the tiles are not passed as
// pointers, so that the compiler emits shared atomics, inside the replay
// mode's non-inlined reverse too, and not generic ones that test the
// address space at run time.
template <Tiles TILES>
struct TileAcc {
  float* d_fold;
  float* d_payload;
  float* d_lights;
  int light_at, fold_at, payload_at;  // tile offsets in the shared array

  // Host and device, as pixel_backward is; it only ever runs on the device.
  __host__ __device__ __forceinline__ void operator()(const nee::Scene&,
                                                      const nee::RowGrads& rg) const {
#if defined(__CUDA_ARCH__)
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* fold = TILES == kAllTiles ? smem + fold_at : d_fold;
    float* payload = TILES == kAllTiles ? smem + payload_at : d_payload;
    float* lights = TILES != kNoTiles ? smem + light_at : d_lights;
    for (int i = 0; i < rg.fold_cols; ++i)
      if (rg.fold[i] != 0.0f) atomicAdd(fold + rg.fold_at + i, rg.fold[i]);
    for (int i = 0; i < 11; ++i)
      if (rg.payload[i] != 0.0f) atomicAdd(payload + 12 * rg.prim + i, rg.payload[i]);
    if (rg.light_row >= 0)
      for (int i = 2; i < 15; ++i)
        if (rg.light[i] != 0.0f) atomicAdd(lights + 16 * rg.light_row + i, rg.light[i]);
#endif
  }
};

// The replay mode's block shape and chunk: kReplayThreads threads, at
// least kReplayMinBlocks resident per SM (80 registers; 256 x 4 was within
// 5% either way), and kReplayChunkWords residual words per thread (2 KB of
// local memory), a chunk of kReplayChunkWords / num_bounces samples.
// Measured on an H100 (PERF.md): at 512x512 / 64 spp / 8 bounces one chunk
// (512 words) ran 1.28-1.36x faster than two (256), and at 32 spp two
// chunks (256 words) 1.5-1.6x faster than eight (64); at suite config 7's
// shapes, one chunk each, the size changed nothing.
constexpr int kReplayThreads = 256;
constexpr int kReplayMinBlocks = 3;
constexpr int kReplayChunkWords = 512;
static_assert(kReplayChunkWords >= kMaxBounces, "a chunk holds at least one sample");

// Where the replay mode's block keeps its tables: the fold table staged in
// shared memory or not, `tiles` of the cotangent tiles there; `smem` bytes
// of it in all.
struct ReplayPlan {
  bool fold_in_smem;
  Tiles tiles;
  size_t smem;
};

// The first of the next 32 lanes, taken from *next by lane 0 of the warp
// for all of it.
__device__ __forceinline__ int take_lanes(int* next, int lane) {
  return __shfl_sync(0xffffffffu, lane == 0 ? atomicAdd(next, 32) : 0, 0);
}

// Makes the lanes of a warp meet (pixel_backward_chunked's sync).  The
// replay kernel's loops are warp-uniform, so every lane of the warp reaches
// each call.
struct WarpSync {
  __host__ __device__ __forceinline__ void operator()() const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
};

template <bool HAS_GLOSSY, bool HAS_DIEL, Tiles TILES>
__global__ void __launch_bounds__(kReplayThreads, kReplayMinBlocks)
nee_vjp_replay_kernel(nee::Scene S, bool fold_in_smem,
                      const float* __restrict__ origin, const float* __restrict__ direction,
                      const uint32_t* __restrict__ rng_in, const float* __restrict__ t0_in,
                      const int* __restrict__ prim0_in, const int* __restrict__ order,
                      const float* __restrict__ g_rad, float* __restrict__ d_fold,
                      float* __restrict__ d_payload, float* __restrict__ d_lights,
                      float* __restrict__ d_origin, float* __restrict__ d_direction,
                      int* next, int num_pixels, int spp, int num_bounces, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nf = S.fold_floats();
  const int npay = 12 * (S.ns + S.np + S.nb + S.nt);
  const int nlight = 16 * (S.nl > 0 ? S.nl : 1);
  // The shared array: [fold table][light tile][fold tile][payload tile],
  // each part only when the plan keeps it there.
  const int light_at = fold_in_smem ? nf : 0;
  if (fold_in_smem) {
    const float4* src = reinterpret_cast<const float4*>(S.fold);
    for (int i = threadIdx.x; i < nf / 4; i += blockDim.x) smem4[i] = src[i];
    S.fold = smem;
  }
  const int ntile = (TILES != kNoTiles ? nlight : 0) + (TILES == kAllTiles ? nf + npay : 0);
  for (int i = threadIdx.x; i < ntile; i += blockDim.x) smem[light_at + i] = 0.0f;
  const TileAcc<TILES> acc{d_fold, d_payload, d_lights, light_at, light_at + nlight,
                             light_at + nlight + nf};
  __syncthreads();

  // Each warp takes 32 lanes at a time from the counter *next (zeroed by
  // the caller) until they run out.  Warp-uniform: every lane of a warp
  // runs every iteration, a lane past the last pixel as a pixel with
  // nothing to trace, so that each pixel_backward_chunked's syncs meet the
  // whole warp.
  int rec[kReplayChunkWords];
  const int lane = threadIdx.x & 31;
  for (int base = take_lanes(next, lane); base < num_pixels; base = take_lanes(next, lane)) {
    const int i = base + lane;
    const bool has = i < num_pixels;
    const int q = has ? (order != nullptr ? order[i] : i) : 0;
    const float po[3] = {origin[3 * q], origin[3 * q + 1], origin[3 * q + 2]};
    const float pd[3] = {direction[3 * q], direction[3 * q + 1], direction[3 * q + 2]};
    const float gr[3] = {g_rad[3 * q], g_rad[3 * q + 1], g_rad[3 * q + 2]};
    float t0 = kInfinite;
    int prim0 = 0;
    if (!has) {
    } else if (t0_in != nullptr) {
      t0 = t0_in[q];
      prim0 = prim0_in[q];
    } else {
      nee::primary_hit(S, po, pd, t0, prim0);
    }
    const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    nee::Residual st[kMaxBounces];
    float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
    nee::pixel_backward_chunked<HAS_GLOSSY, HAS_DIEL>(S, po, pd, t0, prim0, rng, gr, spp,
                                                      num_bounces, chunk, rec, 1, st, g_o, g_d,
                                                      acc, WarpSync{});
    if (has)
      for (int k = 0; k < 3; ++k) {
        d_origin[3 * q + k] = g_o[k];
        d_direction[3 * q + k] = g_d[k];
      }
  }

  __syncthreads();
  if (TILES != kNoTiles) flush(smem + acc.light_at, d_lights, nlight);
  if (TILES == kAllTiles) {
    flush(smem + acc.fold_at, d_fold, nf);
    flush(smem + acc.payload_at, d_payload, npay);
  }
}

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
  // The shared array: [light tile][fold tile][payload tile].
  const TileAcc<TILES_IN_SMEM ? kAllTiles : kLightTile> acc{d_fold, d_payload, d_lights, 0,
                                                            nlight, nlight + nf};

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
  int* next_lane;
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

// The card's opt-in shared memory per block, in bytes; 0 on an error,
// returned in err.
size_t optin_smem(cudaError_t& err) {
  int device = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (size_t)optin : 0;
}

// The three cotangent tiles of a scene, in bytes: fold, payload, light.
void tile_bytes(const nee::Scene& S, size_t& fold, size_t& pay, size_t& light) {
  fold = sizeof(float) * (size_t)S.fold_floats();
  pay = sizeof(float) * 12 * (size_t)(S.ns + S.np + S.nb + S.nt);
  light = sizeof(float) * 16 * (size_t)(S.nl > 0 ? S.nl : 1);
}

// The residual mode's shared memory: the light tile, and the fold and
// payload tiles when `tiles` (the caller allows them and all three fit in
// the opt-in shared memory, returned in tiles).
size_t resid_smem(const nee::Scene& S, bool& tiles, size_t optin) {
  size_t fold, pay, light;
  tile_bytes(S, fold, pay, light);
  tiles = tiles && light + fold + pay <= optin;
  return tiles ? light + fold + pay : light;
}

// The replay kernel's resident blocks per SM with `smem` bytes each; 0 on
// an error, returned in err.  Raises the kernel's dynamic shared-memory
// limit to `smem` where it is lower, and never lowers it.
template <class Kernel>
int resident_blocks(Kernel kernel, size_t smem, cudaError_t& err) {
  cudaFuncAttributes attr{};
  int per_sm = 0;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > (size_t)attr.maxDynamicSharedSizeBytes)
    err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kReplayThreads, smem);
  return err == cudaSuccess ? per_sm : 0;
}

// The replay mode's placement (ReplayPlan).  The light tile in shared
// memory within kLightTileBytes; the fold table staged within
// kSmemTableBytes when it fits beside the tiles.  The fold and payload
// tiles as the residual mode places them (the caller allows them and all
// three fit in the opt-in shared memory), unless they cost the kernel a
// resident block per SM: on an H100 at suite config 7, 1000 spheres, where
// the tiles leave 2 blocks against 3, the global atomics ran 6% faster; at
// 250 spheres, where both leave 3, the tiles ran 2.6x faster (PERF.md).
ReplayPlan replay_place(const nee::Scene& S, Tiles tiles, size_t optin) {
  size_t fold, pay, light;
  tile_bytes(S, fold, pay, light);
  ReplayPlan p;
  p.tiles = tiles;
  const size_t t = (tiles != kNoTiles ? light : 0) + (tiles == kAllTiles ? fold + pay : 0);
  p.fold_in_smem = fold <= (size_t)kSmemTableBytes && fold + t <= optin;
  p.smem = t + (p.fold_in_smem ? fold : 0);
  return p;
}

template <bool G, bool D>
ReplayPlan replay_plan(const nee::Scene& S, bool tiles_in_smem, size_t optin, cudaError_t& err) {
  size_t fold, pay, light;
  tile_bytes(S, fold, pay, light);
  err = cudaSuccess;
  const ReplayPlan apart =
      replay_place(S, light <= (size_t)kLightTileBytes ? kLightTile : kNoTiles, optin);
  if (!tiles_in_smem || light + fold + pay > optin) return apart;
  const ReplayPlan all = replay_place(S, kAllTiles, optin);
  const int with = resident_blocks(nee_vjp_replay_kernel<G, D, kAllTiles>, all.smem, err);
  if (err != cudaSuccess) return all;
  const int without = apart.tiles == kLightTile
                          ? resident_blocks(nee_vjp_replay_kernel<G, D, kLightTile>, apart.smem, err)
                          : resident_blocks(nee_vjp_replay_kernel<G, D, kNoTiles>, apart.smem, err);
  return with >= without ? all : apart;
}

// A replay-mode chunk: kReplayChunkWords / num_bounces samples, at most spp.
int replay_chunk(int spp, int num_bounces) {
  const int chunk = num_bounces > 0 ? kReplayChunkWords / num_bounces : spp;
  return chunk < spp ? chunk : (spp > 0 ? spp : 1);
}

template <bool G, bool D, Tiles TILES>
int launch_replay(const Operands& a, const ReplayPlan& p, cudaStream_t stream) {
  auto kernel = nee_vjp_replay_kernel<G, D, TILES>;
  cudaError_t err;
  const int blocks = grid_blocks(kernel, kReplayThreads, p.smem, a.num_pixels, err);
  if (blocks == 0) return (int)err;
  kernel<<<blocks, kReplayThreads, p.smem, stream>>>(
      a.S, p.fold_in_smem, a.origin, a.direction, a.rng_in, a.t0_in, a.prim0_in, a.order,
      a.g_rad, a.d_fold, a.d_payload, a.d_lights, a.d_origin, a.d_direction, a.next_lane,
      a.num_pixels, a.spp, a.num_bounces, replay_chunk(a.spp, a.num_bounces));
  return (int)cudaGetLastError();
}

template <bool G, bool D>
int launch(const Operands& a, bool tiles_in_smem, cudaStream_t stream) {
  cudaError_t err;
  const size_t optin = optin_smem(err);
  if (err != cudaSuccess) return (int)err;
  if (a.words != nullptr) {
    bool tiles = tiles_in_smem;
    const size_t smem = resid_smem(a.S, tiles, optin);
    return tiles ? launch_resid<G, D, true>(a, smem, stream)
                 : launch_resid<G, D, false>(a, smem, stream);
  }
  if (a.next_lane == nullptr) return (int)cudaErrorInvalidValue;
  const ReplayPlan p = replay_plan<G, D>(a.S, tiles_in_smem, optin, err);
  if (err != cudaSuccess) return (int)err;
  if (p.tiles == kAllTiles) return launch_replay<G, D, kAllTiles>(a, p, stream);
  if (p.tiles == kLightTile) return launch_replay<G, D, kLightTile>(a, p, stream);
  return launch_replay<G, D, kNoTiles>(a, p, stream);
}

// Every backward instance: the residual mode's by glossy * 4 + dielectric
// * 2 + tiles, the replay mode's by (glossy * 2 + dielectric) * 3 + tiles.
template <bool G, bool D, bool T>
KernelInstance resid_instance(const char* name) {
  return {name, reinterpret_cast<const void*>(nee_vjp_resid_kernel<G, D, T>)};
}
template <bool G, bool D, Tiles T>
KernelInstance replay_instance(const char* name) {
  return {name, reinterpret_cast<const void*>(nee_vjp_replay_kernel<G, D, T>)};
}
const KernelInstance kResidInstances[] = {
    resid_instance<false, false, false>("nee_vjp_resid_kernel<matte>"),
    resid_instance<false, false, true>("nee_vjp_resid_kernel<matte, tiles>"),
    resid_instance<false, true, false>("nee_vjp_resid_kernel<dielectric>"),
    resid_instance<false, true, true>("nee_vjp_resid_kernel<dielectric, tiles>"),
    resid_instance<true, false, false>("nee_vjp_resid_kernel<glossy>"),
    resid_instance<true, false, true>("nee_vjp_resid_kernel<glossy, tiles>"),
    resid_instance<true, true, false>("nee_vjp_resid_kernel<glossy+dielectric>"),
    resid_instance<true, true, true>("nee_vjp_resid_kernel<glossy+dielectric, tiles>"),
};
const KernelInstance kReplayInstances[] = {
    replay_instance<false, false, kNoTiles>("nee_vjp_replay_kernel<matte>"),
    replay_instance<false, false, kLightTile>("nee_vjp_replay_kernel<matte, light tile>"),
    replay_instance<false, false, kAllTiles>("nee_vjp_replay_kernel<matte, tiles>"),
    replay_instance<false, true, kNoTiles>("nee_vjp_replay_kernel<dielectric>"),
    replay_instance<false, true, kLightTile>("nee_vjp_replay_kernel<dielectric, light tile>"),
    replay_instance<false, true, kAllTiles>("nee_vjp_replay_kernel<dielectric, tiles>"),
    replay_instance<true, false, kNoTiles>("nee_vjp_replay_kernel<glossy>"),
    replay_instance<true, false, kLightTile>("nee_vjp_replay_kernel<glossy, light tile>"),
    replay_instance<true, false, kAllTiles>("nee_vjp_replay_kernel<glossy, tiles>"),
    replay_instance<true, true, kNoTiles>("nee_vjp_replay_kernel<glossy+dielectric>"),
    replay_instance<true, true, kLightTile>("nee_vjp_replay_kernel<glossy+dielectric, light tile>"),
    replay_instance<true, true, kAllTiles>("nee_vjp_replay_kernel<glossy+dielectric, tiles>"),
};

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns the CUDA error (0 = launched), or
// cudaErrorInvalidValue when num_bounces exceeds the replay's kMaxBounces or
// the scene has boxes.  words null launches the replay mode (t0_in,
// prim0_in and order may be null), else the residual mode on the recording
// forward's words (order as that forward took it; t0_in and prim0_in are
// not read).  Either mode keeps the fold and payload cotangent tiles in
// shared memory when tiles_in_smem and the three tiles fit in the card's
// opt-in shared memory per block (the replay mode: unless they cost it a
// resident block).  The replay mode takes its lanes from next_lane, a
// zeroed int in device memory (cudaErrorInvalidValue when null); the
// residual mode does not read it.
extern "C" int hpt_nee_vjp_launch(
    const float* fold, const float* payload, const float* lights,
    int num_spheres, int num_planes, int num_boxes, int num_triangles,
    int num_lights, const float* origin, const float* direction,
    const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
    const int* order, const float* g_rad, const int* words, int tiles_in_smem,
    float* d_fold, float* d_payload, float* d_lights, float* d_origin, float* d_direction,
    int* next_lane, int num_pixels, int spp, int num_bounces, int has_glossy, int has_diel,
    void* stream) {
  if (num_bounces > kMaxBounces || num_boxes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_pixels <= 0) return static_cast<int>(cudaGetLastError());
  const Operands a{{fold, payload, lights, num_spheres, num_planes, num_boxes, num_triangles,
                    num_lights},
                   origin, direction, rng_in, t0_in, prim0_in, order, g_rad, words,
                   d_fold, d_payload, d_lights, d_origin, d_direction, next_lane,
                   num_pixels, spp, num_bounces};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tiles = tiles_in_smem != 0;
  if (has_glossy && has_diel) return launch<true, true>(a, tiles, s);
  if (has_glossy) return launch<true, false>(a, tiles, s);
  if (has_diel) return launch<false, true>(a, tiles, s);
  return launch<false, false>(a, tiles, s);
}

// What the card gives the backward instance that a launch on these tables
// takes (bounce.cuh:kernel_resources): out[7], and its name; residual != 0
// asks for the residual mode's instance, else the replay mode's, by kinds
// and tiles_in_smem as hpt_nee_vjp_launch takes them.  Returns the CUDA
// error (0 = answered), which also clears the error for the next launch's
// check.
extern "C" int hpt_nee_vjp_resources(int num_spheres, int num_planes, int num_boxes,
                                     int num_triangles, int num_lights, int has_glossy,
                                     int has_diel, int residual, int tiles_in_smem, int* out,
                                     const char** name) {
  const nee::Scene S{nullptr, nullptr, nullptr, num_spheres, num_planes,
                     num_boxes, num_triangles, num_lights};
  cudaError_t err;
  const size_t optin = optin_smem(err);
  if (err != cudaSuccess) return (int)err;
  bool tiles = tiles_in_smem != 0;
  KernelInstance k;
  size_t smem;
  if (residual) {
    smem = resid_smem(S, tiles, optin);
    k = kResidInstances[(has_glossy ? 4 : 0) + (has_diel ? 2 : 0) + (tiles ? 1 : 0)];
  } else {
    const ReplayPlan p =
        has_glossy && has_diel ? replay_plan<true, true>(S, tiles, optin, err)
        : has_glossy           ? replay_plan<true, false>(S, tiles, optin, err)
        : has_diel             ? replay_plan<false, true>(S, tiles, optin, err)
                               : replay_plan<false, false>(S, tiles, optin, err);
    if (err != cudaSuccess) return (int)err;
    smem = p.smem;
    k = kReplayInstances[((has_glossy ? 2 : 0) + (has_diel ? 1 : 0)) * 3 + p.tiles];
  }
  *name = k.name;
  kernel_resources(k.fn, residual ? kResidThreads : kReplayThreads, smem, out);
  return static_cast<int>(cudaGetLastError());
}
