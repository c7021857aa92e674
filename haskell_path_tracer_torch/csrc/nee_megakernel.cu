// The physical/NEE megakernel and the primary-hit probe for Hopper (sm_90a).
//
// nee_kernel replaces haskell_path_tracer_tpu/ops/pallas_nee.py:_nee_kernel
// (launched there by _trace_nee_from_tables): `spp` samples of the
// physical/NEE estimator per pixel, summed, one thread per pixel;
// nee_persistent_kernel is the same work when the probe's primary hits are
// given, each thread taking pixels until they run out.  Per live
// bounce: the winner's payload row, emission pickup, the BSDF sample (3
// draws), the light sample (3 draws, taken even with no emitter), one pass
// over the tables that answers both the BSDF ray's nearest hit and the
// shadow ray's occlusion, and the NEE contribution.  probe_kernel replaces
// _primary_kernel (launched by primary_probe and the presort): the camera
// rays' nearest (t0, prim0) over all four kinds, eps = 0, with the
// decisions of nee_kernel's primary fold (nee::primary_hit) bit for bit, so
// feeding the probe's output back in (t0_in, prim0_in) gives nee_kernel's
// results bit for bit.  The per-pixel code is in nee.cuh, the probe's
// per-ray code in probe.cuh.
//
// What bounds the probe: fp32 work, ~19 operations per sphere per ray
// against 32 B of device memory traffic per ray.  Its design is the
// nearest-sphere fold's (sphere_fold.cu): the sphere rows stream through
// shared memory in index-ordered cp.async tiles (tiles.cuh), so a table of
// any size is read from shared memory, and a row that misses costs its
// discriminant alone (sphere_fold.cuh:fold_rows).  A row costs about 21
// issue slots (17 fp32 operations, a shared load, the compare and branch),
// so the issue rate, not the fp32 count, is the floor.
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
//   * one flat loop runs a thread's samples and bounces (nee.cuh:
//     lane_step, the TPU kernel's path regeneration): a path that ends (a
//     dead bounce, or its bounce budget used) banks its sample and restarts
//     the next from the primary hit, so every step of a lane in flight is
//     a live bounce, and a warp pays for its longest lane's live bounces
//     over all samples, not for each sample's longest path.  On suite
//     config 4 that takes the warp efficiency (lane-mean live bounces over
//     the warp's) from 0.49 to 0.75 presorted, 0.45 to 0.80 in raster order;
//   * `order` (optional) maps lane i to pixel order[i], the presort's
//     depth order, with the probe's (t0, prim0) read instead of folded.
//     With the probe's hits the persistent instance runs: as many threads
//     as fit on the SMs, each warp taking lane indices from a counter in
//     device memory, so a thread whose pixel is done takes the next one
//     and the warp's lanes stay busy until the lanes run out, not until
//     its longest lane is done (config 4 presorted 1.24x, config 7's
//     recording 1.42x faster than one thread per lane).  Without them
//     (raster order) a lane that took a pixel would fold its primary ray
//     alone, so the one-thread-per-lane instance stays;
//   * 256-thread blocks, at least 4 per SM: 64 registers and 32 warps per
//     SM, against 84 registers and 20 warps unbounded (PERF.md);
//   * the recording instance (RECORD, the forward of the NEE gradient,
//     ops/nee_vjp.py) also writes one int32 residual word per (sample,
//     bounce) that the lane reaches (nee.cuh:residual_word: the winner,
//     and the occlusion, hit and live bits), the TPU kernel's two
//     grad_residuals planes packed into one.  Layout [spp * bounces, n] by
//     thread lane i, not by pixel: the backward, launched with the same
//     lane order, reads them back by lane, so neither frame permutes them
//     (the lanes of a warp sit at different samples, so their stores land
//     on different rows).  Radiance and rng are the production instance's
//     bit for bit; RECORD is a template parameter, so the production
//     instance's code is as it was.
//
// Floating point: built without --use_fast_math and with -fmad=false, so
// each a*b+c rounds twice, as PyTorch's separate ops do; sinf/cosf, sqrtf
// and `/` are the IEEE-accurate versions.  An -fmad=true build was 5-9%
// faster but broke the lane contract (PERF.md): 0.7% of lanes diverged on
// 1000 spheres, the live-bounce telemetry and the probe's distances moved.
//
// Layout: origin, direction [n, 3] f32; rng [n, 4] u32 (the int32 tensors'
// bits); radiance [n, 3] f32; t0 [n] f32, prim0 [n] i32, order [n] i32,
// steps [n] i32; words [spp * bounces, n] i32; tables as
// ops/nee.py:nee_scene_tables packs them.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "nee.cuh"
#include "probe.cuh"
#include "tiles.cuh"

namespace {

using namespace hpt;

// The NEE kernels' blocks: 256 threads, at least 4 resident per SM, which
// caps them at 64 registers (about 100 B of spills) for 32 warps per SM.
// Measured on the H100 against 128 x 1-8 and 256 x 1-5 (PERF.md): the best
// at config 4 in both frames and at config 7's 1920x1088 / 8 / 4.  The
// probe takes #7's launch shape (sphere_fold.cu): 128-thread blocks, at
// least 4 per SM; but one ray per thread, which the H100 measured faster
// than #7's two (40 registers and 48 warps per SM against 47 and 40) and
// than four (PERF.md).
constexpr int kNeeThreads = 256;
constexpr int kNeeMinBlocks = 4;
constexpr int kProbeThreads = 128;
constexpr int kProbeMinBlocks = 4;
constexpr int kProbeRays = 1;
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
__global__ void __launch_bounds__(kNeeThreads, kNeeMinBlocks)
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

constexpr unsigned kFullWarp = 0xffffffffu;

// The persistent instance, with the probe's (t0, prim0): as many threads
// as the SMs hold, each warp taking lane indices from *next (zeroed by the
// caller), one atomic add per warp and round, until they run out.  A
// thread whose pixel has banked its last sample stores it and takes the
// next in the same step, so it idles only once the lanes run out; a sky
// pixel is stored at once.  Every thread of a warp stays in the loop until
// the whole warp has run out, so the warp meets, converged, at the vote
// before each live bounce.  Lane i still works on pixel order[i] and
// writes its words at words + i.
template <bool HAS_GLOSSY, bool HAS_DIEL, bool RECORD>
__global__ void __launch_bounds__(kNeeThreads, kNeeMinBlocks)
nee_persistent_kernel(nee::Scene S, bool in_smem, const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const uint32_t* __restrict__ rng_in, const float* __restrict__ t0_in,
                      const int* __restrict__ prim0_in, const int* __restrict__ order,
                      float* __restrict__ radiance, uint32_t* __restrict__ rng_out,
                      int* __restrict__ steps, int* __restrict__ words, int* next,
                      int num_pixels, int spp, int num_bounces) {
  S = stage_tables(S, in_smem);
  const int lane = threadIdx.x & 31;
  nee::Lane L;
  int i = -1;  // the lane index of the pixel this thread holds, -1 for none
  bool live = false, drained = false;
  for (;;) {
    if (i >= 0) live = nee::lane_next<RECORD>(L, spp, num_bounces,
                                              RECORD ? words + i : nullptr, num_pixels);
    unsigned need = __ballot_sync(kFullWarp, !live && !drained);
    while (need != 0) {
      if ((need >> lane) & 1u) {
        if (i >= 0) nee::pixel_store(L, order != nullptr ? order[i] : i, radiance, rng_out, steps);
      }
      int base = 0;
      if (lane == 0) base = atomicAdd(next, __popc(need));
      base = __shfl_sync(kFullWarp, base, 0);
      if ((need >> lane) & 1u) {
        i = base + __popc(need & ((1u << lane) - 1u));
        if (i >= num_pixels) {
          i = -1;
          drained = true;
        } else {
          live = nee::pixel_start<RECORD>(S, L, order != nullptr ? order[i] : i, origin,
                                          direction, rng_in, t0_in, prim0_in, spp, num_bounces,
                                          RECORD ? words + i : nullptr, num_pixels);
        }
      }
      need = __ballot_sync(kFullWarp, !live && !drained);
    }
    if (__all_sync(kFullWarp, drained)) return;
    if (live)
      nee::lane_bounce<HAS_GLOSSY, HAS_DIEL, RECORD>(S, L, num_bounces,
                                                     RECORD ? words + i : nullptr, num_pixels);
  }
}

// The probe, R = kProbeRays rays per thread: slot r of thread x in block b
// takes ray (b R + r) kProbeThreads + x, R coalesced loads per operand.
// The sphere rows stream through shared memory in tiles (tiles.cuh), every
// row read once for the thread's R rays (probe.cuh); then each ray folds
// the planes, boxes and triangles from the L1 cache.  Slots past num_rays
// fold the block's first ray and store nothing, so every thread reaches
// every barrier.
template <int R>
__global__ void __launch_bounds__(kProbeThreads, kProbeMinBlocks)
probe_kernel(nee::Scene S, const float* __restrict__ origin,
             const float* __restrict__ direction, float* __restrict__ t0,
             int* __restrict__ prim0, int num_rays) {
  extern __shared__ float4 smem[];
  const int first = blockIdx.x * (R * kProbeThreads);
  sphere_fold::Lanes<R, false> L;
  int lane[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = first + r * kProbeThreads + threadIdx.x;
    lane[r] = k < num_rays ? k : -1;
    L.load(r, k < num_rays ? k : first, origin, direction, nullptr, nullptr, nullptr);
  }
  const float4* spheres = reinterpret_cast<const float4*>(S.fold);
  const int num_tiles = (S.ns + tiles::kTileRows - 1) / tiles::kTileRows;
  if (num_tiles > 0) tiles::issue_tile<kProbeThreads>(spheres, S.ns, 0, smem);
  for (int k = 0; k < num_tiles; ++k) {
    if (k + 1 < num_tiles) {
      tiles::issue_tile<kProbeThreads>(spheres, S.ns, k + 1, smem);
      tiles::wait_async<1>();
    } else {
      tiles::wait_async<0>();
    }
    __syncthreads();
    const int base = k * tiles::kTileRows;
    sphere_fold::fold_rows<R, false>(
        reinterpret_cast<const float*>(smem + (k & 1) * tiles::kTileRows), base,
        min(tiles::kTileRows, S.ns - base), 0.0f, L);
    __syncthreads();  // tile k's buffer is refilled at step k + 1
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane[r];
    if (i < 0) continue;
    probe::fold_tails(S, L.o[r], L.d[r], L.t[r], L.prim[r]);
    t0[i] = L.t[r];
    prim0[i] = L.prim[r];
  }
}

const KernelInstance kProbe = {
    kProbeRays == 1 ? "probe_kernel<1>" : kProbeRays == 2 ? "probe_kernel<2>" : "probe_kernel<4>",
    reinterpret_cast<const void*>(probe_kernel<kProbeRays>)};

size_t smem_bytes(int fold_floats) {
  const size_t bytes = sizeof(float) * (size_t)fold_floats;
  return bytes <= (size_t)kSmemTableBytes ? bytes : 0;
}

// Every NEE kernel instance, by index persistent * 8 + glossy * 4 +
// dielectric * 2 + record.
template <bool G, bool D, bool R>
KernelInstance instance(const char* name) {
  return {name, reinterpret_cast<const void*>(nee_kernel<G, D, R>)};
}
template <bool G, bool D, bool R>
KernelInstance persistent_instance(const char* name) {
  return {name, reinterpret_cast<const void*>(nee_persistent_kernel<G, D, R>)};
}
const KernelInstance kInstances[] = {
    instance<false, false, false>("nee_kernel<matte>"),
    instance<false, false, true>("nee_kernel<matte, record>"),
    instance<false, true, false>("nee_kernel<dielectric>"),
    instance<false, true, true>("nee_kernel<dielectric, record>"),
    instance<true, false, false>("nee_kernel<glossy>"),
    instance<true, false, true>("nee_kernel<glossy, record>"),
    instance<true, true, false>("nee_kernel<glossy+dielectric>"),
    instance<true, true, true>("nee_kernel<glossy+dielectric, record>"),
    persistent_instance<false, false, false>("nee_persistent_kernel<matte>"),
    persistent_instance<false, false, true>("nee_persistent_kernel<matte, record>"),
    persistent_instance<false, true, false>("nee_persistent_kernel<dielectric>"),
    persistent_instance<false, true, true>("nee_persistent_kernel<dielectric, record>"),
    persistent_instance<true, false, false>("nee_persistent_kernel<glossy>"),
    persistent_instance<true, false, true>("nee_persistent_kernel<glossy, record>"),
    persistent_instance<true, true, false>("nee_persistent_kernel<glossy+dielectric>"),
    persistent_instance<true, true, true>("nee_persistent_kernel<glossy+dielectric, record>"),
};

template <bool G, bool D>
void launch_nee(const nee::Scene& S, const float* origin, const float* direction,
                const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
                const int* order, float* radiance, uint32_t* rng_out, int* steps,
                int* words, int* next, int num_pixels, int spp, int num_bounces,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(S.fold_floats());
  int blocks = (num_pixels + kNeeThreads - 1) / kNeeThreads;
  if (next != nullptr) {
    auto kernel = words != nullptr ? nee_persistent_kernel<G, D, true>
                                   : nee_persistent_kernel<G, D, false>;
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kNeeThreads, smem);
    blocks = std::min(blocks, std::max(1, sms * per_sm));
    kernel<<<blocks, kNeeThreads, smem, stream>>>(
        S, smem > 0, origin, direction, rng_in, t0_in, prim0_in, order, radiance,
        rng_out, steps, words, next, num_pixels, spp, num_bounces);
    return;
  }
  auto kernel = words != nullptr ? nee_kernel<G, D, true> : nee_kernel<G, D, false>;
  kernel<<<blocks, kNeeThreads, smem, stream>>>(
      S, smem > 0, origin, direction, rng_in, t0_in, prim0_in, order, radiance,
      rng_out, steps, words, num_pixels, spp, num_bounces);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).  t0_in,
// prim0_in, order and steps may be null; words null launches the
// production instance, else the recording one; next_lane, a zeroed int in
// device memory, launches the persistent instance (ops/nee.py passes one
// with the probe's primary hits), null one thread per lane.
extern "C" int hpt_nee_launch(
    const float* fold, const float* payload, const float* lights,
    int num_spheres, int num_planes, int num_boxes, int num_triangles,
    int num_lights, const float* origin, const float* direction,
    const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
    const int* order, float* radiance, uint32_t* rng_out, int* steps,
    int* words, int* next_lane, int num_pixels, int spp, int num_bounces,
    int has_glossy, int has_diel, void* stream) {
  const nee::Scene S{fold, payload, lights, num_spheres, num_planes,
                     num_boxes, num_triangles, num_lights};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pixels > 0) {
    if (has_glossy && has_diel)
      launch_nee<true, true>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                             radiance, rng_out, steps, words, next_lane, num_pixels, spp,
                             num_bounces, s);
    else if (has_glossy)
      launch_nee<true, false>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                              radiance, rng_out, steps, words, next_lane, num_pixels, spp,
                              num_bounces, s);
    else if (has_diel)
      launch_nee<false, true>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                              radiance, rng_out, steps, words, next_lane, num_pixels, spp,
                              num_bounces, s);
    else
      launch_nee<false, false>(S, origin, direction, rng_in, t0_in, prim0_in, order,
                               radiance, rng_out, steps, words, next_lane, num_pixels, spp,
                               num_bounces, s);
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
    constexpr int per_block = kProbeRays * kProbeThreads;
    probe_kernel<kProbeRays><<<(num_rays + per_block - 1) / per_block, kProbeThreads,
                               tiles::table_smem(num_spheres),
                               static_cast<cudaStream_t>(stream)>>>(S, origin, direction, t0,
                                                                    prim0, num_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the card gives the instance that a launch on `fold_floats` floats of
// fold tables, num_spheres of them spheres, takes
// (bounce.cuh:kernel_resources): out[7], and its name; probe != 0 asks for
// the probe, else the NEE kernel's instance by kinds, record and
// persistent (the instance launches with the probe's primary hits take).
// Returns cudaGetLastError() (0 = answered), which also clears the error
// for the next launch's check.
extern "C" int hpt_nee_resources(int fold_floats, int num_spheres, int has_glossy,
                                 int has_diel, int record, int persistent, int probe, int* out,
                                 const char** name) {
  const KernelInstance& k =
      probe ? kProbe
            : kInstances[(persistent ? 8 : 0) + (has_glossy ? 4 : 0) + (has_diel ? 2 : 0) +
                         (record ? 1 : 0)];
  *name = k.name;
  kernel_resources(k.fn, probe ? kProbeThreads : kNeeThreads,
                   probe ? tiles::table_smem(num_spheres) : smem_bytes(fold_floats), out);
  return static_cast<int>(cudaGetLastError());
}
