// Sphere-table folds for Hopper (sm_90a): the nearest sphere, and the dual
// query of one bounce.
//
// The nearest fold replaces
// haskell_path_tracer_tpu/ops/pallas_intersect.py:_sphere_fold_kernel
// (launched there by sphere_nearest_pallas): each ray's nearest sphere
// along d from o over the table [P, 4] = (center, r^2), accepting tca >=
// eps, h >= 0 and t >= eps (h = r^2 - (|l|^2 - tca^2), t = tca -
// sqrt(max(h, 1e-12))), strict `<` so the lowest index wins ties; (INFINITE,
// 0) on a miss.  `d2 > r2` and `h < 0` are the same test, sign-exact in f32.
//
// The dual fold replaces
// haskell_path_tracer_tpu/ops/pallas_intersect.py:_dual_fold_kernel
// (launched there by sphere_dual_query): one pass over the sphere table
// answering both queries from the shade point o:
//   * the nearest sphere along d_bsdf, offset-origin acceptance in o's frame
//     (tca >= eps, h >= 0, t >= eps), strict `<` so the lowest index wins
//     ties; (INFINITE, 0) on a miss;
//   * whether any sphere but light_idx blocks [EPSILON, t_light) along
//     d_shadow, by the sqrt-free test sharing the `center - o` vector.
// A lane with alive = 0 returns (INFINITE, 0, 0).
// Each ray's arithmetic is nee.cuh's (`sphere_root`, `sphere_blocks`), so
// the decisions are the NEE megakernel's fold's; sphere_fold.cuh holds the
// per-ray work.
//
// What bounds them: fp32 work, ~19 (nearest) and ~31 (dual) operations per
// sphere per ray, against 32 B (6 words in, 2 out) and 60 B (9 + 3 words
// in, 3 out) of device memory traffic per ray.  Built with -fmad=false, so
// no mul/add pair fuses: the fp32 pipe's issue rate, half the 67 TFLOP/s
// that counts an FMA as two, is the floor, and every other instruction
// (compares, selects, branches, loads) takes an issue slot from it.  What
// the design does about it (each step measured on an H100, PERF.md):
//   * a row that misses costs its discriminants alone: the square root,
//     the compares and the shadow test's tail sit in one rare branch
//     (sphere_fold.cuh:fold_rows), where either ray's line meets the sphere;
//   * a thread of the nearest fold takes R = 2 rays when every SM still
//     gets kMinBlocks blocks (else 1), so one shared-memory row load serves
//     both; the dual fold, whose two rays' registers cost occupancy, takes 1;
//   * the table streams through shared memory in index-ordered tiles of
//     kTileRows rows, double-buffered with cp.async (32 KB per block above
//     one tile), so a table of any size is read from shared memory; index
//     order keeps the lowest-index tie rule;
//   * the dual fold first compacts its live lanes on the device (a warp
//     ballot and one atomicAdd per warp, no host synchronisation): the dead
//     lanes' (INFINITE, 0, 0) are written there, and the fold runs over the
//     list of live ones, its blocks past the device-side count exiting at
//     once, so no dead lane idles beside live ones.
//
// Floating point: built with -fmad=false and without fast math.
//
// Layout: spheres [P, 4] f32 (16-byte aligned); ray_o, ray_d, d_bsdf,
// d_shadow [n, 3] f32; t_light [n] f32; light_idx, alive [n] i32; t [n]
// f32, prim, occ [n] i32; live [n + 1] i32 scratch (count, then indices).

#include <cstdint>
#include <cuda_runtime.h>

#include "sphere_fold.cuh"
#include "tiles.cuh"

namespace {

using namespace hpt;

using tiles::issue_tile;
using tiles::kTileRows;
using tiles::wait_async;

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;
constexpr int kCompactThreads = 256;

struct FoldArgs {
  const float4* spheres;
  int num_spheres;
  const float* ray_o;
  const float* ray_d;  // d_bsdf for the dual fold
  const float* d_shadow;
  const float* t_light;
  const int* light_idx;
  float eps;
  float* t;
  int* prim;
  int* occ;
  const int* live;  // the dual fold's live-lane count, then their indices
  int num_rays;
};

// Slot r of thread x in block b folds ray b R kThreads + r kThreads + x of
// the rays (the dual fold's live list): R coalesced loads per operand.
// Slots past the end fold the block's first ray and store nothing.
template <int R, bool DUAL>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fold_kernel(const FoldArgs a) {
  extern __shared__ float4 smem[];
  const int rays = DUAL ? a.live[0] : a.num_rays;
  const int first = blockIdx.x * (R * kThreads);
  if (first >= rays) return;  // the whole block: past the live lanes
  sphere_fold::Lanes<R, DUAL> L;
  int lane[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = first + r * kThreads + threadIdx.x;
    lane[r] = k < rays ? (DUAL ? a.live[1 + k] : k) : -1;
    const int i = lane[r] >= 0 ? lane[r] : (DUAL ? a.live[1 + first] : first);
    L.load(r, i, a.ray_o, a.ray_d, a.d_shadow, a.t_light, a.light_idx);
  }
  const int tiles = (a.num_spheres + kTileRows - 1) / kTileRows;
  if (tiles > 0) issue_tile<kThreads>(a.spheres, a.num_spheres, 0, smem);
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      issue_tile<kThreads>(a.spheres, a.num_spheres, k + 1, smem);
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    __syncthreads();
    const int base = k * kTileRows;
    sphere_fold::fold_rows<R, DUAL>(reinterpret_cast<const float*>(smem + (k & 1) * kTileRows),
                                     base, min(kTileRows, a.num_spheres - base), a.eps, L);
    __syncthreads();  // tile k's buffer is refilled at step k + 1
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane[r];
    if (i < 0) continue;
    a.t[i] = L.t[r];
    a.prim[i] = L.prim[r];
    if (DUAL) a.occ[i] = L.occ[r] ? 1 : 0;
  }
}

// The dual fold's dead lanes get (INFINITE, 0, 0); the live ones are
// appended to live[1..], lane order kept within each warp, and counted in
// live[0] (zeroed before the launch).
__global__ void __launch_bounds__(kCompactThreads)
compact_live_kernel(const int* __restrict__ alive, int num_rays, float* __restrict__ t,
                    int* __restrict__ prim, int* __restrict__ occ, int* __restrict__ live) {
  const int i = blockIdx.x * kCompactThreads + threadIdx.x;
  const bool in = i < num_rays;
  const bool is_live = in && alive[i] != 0;
  if (in && !is_live) {
    t[i] = kInfinite;
    prim[i] = 0;
    occ[i] = 0;
  }
  const unsigned mask = __ballot_sync(0xffffffffu, is_live);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(live, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (is_live) live[1 + base + __popc(mask & ((1u << lane) - 1u))] = i;
}

// The nearest fold's instances by rays per thread (1, 2), and the dual's.
const KernelInstance kNearest[2] = {
    {"fold_kernel<1,false>", reinterpret_cast<const void*>(fold_kernel<1, false>)},
    {"fold_kernel<2,false>", reinterpret_cast<const void*>(fold_kernel<2, false>)}};
const KernelInstance kDual = {"fold_kernel<1,true>",
                              reinterpret_cast<const void*>(fold_kernel<1, true>)};

// Rays per thread: 2 in the nearest fold while every SM still gets
// kMinBlocks blocks of the num_rays rays; else, and in the dual fold, 1.
int rays_per_thread(bool dual, int num_rays) {
  return !dual && (long long)num_rays >= 2LL * kThreads * kMinBlocks * tiles::sm_count() ? 2 : 1;
}

const KernelInstance& instance(bool dual, int rays) { return dual ? kDual : kNearest[rays - 1]; }

cudaError_t launch_fold(bool dual, const FoldArgs& a, cudaStream_t stream) {
  const int rays = rays_per_thread(dual, a.num_rays);
  const KernelInstance& k = instance(dual, rays);
  const int per_block = rays * kThreads;
  void* args[] = {const_cast<FoldArgs*>(&a)};
  return launch_instance(k.fn, (a.num_rays + per_block - 1) / per_block, kThreads,
                         tiles::table_smem(a.num_spheres), args, stream);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int hpt_nearest_fold_launch(const float* spheres, int num_spheres,
                                       const float* ray_o, const float* ray_d, float eps,
                                       float* t, int* prim, int num_rays, void* stream) {
  if (num_rays > 0) {
    const FoldArgs a{reinterpret_cast<const float4*>(spheres), num_spheres, ray_o, ray_d,
                     nullptr, nullptr, nullptr, eps, t, prim, nullptr, nullptr, num_rays};
    const cudaError_t err = launch_fold(false, a, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// `live` is [num_rays + 1] int32 scratch.
extern "C" int hpt_dual_fold_launch(const float* spheres, int num_spheres,
                                    const float* ray_o, const float* d_bsdf,
                                    const float* d_shadow, const float* t_light,
                                    const int* light_idx, const int* alive,
                                    float eps, float* t, int* prim, int* occ, int* live,
                                    int num_rays, void* stream) {
  if (num_rays > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(live, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    compact_live_kernel<<<(num_rays + kCompactThreads - 1) / kCompactThreads, kCompactThreads, 0,
                          s>>>(alive, num_rays, t, prim, occ, live);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const FoldArgs a{reinterpret_cast<const float4*>(spheres), num_spheres, ray_o, d_bsdf,
                     d_shadow, t_light, light_idx, eps, t, prim, occ, live, num_rays};
    err = launch_fold(true, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the card gives the fold instance that a launch on num_rays rays and
// num_spheres spheres takes (bounce.cuh:kernel_resources): out[7], and its
// name.  Returns cudaGetLastError() (0 = answered).
extern "C" int hpt_sphere_fold_resources(int dual, int num_rays, int num_spheres, int* out,
                                         const char** name) {
  const KernelInstance& k = instance(dual != 0, rays_per_thread(dual != 0, num_rays));
  *name = k.name;
  kernel_resources(k.fn, kThreads, tiles::table_smem(num_spheres), out);
  return static_cast<int>(cudaGetLastError());
}
