// Sphere-table folds for Hopper (sm_90a): the nearest sphere, and the dual
// query of one bounce.
//
// nearest_fold_kernel replaces
// haskell_path_tracer_tpu/ops/pallas_intersect.py:_sphere_fold_kernel
// (launched there by sphere_nearest_pallas): one thread per ray, the nearest
// sphere along d from o over the table [P, 4] = (center, r^2), accepting
// tca >= eps, h >= 0 and t >= eps (h = r^2 - (|l|^2 - tca^2), t = tca -
// sqrt(max(h, 1e-12))), strict `<` so the lowest index wins ties; (INFINITE,
// 0) on a miss.  `d2 > r2` and `h < 0` are the same test, sign-exact in f32.
//
// dual_fold_kernel replaces
// haskell_path_tracer_tpu/ops/pallas_intersect.py:_dual_fold_kernel
// (launched there by sphere_dual_query): one thread per ray, one pass over
// the sphere table [P, 4] = (center, r^2) answering both queries from the
// shade point o:
//   * the nearest sphere along d_bsdf, offset-origin acceptance in o's frame
//     (tca >= eps, h >= 0, t >= eps; h = r^2 - (|l|^2 - tca^2) and
//     t = tca - sqrt(max(h, 1e-12))), strict `<` so the lowest index wins
//     ties; (INFINITE, 0) on a miss;
//   * whether any sphere but light_idx blocks [EPSILON, t_light) along
//     d_shadow, by the sqrt-free test sharing the `center - o` vector.
// Both folds are nee.cuh:fold (<false> and <true>) on a table of spheres
// alone, the NEE megakernel's own device function, so their decisions are
// that kernel's.  A lane of the dual query with alive = 0 skips the fold and
// returns (INFINITE, 0, 0).
//
// What bounds them: fp32 work, ~19 (nearest) and ~31 (dual) operations per
// sphere per ray against 32 B (6 words in, 2 out) and 60 B (9 + 3 words in,
// 3 out) of device memory traffic per ray.  The table sits in shared memory
// when it fits in 48 KB (3072 spheres), else it is read through the L1
// cache, every lane of a warp reading the same row.
//
// Floating point: built with -fmad=false and without fast math.
//
// Layout: spheres [P, 4] f32; ray_o, ray_d, d_bsdf, d_shadow [n, 3] f32;
// t_light [n] f32; light_idx, alive [n] i32; t [n] f32, prim, occ [n] i32.

#include <cstdint>
#include <cuda_runtime.h>

#include "nee.cuh"

namespace {

using namespace hpt;

constexpr int kThreads = 128;
constexpr int kSmemTableBytes = 48 * 1024;

// The sphere table, staged into shared memory when `in_smem`.
__device__ nee::Scene sphere_scene(const float* spheres, int num_spheres, bool in_smem,
                                   float4* smem) {
  nee::Scene S{spheres, nullptr, nullptr, num_spheres, 0, 0, 0, 0};
  if (in_smem) {
    const float4* src = reinterpret_cast<const float4*>(spheres);
    for (int i = threadIdx.x; i < num_spheres; i += blockDim.x) smem[i] = src[i];
    __syncthreads();
    S.fold = reinterpret_cast<const float*>(smem);
  }
  return S;
}

__global__ void __launch_bounds__(kThreads)
nearest_fold_kernel(const float* __restrict__ spheres, int num_spheres, bool in_smem,
                    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                    float eps, float* __restrict__ t_out, int* __restrict__ prim_out,
                    int num_rays) {
  extern __shared__ float4 smem[];
  const nee::Scene S = sphere_scene(spheres, num_spheres, in_smem, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const float o[3] = {ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2]};
  const float d[3] = {ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2]};
  float t;
  int prim;
  bool unused = false;
  nee::fold<false>(S, o, d, eps, t, prim, nullptr, 0.0f, -1, unused);
  t_out[i] = t;
  prim_out[i] = prim;
}

__global__ void __launch_bounds__(kThreads)
dual_fold_kernel(const float* __restrict__ spheres, int num_spheres, bool in_smem,
                 const float* __restrict__ ray_o, const float* __restrict__ d_bsdf,
                 const float* __restrict__ d_shadow,
                 const float* __restrict__ t_light,
                 const int* __restrict__ light_idx, const int* __restrict__ alive,
                 float eps, float* __restrict__ t_out, int* __restrict__ prim_out,
                 int* __restrict__ occ_out, int num_rays) {
  extern __shared__ float4 smem[];
  const nee::Scene S = sphere_scene(spheres, num_spheres, in_smem, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  float t = kInfinite;
  int prim = 0;
  bool occ = false;
  if (alive[i] != 0) {
    const float o[3] = {ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2]};
    const float d[3] = {d_bsdf[3 * i], d_bsdf[3 * i + 1], d_bsdf[3 * i + 2]};
    const float b[3] = {d_shadow[3 * i], d_shadow[3 * i + 1], d_shadow[3 * i + 2]};
    nee::fold<true>(S, o, d, eps, t, prim, b, t_light[i], light_idx[i], occ);
  }
  t_out[i] = t;
  prim_out[i] = prim;
  occ_out[i] = occ ? 1 : 0;
}

// Shared memory for the table: all of it when it fits, else none.
size_t table_smem(int num_spheres) {
  const size_t bytes = sizeof(float) * 4 * (size_t)num_spheres;
  return bytes <= (size_t)kSmemTableBytes ? bytes : 0;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int hpt_nearest_fold_launch(const float* spheres, int num_spheres,
                                       const float* ray_o, const float* ray_d, float eps,
                                       float* t, int* prim, int num_rays, void* stream) {
  if (num_rays > 0) {
    const size_t smem = table_smem(num_spheres);
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    nearest_fold_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        spheres, num_spheres, smem > 0, ray_o, ray_d, eps, t, prim, num_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hpt_dual_fold_launch(const float* spheres, int num_spheres,
                                    const float* ray_o, const float* d_bsdf,
                                    const float* d_shadow, const float* t_light,
                                    const int* light_idx, const int* alive,
                                    float eps, float* t, int* prim, int* occ,
                                    int num_rays, void* stream) {
  if (num_rays > 0) {
    const size_t smem = table_smem(num_spheres);
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    dual_fold_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        spheres, num_spheres, smem > 0, ray_o, d_bsdf, d_shadow, t_light,
        light_idx, alive, eps, t, prim, occ, num_rays);
  }
  return static_cast<int>(cudaGetLastError());
}
