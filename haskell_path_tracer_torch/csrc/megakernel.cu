// The inline parity megakernel for Hopper (sm_90a): the whole sample x
// bounce loop of the reference's `render Inline`, one thread per pixel.
//
// Replaces haskell_path_tracer_tpu/ops/pallas_megakernel.py:_megakernel_body
// (launched there by trace_inline_pallas).  Semantics are that kernel's, op
// for op: per bounce 3 SFC32 draws, the nearest hit over spheres ++ planes
// ++ boxes ++ triangles (strict `<`, so the first index wins ties), the
// reference BRDFs with the glass block behind HAS_DIELECTRIC, emission x
// throughput accumulation, the dead-lane rule (a lane whose throughput is
// near zero or whose ray misses keeps its ray and rng and adds nothing),
// and optional Russian roulette with a 4th draw.
//
// What bounds it: fp32 ALU and SFU work.  Per live bounce a thread runs one
// rotation (3 sincosf: the winner's BRDF only, bounce.cuh:brdf_sample), 1
// sqrt (2 with glass) and one intersection test per primitive (7 in the
// reference scene); the only device-memory traffic is 40 B read (origin,
// direction, rng) and 28 B written (radiance, rng) per pixel per launch,
// whatever spp and the bounce count are (the recording instance adds 16 B
// per pixel and sample).  The design follows:
//   * the loop state (ray, rng, throughput, radiance) stays in registers
//     for all samples and bounces;
//   * the scene tables live in shared memory, loaded once per block, up to
//     the card's opt-in limit (227 KB, about 3600 primitives with 8
//     geometry columns, bounce.cuh:stage_tables); larger tables are read
//     from device memory through the L1 cache, which gives the same bits.
//     The fold loops over the per-kind index ranges with the counts passed
//     as arguments (the TPU kernel unrolled them at trace time);
//   * the fold keeps only (best t, best index); the winner's payload and
//     normal are read from its row afterwards, which gives the same bits
//     as the TPU kernel's where-fold;
//   * the fold, the hit and the BRDF sample are the device functions of
//     bounce.cuh, which the backward kernel (megakernel_vjp.cu) replays
//     with, so both take the same decisions.  The TPU kernel computes the
//     matte and the glossy rotation and selects one; here matte and glossy
//     lanes select the rotation's angles and vector and share one
//     rotation, which gives the same bits without diverging, and a glass
//     lane computes none;
//   * the gradient's forward is the RECORD instance: it also writes each
//     pixel's rng at the start of every sample, so the backward can run
//     one thread per (pixel, sample); the render path's instances do not
//     write it and are unchanged;
//   * a dead lane stays dead (its throughput is zero), so a thread leaves
//     the bounce loop at its first dead bounce: the remaining bounces would
//     change nothing, so the result is the same;
//   * any H x W: the grid is ceil(H*W / 128) blocks and the ragged tail is
//     masked.  128-thread blocks with no minimum per SM: 64 registers and
//     no stack on the main path, 8 blocks (32 warps) per SM; the other
//     shapes of 128 and 256 threads with 2-4 blocks per SM measured no
//     faster (PERF.md).
//
// Floating point: built without --use_fast_math and with -fmad=false, so
// each a*b+c rounds twice, as the JAX package's and PyTorch's separate ops
// do; sincosf/sqrtf and `/` are the IEEE-accurate versions (sincosf gives
// the bits of sinf and cosf).  The kernel
// then agrees with the PyTorch plain version on the card lane for lane.
//
// Layout: origin and direction are [H, W, 3] f32, rng [H, W, 4] u32 (the
// int32 tensors' bits), radiance [H, W, 3] f32; geom [P, gcols] (gcols 8
// or 16) and mat [P, 8] f32 are the tables of ops/megakernel.py:scene_tables.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

using namespace hpt;

// Block shape: threads per block, and the blocks per SM the compiler must
// leave room for (it caps the registers at 65536 / (threads x blocks)).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 1;

// RECORD (the gradient's forward, ops/megakernel_vjp.py): also writes each
// lane's rng at the start of every sample, [num_pixels, spp] x 16 B, so the
// backward can replay the samples of a pixel in parallel.
template <bool HAS_DIELECTRIC, bool RUSSIAN_ROULETTE, bool IN_SMEM, bool RECORD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
megakernel(const float* __restrict__ geom_g, int gcols,
           const float* __restrict__ mat_g, int ns, int np, int nb, int nt,
           const float* __restrict__ origin,
           const float* __restrict__ direction,
           const uint32_t* __restrict__ rng_in, float* __restrict__ radiance,
           uint32_t* __restrict__ rng_out, uint4* __restrict__ rng_samples,
           int num_pixels, int spp, int num_bounces, int rr_start) {
  extern __shared__ float smem[];
  const Tables T = stage_tables<IN_SMEM>(geom_g, mat_g, gcols, ns, np, nb, nt, smem);

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= num_pixels) return;
  const float po[3] = {origin[3 * pix], origin[3 * pix + 1], origin[3 * pix + 2]};
  const float pd[3] = {direction[3 * pix], direction[3 * pix + 1],
                       direction[3 * pix + 2]};
  Rng rng{rng_in[4 * pix], rng_in[4 * pix + 1], rng_in[4 * pix + 2],
          rng_in[4 * pix + 3]};
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  for (int s = 0; s < spp; ++s) {
    if (RECORD)
      rng_samples[(size_t)pix * spp + s] = make_uint4(rng.a, rng.b, rng.c, rng.ctr);
    float o[3] = {po[0], po[1], po[2]}, d[3] = {pd[0], pd[1], pd[2]};
    float res_r = 0.0f, res_g = 0.0f, res_b = 0.0f;
    float th[3] = {1.0f, 1.0f, 1.0f};

    for (int bounce = 0; bounce < num_bounces; ++bounce) {
      float best_t;
      const int best = nearest_hit(T, o, d, best_t);
      const bool hit = best_t < kInfinite;
      const float q = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
      // Dead lane: it keeps its ray and rng and adds nothing, and its
      // throughput becomes zero, so every later bounce is dead too.
      if (q <= kNearZeroEps || !hit) break;

      // The bounce's three uniforms (genVec), mapped to [-1, 1].
      Rng r2 = rng;
      float v[3];
      draw_vec(r2, v);
      float no[3], nd[3], nth[3], em[3];
      shade<HAS_DIELECTRIC>(T, best, best_t, o, d, th, v, no, nd, nth, em);
      res_r = res_r + em[0];
      res_g = res_g + em[1];
      res_b = res_b + em[2];

      if (RUSSIAN_ROULETTE) {
        float u = uniform(r2);
        float p_surv =
            fminf(fmaxf(fmaxf(nth[0], fmaxf(nth[1], nth[2])), 0.05f), 1.0f);
        if (bounce >= rr_start) {
          float inv_p = 1.0f / p_surv;
          bool killed = u >= p_surv;
          for (int i = 0; i < 3; ++i) nth[i] = killed ? 0.0f : nth[i] * inv_p;
        }
      }

      for (int i = 0; i < 3; ++i) { o[i] = no[i]; d[i] = nd[i]; th[i] = nth[i]; }
      rng = r2;
    }
    acc_r = acc_r + res_r;
    acc_g = acc_g + res_g;
    acc_b = acc_b + res_b;
  }

  radiance[3 * pix] = acc_r;
  radiance[3 * pix + 1] = acc_g;
  radiance[3 * pix + 2] = acc_b;
  rng_out[4 * pix] = rng.a;
  rng_out[4 * pix + 1] = rng.b;
  rng_out[4 * pix + 2] = rng.c;
  rng_out[4 * pix + 3] = rng.ctr;
}

// Every instance, in the order of their index: (dielectric, roulette,
// tables in shared memory, record), the recording ones without roulette.
template <bool D, bool R, bool S, bool C>
KernelInstance instance(const char* name) {
  return {name, reinterpret_cast<const void*>(megakernel<D, R, S, C>)};
}
const KernelInstance kInstances[] = {
    instance<false, false, false, false>("megakernel<plain, global>"),
    instance<false, false, true, false>("megakernel<plain, smem>"),
    instance<false, true, false, false>("megakernel<roulette, global>"),
    instance<false, true, true, false>("megakernel<roulette, smem>"),
    instance<true, false, false, false>("megakernel<dielectric, global>"),
    instance<true, false, true, false>("megakernel<dielectric, smem>"),
    instance<true, true, false, false>("megakernel<dielectric+roulette, global>"),
    instance<true, true, true, false>("megakernel<dielectric+roulette, smem>"),
    instance<false, false, false, true>("megakernel<record, global>"),
    instance<false, false, true, true>("megakernel<record, smem>"),
    instance<true, false, false, true>("megakernel<dielectric+record, global>"),
    instance<true, false, true, true>("megakernel<dielectric+record, smem>"),
};

// The instance a launch takes, and its dynamic shared memory.
int choose(int gcols, int P, int has_dielectric, int russian_roulette,
           bool record, size_t& smem) {
  const size_t bytes = sizeof(float) * (size_t)P * (gcols + 8);
  const bool in_smem = bytes <= smem_optin_bytes();
  smem = in_smem ? bytes : 0;
  if (record) return 8 + 2 * (has_dielectric != 0) + in_smem;
  return 4 * (has_dielectric != 0) + 2 * (russian_roulette != 0) + in_smem;
}

int launch(const float* geom, int gcols, const float* mat, int ns, int np,
           int nb, int nt, const float* origin, const float* direction,
           const uint32_t* rng_in, float* radiance, uint32_t* rng_out,
           uint32_t* rng_samples, int num_pixels, int spp, int num_bounces,
           int russian_roulette, int rr_start, int has_dielectric,
           void* stream) {
  if (num_pixels <= 0) return static_cast<int>(cudaGetLastError());
  size_t smem;
  const void* kernel = kInstances[choose(gcols, ns + np + nb + nt, has_dielectric,
                                         russian_roulette, rng_samples != nullptr,
                                         smem)].fn;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint4* samples = reinterpret_cast<uint4*>(rng_samples);
  void* args[] = {&geom, &gcols, &mat, &ns, &np, &nb, &nt, &origin, &direction,
                  &rng_in, &radiance, &rng_out, &samples, &num_pixels, &spp,
                  &num_bounces, &rr_start};
  return static_cast<int>(launch_instance(kernel, (num_pixels + kThreads - 1) / kThreads,
                                          kThreads, smem, args,
                                          static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` without
// synchronising and returns the launch's error (0 = launched).
extern "C" int hpt_megakernel_launch(
    const float* geom, int gcols, const float* mat, int num_spheres,
    int num_planes, int num_boxes, int num_triangles, const float* origin,
    const float* direction, const uint32_t* rng_in, float* radiance,
    uint32_t* rng_out, int num_pixels, int spp, int num_bounces,
    int russian_roulette, int rr_start, int has_dielectric, void* stream) {
  return launch(geom, gcols, mat, num_spheres, num_planes, num_boxes,
                num_triangles, origin, direction, rng_in, radiance, rng_out,
                nullptr, num_pixels, spp, num_bounces, russian_roulette,
                rr_start, has_dielectric, stream);
}

// The gradient's forward: as above without Russian roulette, and the rng of
// every pixel at the start of every sample into rng_samples
// [num_pixels, spp, 4].
extern "C" int hpt_megakernel_record_launch(
    const float* geom, int gcols, const float* mat, int num_spheres,
    int num_planes, int num_boxes, int num_triangles, const float* origin,
    const float* direction, const uint32_t* rng_in, float* radiance,
    uint32_t* rng_out, uint32_t* rng_samples, int num_pixels, int spp,
    int num_bounces, int has_dielectric, void* stream) {
  return launch(geom, gcols, mat, num_spheres, num_planes, num_boxes,
                num_triangles, origin, direction, rng_in, radiance, rng_out,
                rng_samples, num_pixels, spp, num_bounces, 0, 0,
                has_dielectric, stream);
}

// Resource use of the instance a launch with these operands takes, without
// Russian roulette (kernel_resources in bounce.cuh): out[7], and its name.
extern "C" void hpt_megakernel_resources(int gcols, int num_primitives,
                                         int has_dielectric, int record, int* out,
                                         const char** name) {
  size_t smem = 0;
  const int index = choose(gcols, num_primitives, has_dielectric, 0, record != 0, smem);
  *name = kInstances[index].name;
  kernel_resources(kInstances[index].fn, kThreads, smem, out);
}
