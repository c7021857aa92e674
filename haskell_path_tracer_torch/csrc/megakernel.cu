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
// What bounds it: fp32 ALU and SFU work.  Per bounce a thread runs about
// 6 sin/cos, 1 sqrt (2 with glass) and one intersection test per primitive
// (7 in the reference scene); the only device-memory traffic is 40 B read
// (origin, direction, rng) and 28 B written (radiance, rng) per pixel per
// launch, whatever spp and the bounce count are.  The design follows:
//   * the loop state (ray, rng, throughput, radiance) stays in registers
//     for all samples and bounces;
//   * the scene tables live in shared memory, loaded once per block; the
//     fold loops over the per-kind index ranges with the counts passed as
//     arguments (the TPU kernel unrolled them at trace time);
//   * the fold keeps only (best t, best index); the winner's payload and
//     normal are read from its row afterwards, which gives the same bits
//     as the TPU kernel's where-fold;
//   * a dead lane stays dead (its throughput is zero), so a thread leaves
//     the bounce loop at its first dead bounce: the remaining bounces would
//     change nothing, so the result is the same;
//   * any H x W: the grid is ceil(H*W / 128) blocks and the ragged tail is
//     masked.
//
// Floating point: built without --use_fast_math and with -fmad=false, so
// each a*b+c rounds twice, as the JAX package's and PyTorch's separate ops
// do; sinf/cosf/sqrtf and `/` are the IEEE-accurate versions.  The kernel
// then agrees with the PyTorch plain version on the card lane for lane.
//
// Layout: origin and direction are [H, W, 3] f32, rng [H, W, 4] u32 (the
// int32 tensors' bits), radiance [H, W, 3] f32; geom [P, gcols] (gcols 8
// or 16) and mat [P, 8] f32 are the tables of ops/megakernel.py:scene_tables.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInfinite = 3.40282347e+38f;  // f32 max: a miss
constexpr float kEpsilon = 0.002f;            // next-ray origin offset
constexpr float kPlaneDenomEps = 1e-6f;
constexpr float kNearZeroEps = 1e-6f;
constexpr float kPi = 3.14159274f;            // float32(pi)
constexpr float kInvTwoPi = 0.159154937f;     // float32(1 / (2 pi))
constexpr float kInv2Pow24 = 5.96046448e-08f; // 2^-24
constexpr int kThreads = 128;

struct Rng {
  uint32_t a, b, c, ctr;
};

__device__ __forceinline__ float uniform(Rng& r) {
  uint32_t t = r.a + r.b + r.ctr;
  r.ctr = r.ctr + 1u;
  r.a = r.b ^ (r.b >> 9);
  r.b = r.c + (r.c << 3);
  r.c = ((r.c << 21) | (r.c >> 11)) + t;
  // (t >> 8) < 2^24, so the int -> float conversion is exact.
  return (float)(int)(t >> 8) * kInv2Pow24;
}

__device__ __forceinline__ void angles_to_quat(float rx, float ry, float rz,
                                               float& w, float& x, float& y,
                                               float& z) {
  float cy = cosf(rz * 0.5f), sy = sinf(rz * 0.5f);
  float cp = cosf(ry * 0.5f), sp = sinf(ry * 0.5f);
  float cr = cosf(rx * 0.5f), sr = sinf(rx * 0.5f);
  w = cy * cp * cr + sy * sp * sr;
  x = cy * cp * sr - sy * sp * cr;
  y = sy * cp * sr + cy * sp * cr;
  z = sy * cp * cr - cy * sp * sr;
}

__device__ __forceinline__ void quat_rotate(float qw, float qx, float qy,
                                            float qz, float vx, float vy,
                                            float vz, float& ox, float& oy,
                                            float& oz) {
  float tx = 2.0f * (qy * vz - qz * vy);
  float ty = 2.0f * (qz * vx - qx * vz);
  float tz = 2.0f * (qx * vy - qy * vx);
  ox = vx + qw * tx + (qy * tz - qz * ty);
  oy = vy + qw * ty + (qz * tx - qx * tz);
  oz = vz + qw * tz + (qx * ty - qy * tx);
}

__device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ void slab(float lo, float hi, float o, float d,
                                     float& tmin, float& tmax) {
  const float tiny = 1e-12f;
  float d_safe = fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
  float inv = 1.0f / d_safe;
  float t1 = (lo - o) * inv;
  float t2 = (hi - o) * inv;
  tmin = fminf(t1, t2);
  tmax = fmaxf(t1, t2);
}

template <bool HAS_DIELECTRIC, bool RUSSIAN_ROULETTE>
__global__ void __launch_bounds__(kThreads)
megakernel(const float* __restrict__ geom_g, int gcols,
           const float* __restrict__ mat_g, int ns, int np, int nb, int nt,
           const float* __restrict__ origin, const float* __restrict__ direction,
           const uint32_t* __restrict__ rng_in, float* __restrict__ radiance,
           uint32_t* __restrict__ rng_out, int num_pixels, int spp,
           int num_bounces, int rr_start) {
  extern __shared__ float smem[];
  const int P = ns + np + nb + nt;
  float* geom = smem;
  float* mat = smem + P * gcols;
  for (int i = threadIdx.x; i < P * gcols; i += blockDim.x) geom[i] = geom_g[i];
  for (int i = threadIdx.x; i < P * 8; i += blockDim.x) mat[i] = mat_g[i];
  __syncthreads();

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= num_pixels) return;

  const float pox = origin[3 * pix], poy = origin[3 * pix + 1],
              poz = origin[3 * pix + 2];
  const float pdx = direction[3 * pix], pdy = direction[3 * pix + 1],
              pdz = direction[3 * pix + 2];
  Rng rng{rng_in[4 * pix], rng_in[4 * pix + 1], rng_in[4 * pix + 2],
          rng_in[4 * pix + 3]};
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  const int plane_end = ns + np, box_end = plane_end + nb;

  for (int s = 0; s < spp; ++s) {
    float ox = pox, oy = poy, oz = poz, dx = pdx, dy = pdy, dz = pdz;
    float res_r = 0.0f, res_g = 0.0f, res_b = 0.0f;
    float th_r = 1.0f, th_g = 1.0f, th_b = 1.0f;

    for (int bounce = 0; bounce < num_bounces; ++bounce) {
      // Nearest hit: strict `<` keeps the first index on ties.
      float best_t = kInfinite;
      int best = -1;
      for (int p = 0; p < ns; ++p) {
        const float* g = geom + p * gcols;
        float lx = g[0] - ox, ly = g[1] - oy, lz = g[2] - oz;
        float tca = lx * dx + ly * dy + lz * dz;
        float d2 = lx * lx + ly * ly + lz * lz - tca * tca;
        float r2 = g[3] * g[3];
        bool outside = d2 > r2;
        float thc = outside ? 0.0f : sqrtf(fmaxf(r2 - d2, 1e-12f));
        float t = tca - thc;
        bool miss = (tca < 0.0f) || outside || (t < 0.0f);
        t = miss ? kInfinite : t;
        if (t < best_t) { best_t = t; best = p; }
      }
      for (int p = ns; p < plane_end; ++p) {
        const float* g = geom + p * gcols;
        float denom = dx * g[3] + dy * g[4] + dz * g[5];
        float num = (g[0] - ox) * g[3] + (g[1] - oy) * g[4] + (g[2] - oz) * g[5];
        float denom_safe = denom == 0.0f ? kPlaneDenomEps * 0.5f : denom;
        float dist = num / denom_safe;
        bool miss = (denom > kPlaneDenomEps) || (dist < 0.0f);
        float t = miss ? kInfinite : dist;
        if (t < best_t) { best_t = t; best = p; }
      }
      for (int p = plane_end; p < box_end; ++p) {
        const float* g = geom + p * gcols;
        float xl, xh, yl, yh, zl, zh;
        slab(g[0], g[3], ox, dx, xl, xh);
        slab(g[1], g[4], oy, dy, yl, yh);
        slab(g[2], g[5], oz, dz, zl, zh);
        float t_near = fmaxf(xl, fmaxf(yl, zl));
        float t_far = fminf(xh, fminf(yh, zh));
        bool miss = (t_near > t_far) || (t_near <= 0.0f);
        float t = miss ? kInfinite : t_near;
        if (t < best_t) { best_t = t; best = p; }
      }
      for (int p = box_end; p < P; ++p) {
        const float* g = geom + p * gcols;
        float e1x = g[3], e1y = g[4], e1z = g[5];
        float e2x = g[6], e2y = g[7], e2z = g[8];
        float pvx = dy * e2z - dz * e2y;
        float pvy = dz * e2x - dx * e2z;
        float pvz = dx * e2y - dy * e2x;
        float det = e1x * pvx + e1y * pvy + e1z * pvz;
        float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
        float tvx = ox - g[0], tvy = oy - g[1], tvz = oz - g[2];
        float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        float qvx = tvy * e1z - tvz * e1y;
        float qvy = tvz * e1x - tvx * e1z;
        float qvz = tvx * e1y - tvy * e1x;
        float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
        float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        bool miss = (det <= kPlaneDenomEps * g[12]) || (u < 0.0f) ||
                    (v < 0.0f) || (u + v > 1.0f) || (t < 0.0f);
        t = miss ? kInfinite : t;
        if (t < best_t) { best_t = t; best = p; }
      }

      const bool hit = best_t < kInfinite;
      const float q = th_r * th_r + th_g * th_g + th_b * th_b;
      // Dead lane: it keeps its ray and rng and adds nothing, and its
      // throughput becomes zero, so every later bounce is dead too.
      if (q <= kNearZeroEps || !hit) break;

      const float hx = ox + dx * best_t, hy = oy + dy * best_t,
                  hz = oz + dz * best_t;
      const float* g = geom + best * gcols;
      const float* m = mat + best * 8;
      float nx, ny, nz;
      if (best < ns) {
        float sx = hx - g[0], sy = hy - g[1], sz = hz - g[2];
        float sq = sx * sx + sy * sy + sz * sz;
        float inv = sq > 1e-20f ? 1.0f / sqrtf(sq) : 1e20f;
        nx = sx * inv; ny = sy * inv; nz = sz * inv;
      } else if (best < plane_end) {
        nx = g[3]; ny = g[4]; nz = g[5];
      } else if (best < box_end) {
        // Dominant axis of the centered, half-size-normalized hit offset;
        // x wins ties, then y.
        float qx = (ox + dx * best_t - (g[0] + g[3]) * 0.5f) /
                   fmaxf((g[3] - g[0]) * 0.5f, 1e-12f);
        float qy = (oy + dy * best_t - (g[1] + g[4]) * 0.5f) /
                   fmaxf((g[4] - g[1]) * 0.5f, 1e-12f);
        float qz = (oz + dz * best_t - (g[2] + g[5]) * 0.5f) /
                   fmaxf((g[5] - g[2]) * 0.5f, 1e-12f);
        float aqx = fabsf(qx), aqy = fabsf(qy), aqz = fabsf(qz);
        bool takex = (aqx >= aqy) && (aqx >= aqz);
        bool takey = !takex && (aqy >= aqz);
        nx = takex ? sign(qx) : 0.0f;
        ny = takey ? sign(qy) : 0.0f;
        nz = (takex || takey) ? 0.0f : sign(qz);
      } else {
        nx = g[9]; ny = g[10]; nz = g[11];
      }
      const float cr = m[0], cg = m[1], cb = m[2], il = m[3], p = m[4],
                  kd = m[5];

      // The bounce's three uniforms (genVec), mapped to [-1, 1].
      Rng r2 = rng;
      float vx = uniform(r2) * 2.0f - 1.0f;
      float vy = uniform(r2) * 2.0f - 1.0f;
      float vz = uniform(r2) * 2.0f - 1.0f;

      // Matte.
      float qw, qx, qy, qz;
      angles_to_quat(kPi * vx, kPi * vy, kPi * vz, qw, qx, qy, qz);
      float mx, my, mz;
      quat_rotate(qw, qx, qy, qz, nx, ny, nz, mx, my, mz);
      float m_b = p / kPi * (mx * nx + my * ny + mz * nz);

      // Glossy.
      float ia = dx * nx + dy * ny + dz * nz;
      float rx = dx - 2.0f * ia * nx, ry = dy - 2.0f * ia * ny,
            rz = dz - 2.0f * ia * nz;
      float sp = 1.0f - p;
      angles_to_quat(sp * vx, sp * vy, sp * vz, qw, qx, qy, qz);
      float gx, gy, gz;
      quat_rotate(qw, qx, qy, qz, rx, ry, rz, gx, gy, gz);
      float g_b = fmaxf(0.0f, gx * rx + gy * ry + gz * rz);

      const bool is_g = kd == 1.0f;
      float nd_x = is_g ? gx : mx, nd_y = is_g ? gy : my,
            nd_z = is_g ? gz : mz;
      float scale = (is_g ? g_b : m_b) * kInvTwoPi;

      if (HAS_DIELECTRIC && kd == 2.0f) {
        // Glass: Snell refraction or reflection, chosen by Schlick-Fresnel
        // with u = (vx + 1) / 2.
        float cos_i = -(dx * nx + dy * ny + dz * nz);
        bool inside = cos_i < 0.0f;
        float fnx = inside ? -nx : nx, fny = inside ? -ny : ny,
              fnz = inside ? -nz : nz;
        float aci = fabsf(cos_i);
        float eta = inside ? p : 1.0f / fmaxf(p, 1e-6f);
        float sin2 = eta * eta * fmaxf(1.0f - aci * aci, 0.0f);
        bool tir = sin2 > 1.0f;
        float cos_t = tir ? 0.0f : sqrtf(fmaxf(1.0f - sin2, 1e-12f));
        float r0 = (1.0f - p) / (1.0f + p);
        r0 = r0 * r0;
        float c1 = 1.0f - aci;
        float c2 = c1 * c1;
        float fres = r0 + (1.0f - r0) * (c1 * (c2 * c2));
        float refl_p = tir ? 1.0f : fres;
        float u = (vx + 1.0f) * 0.5f;
        bool take_refl = u < refl_p;
        float k = eta * aci - cos_t;
        float tx = eta * dx + k * fnx, ty = eta * dy + k * fny,
              tz = eta * dz + k * fnz;
        float tq = tx * tx + ty * ty + tz * tz;
        float tinv = tq > 1e-20f ? 1.0f / sqrtf(tq) : 1e20f;
        nd_x = take_refl ? rx : tx * tinv;
        nd_y = take_refl ? ry : ty * tinv;
        nd_z = take_refl ? rz : tz * tinv;
        scale = 1.0f;
      }

      res_r = res_r + cr * il * th_r;
      res_g = res_g + cg * il * th_g;
      res_b = res_b + cb * il * th_b;
      float nth_r = th_r * (cr * scale);
      float nth_g = th_g * (cg * scale);
      float nth_b = th_b * (cb * scale);

      if (RUSSIAN_ROULETTE) {
        float u = uniform(r2);
        float p_surv =
            fminf(fmaxf(fmaxf(nth_r, fmaxf(nth_g, nth_b)), 0.05f), 1.0f);
        if (bounce >= rr_start) {
          float inv_p = 1.0f / p_surv;
          bool killed = u >= p_surv;
          nth_r = killed ? 0.0f : nth_r * inv_p;
          nth_g = killed ? 0.0f : nth_g * inv_p;
          nth_b = killed ? 0.0f : nth_b * inv_p;
        }
      }

      ox = hx + nd_x * kEpsilon;
      oy = hy + nd_y * kEpsilon;
      oz = hz + nd_z * kEpsilon;
      dx = nd_x; dy = nd_y; dz = nd_z;
      rng = r2;
      th_r = nth_r; th_g = nth_g; th_b = nth_b;
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

template <bool D, bool R>
void launch(const float* geom, int gcols, const float* mat, int ns, int np,
            int nb, int nt, const float* origin, const float* direction,
            const uint32_t* rng_in, float* radiance, uint32_t* rng_out,
            int num_pixels, int spp, int num_bounces, int rr_start,
            cudaStream_t stream) {
  const int P = ns + np + nb + nt;
  const size_t smem = sizeof(float) * (size_t)P * (gcols + 8);
  const int blocks = (num_pixels + kThreads - 1) / kThreads;
  megakernel<D, R><<<blocks, kThreads, smem, stream>>>(
      geom, gcols, mat, ns, np, nb, nt, origin, direction, rng_in, radiance,
      rng_out, num_pixels, spp, num_bounces, rr_start);
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int hpt_megakernel_launch(
    const float* geom, int gcols, const float* mat, int num_spheres,
    int num_planes, int num_boxes, int num_triangles, const float* origin,
    const float* direction, const uint32_t* rng_in, float* radiance,
    uint32_t* rng_out, int num_pixels, int spp, int num_bounces,
    int russian_roulette, int rr_start, int has_dielectric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pixels > 0) {
    if (has_dielectric) {
      if (russian_roulette)
        launch<true, true>(geom, gcols, mat, num_spheres, num_planes,
                           num_boxes, num_triangles, origin, direction,
                           rng_in, radiance, rng_out, num_pixels, spp,
                           num_bounces, rr_start, s);
      else
        launch<true, false>(geom, gcols, mat, num_spheres, num_planes,
                            num_boxes, num_triangles, origin, direction,
                            rng_in, radiance, rng_out, num_pixels, spp,
                            num_bounces, rr_start, s);
    } else {
      if (russian_roulette)
        launch<false, true>(geom, gcols, mat, num_spheres, num_planes,
                            num_boxes, num_triangles, origin, direction,
                            rng_in, radiance, rng_out, num_pixels, spp,
                            num_bounces, rr_start, s);
      else
        launch<false, false>(geom, gcols, mat, num_spheres, num_planes,
                             num_boxes, num_triangles, origin, direction,
                             rng_in, radiance, rng_out, num_pixels, spp,
                             num_bounces, rr_start, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
