// One pixel of the deterministic-splitting kernel (split.cu): every
// sample's dielectric split tree, walked depth first on a per-lane stack.
//
// The semantics are those of _split_kernel_body
// (haskell_path_tracer_tpu/ops/pallas_split.py), step for step:
//   * a step traces the lane's current segment: the nearest hit over all
//     rows (bounce.cuh), then the segment is alive when the lane has one,
//     the ray hits, the throughput is not near zero and depth < bounces;
//   * an alive segment adds its emission at the OLD throughput, consumes
//     three draws (a glass hit draws too and discards the vector), and
//     continues as the BRDF sample, or at glass as the Fresnel reflection
//     with weight F; the refraction child, (throughput x color) x (1 - F),
//     is pushed when F < 1, its quadrance exceeds 1e-6, depth + 1 <
//     bounces and a slot is free;
//   * a segment that dies pops the deepest pending child; a lane with no
//     child left is done.  Dead and popped lanes keep their rng;
//   * at most bounces x (1 + stack_depth) steps per sample.
// A lane that is dead with an empty stack never revives, so the loop ends
// there: the TPU kernel's per-block early exit, exact per lane.
//
// HPT_HD: the same code compiles under nvcc and under a plain C++
// compiler, so tests/test_torch_split_host.py runs it on the host.

#pragma once

#include "bounce.cuh"

#if defined(__CUDACC__)
#define HPT_UNROLL _Pragma("unroll")
#else
#define HPT_UNROLL
#endif

namespace hpt {

// The deepest stack the kernel takes (stack_depth <= bounces - 1).
constexpr int kMaxStack = 64;

// A pending refraction child: origin, direction, throughput and depth.
struct Child {
  float o[3], d[3], th[3];
  int depth;
};

// The per-lane stack.  CAP > 0: CAP slots, each addressed by an unrolled
// compare with a constant index, so the slots stay in registers; CAP == 0:
// kMaxStack slots in thread-local memory, addressed directly.
template <int CAP>
struct Stack {
  Child slot[CAP];
  HPT_HD void put(int i, const Child& c) {
    HPT_UNROLL
    for (int s = 0; s < CAP; ++s)
      if (s == i) slot[s] = c;
  }
  // Slots 0 .. i have all been written when i is read.
  HPT_HD Child get(int i) const {
    Child c = slot[0];
    HPT_UNROLL
    for (int s = 1; s < CAP; ++s)
      if (s == i) c = slot[s];
    return c;
  }
};

template <>
struct Stack<0> {
  Child slot[kMaxStack];
  HPT_HD void put(int i, const Child& c) { slot[i] = c; }
  HPT_HD Child get(int i) const { return slot[i]; }
};

// The stack a launch with `stack_depth` slots takes: 1, 2 or 4 register
// slots, else the local-memory stack (0).
HPT_HD int stack_capacity(int stack_depth) {
  return stack_depth <= 1 ? 1 : (stack_depth <= 2 ? 2 : (stack_depth <= 4 ? 4 : 0));
}

// `spp` samples of one pixel from the primary ray (po, pd): the radiance
// summed over the samples into acc; rng advanced as the samples drew.
template <int CAP>
HPT_HD void split_pixel(const Tables& T, const float* po, const float* pd,
                        Rng& rng, int spp, int num_bounces, int stack_depth,
                        float* acc) {
  const int max_steps = num_bounces * (1 + stack_depth);
  acc[0] = acc[1] = acc[2] = 0.0f;
  for (int s = 0; s < spp; ++s) {
    float o[3] = {po[0], po[1], po[2]}, d[3] = {pd[0], pd[1], pd[2]};
    float th[3] = {1.0f, 1.0f, 1.0f}, res[3] = {0.0f, 0.0f, 0.0f};
    int depth = 0, sp = 0;
    Stack<CAP> stack;
    for (int step = 0; step < max_steps; ++step) {
      float best_t;
      const int best = nearest_hit(T, o, d, best_t);
      const float q = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
      if (best_t < kInfinite && q > kNearZeroEps && depth < num_bounces) {
        const float* m = T.mat + best * 8;
        for (int i = 0; i < 3; ++i) res[i] = res[i] + m[i] * m[3] * th[i];
        float v[3];
        draw_vec(rng, v);
        float h[3], n[3];
        hit_normal(T, best, best_t, o, d, h, n);
        float nd[3], scale, tm[3];
        brdf_sample<false>(n, d, m[4], m[5], v, nd, scale);
        for (int i = 0; i < 3; ++i) tm[i] = m[i] * scale;
        if (m[5] == 2.0f) {
          // Continue as the reflection, weight F; push the refraction.
          float r[3], t[3], f;
          dielectric_split(d, n, m[4], r, t, f);
          Child c;
          const float omf = 1.0f - f;
          for (int i = 0; i < 3; ++i) {
            nd[i] = r[i];
            tm[i] = m[i] * f;
            c.th[i] = th[i] * m[i] * omf;
          }
          const float cq = c.th[0] * c.th[0] + c.th[1] * c.th[1] + c.th[2] * c.th[2];
          if (f < 1.0f && cq > kNearZeroEps && depth + 1 < num_bounces && sp < stack_depth) {
            for (int i = 0; i < 3; ++i) {
              c.o[i] = h[i] + t[i] * kEpsilon;
              c.d[i] = t[i];
            }
            c.depth = depth + 1;
            stack.put(sp, c);
            ++sp;
          }
        }
        for (int i = 0; i < 3; ++i) {
          o[i] = h[i] + nd[i] * kEpsilon;
          d[i] = nd[i];
          th[i] = th[i] * tm[i];
        }
        ++depth;
      } else if (sp > 0) {
        const Child c = stack.get(--sp);
        for (int i = 0; i < 3; ++i) {
          o[i] = c.o[i];
          d[i] = c.d[i];
          th[i] = c.th[i];
        }
        depth = c.depth;
      } else {
        break;
      }
    }
    for (int i = 0; i < 3; ++i) acc[i] = acc[i] + res[i];
  }
}

// split_pixel with the stack that `cap` (stack_capacity) names.
HPT_HD void split_pixel_cap(int cap, const Tables& T, const float* po,
                            const float* pd, Rng& rng, int spp,
                            int num_bounces, int stack_depth, float* acc) {
  switch (cap) {
    case 1: split_pixel<1>(T, po, pd, rng, spp, num_bounces, stack_depth, acc); break;
    case 2: split_pixel<2>(T, po, pd, rng, spp, num_bounces, stack_depth, acc); break;
    case 4: split_pixel<4>(T, po, pd, rng, spp, num_bounces, stack_depth, acc); break;
    default: split_pixel<0>(T, po, pd, rng, spp, num_bounces, stack_depth, acc);
  }
}

}  // namespace hpt
