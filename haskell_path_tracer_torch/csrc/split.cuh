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
// A lane that is dead with an empty stack never revives, so its sample ends
// there: the TPU kernel's per-block early exit, exact per lane.  The kernel
// runs a pixel's samples as one flat loop of steps (split_step), each lane
// on its own sample and step, rather than a loop over samples with the
// steps nested inside.
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

// One lane of the kernel's flat step loop: the pixel's primary ray and its
// nearest hit (the same for every sample, so folded once), the current
// segment (ray, throughput, depth) and its nearest hit (best, t; best < 0
// when the segment is dead), the stack of pending children, the sample's
// radiance `res`, the pixel's sum `acc`, the sample index s and the count
// of the nested loop's steps the sample has taken.
template <int CAP>
struct SplitLane {
  float po[3], pd[3], t0;
  int best0;
  float o[3], d[3], th[3], t, res[3], acc[3];
  int best, depth, sp, s, step;
  Rng rng;
  Stack<CAP> stack;
};

// Folds the lane's current segment: its winner, or -1 when it is dead (no
// hit, throughput near zero, or depth == bounces; only a hit needs the
// fold).
template <int CAP>
HPT_HD void split_fold(const Tables& T, SplitLane<CAP>& L, int num_bounces) {
  const float q = L.th[0] * L.th[0] + L.th[1] * L.th[1] + L.th[2] * L.th[2];
  L.best = -1;
  if (q > kNearZeroEps && L.depth < num_bounces) L.best = nearest_hit(T, L.o, L.d, L.t);
}

// Starts the lane's current sample from the primary ray and its hit.
template <int CAP>
HPT_HD void split_restart(SplitLane<CAP>& L) {
  for (int i = 0; i < 3; ++i) {
    L.o[i] = L.po[i];
    L.d[i] = L.pd[i];
    L.th[i] = 1.0f;
    L.res[i] = 0.0f;
  }
  L.t = L.t0;
  L.best = L.best0;
  L.depth = L.sp = L.step = 0;
}

// Sets a lane up at its first sample and folds its primary ray.  Returns
// whether it has a step to run: false with no samples or no bounces, or
// when the primary ray misses (every sample adds nothing and draws
// nothing), the pixel's sum 0.
template <int CAP>
HPT_HD bool split_start(const Tables& T, SplitLane<CAP>& L, const float* po, const float* pd,
                        const Rng& rng, int spp, int num_bounces) {
  for (int i = 0; i < 3; ++i) {
    L.po[i] = po[i];
    L.pd[i] = pd[i];
    L.acc[i] = 0.0f;
  }
  L.rng = rng;
  L.s = 0;
  if (spp <= 0 || num_bounces <= 0) return false;
  L.best0 = nearest_hit(T, L.po, L.pd, L.t0);
  split_restart(L);
  return L.best0 >= 0;
}

// The nested loop's alive step on the lane's current segment, whose hit
// (best, t) is known: its emission at the old throughput, three draws, and
// the BRDF sample, or at glass the Fresnel reflection with weight F and
// the refraction child pushed (the BRDF sample, which the nested loop
// computed and threw away there, is not computed).
template <int CAP>
HPT_HD void split_shade(const Tables& T, SplitLane<CAP>& L, int num_bounces, int stack_depth) {
  const float* m = T.mat + L.best * 8;
  for (int i = 0; i < 3; ++i) L.res[i] = L.res[i] + m[i] * m[3] * L.th[i];
  float v[3];
  draw_vec(L.rng, v);
  float h[3], n[3], nd[3], tm[3];
  hit_normal(T, L.best, L.t, L.o, L.d, h, n);
  if (m[5] == 2.0f) {
    // Continue as the reflection, weight F; push the refraction.
    float t[3], f;
    dielectric_split(L.d, n, m[4], nd, t, f);
    Child c;
    const float omf = 1.0f - f;
    for (int i = 0; i < 3; ++i) {
      tm[i] = m[i] * f;
      c.th[i] = L.th[i] * m[i] * omf;
    }
    const float cq = c.th[0] * c.th[0] + c.th[1] * c.th[1] + c.th[2] * c.th[2];
    if (f < 1.0f && cq > kNearZeroEps && L.depth + 1 < num_bounces && L.sp < stack_depth) {
      for (int i = 0; i < 3; ++i) {
        c.o[i] = h[i] + t[i] * kEpsilon;
        c.d[i] = t[i];
      }
      c.depth = L.depth + 1;
      L.stack.put(L.sp, c);
      ++L.sp;
    }
  } else {
    float scale;
    brdf_sample<false>(n, L.d, m[4], m[5], v, nd, scale);
    for (int i = 0; i < 3; ++i) tm[i] = m[i] * scale;
  }
  for (int i = 0; i < 3; ++i) {
    L.o[i] = h[i] + nd[i] * kEpsilon;
    L.d[i] = nd[i];
    L.th[i] = L.th[i] * tm[i];
  }
  ++L.depth;
}

// One step of the flat loop: one of the nested loop's steps, exactly as it
// runs it, on a segment whose hit the previous step folded.  An alive
// segment is shaded (the alive step), a dead one pops the deepest child
// (the popping step); then the next segment is folded.  A segment that the
// fold finds dead with no child left ends the sample in the same step,
// where the nested loop took one more to find it dead.  The nested loop's
// step count is kept, and the sample ends after max_steps of them as
// there.  A sample that ends banks `res` into `acc` (in sample order) and
// the lane restarts the next one from the primary hit.  Returns false once
// the lane has banked its last sample.
template <int CAP>
HPT_HD bool split_step(const Tables& T, SplitLane<CAP>& L, int spp, int num_bounces,
                       int stack_depth, int max_steps) {
  if (L.best >= 0) {
    split_shade(T, L, num_bounces, stack_depth);
  } else {
    const Child c = L.stack.get(--L.sp);
    for (int i = 0; i < 3; ++i) {
      L.o[i] = c.o[i];
      L.d[i] = c.d[i];
      L.th[i] = c.th[i];
    }
    L.depth = c.depth;
  }
  bool ended = ++L.step == max_steps;
  if (!ended) {
    split_fold(T, L, num_bounces);
    ended = L.best < 0 && L.sp == 0;
  }
  if (!ended) return true;
  for (int i = 0; i < 3; ++i) L.acc[i] = L.acc[i] + L.res[i];
  if (++L.s == spp) return false;
  split_restart(L);
  return true;
}

// Writes a lane's outputs, all its samples banked, as pixel q's.
template <int CAP>
HPT_HD void split_store(const SplitLane<CAP>& L, int q, float* radiance, uint32_t* rng_out) {
  for (int i = 0; i < 3; ++i) radiance[3 * q + i] = L.acc[i];
  rng_out[4 * q] = L.rng.a;
  rng_out[4 * q + 1] = L.rng.b;
  rng_out[4 * q + 2] = L.rng.c;
  rng_out[4 * q + 3] = L.rng.ctr;
}

// `spp` samples of one pixel from the primary ray (po, pd): the radiance
// summed over the samples into acc; rng advanced as the samples drew.  One
// lane's flat loop, run alone: the nested loop
//   for s < spp { for step < max_steps { step body; break when done } }
// with max_steps = bounces x (1 + stack_depth), as one loop of split_step.
// Each sample's arithmetic, its draws and the order of the sums are the
// nested loop's, so rng and radiance are its bits.  A warp of lanes each
// running this loop pays for its longest lane's steps over all samples,
// where the nested loop paid, sample by sample, for the longest split tree
// among its lanes.
template <int CAP>
HPT_HD void split_pixel(const Tables& T, const float* po, const float* pd,
                        Rng& rng, int spp, int num_bounces, int stack_depth,
                        float* acc) {
  const int max_steps = num_bounces * (1 + stack_depth);
  SplitLane<CAP> L;
  if (split_start(T, L, po, pd, rng, spp, num_bounces))
    while (split_step(T, L, spp, num_bounces, stack_depth, max_steps)) {
    }
  for (int i = 0; i < 3; ++i) acc[i] = L.acc[i];
  rng = L.rng;
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
