// Host harness for the NEE megakernel's per-pixel code: compiles
// haskell_path_tracer_torch/csrc/nee.cuh with a plain C++ compiler, so
// tests/test_torch_nee_host.py can run the kernel's arithmetic, pixel by
// pixel, on a machine without a GPU and hold it against the plain PyTorch
// version, and run the kernel's flat sample loop (nee.cuh:lane_step) in
// lockstep over 32-lane groups, as a warp runs it, against the nested
// sample x bounce loop it replaced, kept here as the oracle; and runs the
// probe's fold (probe.cuh) as its kernel does, in R-ray groups over the
// sphere table in tiles, against `nee::primary_hit`.  A test tool only:
// nothing in the package calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libnee_host.so nee_host.cpp

#include <vector>

#include "nee.cuh"
#include "probe.cuh"

using namespace hpt;

// nee_kernel's work, one pixel after the other (order, t0_in, prim0_in and
// steps may be null, as there).
extern "C" void hpt_nee_host(
    const float* fold, const float* payload, const float* lights, int ns,
    int np, int nb, int nt, int nl, const float* origin, const float* direction,
    const uint32_t* rng_in, const float* t0_in, const int* prim0_in,
    const int* order, float* radiance, uint32_t* rng_out, int* steps,
    int num_pixels, int spp, int num_bounces, int has_glossy, int has_diel) {
  const nee::Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  for (int i = 0; i < num_pixels; ++i) {
    const int q = order != nullptr ? order[i] : i;
    if (has_glossy && has_diel)
      nee::nee_pixel<true, true>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                 radiance, rng_out, steps, spp, num_bounces);
    else if (has_glossy)
      nee::nee_pixel<true, false>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                  radiance, rng_out, steps, spp, num_bounces);
    else if (has_diel)
      nee::nee_pixel<false, true>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                  radiance, rng_out, steps, spp, num_bounces);
    else
      nee::nee_pixel<false, false>(S, q, origin, direction, rng_in, t0_in, prim0_in,
                                   radiance, rng_out, steps, spp, num_bounces);
  }
}

// probe_kernel's work.
extern "C" void hpt_probe_host(const float* fold, int ns, int np, int nb,
                               int nt, const float* origin,
                               const float* direction, float* t0, int* prim0,
                               int num_rays) {
  const nee::Scene S{fold, nullptr, nullptr, ns, np, nb, nt, 0};
  for (int i = 0; i < num_rays; ++i)
    nee::primary_hit(S, origin + 3 * i, direction + 3 * i, t0[i], prim0[i]);
}

namespace {

// probe_kernel's work: the rays in groups of R, the last group's empty
// slots folding its first ray and storing nothing; each group over the
// sphere rows in tiles of tile_rows rows, each tile copied into a buffer
// as the kernel stages it in shared memory, then over the other kinds.
template <int R>
void probe_tiled(const nee::Scene& S, int tile_rows, const float* origin,
                 const float* direction, float* t0, int* prim0, int num_rays) {
  std::vector<float> tile(4 * (size_t)tile_rows);
  for (int first = 0; first < num_rays; first += R) {
    sphere_fold::Lanes<R, false> L;
    for (int r = 0; r < R; ++r)
      L.load(r, first + r < num_rays ? first + r : first, origin, direction, nullptr, nullptr,
             nullptr);
    for (int base = 0; base < S.ns; base += tile_rows) {
      const int rows = S.ns - base < tile_rows ? S.ns - base : tile_rows;
      for (int j = 0; j < 4 * rows; ++j) tile[j] = S.sphere(base)[j];
      sphere_fold::fold_rows<R, false>(tile.data(), base, rows, 0.0f, L);
    }
    for (int r = 0; r < R && first + r < num_rays; ++r) {
      probe::fold_tails(S, L.o[r], L.d[r], L.t[r], L.prim[r]);
      t0[first + r] = L.t[r];
      prim0[first + r] = L.prim[r];
    }
  }
}

}  // namespace

// The probe kernel's fold (R = 1, 2 or 4 rays per group) over the sphere
// rows in tiles of tile_rows rows.
extern "C" void hpt_probe_tiled_host(int rays_per_thread, int tile_rows, const float* fold,
                                     int ns, int np, int nb, int nt, const float* origin,
                                     const float* direction, float* t0, int* prim0,
                                     int num_rays) {
  const nee::Scene S{fold, nullptr, nullptr, ns, np, nb, nt, 0};
  if (rays_per_thread == 4)
    probe_tiled<4>(S, tile_rows, origin, direction, t0, prim0, num_rays);
  else if (rays_per_thread == 2)
    probe_tiled<2>(S, tile_rows, origin, direction, t0, prim0, num_rays);
  else
    probe_tiled<1>(S, tile_rows, origin, direction, t0, prim0, num_rays);
}

namespace {

using namespace hpt::nee;

// The nested loop the kernel ran before the flat one, as it was: for each
// sample, the bounces from the primary hit until the first dead one, whose
// residual word (with RECORD) is written with a clear live bit.  A path
// that uses its whole bounce budget writes no dead word.
template <bool HAS_GLOSSY, bool HAS_DIEL, bool RECORD>
void nested_trace_pixel(const Scene& S, const float* po, const float* pd, float t0,
                        int prim0, Rng& rng, int spp, int num_bounces, float* acc,
                        int& steps, int* rec, int stride) {
  for (int s = 0; s < spp; ++s) {
    float o[3] = {po[0], po[1], po[2]}, d[3] = {pd[0], pd[1], pd[2]};
    float t = t0;
    int prim = prim0;
    float res[3] = {0.0f, 0.0f, 0.0f}, th[3] = {1.0f, 1.0f, 1.0f};
    bool prev_spec = true;  // camera rays see lights
    for (int bounce = 0; bounce < num_bounces; ++bounce) {
      int* word = RECORD ? rec + (size_t)(s * num_bounces + bounce) * stride : nullptr;
      if (dead_bounce(th, t)) {
        if (RECORD) *word = residual_word(prim, t < kInfinite, false, false);
        break;
      }
      ++steps;
      Draws dr;
      const int winner = prim;
      live_bounce<HAS_GLOSSY, HAS_DIEL>(S, o, d, t, prim, th, prev_spec, rng, res, dr);
      if (RECORD) *word = residual_word(winner, true, true, dr.occ);
    }
    for (int i = 0; i < 3; ++i) acc[i] = acc[i] + res[i];
  }
}

void store(int q, const float* acc, const Rng& rng, int n_steps, float* radiance,
           uint32_t* rng_out, int* steps) {
  for (int i = 0; i < 3; ++i) radiance[3 * q + i] = acc[i];
  rng_out[4 * q] = rng.a;
  rng_out[4 * q + 1] = rng.b;
  rng_out[4 * q + 2] = rng.c;
  rng_out[4 * q + 3] = rng.ctr;
  steps[q] = n_steps;
}

template <bool G, bool D, bool RECORD>
void nested_all(const Scene& S, int n, const float* origin, const float* direction,
                const uint32_t* rng_in, float* radiance, uint32_t* rng_out, int* steps,
                int* words, int spp, int num_bounces) {
  for (int q = 0; q < n; ++q) {
    float t0;
    int prim0;
    primary_hit(S, origin + 3 * q, direction + 3 * q, t0, prim0);
    Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
    float acc[3] = {0.0f, 0.0f, 0.0f};
    int n_steps = 0;
    nested_trace_pixel<G, D, RECORD>(S, origin + 3 * q, direction + 3 * q, t0, prim0, rng,
                                     spp, num_bounces, acc, n_steps,
                                     RECORD ? words + q : nullptr, n);
    store(q, acc, rng, n_steps, radiance, rng_out, steps);
  }
}

constexpr int kWarp = 32;

// The flat loop over groups of kWarp lanes, one lane_step of every lane in
// flight per round, as a warp runs them.  Returns the rounds in which the
// lanes still in flight sat at different samples.
template <bool G, bool D, bool RECORD>
long flat_lockstep(const Scene& S, int n, const float* origin, const float* direction,
                   const uint32_t* rng_in, float* radiance, uint32_t* rng_out, int* steps,
                   int* words, int spp, int num_bounces) {
  long mixed = 0;
  for (int base = 0; base < n; base += kWarp) {
    const int m = n - base < kWarp ? n - base : kWarp;
    Lane lanes[kWarp];
    bool flying[kWarp];
    int left = 0;
    for (int k = 0; k < m; ++k) {
      const int q = base + k;
      float t0;
      int prim0;
      primary_hit(S, origin + 3 * q, direction + 3 * q, t0, prim0);
      const Rng rng{rng_in[4 * q], rng_in[4 * q + 1], rng_in[4 * q + 2], rng_in[4 * q + 3]};
      flying[k] = lane_start<RECORD>(lanes[k], origin + 3 * q, direction + 3 * q, t0, prim0,
                                     rng, spp, num_bounces, RECORD ? words + q : nullptr, n);
      left += flying[k];
    }
    while (left > 0) {
      int lo = spp, hi = -1;
      for (int k = 0; k < m; ++k) {
        if (!flying[k]) continue;
        flying[k] = lane_step<G, D, RECORD>(S, lanes[k], spp, num_bounces,
                                            RECORD ? words + base + k : nullptr, n);
        if (flying[k]) {
          lo = lanes[k].s < lo ? lanes[k].s : lo;
          hi = lanes[k].s > hi ? lanes[k].s : hi;
        } else {
          --left;
        }
      }
      mixed += lo < hi;
    }
    for (int k = 0; k < m; ++k)
      store(base + k, lanes[k].acc, lanes[k].rng, lanes[k].steps, radiance, rng_out, steps);
  }
  return mixed;
}

template <bool G, bool D>
long run(int flat, int record, const Scene& S, int n, const float* origin,
         const float* direction, const uint32_t* rng_in, float* radiance, uint32_t* rng_out,
         int* steps, int* words, int spp, int num_bounces) {
  if (flat && record)
    return flat_lockstep<G, D, true>(S, n, origin, direction, rng_in, radiance, rng_out,
                                     steps, words, spp, num_bounces);
  if (flat)
    return flat_lockstep<G, D, false>(S, n, origin, direction, rng_in, radiance, rng_out,
                                      steps, words, spp, num_bounces);
  if (record)
    nested_all<G, D, true>(S, n, origin, direction, rng_in, radiance, rng_out, steps, words,
                           spp, num_bounces);
  else
    nested_all<G, D, false>(S, n, origin, direction, rng_in, radiance, rng_out, steps,
                            words, spp, num_bounces);
  return 0;
}

}  // namespace

// Every pixel in raster order (lane i is pixel i) through the flat loop in
// lockstep (flat != 0; returns its mixed rounds) or through the nested
// oracle (returns 0): radiance, rng, live bounces and, with words non-null,
// the residual words [spp * num_bounces, n] (a word past the bounce where
// its path ended is left as the caller filled it).
extern "C" long hpt_nee_loop_host(
    const float* fold, const float* payload, const float* lights, int ns, int np, int nb,
    int nt, int nl, int flat, const float* origin, const float* direction,
    const uint32_t* rng_in, float* radiance, uint32_t* rng_out, int* steps, int* words,
    int n, int spp, int num_bounces, int has_glossy, int has_diel) {
  const Scene S{fold, payload, lights, ns, np, nb, nt, nl};
  const int record = words != nullptr;
  if (has_glossy && has_diel)
    return run<true, true>(flat, record, S, n, origin, direction, rng_in, radiance, rng_out,
                           steps, words, spp, num_bounces);
  if (has_glossy)
    return run<true, false>(flat, record, S, n, origin, direction, rng_in, radiance, rng_out,
                            steps, words, spp, num_bounces);
  if (has_diel)
    return run<false, true>(flat, record, S, n, origin, direction, rng_in, radiance, rng_out,
                            steps, words, spp, num_bounces);
  return run<false, false>(flat, record, S, n, origin, direction, rng_in, radiance, rng_out,
                           steps, words, spp, num_bounces);
}
