// The primary-hit probe's per-ray work (nee_megakernel.cu:probe_kernel):
// a camera ray's nearest (t0, prim0) over spheres, planes, boxes and
// triangles, eps = 0, strict `<` so the lowest index wins ties, (INFINITE,
// 0) on a miss: `nee::primary_hit`'s decisions bit for bit, taken in two
// parts so that the kernel can stream the sphere rows through shared
// memory in index-ordered tiles, R rays per thread:
//   1. sphere_fold::fold_rows<R, false> at eps = 0 over the sphere rows,
//      tile after tile (on a table of spheres alone it takes
//      `nee::fold`'s decisions: the near root only, accepted at t >= 0);
//   2. `fold_tails` over the planes, boxes and triangles.
//
// HPT_HD makes every function callable on the host too, so
// tests/test_torch_nee_host.py runs the probe's fold with g++ against
// `nee::primary_hit`.

#pragma once

#include "sphere_fold.cuh"

namespace hpt {
namespace probe {

// The rows after the spheres, folded into the running (best_t, best_p) of
// the sphere rows: a copy of `nee::fold<false>`'s tail at eps = 0, which
// must keep its order (planes, boxes, then triangles), its tests and its
// strict `<`.  The tables are small (the reference scene has 7 rows), so
// the kernel reads them through the L1 cache.
HPT_HD void fold_tails(const nee::Scene& S, const float* o, const float* d, float& best_t,
                       int& best_p) {
  int base = S.ns;
  for (int j = 0; j < S.np; ++j) {
    const float t = nee::plane_dist(S.plane(j), o, d, 0.0f);
    if (t < best_t) { best_t = t; best_p = base + j; }
  }
  base += S.np;
  for (int k = 0; k < S.nb; ++k) {
    const float t = nee::box_dist(S.box(k), o, d, 0.0f);
    if (t < best_t) { best_t = t; best_p = base + k; }
  }
  base += S.nb;
  for (int k = 0; k < S.nt; ++k) {
    const float* g = S.tri(k);
    const float tv[3] = {o[0] - g[0], o[1] - g[1], o[2] - g[2]};
    const float t = nee::tri_dist(g, tv, d, 0.0f);
    if (t < best_t) { best_t = t; best_p = base + k; }
  }
}

}  // namespace probe
}  // namespace hpt
