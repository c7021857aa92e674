// The per-ray work of the sphere-table folds (sphere_fold.cu): R rays fold
// one run of table rows at a time, each row read once for all R.
//
// Each ray's f32 sequence is nee.cuh's: `sphere_root`'s parts for the
// nearest sphere (accepting h >= 0 and t >= eps, strict `<` so the lowest
// index wins ties) and, for the dual query, `sphere_blocks`' halves for the
// shadow ray, the sphere `lgi` excluded.  Rows come in index order, run after run, so a
// fold over any split of the table into runs takes the decisions of one
// pass over it (`nee::fold` on a table of spheres alone).
//
// HPT_HD makes every function callable on the host too, so
// tests/test_torch_sphere_fold_host.py runs the fold with g++.

#pragma once

#include "nee.cuh"

namespace hpt {
namespace sphere_fold {

// R rays' operands and running results.  The shadow fields are read only
// by the dual query (SHADOW).
template <int R, bool SHADOW>
struct Lanes {
  float o[R][3], d[R][3];
  float t[R];
  int prim[R];
  float b[R][3], t_l[R];
  int lgi[R];
  bool occ[R];

  // Slot r takes ray i; every slot starts at (INFINITE, 0, false).
  HPT_HD void load(int r, int i, const float* ray_o, const float* ray_d,
                   const float* d_shadow, const float* t_light, const int* light_idx) {
    for (int k = 0; k < 3; ++k) {
      o[r][k] = ray_o[3 * i + k];
      d[r][k] = ray_d[3 * i + k];
    }
    t[r] = kInfinite;
    prim[r] = 0;
    occ[r] = false;
    if (SHADOW) {
      for (int k = 0; k < 3; ++k) b[r][k] = d_shadow[3 * i + k];
      t_l[r] = t_light[i];
      lgi[r] = light_idx[i];
    }
  }
};

// Folds the rows [base, base + n) of the sphere table, row p at
// rows + 4 * (p - base) (center, r^2), into the R rays of L.  Every row
// costs the discriminants alone (h of the ray, and h2 of the shadow ray);
// the square root, the compares and the shadow test's tail run in one rare
// branch, where either line meets the sphere (h >= 0 or h2 >= 0).
template <int R, bool SHADOW>
HPT_HD void fold_rows(const float* rows, int base, int n, float eps, Lanes<R, SHADOW>& L) {
#if defined(__CUDA_ARCH__)
#pragma unroll 2
#endif
  for (int j = 0; j < n; ++j) {
    float g[4];
    nee::load4(rows + 4 * j, g);
    const int p = base + j;
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int r = 0; r < R; ++r) {
      float l[3], ll, tca2 = 0.0f;
      const float tca = nee::sphere_tca(g, L.o[r], L.d[r], l);
      const float h = nee::sphere_h(g, l, tca, ll);
      const float h2 = SHADOW ? nee::sphere_shadow_h(g, l, ll, L.b[r], tca2) : -1.0f;
      if (h >= 0.0f || h2 >= 0.0f) {
        if (h >= 0.0f) {
          const float t = nee::sphere_near(tca, h);
          // tca >= eps is implied: t >= eps with thc > 0.
          if (t >= eps && t < L.t[r]) {
            L.t[r] = t;
            L.prim[r] = p;
          }
        }
        if (SHADOW) {
          const bool blocks = nee::sphere_blocks_from(tca2, h2, L.t_l[r]);
          L.occ[r] = L.occ[r] || (blocks && p != L.lgi[r]);
        }
      }
    }
  }
}

}  // namespace sphere_fold
}  // namespace hpt
