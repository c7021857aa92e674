// Host harness for the sphere-table folds' per-ray code: compiles
// haskell_path_tracer_torch/csrc/sphere_fold.cuh with a plain C++ compiler,
// so tests/test_torch_sphere_fold_host.py can run the kernels' R-ray fold,
// over the table in tiles of any size, on a machine without a GPU and hold
// it against the plain PyTorch versions and against the NEE megakernel's
// per-ray fold (nee.cuh:fold).  A test tool only: nothing in the package
// calls it.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I haskell_path_tracer_torch/csrc -o libsphere_fold_host.so
//       sphere_fold_host.cpp

#include <vector>

#include "sphere_fold.cuh"

using namespace hpt;

namespace {

// The kernel's work: the rays (the dual fold's live lanes, in index order)
// in groups of R, the last group's empty slots folding its first ray and
// storing nothing; each group over the table in tiles of tile_rows rows,
// each tile copied into a buffer as the kernel stages it in shared memory.
template <int R, bool DUAL>
void fold_all(const float* table, int num_spheres, int tile_rows, const float* ray_o,
              const float* ray_d, const float* d_shadow, const float* t_light,
              const int* light_idx, const int* alive, float eps, float* t, int* prim,
              int* occ, int num_rays) {
  std::vector<int> rays;
  for (int i = 0; i < num_rays; ++i) {
    if (DUAL && alive[i] == 0) {
      t[i] = kInfinite;
      prim[i] = 0;
      occ[i] = 0;
    } else {
      rays.push_back(i);
    }
  }
  std::vector<float> tile(4 * (size_t)tile_rows);
  const int n = (int)rays.size();
  for (int first = 0; first < n; first += R) {
    sphere_fold::Lanes<R, DUAL> L;
    for (int r = 0; r < R; ++r)
      L.load(r, rays[first + r < n ? first + r : first], ray_o, ray_d, d_shadow, t_light,
             light_idx);
    for (int base = 0; base < num_spheres; base += tile_rows) {
      const int rows = num_spheres - base < tile_rows ? num_spheres - base : tile_rows;
      for (int j = 0; j < 4 * rows; ++j) tile[j] = table[4 * base + j];
      sphere_fold::fold_rows<R, DUAL>(tile.data(), base, rows, eps, L);
    }
    for (int r = 0; r < R && first + r < n; ++r) {
      const int i = rays[first + r];
      t[i] = L.t[r];
      prim[i] = L.prim[r];
      if (DUAL) occ[i] = L.occ[r] ? 1 : 0;
    }
  }
}

template <int R>
void fold_r(int dual, const float* table, int num_spheres, int tile_rows, const float* ray_o,
            const float* ray_d, const float* d_shadow, const float* t_light,
            const int* light_idx, const int* alive, float eps, float* t, int* prim, int* occ,
            int num_rays) {
  if (dual)
    fold_all<R, true>(table, num_spheres, tile_rows, ray_o, ray_d, d_shadow, t_light,
                      light_idx, alive, eps, t, prim, occ, num_rays);
  else
    fold_all<R, false>(table, num_spheres, tile_rows, ray_o, ray_d, d_shadow, t_light,
                       light_idx, alive, eps, t, prim, occ, num_rays);
}

}  // namespace

// The tiled R-ray fold (R = 1, 2 or 4): the nearest fold (dual = 0; the
// shadow operands, alive and occ unused) or the dual fold.
extern "C" void hpt_sphere_fold_host(int rays_per_thread, int dual, const float* table,
                                     int num_spheres, int tile_rows, const float* ray_o,
                                     const float* ray_d, const float* d_shadow,
                                     const float* t_light, const int* light_idx,
                                     const int* alive, float eps, float* t, int* prim,
                                     int* occ, int num_rays) {
  if (rays_per_thread == 4)
    fold_r<4>(dual, table, num_spheres, tile_rows, ray_o, ray_d, d_shadow, t_light, light_idx,
              alive, eps, t, prim, occ, num_rays);
  else if (rays_per_thread == 2)
    fold_r<2>(dual, table, num_spheres, tile_rows, ray_o, ray_d, d_shadow, t_light, light_idx,
              alive, eps, t, prim, occ, num_rays);
  else
    fold_r<1>(dual, table, num_spheres, tile_rows, ray_o, ray_d, d_shadow, t_light, light_idx,
              alive, eps, t, prim, occ, num_rays);
}

// The NEE megakernel's per-ray fold on a table of spheres alone, ray by ray:
// nee::fold<false> (dual = 0) or nee::fold<true>, dead lanes (INFINITE, 0, 0).
extern "C" void hpt_nee_sphere_fold_host(int dual, const float* table, int num_spheres,
                                         const float* ray_o, const float* ray_d,
                                         const float* d_shadow, const float* t_light,
                                         const int* light_idx, const int* alive, float eps,
                                         float* t, int* prim, int* occ, int num_rays) {
  const nee::Scene S{table, nullptr, nullptr, num_spheres, 0, 0, 0, 0};
  for (int i = 0; i < num_rays; ++i) {
    bool o = false;
    if (!dual) {
      nee::fold<false>(S, ray_o + 3 * i, ray_d + 3 * i, eps, t[i], prim[i], nullptr, 0.0f, -1,
                       o);
      continue;
    }
    if (alive[i] == 0) {
      t[i] = kInfinite;
      prim[i] = 0;
    } else {
      nee::fold<true>(S, ray_o + 3 * i, ray_d + 3 * i, eps, t[i], prim[i], d_shadow + 3 * i,
                      t_light[i], light_idx[i], o);
    }
    occ[i] = o ? 1 : 0;
  }
}
