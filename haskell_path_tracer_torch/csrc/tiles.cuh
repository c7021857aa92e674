// A table of 16-byte rows streamed through shared memory in index-ordered
// tiles, double-buffered with cp.async: the sphere folds (sphere_fold.cu)
// and the primary-hit probe (nee_megakernel.cu) read their sphere rows so.
//
// CUDA only: the host harnesses (tests/*_host.cpp) compile the per-ray
// headers with g++ and never include this one.

#pragma once

#include <cuda_runtime.h>

namespace hpt {
namespace tiles {

constexpr int kTileRows = 1024;
// Two tiles, 32 KB, the most dynamic shared memory a block takes: under
// the 48 KB a launch may take without raising the kernel's limit.
static_assert(2 * kTileRows * sizeof(float4) <= 48 * 1024, "two tiles exceed 48 KB");

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile k of the table (rows [k kTileRows, ...)) into buffer k & 1, by the
// THREADS threads of the block.
template <int THREADS>
__device__ __forceinline__ void issue_tile(const float4* rows, int num_rows, int k,
                                           float4* smem) {
  const int base = k * kTileRows;
  const int n = min(kTileRows, num_rows - base);
  float4* dst = smem + (k & 1) * kTileRows;
  for (int j = threadIdx.x; j < n; j += THREADS) copy16_async(dst + j, rows + base + j);
  commit_async();
}

// Shared memory for a table of num_rows rows: all of it in one tile, else
// two tiles.
inline size_t table_smem(int num_rows) {
  return sizeof(float4) * (num_rows <= kTileRows ? (size_t)num_rows : 2 * (size_t)kTileRows);
}

// The current device's SM count, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace tiles
}  // namespace hpt
