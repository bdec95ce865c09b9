// Shared device helpers of the ALS kernels (als_cg.cu, als_chol.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RSP_FULL_MASK 0xffffffffu

namespace rsp {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(RSP_FULL_MASK, v, o);
  return v;
}

// Sum of `v` over the block; every thread gets the total.  `scratch` holds
// at least 32 floats.  Contains two __syncthreads, so every thread calls it.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < n_warps ? scratch[lane] : 0.f);
}

// The entries of one target row: its cold (bucketed) entries, `nnz` source
// rows `table[col[l]]` with confidences `val[l]`, and optionally its dense
// zipf-head entries, source rows `hot_table[h]` with confidence `w[h]`
// (0 = absent).  Rows are `d` floats.
struct RowEntries {
  const float* table;
  const int* col;
  const float* val;
  int nnz;
  const float* hot_table;
  const float* w;  // nullptr: no dense head
  int H;
  int d;
};

// Calls f(row_ptr, c) once per entry of the row, with all 32 lanes of the
// calling warp; the entries are dealt to the block's `n_warps` warps in
// chunks of 32.  Absent head entries (w == 0) are skipped, as they add
// nothing to the rhs, the matvec or the loss.
template <class F>
__device__ __forceinline__ void for_each_entry(const RowEntries& R, int warp,
                                               int n_warps, F&& f) {
  const int lane = threadIdx.x & 31;
  for (int base = warp * 32; base < R.nnz; base += n_warps * 32) {
    const int l = base + lane;
    const int my_col = l < R.nnz ? R.col[l] : 0;
    const float my_val = l < R.nnz ? R.val[l] : 0.f;
    const int cnt = min(32, R.nnz - base);
    for (int j = 0; j < cnt; ++j) {
      const int c = __shfl_sync(RSP_FULL_MASK, my_col, j);
      const float v = __shfl_sync(RSP_FULL_MASK, my_val, j);
      f(R.table + (size_t)c * R.d, v);
    }
  }
  if (R.w == nullptr) return;
  for (int base = warp * 32; base < R.H; base += n_warps * 32) {
    const int h = base + lane;
    const float my_w = h < R.H ? R.w[h] : 0.f;
    unsigned present = __ballot_sync(RSP_FULL_MASK, my_w > 0.f);
    while (present) {
      const int j = __ffs(present) - 1;
      present &= present - 1;
      const float v = __shfl_sync(RSP_FULL_MASK, my_w, j);
      f(R.hot_table + (size_t)(base + j) * R.d, v);
    }
  }
}

// Lane `lane` holds elements lane, lane + 32, ... of a d-float row.
template <int PER_LANE>
__device__ __forceinline__ void load_row(const float* row, int d,
                                         float (&r)[PER_LANE]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    const int k = lane + 32 * m;
    r[m] = k < d ? __ldg(row + k) : 0.f;
  }
}

// Dot product of a lane-distributed row with a shared-memory vector,
// summed over the warp (every lane gets it).
template <int PER_LANE>
__device__ __forceinline__ float row_dot(const float (&r)[PER_LANE],
                                         const float* vec, int d) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    const int k = lane + 32 * m;
    if (k < d) s += r[m] * vec[k];
  }
  return warp_sum(s);
}

// Per-row loss sum c (1 - g - row . y)^2 over the row's entries, summed over
// the calling warp's entries (every lane holds the warp's sum).
template <int PER_LANE>
__device__ __forceinline__ float entries_loss(const RowEntries& R, int warp,
                                              int n_warps, const float* y,
                                              float g) {
  float acc = 0.f;
  for_each_entry(R, warp, n_warps, [&](const float* row, float c) {
    float r[PER_LANE];
    load_row<PER_LANE>(row, R.d, r);
    const float base = 1.f - g - row_dot<PER_LANE>(r, y, R.d);
    acc += c * base * base;
  });
  return acc;
}

}  // namespace rsp
