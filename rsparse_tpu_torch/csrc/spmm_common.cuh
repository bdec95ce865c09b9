// What the bucketed sparse-dense kernels K5 (spmm.cu) and K6
// (spmm_residual.cu) share: the buckets of a launch, the gather of a table
// row as f32 or bf16, bf16 rounding, the sum of a block's partial rows, and
// the thread layout over one row (make_shape).
//
// Layout.  A bucket is B rows padded to L entries (col, val: (B, L); row b
// holds nnz[b] entries; padding rows carry row_id == n_rows and nnz 0).  A
// block's threads form G groups of tpe threads; a group takes one entry at
// a time, and thread t of the group holds the table columns
// (t + m * tpe) * VEC + e, m < NV, e < VEC, so a gathered row is read as
// VEC-wide loads, neighbouring threads on neighbouring addresses.  At the
// end the G groups' partial rows are summed in shared memory in a fixed
// order (reduce_row), and the row is stored, or added with atomicAdd when
// the row spans several blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace rsp_sp {

constexpr int kThreads = 256;  // ops/spmm.py ROW_THREADS
constexpr int kMaxK = 512;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC consecutive table values, widened to f32 (bf16 -> f32 is exact).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out);

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float* out) {
  out[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float* out) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* out) {
  const unsigned short v = __ldg(reinterpret_cast<const unsigned short*>(p));
  out[0] = __uint_as_float(static_cast<unsigned>(v) << 16);
}

// The lanes of this thread's group of tpe threads (tpe a power of two <=
// 32; groups never straddle a warp), for shuffles within the group alone.
__device__ __forceinline__ unsigned group_mask(int tpe) {
  return tpe == 32 ? 0xffffffffu
                   : ((1u << tpe) - 1u) << ((threadIdx.x & 31) & ~(tpe - 1));
}

// Sum the G groups' partial rows (acc, NV * VEC columns per thread) in
// shared memory `red` (G * k floats) and write row `row` of `out`: a store,
// or atomicAdd when the row spans several blocks.  Called by every thread.
template <int VEC, int NV>
__device__ __forceinline__ void reduce_row(const float* acc, float* red,
                                           int k, int tpe, float* out_row,
                                           bool atomic) {
  const int t = threadIdx.x % tpe, g = threadIdx.x / tpe;
  const int G = blockDim.x / tpe;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int j0 = (t + m * tpe) * VEC;
    if (j0 < k) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[g * k + j0 + e] = acc[m * VEC + e];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int h = 0; h < G; ++h) s += red[h * k + j];
    if (atomic)
      atomicAdd(out_row + j, s);
    else
      out_row[j] = s;
  }
}

// The buckets of one launch over a work list (ops/spmm.py row_layout),
// passed by value: a block reads its bucket's pointers from the constant
// bank, not through a load from memory.
constexpr int kMaxBuckets = 64;  // ops/spmm.py ROW_MAX_BUCKETS
struct Buckets {
  const int* col[kMaxBuckets];
  const float* val[kMaxBuckets];
  const int* row_ids[kMaxBuckets];
  const int* nnz[kMaxBuckets];
  long long L[kMaxBuckets];
};

// From the host array of n x 5 int64 (col, val, row_ids, nnz device
// pointers, L) the wrappers pass; n <= kMaxBuckets.
inline Buckets unpack_buckets(const long long* buckets, int n) {
  Buckets bk = {};
  for (int i = 0; i < n; ++i) {
    const long long* b = buckets + 5 * i;
    bk.col[i] = reinterpret_cast<const int*>(b[0]);
    bk.val[i] = reinterpret_cast<const float*>(b[1]);
    bk.row_ids[i] = reinterpret_cast<const int*>(b[2]);
    bk.nnz[i] = reinterpret_cast<const int*>(b[3]);
    bk.L[i] = b[4];
  }
  return bk;
}

// Thread layout over a row of k columns: groups of tpe threads, each
// thread nv vectors of vec columns (the same arithmetic as ops/spmm.py
// row_shape).
struct Shape {
  int vec, tpe, nv;
};

inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// vec: 4 when every row starts 16-byte aligned (f32) / 8-byte (bf16), else 1
inline Shape make_shape(int k, bool aligned) {
  Shape s;
  s.vec = (k % 4 == 0 && aligned) ? 4 : 1;
  const int nvec = k / s.vec + (k % s.vec != 0);
  s.tpe = pow2_ceil(nvec) < 32 ? pow2_ceil(nvec) : 32;
  s.nv = pow2_ceil((nvec + s.tpe - 1) / s.tpe);
  return s;
}

}  // namespace rsp_sp
