// What the bucketed sparse-dense kernels K5 (spmm.cu) and K6
// (spmm_residual.cu) share: the gather of a table row as f32 or bf16, bf16
// rounding, the sum of a block's partial rows, and the thread layout over
// one bucket row (make_shape).
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

constexpr int kMaxThreads = 256;
constexpr int kEntriesPerGroup = 16;  // a chunk is G * 16 entries
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

// Sum over the tpe threads of a group (tpe a power of two <= 32).  Every
// lane of the warp must call it: groups never straddle a warp, and the
// callers keep their loops uniform across the block.
__device__ __forceinline__ float group_sum(float v, int tpe) {
  for (int o = tpe >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, tpe);
  return v;
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

// Launch shape of one bucket: entries per group, threads, chunk length.
struct Shape {
  int vec, tpe, nv, groups, chunk, n_chunks;
};

inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// vec: 4 when every row starts 16-byte aligned (f32) / 8-byte (bf16), else 1
inline Shape make_shape(int L, int k, bool aligned) {
  Shape s;
  s.vec = (k % 4 == 0 && aligned) ? 4 : 1;
  const int nvec = k / s.vec + (k % s.vec != 0);
  s.tpe = pow2_ceil(nvec) < 32 ? pow2_ceil(nvec) : 32;
  s.nv = pow2_ceil((nvec + s.tpe - 1) / s.tpe);
  int g = pow2_ceil(L);
  if (g < 32 / s.tpe) g = 32 / s.tpe;
  if (g > kMaxThreads / s.tpe) g = kMaxThreads / s.tpe;
  s.groups = g;
  s.chunk = g * kEntriesPerGroup;
  s.n_chunks = (L + s.chunk - 1) / s.chunk;
  return s;
}

}  // namespace rsp_sp
