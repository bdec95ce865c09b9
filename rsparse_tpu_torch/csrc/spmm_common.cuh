// The one kernel body of the bucketed sparse-dense kernels K5 (spmm.cu) and
// K6 (spmm_residual.cu), and what it is built from: the thread layout over
// one bucket row, the gather of a table row as f32 or bf16, bf16 rounding,
// and the launch shape.  K5 is the body with kResidual = false: with no left
// factor the low-rank product is 0, the residual is the value itself
// (rounded to bf16 with a bf16 table, as K5 rounds its values), and only
// the SpMM output is written.
//
// Layout.  A bucket is B rows padded to L entries (col, val: (B, L); row b
// holds nnz[b] entries; padding rows carry row_id == n_rows and nnz 0).  A
// block takes one chunk of one row: entries [c * chunk, (c + 1) * chunk) of
// row blockIdx.x, chunk blockIdx.y.  Its threads form G groups of tpe
// threads; a group takes one entry at a time (entries g, g + G, ...), and
// thread t of the group holds the table columns (t + m * tpe) * VEC + e,
// m < NV, e < VEC, so a gathered row is read as VEC-wide loads, neighbouring
// threads on neighbouring addresses.  At the end the G groups' partial rows
// are summed in shared memory in a fixed order, and the row is stored, or
// added with atomicAdd when the row spans several chunks (several blocks).
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

namespace {  // each source instantiates its own cases

// For entry (b, l < nnz[b]) with cf = table[col[b, l]]:
//   K6: lf = rowfac[min(row_ids[b], n_fac - 1)] * scale, a = lf . cf,
//       delta = val[b, l] - a, sq += delta^2, approx[b, l] = a;
//   K5: delta = val[b, l];
//   both: proj[row_ids[b]] += delta * cf (proj may be null in K6).
// With a bf16 table, lf and the delta that multiplies cf are rounded to
// bf16.  See spmm_residual.cu for the outputs' layout.
template <bool kResidual, typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
sparse_dense_kernel(const int* __restrict__ row_ids,
                    const int* __restrict__ col,
                    const float* __restrict__ val,
                    const int* __restrict__ nnz,
                    const float* __restrict__ rowfac,
                    const float* __restrict__ scale, int n_fac,
                    const T* __restrict__ table, int L, int k, int n_rows,
                    int tpe, int chunk, float* __restrict__ proj,
                    float* __restrict__ approx, float* __restrict__ sq_part) {
  extern __shared__ float red[];  // G * k floats, then 32 for block_sum
  const int b = blockIdx.x;
  const int n = nnz[b], row = row_ids[b];
  const int start = blockIdx.y * chunk;
  if (start >= n) return;  // uniform over the block; sq_part stays 0
  if (!kResidual && row >= n_rows) return;
  const int end = min(n, start + chunk);
  const int t = threadIdx.x % tpe, g = threadIdx.x / tpe;
  const int G = blockDim.x / tpe;
  constexpr bool kBf16 = sizeof(T) == 2;

  // this thread's columns of lf = rowfac[row] * scale
  float lf[NV * VEC];
  if constexpr (kResidual) {
    const float* frow = rowfac + (size_t)min(row, n_fac - 1) * k;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int j0 = (t + m * tpe) * VEC;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        float x = 0.f;
        if (j0 < k) {
          x = frow[j0 + q];
          if (scale != nullptr) x *= scale[j0 + q];
          if (kBf16) x = bf16_round(x);
        }
        lf[m * VEC + q] = x;
      }
    }
  }

  float acc[NV * VEC];
#pragma unroll
  for (int i = 0; i < NV * VEC; ++i) acc[i] = 0.f;
  float sq = 0.f;
  // K6's loop runs the same trips on every thread (group_sum shuffles);
  // K5 has no shuffle, and a thread leaves once its entries are done
  for (int l0 = start; l0 < end; l0 += G) {
    const int l = l0 + g;
    const bool live = l < end;
    if (!kResidual && !live) break;
    const size_t e = (size_t)b * L + (live ? l : start);
    const T* crow = table + (size_t)col[e] * k;
    float cf[NV * VEC];
    float dot = 0.f;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int j0 = (t + m * tpe) * VEC;
      if (j0 < k) {
        load_vec<T, VEC>(crow + j0, cf + m * VEC);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) cf[m * VEC + q] = 0.f;
      }
      if constexpr (kResidual) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) dot += lf[m * VEC + q] * cf[m * VEC + q];
      }
    }
    if constexpr (kResidual) dot = group_sum(dot, tpe);
    if (live) {
      const float delta = kResidual ? val[e] - dot : val[e];
      if (kResidual && t == 0) {
        sq += delta * delta;
        if (approx != nullptr) approx[e] = dot;
      }
      if (proj != nullptr) {
        const float du = kBf16 ? bf16_round(delta) : delta;
#pragma unroll
        for (int i = 0; i < NV * VEC; ++i) acc[i] += du * cf[i];
      }
    }
  }
  if (kResidual && sq_part != nullptr) {
    const float s = rsp::block_sum(sq, red + G * k);
    if (threadIdx.x == 0) sq_part[(size_t)blockIdx.y * gridDim.x + b] = s;
  }
  if (proj != nullptr && row < n_rows)
    reduce_row<VEC, NV>(acc, red, k, tpe, proj + (size_t)row * k,
                        gridDim.y > 1);
}

template <bool kResidual, typename T, int VEC, int NV>
int launch(const int* row_ids, const int* col, const float* val,
           const int* nnz, const float* rowfac, const float* scale,
           int n_fac, const void* table, int B, int L, int k, int n_rows,
           const Shape& s, float* proj, float* approx, float* sq_part,
           cudaStream_t stream) {
  const dim3 grid(B, s.n_chunks);
  const size_t smem = ((size_t)s.groups * k + 32) * sizeof(float);
  sparse_dense_kernel<kResidual, T, VEC, NV>
      <<<grid, s.tpe * s.groups, smem, stream>>>(
          row_ids, col, val, nnz, rowfac, scale, n_fac,
          static_cast<const T*>(table), L, k, n_rows, s.tpe, s.chunk, proj,
          approx, sq_part);
  return (int)cudaGetLastError();
}

// The launch of one bucket: the table's element type from table_bf16, the
// vector width and vectors per thread from the shape.
template <bool kResidual>
int dispatch(const int* row_ids, const int* col, const float* val,
             const int* nnz, const float* rowfac, const float* scale,
             int n_fac, const void* table, int table_bf16, int aligned, int B,
             int L, int k, int n_rows, float* proj, float* approx,
             float* sq_part, cudaStream_t stream) {
  const Shape s = make_shape(L, k, aligned != 0);
#define RSP_SD_CASE(T, V, N)                                                 \
  if (s.vec == V && s.nv == N)                                               \
    return launch<kResidual, T, V, N>(row_ids, col, val, nnz, rowfac, scale, \
                                      n_fac, table, B, L, k, n_rows, s, proj, \
                                      approx, sq_part, stream);
#define RSP_SD_CASES(T) \
  RSP_SD_CASE(T, 4, 1)  \
  RSP_SD_CASE(T, 4, 2)  \
  RSP_SD_CASE(T, 4, 4)  \
  RSP_SD_CASE(T, 1, 1)  \
  RSP_SD_CASE(T, 1, 2)  \
  RSP_SD_CASE(T, 1, 4)  \
  RSP_SD_CASE(T, 1, 8)  \
  RSP_SD_CASE(T, 1, 16)
  if (table_bf16) {
    RSP_SD_CASES(__nv_bfloat16)
  } else {
    RSP_SD_CASES(float)
  }
#undef RSP_SD_CASES
#undef RSP_SD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

}  // namespace rsp_sp
