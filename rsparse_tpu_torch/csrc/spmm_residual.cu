// K6: fused soft-impute residual: SDDMM + squared norm + SpMM in one pass.
//
// Replaces the TPU program rsparse_tpu/ops/spmm.py:81 spmm_residual_buckets
// and, in its approx-only mode, :59 sparse_approx_buckets (through :117
// residual_values).  Its plain PyTorch version is
// rsparse_tpu_torch/ops/spmm.py _residual_plain.
//
// For entry (b, l < nnz[b]) of a bucket, with lf = rowfac[min(row_ids[b],
// n_fac - 1)] * scale and cf = colfac[col[b, l]]:
//   a = lf . cf                       (the low-rank product at the entry)
//   delta = val[b, l] - a
//   sq += delta^2                     (one partial per block, f32)
//   proj[row_ids[b]] += delta * cf    (skipped without proj)
// and approx[b, l] = a when approx is given (0 stays at padding entries).
// With a bf16 colfac shadow (compute_dtype="bfloat16") lf and delta are
// rounded to bf16 before they multiply cf, as the reference casts them to
// the gather dtype (spmm.py:105, :111); the products are exact in f32 and
// every sum is f32.
//
// What bounds it on the H100: the gather of cf, r * 4 bytes (r * 2 in bf16)
// per entry, as in K5; the table fits in L2 at the soft-impute shapes
// (32,768 x 256 f32 = 32 MB), so the reads are L2 hits.  The arithmetic is
// 4 flops per gathered value: still far below the card's f32 rate.
//
// What the design does about it: cf is gathered once per entry and serves
// both the dot product and the SpMM (the plain version gathers the
// (B, L, r) block, keeps it, and reads it twice); lf is read once per
// block.  The dot product of an entry is a shuffle sum over the tpe
// threads that hold its columns.  Long rows are cut into chunks, one block
// each, as in K5, and combined with atomicAdd into the zeroed proj: rows
// longer than one chunk agree with the plain version to f32 rounding
// (1e-5 relative), not bit for bit.  The squared norm is one partial per
// block, summed by one torch reduction: deterministic.

#include "spmm_common.cuh"

namespace rsp_sp {
namespace {

// One block takes one chunk of one row: entries [c * chunk, (c + 1) *
// chunk) of row blockIdx.x, chunk blockIdx.y (make_shape).  For entry
// (b, l < nnz[b]) with cf = table[col[b, l]]: lf = rowfac[min(row_ids[b],
// n_fac - 1)] * scale, a = lf . cf, delta = val[b, l] - a, sq += delta^2,
// approx[b, l] = a, proj[row_ids[b]] += delta * cf (proj may be null).
// With a bf16 table, lf and the delta that multiplies cf are rounded to
// bf16.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
residual_kernel(const int* __restrict__ row_ids, const int* __restrict__ col,
                const float* __restrict__ val, const int* __restrict__ nnz,
                const float* __restrict__ rowfac,
                const float* __restrict__ scale, int n_fac,
                const T* __restrict__ table, int L, int k, int n_rows, int tpe,
                int chunk, float* __restrict__ proj,
                float* __restrict__ approx, float* __restrict__ sq_part) {
  extern __shared__ float red[];  // G * k floats, then 32 for block_sum
  const int b = blockIdx.x;
  const int n = nnz[b], row = row_ids[b];
  const int start = blockIdx.y * chunk;
  if (start >= n) return;  // uniform over the block; sq_part stays 0
  const int end = min(n, start + chunk);
  const int t = threadIdx.x % tpe, g = threadIdx.x / tpe;
  const int G = blockDim.x / tpe;
  constexpr bool kBf16 = sizeof(T) == 2;

  // this thread's columns of lf = rowfac[row] * scale
  float lf[NV * VEC];
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

  float acc[NV * VEC];
#pragma unroll
  for (int i = 0; i < NV * VEC; ++i) acc[i] = 0.f;
  float sq = 0.f;
  // the loop runs the same trips on every thread (group_sum shuffles)
  for (int l0 = start; l0 < end; l0 += G) {
    const int l = l0 + g;
    const bool live = l < end;
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
#pragma unroll
      for (int q = 0; q < VEC; ++q) dot += lf[m * VEC + q] * cf[m * VEC + q];
    }
    dot = group_sum(dot, tpe);
    if (live) {
      const float delta = val[e] - dot;
      if (t == 0) {
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
  if (sq_part != nullptr) {
    const float s = rsp::block_sum(sq, red + G * k);
    if (threadIdx.x == 0) sq_part[(size_t)blockIdx.y * gridDim.x + b] = s;
  }
  if (proj != nullptr && row < n_rows)
    reduce_row<VEC, NV>(acc, red, k, tpe, proj + (size_t)row * k,
                        gridDim.y > 1);
}

template <typename T, int VEC, int NV>
int launch(const int* row_ids, const int* col, const float* val,
           const int* nnz, const float* rowfac, const float* scale,
           int n_fac, const void* table, int B, int L, int k, int n_rows,
           const Shape& s, float* proj, float* approx, float* sq_part,
           cudaStream_t stream) {
  const dim3 grid(B, s.n_chunks);
  const size_t smem = ((size_t)s.groups * k + 32) * sizeof(float);
  residual_kernel<T, VEC, NV><<<grid, s.tpe * s.groups, smem, stream>>>(
      row_ids, col, val, nnz, rowfac, scale, n_fac,
      static_cast<const T*>(table), L, k, n_rows, s.tpe, s.chunk, proj,
      approx, sq_part);
  return (int)cudaGetLastError();
}

// The launch of one bucket: the table's element type from table_bf16, the
// vector width and vectors per thread from the shape.
int dispatch(const int* row_ids, const int* col, const float* val,
             const int* nnz, const float* rowfac, const float* scale,
             int n_fac, const void* table, int table_bf16, int aligned, int B,
             int L, int k, int n_rows, float* proj, float* approx,
             float* sq_part, cudaStream_t stream) {
  const Shape s = make_shape(L, k, aligned != 0);
#define RSP_SD_CASE(T, V, N)                                                 \
  if (s.vec == V && s.nv == N)                                               \
    return launch<T, V, N>(row_ids, col, val, nnz, rowfac, scale, n_fac,    \
                           table, B, L, k, n_rows, s, proj, approx, sq_part, \
                           stream);
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

// rowfac (n_fac, k) f32; scale (k,) f32 or null; table (n_cols, k) f32 or
// bf16 (table_bf16 = 1).  Outputs, each optional (null): proj (n_rows, k)
// f32, zeroed by the caller; approx (B, L) f32, zeroed; sq_part
// (rsp_spmm_residual_parts(B, L, k, aligned),) f32, zeroed.
extern "C" int rsp_spmm_residual(const int* row_ids, const int* col,
                                 const float* val, const int* nnz,
                                 const float* rowfac, const float* scale,
                                 int n_fac, const void* table, int table_bf16,
                                 int aligned, int B, int L, int k, int n_rows,
                                 float* proj, float* approx, float* sq_part,
                                 void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || k <= 0 || k > rsp_sp::kMaxK || n_fac <= 0)
    return (int)cudaErrorInvalidValue;
  return rsp_sp::dispatch(row_ids, col, val, nnz, rowfac, scale, n_fac,
                          table, table_bf16, aligned, B, L, k, n_rows, proj,
                          approx, sq_part, (cudaStream_t)stream);
}

// Length of the sq_part buffer of one bucket: one float per block.
extern "C" int rsp_spmm_residual_parts(int B, int L, int k, int aligned) {
  if (B <= 0 || L <= 0 || k <= 0 || k > rsp_sp::kMaxK) return 0;
  return B * rsp_sp::make_shape(L, k, aligned != 0).n_chunks;
}
