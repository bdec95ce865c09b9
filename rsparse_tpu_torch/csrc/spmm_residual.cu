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

// rowfac (n_fac, k) f32; scale (k,) f32 or null; table (n_cols, k) f32 or
// bf16 (table_bf16 = 1).  Outputs, each optional (null): proj (n_rows, k)
// f32, zeroed by the caller; approx (B, L) f32, zeroed; sq_part
// (rsp_spmm_residual_parts(B, L, k, aligned),) f32, zeroed.  The kernel
// body is in spmm_common.cuh (kResidual = true).
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
  return rsp_sp::dispatch<true>(row_ids, col, val, nnz, rowfac, scale, n_fac,
                                table, table_bf16, aligned, B, L, k, n_rows,
                                proj, approx, sq_part, (cudaStream_t)stream);
}

// Length of the sq_part buffer of one bucket: one float per block.
extern "C" int rsp_spmm_residual_parts(int B, int L, int k, int aligned) {
  if (B <= 0 || L <= 0 || k <= 0 || k > rsp_sp::kMaxK) return 0;
  return B * rsp_sp::make_shape(L, k, aligned != 0).n_chunks;
}
