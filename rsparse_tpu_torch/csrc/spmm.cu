// K5: bucketed sparse x dense product.
//
// Replaces the TPU program rsparse_tpu/ops/spmm.py:35 spmm_buckets (the
// gather dense[col_idx] (B, L, k), the masked einsum "bl,blk->bk" and the
// scatter-add into out[row_ids]).  Its plain PyTorch version is
// rsparse_tpu_torch/ops/spmm.py _spmm_plain.
//
// For each row b of a bucket, out[row_ids[b]] = sum over l < nnz[b] of
// val[b, l] * table[col[b, l], :], summed in f32.  The table is f32 or the
// bf16 shadow of compute_dtype="bfloat16"; then val is rounded to bf16 too,
// as the reference casts it to the gather dtype (spmm.py:53), and every
// product of two bf16 values is exact in f32.  Padding rows (row_id ==
// n_rows) write nothing.
//
// What bounds it on the H100: the gather.  Each entry reads one table row
// (k * 4 or k * 2 bytes) at a random column; the table itself (32,768 x 256
// f32 = 32 MB at the LinearFlow shape) fits in the 50 MB L2, so the reads
// are L2 hits after first touch and the arithmetic is 2 flops per loaded
// value.  The bound over device memory (each input byte once) is far below
// what the L2 gather rate allows.
//
// What the design does about it: no (B, L, k) intermediate (the plain
// version materialises it and reads it back); one pass over the entries
// with the row's columns spread over the lanes as 16-byte loads (8-byte for
// bf16); long rows (the most popular items: 8 rows x 41,280 entries in the
// transposed ML-20M-shaped matrix) are cut into chunks of G * 16 entries,
// one block each, combined with atomicAdd into the zeroed output, so the
// whole card works on them.  The order of those atomic adds varies from
// run to run: rows longer than one chunk agree with the plain version to
// f32 rounding (1e-5 relative), not bit for bit.

#include "spmm_common.cuh"

// out (n_rows, k) f32, zeroed by the caller; table (n_cols, k) f32 or bf16
// (table_bf16 = 1); val (B, L) f32.  aligned: the table's base address is
// 16-byte aligned.  The kernel body is K6's with kResidual = false
// (spmm_common.cuh).
extern "C" int rsp_spmm(const int* row_ids, const int* col, const float* val,
                        const int* nnz, const void* table, int table_bf16,
                        int aligned, int B, int L, int k, int n_rows,
                        float* out, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || k <= 0 || k > rsp_sp::kMaxK) return (int)cudaErrorInvalidValue;
  return rsp_sp::dispatch<false>(row_ids, col, val, nnz, nullptr, nullptr, 0,
                                 table, table_bf16, aligned, B, L, k, n_rows,
                                 out, nullptr, nullptr, (cudaStream_t)stream);
}
