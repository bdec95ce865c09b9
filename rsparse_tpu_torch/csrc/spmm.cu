// K5: bucketed sparse x dense product, one launch over every bucket.
//
// Replaces the TPU program rsparse_tpu/ops/spmm.py:35 spmm_buckets (the
// gather dense[col_idx] (B, L, k), the masked einsum "bl,blk->bk" and the
// scatter-add into out[row_ids]).  Its plain PyTorch version is
// rsparse_tpu_torch/ops/spmm.py _spmm_plain; tests/test_torch_spmm_layout.py
// runs this kernel's work list in plain torch.
//
// For each row b of a bucket, out[row_ids[b]] = sum over l < nnz[b] of
// val[b, l] * table[col[b, l], :], summed in f32.  The table is f32 or the
// bf16 shadow of compute_dtype="bfloat16"; then val is rounded to bf16 too,
// as the reference casts it to the gather dtype (spmm.py:53), and every
// product of two bf16 values is exact in f32.  Padding rows (row_id ==
// n_rows) write nothing.
//
// What bounds it on the H100: the gather.  Each entry reads one table row
// (k * 4 or k * 2 bytes); at LinearFlow's rhs shape (7.44M entries, k =
// 256, f32) that is 7.62 GB from L2 (and from HBM where the 64 MB table
// spills out of the 50 MB L2), while the bytes of each input and output
// once take 0.057 ms.  The card serves those reads at 6-8 TB/s.
//
// What the design does about it: the work list (ops/spmm.py row_layout)
// cuts every bucket into blocks of two kinds, all in one launch.  It is a
// function of the buckets' shapes alone (rows and padded length), so it is
// built once per list of shapes on the host and cached; a block whose part
// of a row holds no entry leaves at once.  A bucket padded to more than
// `short` entries is cut into chunks of `chunk` entries, one block for each
// chunk of each row: its G groups of tpe threads take the chunk's entries
// in turn (neighbouring entries, whose columns ascend, so a dense row reads
// nearly contiguous table rows), each thread holding nv vectors of vec
// columns; the groups' partial rows are summed in shared memory and stored,
// or added with atomicAdd into the zeroed output when the row has more than
// one chunk of entries (such rows agree with the plain version to f32
// rounding, 1e-5 relative, not bit for bit).  The rows of a bucket padded to
// at most `short` are packed G to a block, one group each, walked in step
// from their first (lowest) columns, so neighbouring rows meet the same
// table rows in L1, and stored from registers with no reduction.  The
// layout puts the chunked blocks first (the first chunk of every row of the
// longest buckets, then the second ...: the blocks running at once add into
// many rows, not all into one), and sizes `chunk` and `short` to the
// product (ops/spmm.py row_shape): a small one keeps 16 entries a group and
// packs nothing, as one block per chunk of a row fills the card best there.
// Row panels that stage the table rows several rows share in shared memory
// read half the L2 bytes but ran slower (PERF.md, section 6).

#include "spmm_common.cuh"

namespace {

using rsp_sp::Buckets;
using rsp_sp::kMaxBuckets;
using rsp_sp::kThreads;

// desc: per block (bucket, row, chunk index or row count, packed): packed
// 0 chunk z of row y, stored, or added with atomics when the row has more
// than one chunk of entries; packed 1 the z rows y, y + 1, ... of the
// bucket, row y + g for group g, stored.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
spmm_rows_kernel(const __grid_constant__ Buckets bk,
                 const int4* __restrict__ desc, const T* __restrict__ table,
                 int k, int n_rows, int tpe, int chunk,
                 float* __restrict__ out) {
  extern __shared__ float red[];  // G * k floats for the chunk blocks
  constexpr int W = NV * VEC;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int4 dd = desc[blockIdx.x];
  const int* col = bk.col[dd.x];
  const float* val = bk.val[dd.x];
  const int* row_ids = bk.row_ids[dd.x];
  const int* nnz = bk.nnz[dd.x];
  const long long L = bk.L[dd.x];
  const int t = threadIdx.x % tpe, g = threadIdx.x / tpe;
  const int G = blockDim.x / tpe;
  const bool packed = dd.w != 0;
  if (packed && g >= dd.z) return;  // no barrier follows in this mode
  const int b = packed ? dd.y + g : dd.y;
  const int n = nnz[b], row = row_ids[b];
  const int start = packed ? 0 : dd.z * chunk;
  if (!packed && start >= n) return;  // uniform over the block
  const int end = packed ? n : min(n, start + chunk);
  const int stride = packed ? 1 : G;
  const int* cb = col + (size_t)b * L;
  const float* vb = val + (size_t)b * L;

  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  for (int l = start + (packed ? 0 : g); l < end; l += stride) {
    const T* crow = table + (size_t)__ldg(cb + l) * k;
    const float v = __ldg(vb + l);
    const float du = kBf16 ? rsp_sp::bf16_round(v) : v;
    float x[W];
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int j0 = (t + m * tpe) * VEC;
      if (j0 < k) {
        rsp_sp::load_vec<T, VEC>(crow + j0, x + m * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[m * VEC + e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] += du * x[i];
  }

  if (packed) {
    if (row >= n_rows) return;
    float* o = out + (size_t)row * k;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int j0 = (t + m * tpe) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (j0 + e < k) o[j0 + e] = acc[m * VEC + e];
    }
  } else if (row < n_rows) {  // uniform over the block
    rsp_sp::reduce_row<VEC, NV>(acc, red, k, tpe, out + (size_t)row * k,
                                n > chunk);
  }
}

template <typename T, int VEC, int NV>
int launch(const Buckets& bk, const int4* desc, int n_blocks,
           const void* table, int k, int n_rows, int tpe, int chunk,
           float* out, cudaStream_t stream) {
  const size_t smem = (size_t)(kThreads / tpe) * k * sizeof(float);
  spmm_rows_kernel<T, VEC, NV><<<n_blocks, kThreads, smem, stream>>>(
      bk, desc, static_cast<const T*>(table), k, n_rows, tpe, chunk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n_rows, k) f32, zeroed by the caller; table (n_cols, k) f32 or bf16
// (table_bf16 = 1).  aligned: the table's base address is 16-byte aligned.
// buckets: host array of n_buckets x 5 int64 (col, val, row_ids, nnz device
// pointers, L), n_buckets <= kMaxBuckets.  desc (n_blocks x 4): the work
// list of ops/spmm.py row_layout for these buckets' shapes, this k and
// alignment; chunk its chunk length.
extern "C" int rsp_spmm(const long long* buckets, int n_buckets,
                        const int* desc, int n_blocks, const void* table,
                        int table_bf16, int aligned, int k, int n_rows,
                        int chunk, float* out, void* stream) {
  if (n_blocks <= 0) return 0;
  if (k <= 0 || k > rsp_sp::kMaxK || chunk <= 0 || n_buckets <= 0 ||
      n_buckets > kMaxBuckets)
    return (int)cudaErrorInvalidValue;
  const Buckets bk = rsp_sp::unpack_buckets(buckets, n_buckets);
  const rsp_sp::Shape s = rsp_sp::make_shape(k, aligned != 0);
  const int4* d = reinterpret_cast<const int4*>(desc);
  const cudaStream_t st = (cudaStream_t)stream;
#define RSP_ROWS_CASE(T, V, N)                                        \
  if (s.vec == V && s.nv == N)                                        \
    return launch<T, V, N>(bk, d, n_blocks, table, k, n_rows, s.tpe, \
                           chunk, out, st);
#define RSP_ROWS_CASES(T) \
  RSP_ROWS_CASE(T, 4, 1)  \
  RSP_ROWS_CASE(T, 4, 2)  \
  RSP_ROWS_CASE(T, 4, 4)  \
  RSP_ROWS_CASE(T, 1, 1)  \
  RSP_ROWS_CASE(T, 1, 2)  \
  RSP_ROWS_CASE(T, 1, 4)  \
  RSP_ROWS_CASE(T, 1, 8)  \
  RSP_ROWS_CASE(T, 1, 16)
  if (table_bf16) {
    RSP_ROWS_CASES(__nv_bfloat16)
  } else {
    RSP_ROWS_CASES(float)
  }
#undef RSP_ROWS_CASES
#undef RSP_ROWS_CASE
  return (int)cudaErrorInvalidValue;
}
