// K6: fused soft-impute residual: SDDMM + squared norm + SpMM in one pass,
// one launch over every bucket.
//
// Replaces the TPU program rsparse_tpu/ops/spmm.py:81 spmm_residual_buckets
// and, in its approx-only mode, :59 sparse_approx_buckets (through :117
// residual_values).  Its plain PyTorch version is
// rsparse_tpu_torch/ops/spmm.py _residual_plain; tests/test_torch_k6_split.py
// runs this kernel's work list in plain torch.
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
// every sum is f32.  Padding rows (row_id == n_rows) write no proj row.
//
// What bounds it on the H100: the gather of cf, r * 4 bytes (r * 2 in bf16)
// per entry, as in K5 (1.9 GB at the soft-impute item step, 1.86M entries at
// r = 256, from L2: the 32 MB table fits); the bytes of each input and
// output once take 0.03 ms there.  The arithmetic is 4 flops per gathered
// value: far below the card's f32 rate.  Behind the gather sit two latencies
// K5 does not have: an entry's dot product is a shuffle tree over the tpe
// threads that hold its columns (5 dependent steps at r = 256) before its
// SpMM update can start, and its residual feeds the update.
//
// What the design does about it.  (1) One launch per call over K5's work
// list (ops/spmm.py row_layout / spmm_layout, the same cached list for the
// same bucket shapes; a launch per bucket would be 24 at the item step,
// each with its host work): the rows of a bucket padded past
// `short` are cut into chunks of `chunk` entries, chunk c of every such row
// before chunk c + 1, so the blocks running at once add into many rows; a
// chunk past a row's entries leaves at once; the rows of the other buckets
// are packed one group a row, stored from registers.  The chunk and short
// of K5's row_shape serve both kernels.  (2) Each group holds kU = 2
// entries at a time: their row loads are issued together and their two
// shuffle trees interleave, so one entry's dot product overlaps the next
// entry's gather instead of waiting in line (one entry at a time ran 3-12%
// slower at the item step, four no faster than two).
// Registers bound the blocks an SM holds: up to 8 columns a thread, the
// kernel is held to 64 registers (four blocks an SM, against three at the
// 78 it takes unbounded); loading the next trip's rows before this trip's
// dot products took 96 and ran slower (PERF.md, section 6).
// Shuffles use the group's lanes alone, so the groups of a warp run their
// own trip counts.  (3) cf is gathered once per entry and serves both the
// dot product and the SpMM (the plain version gathers the (B, L, r) block
// and reads it twice); lf is read once per group.  Rows longer than one
// chunk are combined with atomicAdd into the zeroed proj and agree with the
// plain version to f32 rounding (1e-5 relative), not bit for bit.  The
// squared norm is one partial per block of the work list, summed by one
// torch reduction: deterministic.

#include "spmm_common.cuh"

namespace rsp_sp {
namespace {

constexpr int kU = 2;  // entries a group holds at once

// The approx outputs of one launch, one (B, L) f32 tensor per bucket, or
// null (no approx output).
struct Approx {
  float* a[kMaxBuckets];
};

// The kU entries l0, l0 + stride, ... of a row (those at or past `end` are
// not live and reload entry l0): their indices, values and this thread's
// columns of their table rows.
template <typename T, int VEC, int NV, int U = kU>
__device__ __forceinline__ void load_trip(const int* cb, const float* vb,
                                          const T* table, int k, int t,
                                          int tpe, int l0, int end,
                                          int stride, int (&e)[U],
                                          bool (&live)[U], float (&v)[U],
                                          float (&cf)[U][NV * VEC]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int l = l0 + u * stride;
    live[u] = l < end;
    e[u] = live[u] ? l : l0;
    v[u] = __ldg(vb + e[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* crow = table + (size_t)__ldg(cb + e[u]) * k;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int j0 = (t + m * tpe) * VEC;
      if (j0 < k) {
        load_vec<T, VEC>(crow + j0, cf[u] + m * VEC);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) cf[u][m * VEC + q] = 0.f;
      }
    }
  }
}

// One block of the work list: desc (bucket, row, chunk index or row count,
// packed), as in K5 (spmm.cu).  Chunk blocks: the G groups take the chunk's
// entries in turn, kU at a time each, and the block sums its groups'
// partial rows; packed blocks: group g walks row y + g (g < z) alone, kU
// entries at a time, and stores it.  sq_part[blockIdx.x] gets the block's sum of delta^2.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, NV * VEC <= 8 ? 4 : 2)
residual_rows_kernel(const __grid_constant__ Buckets bk,
                     const __grid_constant__ Approx ao,
                     const int4* __restrict__ desc,
                     const float* __restrict__ rowfac,
                     const float* __restrict__ scale, int n_fac,
                     const T* __restrict__ table, int k, int n_rows, int tpe,
                     int chunk, float* __restrict__ proj,
                     float* __restrict__ sq_part) {
  extern __shared__ float red[];  // G * k floats, then 32 for block_sum
  constexpr int W = NV * VEC, U = kU;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int4 dd = desc[blockIdx.x];
  const int* col = bk.col[dd.x];
  const float* val = bk.val[dd.x];
  const int* row_ids = bk.row_ids[dd.x];
  const long long L = bk.L[dd.x];
  const int t = threadIdx.x % tpe, g = threadIdx.x / tpe;
  const int G = blockDim.x / tpe;
  const bool packed = dd.w != 0;
  const bool on = !packed || g < dd.z;  // this group has a row
  const int b = packed && on ? dd.y + g : dd.y;
  const int n = bk.nnz[dd.x][b], row = row_ids[b];
  const int start = packed ? 0 : dd.z * chunk;
  if (!packed && start >= n) {  // uniform over the block
    if (threadIdx.x == 0 && sq_part != nullptr) sq_part[blockIdx.x] = 0.f;
    return;
  }
  const int end = !on ? 0 : (packed ? n : min(n, start + chunk));
  const int stride = packed ? 1 : G;
  const int* cb = col + (size_t)b * L;
  const float* vb = val + (size_t)b * L;
  float* ab = ao.a[dd.x] == nullptr ? nullptr : ao.a[dd.x] + (size_t)b * L;
  const unsigned gm = group_mask(tpe);

  // this thread's columns of lf = rowfac[row] * scale
  float lf[W];
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

  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  float sq = 0.f;
  // U entries a trip, l0, l0 + stride, ...; trips are uniform over the group
  for (int l0 = (packed ? 0 : start + g); l0 < end; l0 += U * stride) {
    int e[U];
    bool live[U];
    float v[U], cf[U][W], dot[U];
    load_trip<T, VEC, NV>(cb, vb, table, k, t, tpe, l0, end, stride, e, live,
                          v, cf);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dot[u] = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) dot[u] += lf[i] * cf[u][i];
    }
    // the shuffle trees, interleaved
    for (int o = tpe >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        dot[u] += __shfl_xor_sync(gm, dot[u], o, tpe);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (live[u]) {
        const float delta = v[u] - dot[u];
        if (t == 0) {
          sq += delta * delta;
          if (ab != nullptr) ab[e[u]] = dot[u];
        }
        if (proj != nullptr) {
          const float du = kBf16 ? bf16_round(delta) : delta;
#pragma unroll
          for (int i = 0; i < W; ++i) acc[i] += du * cf[u][i];
        }
      }
    }
  }

  if (sq_part != nullptr) {
    const float s = rsp::block_sum(sq, red + G * k);
    if (threadIdx.x == 0) sq_part[blockIdx.x] = s;
  }
  if (proj == nullptr) return;
  if (packed) {
    if (!on || row >= n_rows) return;
    float* o = proj + (size_t)row * k;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int j0 = (t + m * tpe) * VEC;
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        if (j0 + q < k) o[j0 + q] = acc[m * VEC + q];
    }
  } else if (row < n_rows) {  // uniform over the block
    reduce_row<VEC, NV>(acc, red, k, tpe, proj + (size_t)row * k, n > chunk);
  }
}

template <typename T, int VEC, int NV>
int launch(const Buckets& bk, const Approx& ao, const int4* desc,
           int n_blocks, const float* rowfac, const float* scale, int n_fac,
           const void* table, int k, int n_rows, int tpe, int chunk,
           float* proj, float* sq_part, cudaStream_t stream) {
  const size_t smem = ((size_t)(kThreads / tpe) * k + 32) * sizeof(float);
  residual_rows_kernel<T, VEC, NV><<<n_blocks, kThreads, smem, stream>>>(
      bk, ao, desc, rowfac, scale, n_fac, static_cast<const T*>(table), k,
      n_rows, tpe, chunk, proj, sq_part);
  return (int)cudaGetLastError();
}

// The table's element type from table_bf16, the vector width and vectors
// per thread from the shape.
int dispatch(const Buckets& bk, const Approx& ao, const int4* desc,
             int n_blocks, const float* rowfac, const float* scale, int n_fac,
             const void* table, int table_bf16, const Shape& s, int k,
             int n_rows, int chunk, float* proj, float* sq_part,
             cudaStream_t stream) {
#define RSP_SD_CASE(T, V, N)                                                  \
  if (s.vec == V && s.nv == N)                                                \
    return launch<T, V, N>(bk, ao, desc, n_blocks, rowfac, scale, n_fac,      \
                           table, k, n_rows, s.tpe, chunk, proj, sq_part,    \
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

// buckets: host array of n_buckets x 5 int64 (col, val, row_ids, nnz device
// pointers, L), n_buckets <= kMaxBuckets; approx: host array of n_buckets
// device pointers of the (B, L) f32 approx outputs, zeroed by the caller,
// or null.  desc (n_blocks x 4): the work list of ops/spmm.py row_layout for
// these buckets' shapes, this k and alignment; chunk its chunk length.
// rowfac (n_fac, k) f32; scale (k,) f32 or null; table (n_cols, k) f32 or
// bf16 (table_bf16 = 1); aligned: the table's base address is 16-byte
// aligned.  Outputs, each optional (null): proj (n_rows, k) f32, zeroed by the
// caller; sq_part (n_blocks,) f32, every entry written.
extern "C" int rsp_spmm_residual(const long long* buckets, int n_buckets,
                                 const long long* approx, const int* desc,
                                 int n_blocks, const float* rowfac,
                                 const float* scale, int n_fac,
                                 const void* table, int table_bf16,
                                 int aligned, int k, int n_rows, int chunk,
                                 float* proj, float* sq_part, void* stream) {
  using namespace rsp_sp;
  if (n_blocks <= 0) return 0;
  if (k <= 0 || k > kMaxK || chunk <= 0 || n_fac <= 0 || n_buckets <= 0 ||
      n_buckets > kMaxBuckets)
    return (int)cudaErrorInvalidValue;
  const Buckets bk = unpack_buckets(buckets, n_buckets);
  Approx ao = {};
  if (approx != nullptr)
    for (int i = 0; i < n_buckets; ++i)
      ao.a[i] = reinterpret_cast<float*>(approx[i]);
  const Shape s = make_shape(k, aligned != 0);
  const int4* d = reinterpret_cast<const int4*>(desc);
  return dispatch(bk, ao, d, n_blocks, rowfac, scale, n_fac, table,
                  table_bf16, s, k, n_rows, chunk, proj, sq_part,
                  (cudaStream_t)stream);
}
