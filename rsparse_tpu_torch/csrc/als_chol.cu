// K2: one bucket of implicit-feedback ALS solves by exact Cholesky.
//
// Replaces the TPU program rsparse_tpu/ops/als.py:138 _solve_bucket_implicit
// (exact branch :228-247, loss :249-266) with rsparse_tpu/ops/solvers.py:28
// batched_spd_solve -> :134 batched_spd_solve_blocked (_chol_panel :59,
// _trsm_lower :85, _trsm_lower_t :103).  Its plain PyTorch version is
// rsparse_tpu_torch/ops/als.py _solve_bucket_implicit (einsum Gram +
// torch.linalg.cholesky + torch.cholesky_solve).  transform() and the closing
// half-sweep of fit_transform run it.
//
// One CTA solves one target row:
//   lhs  = XtX + Xg' diag(c - 1) Xg     built in shared memory (d x d)
//   rhs  = Xg' (c - (c - 1) g) + rhs_init
//   right-looking Cholesky, one column per step, with the reference's guard
//   for a non-positive pivot (piv = sqrt(max(A_jj, 0)), divisor 1 if 0);
//   forward and back substitution; then the loss as in K1.
// The Gram is accumulated in registers: the 256 threads form a 16 x 16 grid
// and thread (ty, tx) owns the entries (ty + 16 a, tx + 16 b), a, b < 8, so
// each staged source row costs 16 shared loads and 64 FMAs per thread.
//
// What bounds it on the H100: the Gram build is nnz * d^2 FMAs on the CUDA
// cores (2.4e11 at 7.4M nnz, d = 128), reading source rows staged 32 at a
// time through shared memory; the factorisation is d^3 / 3 FMAs per row
// with one __syncthreads per column, latency-bound at small d.  The lhs
// takes d^2 floats of shared memory (64 KB at d = 128), so two CTAs fit on
// an SM.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kTile = kMaxD / 16;  // Gram entries per thread per axis
constexpr int kChunk = 32;         // source rows staged per pass

__device__ __forceinline__ float safe_div(float v) { return v > 0.f ? v : 1.f; }

__global__ void __launch_bounds__(kThreads)
als_chol_kernel(const float* __restrict__ V, const int* __restrict__ col,
                const float* __restrict__ val, const int* __restrict__ nnz_arr,
                int L, int d, const float* __restrict__ XtX,
                const float* __restrict__ rhs_init, float lam, float g,
                float* __restrict__ y, float* __restrict__ loss) {
  extern __shared__ float smem[];
  float* A = smem;                        // d x d, row-major
  float* rows = A + d * d;                // kChunk x d staged source rows
  float* cbuf = rows + kChunk * d;        // kChunk confidences
  float* rhs = cbuf + kChunk;             // d
  float* x = rhs + d;                     // d
  float* colv = x + d;                    // d
  float* scratch = colv + d;              // 32

  const int b = blockIdx.x, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nnz = nnz_arr[b];
  const int* rcol = col + (size_t)b * L;
  const float* rval = val + (size_t)b * L;

  // ---- lhs and rhs ------------------------------------------------------
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;
  float rhs_acc = 0.f;
  for (int base = 0; base < nnz; base += kChunk) {
    const int cnt = min(kChunk, nnz - base);
    for (int e = tid; e < cnt * d; e += kThreads) {
      const int l = e / d, k = e - l * d;
      rows[e] = __ldg(V + (size_t)rcol[base + l] * d + k);
    }
    if (tid < cnt) cbuf[tid] = rval[base + tid];
    __syncthreads();
    for (int l = 0; l < cnt; ++l) {
      const float c = cbuf[l];
      const float* row = rows + l * d;
      float a[kTile], bb[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const int ri = ty + 16 * i, ci = tx + 16 * i;
        a[i] = ri < d ? (c - 1.f) * row[ri] : 0.f;
        bb[i] = ci < d ? row[ci] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] += a[i] * bb[j];
      if (tid < d) rhs_acc += (c - (c - 1.f) * g) * row[tid];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int ri = ty + 16 * i, ci = tx + 16 * j;
      if (ri < d && ci < d) A[ri * d + ci] = __ldg(XtX + ri * d + ci) + acc[i][j];
    }
  if (tid < d) rhs[tid] = rhs_acc + (rhs_init != nullptr ? rhs_init[tid] : 0.f);
  __syncthreads();

  // ---- Cholesky: L overwrites the lower triangle of A ----------------------
  for (int j = 0; j < d; ++j) {
    const float safe = safe_div(sqrtf(fmaxf(A[j * d + j], 0.f)));
    for (int i = j + tid; i < d; i += kThreads) colv[i] = A[i * d + j] / safe;
    __syncthreads();
    for (int i = j + tid; i < d; i += kThreads) A[i * d + j] = colv[i];
    for (int i = j + 1 + ty; i < d; i += 16)
      for (int k = j + 1 + tx; k <= i; k += 16) A[i * d + k] -= colv[i] * colv[k];
    __syncthreads();
  }

  // ---- L z = rhs (z overwrites rhs), then L' x = z ---------------------------
  for (int j = 0; j < d; ++j) {
    const float zj = rhs[j] / safe_div(A[j * d + j]);
    for (int i = j + 1 + tid; i < d; i += kThreads) rhs[i] -= A[i * d + j] * zj;
    if (tid == 0) colv[j] = zj;
    __syncthreads();
  }
  for (int j = d - 1; j >= 0; --j) {
    const float xj = colv[j] / safe_div(A[j * d + j]);
    for (int i = tid; i < j; i += kThreads) colv[i] -= A[j * d + i] * xj;
    if (tid == 0) x[j] = xj;
    __syncthreads();
  }

  // ---- output and loss -----------------------------------------------------
  for (int t = tid; t < d; t += kThreads) y[(size_t)b * d + t] = x[t];
  rsp::RowEntries R{V, rcol, rval, nnz, nullptr, nullptr, 0, d};
  const float wl = rsp::entries_loss<kMaxD / 32>(R, tid >> 5, kWarps, x, g);
  float part = (tid & 31) == 0 ? wl : 0.f;
  for (int t = tid; t < d; t += kThreads) part += lam * x[t] * x[t];
  const float total = rsp::block_sum(part, scratch);
  if (tid == 0) loss[b] = total;
}

}  // namespace

extern "C" int rsp_als_chol(const float* V, const int* col, const float* val,
                            const int* nnz, int B, int L, int d,
                            const float* XtX, const float* rhs_init, float lam,
                            float g, float* y, float* loss, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)d * d + (size_t)kChunk * d + kChunk + 3 * d + 32);
  // above 48 KB a block's dynamic shared memory must be opted into; the
  // attribute is per device, so it is set before every launch
  cudaError_t err = cudaFuncSetAttribute(
      als_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  als_chol_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      V, col, val, nnz, L, d, XtX, rhs_init, lam, g, y, loss);
  return (int)cudaGetLastError();
}
