// K2: one bucket of exact ALS solves by Cholesky, implicit or explicit
// feedback, with an optional dense zipf head.
//
// Replaces the TPU programs rsparse_tpu/ops/als.py:138
// _solve_bucket_implicit (exact branch :228-247, loss :249-266) and :269
// _solve_bucket_explicit (exact branch :346-362, loss :364-373), their
// dense-head lhs term :125 _hot_lhs over :116 hot_outer_table, and
// rsparse_tpu/ops/solvers.py:28 batched_spd_solve -> :134
// batched_spd_solve_blocked (_chol_panel :59, _trsm_lower :85,
// _trsm_lower_t :103).  Its plain PyTorch versions are
// rsparse_tpu_torch/ops/als.py _solve_bucket_implicit / _explicit (einsum
// Gram + torch.linalg.cholesky + torch.cholesky_solve).  transform() and
// the closing half-sweep of fit_transform run it.
//
// One CTA solves one target row:
//   lhs, rhs  built in shared memory by rsp::build_normal_equations
//             (common.cuh): the Gram of the row's cold entries, staged 32
//             source rows at a time, and of its present head entries, each
//             32-column strip of the dense head compacted by a ballot (the
//             TPU's (H, d^2) outer-product table is never built);
//   right-looking Cholesky (of the symmetric part (A + A') / 2 with
//   compute_dtype="bfloat16"), one column per step, with the reference's guard for a non-positive pivot
//   (piv = sqrt(max(A_jj, 0)), divisor 1 if 0);
//   forward and back substitution; then the loss as in K1.
// The Gram is accumulated in registers: the 256 threads form a 16 x 16 grid
// and thread (ty, tx) owns the entries (ty + 16 a, tx + 16 b), a, b < d/16,
// so each staged source row costs 2 d / 16 shared loads and (d / 16)^2 FMAs
// per thread.  Two widths are built: d <= 128 (8 x 8 tiles) and d <= 160
// (10 x 10; rank 128 with biases is d = 129), each for float and bf16
// source tables (the bf16 shadow of compute_dtype="bfloat16", or a
// precision="bfloat16" model's factors): rows are staged as float, and
// the bf16 rounding points are build_normal_equations' and K1's.
//
// What bounds it on the H100: the Gram build is nnz * d^2 FMAs on the CUDA
// cores (2.4e11 at 7.4M nnz, d = 128), reading source rows staged 32 at a
// time through shared memory; the factorisation is d^3 / 3 FMAs per row
// with one __syncthreads per column, latency-bound at small d.  The lhs
// takes d^2 floats of shared memory (64 KB at d = 128, 65 KB at d = 129),
// so two CTAs fit on an SM.

#include "common.cuh"

namespace {

__device__ __forceinline__ float safe_div(float v) { return v > 0.f ? v : 1.f; }

template <int KMAXD, class T, bool EXPLICIT>
__global__ void __launch_bounds__(rsp::kGramThreads)
als_chol_kernel(rsp::BucketArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, b = blockIdx.x, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float* A = smem;                                  // d x d, row-major
  float* rhs = A + d * d;                           // d
  float* x = rhs + d;                               // d
  float* colv = x + d;                              // d
  float* scratch = colv + d;                        // 32
  const rsp::GramSmem S = rsp::gram_smem(scratch + 32, d);

  const float lam_use = rsp::row_lambda(a, b);
  rsp::build_normal_equations<KMAXD, EXPLICIT, T>(a, b, lam_use, A, rhs, S);
  // with compute_dtype="bfloat16" factor the symmetric part (A + A') / 2,
  // as the plain version and the reference's lax.linalg.cholesky do: a
  // Gram of bf16-rounded weighted rows is not symmetric (in float32 it is
  // up to rounding, and the pass is skipped).  Only the lower triangle is
  // written.
  if (a.round_bf16) {
    for (int e = tid; e < d * d; e += rsp::kGramThreads) {
      const int i = e / d, j = e - i * d;
      if (i > j) A[e] = (A[e] + A[j * d + i]) / 2.f;
    }
    __syncthreads();
  }

  // ---- Cholesky: L overwrites the lower triangle of A ----------------------
  for (int j = 0; j < d; ++j) {
    const float safe = safe_div(sqrtf(fmaxf(A[j * d + j], 0.f)));
    for (int i = j + tid; i < d; i += rsp::kGramThreads) colv[i] = A[i * d + j] / safe;
    __syncthreads();
    for (int i = j + tid; i < d; i += rsp::kGramThreads) A[i * d + j] = colv[i];
    for (int i = j + 1 + ty; i < d; i += 16)
      for (int k = j + 1 + tx; k <= i; k += 16) A[i * d + k] -= colv[i] * colv[k];
    __syncthreads();
  }

  // ---- L z = rhs (z overwrites rhs), then L' x = z ---------------------------
  for (int j = 0; j < d; ++j) {
    const float zj = rhs[j] / safe_div(A[j * d + j]);
    for (int i = j + 1 + tid; i < d; i += rsp::kGramThreads) rhs[i] -= A[i * d + j] * zj;
    if (tid == 0) colv[j] = zj;
    __syncthreads();
  }
  for (int j = d - 1; j >= 0; --j) {
    const float xj = colv[j] / safe_div(A[j * d + j]);
    for (int i = tid; i < j; i += rsp::kGramThreads) colv[i] -= A[j * d + i] * xj;
    if (tid == 0) x[j] = xj;
    __syncthreads();
  }

  // ---- output and loss -----------------------------------------------------
  for (int t = tid; t < d; t += rsp::kGramThreads) a.y[(size_t)b * d + t] = x[t];
  const float total = rsp::row_loss<KMAXD / 32, EXPLICIT>(
      rsp::row_entries<T>(a, b), a, x,
      rsp::dot_operand(x, colv, d, a.round_bf16 != 0), lam_use, scratch);
  if (tid == 0) a.loss[b] = total;
}

}  // namespace

extern "C" int rsp_als_chol(const rsp::BucketArgs* args, void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (a.d <= 0 || a.d > 160) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(rsp::BucketArgs);
  using bf16 = __nv_bfloat16;
  // [d <= 128 ? 0 : 1][bf16 table][explicit]
  static const Kernel kernels[2][2][2] = {
      {{als_chol_kernel<128, float, false>, als_chol_kernel<128, float, true>},
       {als_chol_kernel<128, bf16, false>, als_chol_kernel<128, bf16, true>}},
      {{als_chol_kernel<160, float, false>, als_chol_kernel<160, float, true>},
       {als_chol_kernel<160, bf16, false>, als_chol_kernel<160, bf16, true>}}};
  const Kernel kern =
      kernels[a.d > 128][a.table_bf16 != 0][a.explicit_fb != 0];
  const size_t smem = sizeof(float) * ((size_t)a.d * a.d + 4 * (size_t)a.d + 32 +
                                       rsp::gram_smem_floats(a.d));
  // above 48 KB a block's dynamic shared memory must be opted into; the
  // attribute is per device, so it is set before every launch
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.B, rsp::kGramThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
