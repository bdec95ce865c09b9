// K4: one bucket of non-negative ALS solves (NNLS by sequential coordinate
// descent), implicit or explicit feedback, with an optional dense zipf head.
//
// Replaces the TPU program rsparse_tpu/ops/solvers.py:254 batched_nnls as
// rsparse_tpu/ops/als.py reaches it (:243-245 implicit, :358-360
// explicit), with the lhs of those branches.  Its plain PyTorch version is
// rsparse_tpu_torch/ops/solvers.py batched_nnls behind ops/als.py
// _solve_bucket_implicit / _explicit.
//
// One CTA solves one target row:
//   lhs, rhs  as K2 builds them (rsp::build_normal_equations, common.cuh);
//   G  = lhs' lhs + eps I (lhs is symmetric, so G = lhs lhs), a d^3 product
//        on the 16 x 16 thread grid;
//   mu = G x0 - lhs' rhs;
//   sweeps over the coordinates k = 0 .. d-1 in order (reference
//   inst/include/nnls.hpp:11-34): x_k' = max(x_k - mu_k / G_kk, 0),
//   mu += (x_k' - x_k) G[:, k]; a system stops after the first sweep whose
//   largest |x_k' - x_k| / (|x_k| + eps) is at most rel_tol, or after
//   max_iter sweeps.  The sweeps run in one warp with x and mu in
//   registers (lane l holds coordinates l, l + 32, ...): a coordinate step
//   is two shuffles, one division and d / 32 FMAs per lane, with no barrier.
//   The stop is per system, as in nnls.hpp; the TPU program stops the
//   whole batch at once (ROADMAP queue 3).
//   Then the loss as in K1.
//
// Built for d <= 128 and d <= 160, each for float and bf16 source tables
// (the rounding points of compute_dtype="bfloat16" are those of the shared
// normal-equation build and of K1's loss).
//
// What bounds it on the H100: the coordinate sweeps, a chain of d
// dependent steps per sweep (about 100 cycles each), times the sweeps a
// system needs (G squares the condition number of the lhs).  lhs and G
// take 2 d^2 floats of shared memory (133 KB at d = 129), so one CTA runs
// per SM, and while one warp sweeps the other seven wait.

#include <math.h>

#include "common.cuh"

namespace {

constexpr float kEps = 1e-16f;  // NNLS_EPS of ops/solvers.py

template <int KMAXD, class T, bool EXPLICIT>
__global__ void __launch_bounds__(rsp::kGramThreads)
als_nnls_kernel(rsp::BucketArgs a, int max_iter, float rel_tol,
                int* __restrict__ sweeps) {
  constexpr int KT = KMAXD / 16;
  constexpr int PL = KMAXD / 32;
  extern __shared__ float smem[];
  const int d = a.d, b = blockIdx.x, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int g_floats = max(d * d, rsp::gram_smem_floats(d));
  float* A = smem;                  // d x d lhs
  float* G = A + d * d;             // workspace of the build, then G
  float* rhs = G + g_floats;        // d
  float* x = rhs + d;               // d
  float* mu = x + d;                // d
  float* scratch = mu + d;          // 32

  const float lam_use = rsp::row_lambda(a, b);
  rsp::build_normal_equations<KMAXD, EXPLICIT, T>(a, b, lam_use, A, rhs,
                                                  rsp::gram_smem(G, d));

  // ---- G = lhs' lhs + eps I ----------------------------------------------
  {
    float acc[KT][KT];
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float* row = A + k * d;
      float av[KT], bv[KT];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const int ri = ty + 16 * i, ci = tx + 16 * i;
        av[i] = ri < d ? row[ri] : 0.f;
        bv[i] = ci < d ? row[ci] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();  // the build's workspace in G is read no more
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int ri = ty + 16 * i, ci = tx + 16 * j;
        if (ri < d && ci < d) G[ri * d + ci] = acc[i][j] + (ri == ci ? kEps : 0.f);
      }
  }
  for (int t = tid; t < d; t += rsp::kGramThreads) x[t] = a.x0[(size_t)b * d + t];
  __syncthreads();

  // ---- mu = G x0 - lhs' rhs ------------------------------------------------
  for (int t = tid; t < d; t += rsp::kGramThreads) {
    float gx = 0.f, ar = 0.f;
    for (int i = 0; i < d; ++i) {
      gx += G[t * d + i] * x[i];
      ar += A[i * d + t] * rhs[i];
    }
    mu[t] = gx - ar;
  }
  __syncthreads();

  // ---- coordinate sweeps, one warp, x and mu in registers ------------------
  if (tid < 32) {
    const int lane = tid;
    float xr[PL], mr[PL];
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int k = lane + 32 * m;
      xr[m] = k < d ? x[k] : 0.f;
      mr[m] = k < d ? mu[k] : 0.f;
    }
    int t = 0;
    float rel = INFINITY;
    while (t < max_iter && rel > rel_tol) {
      rel = 0.f;
#pragma unroll
      for (int m = 0; m < PL; ++m) {
        for (int j = 0; j < 32; ++j) {
          const int k = 32 * m + j;
          if (k >= d) break;
          const float old = __shfl_sync(RSP_FULL_MASK, xr[m], j);
          const float mk = __shfl_sync(RSP_FULL_MASK, mr[m], j);
          const float nw = fmaxf(old - mk / G[k * d + k], 0.f);
          const float diff = nw - old;
          const float* gcol = G + k * d;  // row k == column k (G symmetric)
#pragma unroll
          for (int mm = 0; mm < PL; ++mm) {
            const int i = lane + 32 * mm;
            if (i < d) mr[mm] += diff * gcol[i];
          }
          if (lane == j) xr[m] = nw;
          rel = fmaxf(rel, fabsf(diff) / (fabsf(old) + kEps));
        }
      }
      ++t;
    }
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int k = lane + 32 * m;
      if (k < d) x[k] = xr[m];
    }
    if (lane == 0 && sweeps != nullptr) sweeps[b] = t;
  }
  __syncthreads();

  // ---- output and loss -----------------------------------------------------
  for (int t = tid; t < d; t += rsp::kGramThreads) a.y[(size_t)b * d + t] = x[t];
  const float total = rsp::row_loss<PL, EXPLICIT>(
      rsp::row_entries<T>(a, b), a, x,
      rsp::dot_operand(x, mu, d, a.round_bf16 != 0), lam_use, scratch);
  if (tid == 0) a.loss[b] = total;
}

}  // namespace

extern "C" int rsp_als_nnls(const rsp::BucketArgs* args, int max_iter,
                            float rel_tol, int* sweeps, void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (a.d <= 0 || a.d > 160) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(rsp::BucketArgs, int, float, int*);
  using bf16 = __nv_bfloat16;
  // [d <= 128 ? 0 : 1][bf16 table][explicit]
  static const Kernel kernels[2][2][2] = {
      {{als_nnls_kernel<128, float, false>, als_nnls_kernel<128, float, true>},
       {als_nnls_kernel<128, bf16, false>, als_nnls_kernel<128, bf16, true>}},
      {{als_nnls_kernel<160, float, false>, als_nnls_kernel<160, float, true>},
       {als_nnls_kernel<160, bf16, false>, als_nnls_kernel<160, bf16, true>}}};
  const Kernel kern =
      kernels[a.d > 128][a.table_bf16 != 0][a.explicit_fb != 0];
  const int gram = rsp::gram_smem_floats(a.d);
  const size_t g_floats = (size_t)(a.d * a.d > gram ? a.d * a.d : gram);
  const size_t smem = sizeof(float) * ((size_t)a.d * a.d + g_floats + 3 * (size_t)a.d + 32);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.B, rsp::kGramThreads, smem, (cudaStream_t)stream>>>(a, max_iter,
                                                               rel_tol, sweeps);
  return (int)cudaGetLastError();
}
