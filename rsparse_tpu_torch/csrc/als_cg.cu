// K1: one bucket of ALS solves by conjugate gradient, implicit or explicit
// feedback.
//
// Replaces the TPU programs rsparse_tpu/ops/als.py:138
// _solve_bucket_implicit (CG branch :213-227, bias terms :179-189, loss
// :249-266) and :269 _solve_bucket_explicit (CG branch :330-345, bias
// terms :306-308, loss :364-373), with rsparse_tpu/ops/solvers.py:208
// batched_cg.  Its plain PyTorch versions are rsparse_tpu_torch/ops/als.py
// _solve_bucket_implicit and _solve_bucket_explicit.
//
// One CTA solves one target row b.  With x_e the source rows its entries
// touch (cold entries from the bucket, zipf-head entries from the dense
// weights), c_e their values and xb_e their source biases
// (common.cuh lhs_weight / rhs_weight / entry_loss):
//   rhs   = sum_e rw_e x_e + rhs_init
//   A p   = XtX p + sum_e (c_e - 1) (x_e . p) x_e        (implicit)
//   A p   = lam_use p + sum_e (x_e . p) x_e              (explicit)
//   x     = cg_steps of CG from x0, an entity freezing once rsold < tol
//   loss  = sum_e entry_loss + lam_use |x|^2
// Explicit rows see only their observed entries; lam_use is lambda times
// the row's total nnz with dynamic lambda; a head entry is present where its
// packed bit is set, so a stored 0.0 rating enters the lhs and the loss.
// x, r, p and Ap live in shared memory; the entries are never materialised:
// every pass re-reads the source rows (through L1/L2) one warp per row.
//
// What bounds it on the H100: each matvec reads every entry's d-float source
// row once (nnz * d * 4 bytes, mostly L2 hits: a 32k x 128 f32 table is
// 16 MB of the 50 MB L2), d^2 floats of XtX (implicit), and the row's H
// head weights.  The FLOPs are 4 d per entry per pass, far below the FP32
// peak, so the kernel is bound by L2/HBM bytes and by latency for short
// rows.  Two widths are built: d <= 128 keeps 4 floats per lane, d <= 160
// (rank 128 with biases is d = 129) 5; each with and without the source
// biases compiled in (XB), so the unbiased path carries no bias code.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Smem {
  float* x;
  float* r;
  float* p;
  float* Ap;
  float* red;      // kWarps x d partial sums
  float* scratch;  // 32 floats for block_sum
};

// out = sum over entries of weight * row, plus (MODE 0, the rhs) rhs_init,
// or (MODE 1, the matvec A vec) XtX vec / lam_use vec.  MODE 0:
// weight = rhs_weight; MODE 1: weight = lhs_weight * (row . vec).
template <int PL, bool EXPLICIT, bool XB, int MODE>
__device__ void accumulate(const rsp::RowEntries& R, const Smem& S,
                           const float* vec, const rsp::BucketArgs& a,
                           float lam_use, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = R.d;
  float acc[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) acc[m] = 0.f;
  rsp::for_each_entry<XB>(R, warp, kWarps, [&](const float* row, float c,
                                               float xb) {
    float rr[PL];
    rsp::load_row<PL>(row, d, rr);
    float wgt;
    if (MODE == 0) {
      wgt = rsp::rhs_weight<EXPLICIT>(c, xb, a.g_rhs);
    } else {
      wgt = rsp::lhs_weight<EXPLICIT>(c) * rsp::row_dot<PL>(rr, vec, d);
    }
#pragma unroll
    for (int m = 0; m < PL; ++m) acc[m] += wgt * rr[m];
  });
#pragma unroll
  for (int m = 0; m < PL; ++m) {
    const int k = lane + 32 * m;
    if (k < d) S.red[warp * d + k] = acc[m];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < d; t += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += S.red[w * d + t];
    if (MODE == 0) {
      if (a.rhs_init != nullptr) s += a.rhs_init[t];
    } else if (EXPLICIT) {
      s += lam_use * vec[t];
    } else {
      for (int i = 0; i < d; ++i) s += vec[i] * __ldg(a.XtX + (size_t)i * d + t);
    }
    out[t] = s;
  }
  __syncthreads();
}

__device__ float block_dot(const float* a, const float* b, int d,
                           float* scratch) {
  float s = 0.f;
  for (int t = threadIdx.x; t < d; t += kThreads) s += a[t] * b[t];
  return rsp::block_sum(s, scratch);
}

template <int KMAXD, bool EXPLICIT, bool XB>
__global__ void __launch_bounds__(kThreads)
als_cg_kernel(rsp::BucketArgs a, int cg_steps, float tol) {
  constexpr int PL = KMAXD / 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x, d = a.d;
  Smem S{smem, smem + d, smem + 2 * d, smem + 3 * d, smem + 4 * d,
         smem + (4 + kWarps) * d};
  const rsp::RowEntries R = rsp::row_entries(a, b);
  const float lam_use = rsp::row_lambda(a, b);

  // r = rhs - A x0, p = r
  accumulate<PL, EXPLICIT, XB, 0>(R, S, nullptr, a, lam_use, S.r);
  for (int t = threadIdx.x; t < d; t += kThreads) S.x[t] = a.x0[(size_t)b * d + t];
  __syncthreads();
  accumulate<PL, EXPLICIT, XB, 1>(R, S, S.x, a, lam_use, S.Ap);
  for (int t = threadIdx.x; t < d; t += kThreads) {
    S.r[t] -= S.Ap[t];
    S.p[t] = S.r[t];
  }
  float rsold = block_dot(S.r, S.r, d, S.scratch);

  // the freeze rule of batched_cg: live = rsold >= tol, masked alpha/beta
  for (int step = 0; step < cg_steps; ++step) {
    const bool live = rsold >= tol;
    accumulate<PL, EXPLICIT, XB, 1>(R, S, S.p, a, lam_use, S.Ap);
    const float pAp = block_dot(S.p, S.Ap, d, S.scratch);
    const float alpha = live ? rsold / (pAp == 0.f ? 1.f : pAp) : 0.f;
    for (int t = threadIdx.x; t < d; t += kThreads) {
      S.x[t] += alpha * S.p[t];
      S.r[t] -= alpha * S.Ap[t];
    }
    const float rsnew = block_dot(S.r, S.r, d, S.scratch);
    const float beta = live ? rsnew / (rsold == 0.f ? 1.f : rsold) : 0.f;
    for (int t = threadIdx.x; t < d; t += kThreads) {
      S.p[t] = S.r[t] + beta * S.p[t];
    }
    if (live) rsold = rsnew;
    __syncthreads();
  }

  for (int t = threadIdx.x; t < d; t += kThreads) a.y[(size_t)b * d + t] = S.x[t];
  const float total =
      rsp::row_loss<PL, EXPLICIT, XB>(R, a, S.x, lam_use, S.scratch);
  if (threadIdx.x == 0) a.loss[b] = total;
}

}  // namespace

extern "C" int rsp_als_cg(const rsp::BucketArgs* args, int cg_steps, float tol,
                          void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (a.d <= 0 || a.d > 160) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(rsp::BucketArgs, int, float);
  // [d <= 128 ? 0 : 1][explicit][source biases]
  static const Kernel kernels[2][2][2] = {
      {{als_cg_kernel<128, false, false>, als_cg_kernel<128, false, true>},
       {als_cg_kernel<128, true, false>, als_cg_kernel<128, true, true>}},
      {{als_cg_kernel<160, false, false>, als_cg_kernel<160, false, true>},
       {als_cg_kernel<160, true, false>, als_cg_kernel<160, true, true>}}};
  const Kernel kern =
      kernels[a.d > 128][a.explicit_fb != 0][a.xbias != nullptr];
  const size_t smem = sizeof(float) * ((size_t)(4 + kWarps) * a.d + 32);
  kern<<<a.B, kThreads, smem, (cudaStream_t)stream>>>(a, cg_steps, tol);
  return (int)cudaGetLastError();
}
