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
// compute_dtype="bfloat16" (round_bf16): V and Vh are the bf16 shadow
// tables, and the kernel rounds where the reference's bf16 operands round
// (common.cuh rhs_weight_bf16 / matvec_coef_bf16, dot_operand): bf16(p)
// and bf16(y) before each product against a row, each matvec term before
// its second product, the rhs weights, the head's Wc, W1 and Wc - W1 g;
// sums and the CG recurrences stay float32.  A uint8 head is dequantised
// in the head loop (code * scale, common.cuh head_value), so the codes are
// read at one byte each.
//
// rsp_hot_chain runs the head term of one row alone (a row with no cold
// entries, no XtX and no rhs_init: the same accumulate() K1 runs; built for
// a bf16 Vh of d <= 128, the probe's shape), the counterpart of the Pallas probe scripts/exp_bisect3.py:15 tryk (kernels
// ka, kb, kc at :40-64, kd at :69 with its pallas_call at :80): mode 1 the
// matvec term bf16(bf16(x.bf16(p)) W1) summed over the present head rows,
// mode 0 the rhs term bf16(Wc - bf16(W1 g)).
//
// What bounds it on the H100: each matvec reads every entry's d-value source
// row once (nnz * d * 4 bytes, or 2 with a bf16 table, mostly L2 hits: a
// 32k x 128 f32 table is 16 MB of the 50 MB L2), d^2 floats of XtX
// (implicit), and the row's H head weights (4, 2 or 1 bytes).  The FLOPs
// are 4 d per entry per pass, far below the FP32 peak, so the kernel is
// bound by L2/HBM bytes and by latency for short rows.  Two widths are
// built: d <= 128 keeps 4 values per lane, d <= 160 (rank 128 with biases
// is d = 129) 5; each for float and bf16 tables, and with and without the
// source biases compiled in (XB), so the unbiased path carries no bias
// code.  The rounding and the head's storage kind are warp-uniform runtime
// branches: templating them too would triple the build for one select per
// entry.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Smem {
  float* x;
  float* r;
  float* p;
  float* Ap;
  float* pb;       // bf16(p) or bf16(x), the products' operand
  float* red;      // kWarps x d partial sums
  float* scratch;  // 32 floats for block_sum
};

__device__ __forceinline__ Smem smem_layout(float* smem, int d) {
  return Smem{smem,          smem + d,          smem + 2 * d,
              smem + 3 * d,  smem + 4 * d,      smem + 5 * d,
              smem + (5 + kWarps) * d};
}

__host__ __device__ constexpr size_t smem_floats(int d) {
  return (size_t)(5 + kWarps) * d + 32;
}

// out = sum over entries of weight * row, plus (MODE 0, the rhs) rhs_init,
// or (MODE 1, the matvec A vec) XtX vec / lam_use vec.  MODE 0:
// weight = rhs_weight; MODE 1: weight = lhs_weight * (row . vec_dot), with
// vec_dot = vec or bf16(vec) (dot_operand).  XtX and rhs_init are skipped
// where null.
template <int PL, bool EXPLICIT, bool XB, int MODE, class T>
__device__ void accumulate(const rsp::RowEntries<T>& R, const Smem& S,
                           const float* vec, const float* vec_dot,
                           const rsp::BucketArgs& a, float lam_use,
                           float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = R.d;
  const bool rnd = a.round_bf16 != 0;
  float acc[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) acc[m] = 0.f;
  rsp::for_each_entry<XB>(R, warp, kWarps, [&](const T* row, float c,
                                               float xb, bool head) {
    float rr[PL];
    rsp::load_row<PL>(row, d, rr);
    float wgt;
    if (MODE == 0) {
      wgt = rnd ? rsp::rhs_weight_bf16<EXPLICIT>(c, xb, a.g_rhs, head)
                : rsp::rhs_weight<EXPLICIT>(c, xb, a.g_rhs);
    } else {
      const float dot = rsp::row_dot<PL>(rr, vec_dot, d);
      wgt = rnd ? rsp::matvec_coef_bf16<EXPLICIT>(c, dot, head)
                : rsp::lhs_weight<EXPLICIT>(c) * dot;
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
    } else if (a.XtX != nullptr) {
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

template <int KMAXD, class T, bool EXPLICIT, bool XB>
__global__ void __launch_bounds__(kThreads)
als_cg_kernel(rsp::BucketArgs a, int cg_steps, float tol) {
  constexpr int PL = KMAXD / 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x, d = a.d;
  const Smem S = smem_layout(smem, d);
  const rsp::RowEntries<T> R = rsp::row_entries<T>(a, b);
  const float lam_use = rsp::row_lambda(a, b);
  const bool rnd = a.round_bf16 != 0;

  // r = rhs - A x0, p = r
  accumulate<PL, EXPLICIT, XB, 0>(R, S, nullptr, nullptr, a, lam_use, S.r);
  for (int t = threadIdx.x; t < d; t += kThreads) S.x[t] = a.x0[(size_t)b * d + t];
  __syncthreads();
  accumulate<PL, EXPLICIT, XB, 1>(R, S, S.x, rsp::dot_operand(S.x, S.pb, d, rnd),
                                  a, lam_use, S.Ap);
  for (int t = threadIdx.x; t < d; t += kThreads) {
    S.r[t] -= S.Ap[t];
    S.p[t] = S.r[t];
  }
  float rsold = block_dot(S.r, S.r, d, S.scratch);

  // the freeze rule of batched_cg: live = rsold >= tol, masked alpha/beta
  for (int step = 0; step < cg_steps; ++step) {
    const bool live = rsold >= tol;
    accumulate<PL, EXPLICIT, XB, 1>(R, S, S.p,
                                    rsp::dot_operand(S.p, S.pb, d, rnd), a,
                                    lam_use, S.Ap);
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
  const float total = rsp::row_loss<PL, EXPLICIT, XB>(
      R, a, S.x, rsp::dot_operand(S.x, S.pb, d, rnd), lam_use, S.scratch);
  if (threadIdx.x == 0) a.loss[b] = total;
}

// The head term of row b alone: MODE 1 the matvec term of p = x0[b],
// MODE 0 the rhs term with g = g_rhs (see the note at the top).
template <int KMAXD, class T, int MODE>
__global__ void __launch_bounds__(kThreads) hot_chain_kernel(rsp::BucketArgs a) {
  constexpr int PL = KMAXD / 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x, d = a.d;
  const Smem S = smem_layout(smem, d);
  const rsp::RowEntries<T> R = rsp::row_entries<T>(a, b);
  const float* vec = nullptr;
  const float* vec_dot = nullptr;
  if (MODE == 1) {
    for (int t = threadIdx.x; t < d; t += kThreads) S.p[t] = a.x0[(size_t)b * d + t];
    __syncthreads();
    vec = S.p;
    vec_dot = rsp::dot_operand(S.p, S.pb, d, a.round_bf16 != 0);
  }
  accumulate<PL, false, false, MODE>(R, S, vec, vec_dot, a, 0.f, S.Ap);
  for (int t = threadIdx.x; t < d; t += kThreads) a.y[(size_t)b * d + t] = S.Ap[t];
}

}  // namespace

extern "C" int rsp_als_cg(const rsp::BucketArgs* args, int cg_steps, float tol,
                          void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (a.d <= 0 || a.d > 160) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(rsp::BucketArgs, int, float);
  using bf16 = __nv_bfloat16;
  // [d <= 128 ? 0 : 1][bf16 table][explicit][source biases]
  static const Kernel kernels[2][2][2][2] = {
      {{{als_cg_kernel<128, float, false, false>, als_cg_kernel<128, float, false, true>},
        {als_cg_kernel<128, float, true, false>, als_cg_kernel<128, float, true, true>}},
       {{als_cg_kernel<128, bf16, false, false>, als_cg_kernel<128, bf16, false, true>},
        {als_cg_kernel<128, bf16, true, false>, als_cg_kernel<128, bf16, true, true>}}},
      {{{als_cg_kernel<160, float, false, false>, als_cg_kernel<160, float, false, true>},
        {als_cg_kernel<160, float, true, false>, als_cg_kernel<160, float, true, true>}},
       {{als_cg_kernel<160, bf16, false, false>, als_cg_kernel<160, bf16, false, true>},
        {als_cg_kernel<160, bf16, true, false>, als_cg_kernel<160, bf16, true, true>}}}};
  const Kernel kern = kernels[a.d > 128][a.table_bf16 != 0][a.explicit_fb != 0]
                             [a.xbias != nullptr];
  const size_t smem = sizeof(float) * smem_floats(a.d);
  kern<<<a.B, kThreads, smem, (cudaStream_t)stream>>>(a, cg_steps, tol);
  return (int)cudaGetLastError();
}

extern "C" int rsp_hot_chain(const rsp::BucketArgs* args, int mode,
                             void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  // built for what the probe runs: a bf16 Vh of d <= 128
  if (a.d <= 0 || a.d > 128 || a.W == nullptr || a.table_bf16 == 0)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const auto kern = mode != 0 ? hot_chain_kernel<128, bf16, 1>
                              : hot_chain_kernel<128, bf16, 0>;
  const size_t smem = sizeof(float) * smem_floats(a.d);
  kern<<<a.B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
