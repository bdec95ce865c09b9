// K1: one bucket of implicit-feedback ALS solves by conjugate gradient.
//
// Replaces the TPU program rsparse_tpu/ops/als.py:138 _solve_bucket_implicit
// (CG branch :165-227, loss :249-266) with rsparse_tpu/ops/solvers.py:208
// batched_cg.  Its plain PyTorch version is
// rsparse_tpu_torch/ops/als.py _solve_bucket_implicit.
//
// One CTA solves one target row b.  With Xg the source rows its entries
// touch and c their confidences (cold entries from the bucket, zipf-head
// entries from the dense weights w, 0 = absent):
//   rhs   = Xg' (c - (c - 1) g) + rhs_init
//   A p   = XtX p + Xg' ((c - 1) .* (Xg p))
//   x     = cg_steps of CG from x0, an entity freezing once rsold < tol
//   loss  = sum c (1 - g - Xg x)^2 + lam |x|^2
// x, r, p and Ap live in shared memory; the entries are never materialised:
// every pass re-reads the source rows (through L1/L2) one warp per row.
//
// What bounds it on the H100: each matvec reads every entry's d-float source
// row once (nnz * d * 4 bytes, mostly L2 hits: a 32k x 128 f32 table is
// 16 MB of the 50 MB L2), d^2 floats of XtX, and the row's H head weights.
// The FLOPs are 4 d per entry per pass, far below the FP32 peak, so the
// kernel is bound by L2/HBM bytes and by latency for short rows.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kPerLane = kMaxD / 32;

struct Smem {
  float* x;
  float* r;
  float* p;
  float* Ap;
  float* red;      // kWarps x d partial sums
  float* scratch;  // 32 floats for block_sum
};

// out = sum over entries of weight(c, row) * row, plus `extra` (a d-vector,
// or the product XtX vec when `vec` is given).  mode 0: weight = c - (c-1) g
// (rhs); mode 1: weight = (c - 1) (row . vec) (matvec).
template <int MODE>
__device__ void accumulate(const rsp::RowEntries& R, const Smem& S,
                           const float* vec, const float* XtX,
                           const float* extra, float g, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = R.d;
  float acc[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) acc[m] = 0.f;
  rsp::for_each_entry(R, warp, kWarps, [&](const float* row, float c) {
    float rr[kPerLane];
    rsp::load_row<kPerLane>(row, d, rr);
    float wgt;
    if (MODE == 0) {
      wgt = c - (c - 1.f) * g;
    } else {
      wgt = (c - 1.f) * rsp::row_dot<kPerLane>(rr, vec, d);
    }
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) acc[m] += wgt * rr[m];
  });
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    if (k < d) S.red[warp * d + k] = acc[m];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < d; t += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += S.red[w * d + t];
    if (MODE == 0) {
      if (extra != nullptr) s += extra[t];
    } else {
      for (int i = 0; i < d; ++i) s += vec[i] * __ldg(XtX + (size_t)i * d + t);
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

__global__ void __launch_bounds__(kThreads)
als_cg_kernel(const float* __restrict__ V, const int* __restrict__ col,
              const float* __restrict__ val, const int* __restrict__ nnz,
              int L, int d, const float* __restrict__ XtX,
              const float* __restrict__ rhs_init,
              const float* __restrict__ x0, const float* __restrict__ W,
              const float* __restrict__ Vh, int H, float lam, float g,
              int cg_steps, float tol, float* __restrict__ y,
              float* __restrict__ loss) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  Smem S{smem, smem + d, smem + 2 * d, smem + 3 * d, smem + 4 * d,
         smem + (4 + kWarps) * d};
  rsp::RowEntries R{V, col + (size_t)b * L, val + (size_t)b * L, nnz[b],
                    Vh, W == nullptr ? nullptr : W + (size_t)b * H, H, d};

  // r = rhs - A x0, p = r
  accumulate<0>(R, S, nullptr, XtX, rhs_init, g, S.r);
  for (int t = threadIdx.x; t < d; t += kThreads) S.x[t] = x0[(size_t)b * d + t];
  __syncthreads();
  accumulate<1>(R, S, S.x, XtX, nullptr, g, S.Ap);
  for (int t = threadIdx.x; t < d; t += kThreads) {
    S.r[t] -= S.Ap[t];
    S.p[t] = S.r[t];
  }
  float rsold = block_dot(S.r, S.r, d, S.scratch);

  // the freeze rule of batched_cg: live = rsold >= tol, masked alpha/beta
  for (int step = 0; step < cg_steps; ++step) {
    const bool live = rsold >= tol;
    accumulate<1>(R, S, S.p, XtX, nullptr, g, S.Ap);
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

  for (int t = threadIdx.x; t < d; t += kThreads) y[(size_t)b * d + t] = S.x[t];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float wl = rsp::entries_loss<kPerLane>(R, warp, kWarps, S.x, g);
  float part = lane == 0 ? wl : 0.f;
  for (int t = threadIdx.x; t < d; t += kThreads) part += lam * S.x[t] * S.x[t];
  const float total = rsp::block_sum(part, S.scratch);
  if (threadIdx.x == 0) loss[b] = total;
}

}  // namespace

extern "C" int rsp_als_cg(const float* V, const int* col, const float* val,
                          const int* nnz, int B, int L, int d,
                          const float* XtX, const float* rhs_init,
                          const float* x0, const float* W, const float* Vh,
                          int H, float lam, float g, int cg_steps, float tol,
                          float* y, float* loss, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(4 + kWarps) * d + 32);
  als_cg_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      V, col, val, nnz, L, d, XtX, rhs_init, x0, W, Vh, H, lam, g, cg_steps,
      tol, y, loss);
  return (int)cudaGetLastError();
}
