// K8: one Factorization Machine row block.
//
// Replaces the TPU program rsparse_tpu/models/fm.py:39 _fm_block_impl, and
// for FM the scheduled segment sums of rsparse_tpu/ops/segsum.py:784 that
// it runs on.  Its plain PyTorch version is rsparse_tpu_torch/models/fm.py
// _fm_block_plain.
//
// Every row of a block reads the block-start tables, and AdaGrad is
// accumulator first: a feature's step is -lr sum(g) / sqrt(acc + sum(g^2))
// over all its entries in the block (rsparse_tpu/models/fm.py:157-167).  So
// the work is two launches:
//   A  one warp per row: the prediction w0 + sum w x + (|s1|^2 -
//      sum |v x|^2) / 2 with s1 = sum v x, the link, dL * sample_w, and per
//      entry the clipped (+-100) g_w = x dL + 2 lambda_w and g_v = dL x (s1 -
//      v x) + 2 lambda_v v, whose sums and sums of squares go with atomicAdd
//      into zeroed per-slot scratch; sum dL and sum dL^2 for the intercept,
//      one atomic per CTA;
//   B  one thread per (distinct feature, component): the AdaGrad step of
//      w / v and their accumulators (distinct ids: no race), and one thread
//      for w0 / acc_w0 when the model has an intercept.
// Predict mode is launch A without the gradients.
//
// What bounds it on the H100: bytes.  Per entry it reads the index, the
// value, the slot, w and one v row of r floats at a random feature (16 to
// 36 bytes; at 40M features the tables are 1.3 GB, so mostly device memory)
// and does ~10 r flops.  What the design does about it: each entry's
// w and v row are read twice (prediction, gradient; the second from L2),
// nothing of (B, L, r) size is written, and launch B touches each table row
// once.  Lanes work in groups of tpe = min(next power of two >= r, 32)
// threads per entry, so 32 / tpe entries of a row go at once (r = 4: 8).
// The atomic sums of a popular feature add in an order that changes from
// run to run (f32 rounding, ~1e-6 relative against the plain version).

#include "common.cuh"

namespace {

constexpr float kClip = 100.f;
constexpr int kMaxR = 128;          // widest v (models/fm.py MAX_RANK)
constexpr int kRpl = kMaxR / 32;    // components a lane holds at most
constexpr int kWarps = 8;           // rows (warps) per CTA in launch A

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// sums: [sum dL, sum dL^2, sw (U), sw2 (U), sv (U, r), sv2 (U, r)]
__global__ void fm_rows(const int* __restrict__ col,
                        const float* __restrict__ val,
                        const int* __restrict__ nnz,
                        const int* __restrict__ slot,
                        const float* __restrict__ y,
                        const float* __restrict__ sample_w,
                        const float* __restrict__ w0,
                        const float* __restrict__ w,
                        const float* __restrict__ v, int B, int L, int r,
                        int tpe, int family, int do_update, float lam_w,
                        float lam_v, float* sums, int U,
                        float* __restrict__ y_hat) {
  __shared__ float part[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  const int groups = 32 / tpe, g = lane / tpe, t = lane % tpe;
  float dL = 0.f;
  if (b < B) {  // b is the same on every lane of the warp
    const int m = nnz[b];
    const size_t base = (size_t)b * L;
    float s1[kRpl];
#pragma unroll
    for (int j = 0; j < kRpl; ++j) s1[j] = 0.f;
    float sq = 0.f, lin = 0.f;
    for (int l = g; l < m; l += groups) {
      const int c = col[base + l];
      const float x = val[base + l];
      const float* vr = v + (size_t)c * r;
#pragma unroll
      for (int j = 0; j < kRpl; ++j) {
        const int k = t + j * tpe;
        if (k < r) {
          const float vx = vr[k] * x;
          s1[j] += vx;
          sq += vx * vx;
        }
      }
      if (t == 0) lin += w[c] * x;
    }
    // s1 over the groups: every group then holds the whole row's s1
    for (int o = tpe; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kRpl; ++j)
        s1[j] += __shfl_xor_sync(RSP_FULL_MASK, s1[j], o);
    }
    float s1sq = 0.f;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < kRpl; ++j)
        if (t + j * tpe < r) s1sq += s1[j] * s1[j];
    }
    lin = rsp::warp_sum(lin);
    sq = rsp::warp_sum(sq);
    s1sq = rsp::warp_sum(s1sq);
    const float raw = w0[0] + lin + 0.5f * (s1sq - sq);
    if (lane == 0) y_hat[b] = family == 1 ? sigmoid(raw) : raw;
    if (do_update) {
      const float yb = y[b];
      dL = (family == 1 ? (sigmoid(raw * yb) - 1.f) * yb : 2.f * (raw - yb))
           * sample_w[b];
      float* sw = sums + 2;
      float* sw2 = sw + U;
      float* sv = sw2 + U;
      float* sv2 = sv + (size_t)U * r;
      for (int l = g; l < m; l += groups) {
        const int c = col[base + l];
        const float x = val[base + l];
        const int s = slot[base + l];
        const float* vr = v + (size_t)c * r;
#pragma unroll
        for (int j = 0; j < kRpl; ++j) {
          const int k = t + j * tpe;
          if (k < r) {
            const float vk = vr[k];
            const float gv = clip(dL * x * (s1[j] - vk * x) + 2.f * lam_v * vk);
            atomicAdd(sv + (size_t)s * r + k, gv);
            atomicAdd(sv2 + (size_t)s * r + k, gv * gv);
          }
        }
        if (t == 0) {
          const float gw = clip(x * dL + 2.f * lam_w);
          atomicAdd(sw + s, gw);
          atomicAdd(sw2 + s, gw * gw);
        }
      }
    }
  }
  if (!do_update) return;  // a kernel argument: the same on every thread
  if (lane == 0) {
    part[warp][0] = dL;
    part[warp][1] = dL * dL;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      a += part[i][0];
      a2 += part[i][1];
    }
    atomicAdd(sums, a);
    atomicAdd(sums + 1, a2);
  }
}

__global__ void fm_apply(const int* __restrict__ feats,
                         const float* __restrict__ sums, float* w,
                         float* acc_w, float* v, float* acc_v, int U, int r,
                         float lr_w, float lr_v) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)U * (r + 1)) return;
  const int u = (int)(idx / (r + 1)), k = (int)(idx % (r + 1));
  const int f = feats[u];
  const float* sw = sums + 2;
  const float* sw2 = sw + U;
  const float* sv = sw2 + U;
  const float* sv2 = sv + (size_t)U * r;
  if (k == r) {
    const float a = acc_w[f] + sw2[u];
    w[f] += -lr_w * sw[u] / sqrtf(a);
    acc_w[f] = a;
  } else {
    const size_t e = (size_t)f * r + k, q = (size_t)u * r + k;
    const float a = acc_v[e] + sv2[q];
    v[e] += -lr_v * sv[q] / sqrtf(a);
    acc_v[e] = a;
  }
}

__global__ void fm_intercept(const float* __restrict__ sums, float* w0,
                             float* acc_w0, float lr_w) {
  const float a = acc_w0[0] + sums[1];
  acc_w0[0] = a;
  w0[0] -= lr_w * sums[0] / sqrtf(a);
}

}  // namespace

// col/val/slot (B, L), nnz/y/sample_w/y_hat (B,); w0/acc_w0 one float each,
// w/acc_w (F + 1,), v/acc_v (F + 1, r) f32, updated in place; feats (U,);
// sums (2 + 2 U (r + 1)) zeroed by the caller (null in predict mode).
extern "C" int rsp_fm_block(const int* col, const float* val, const int* nnz,
                            const int* slot, const float* y,
                            const float* sample_w, float* w0, float* acc_w0,
                            float* w, float* v, float* acc_w, float* acc_v,
                            float* sums, const int* feats, int U, int B, int L,
                            int r, float lr_w, float lr_v, float lam_w,
                            float lam_v, int family, int intercept,
                            int do_update, float* y_hat, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || U < 0 || r < 1 || r > kMaxR || (do_update && !sums))
    return (int)cudaErrorInvalidValue;
  int tpe = 1;
  while (tpe < r && tpe < 32) tpe <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
  fm_rows<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      col, val, nnz, slot, y, sample_w, w0, w, v, B, L, r, tpe, family,
      do_update, lam_w, lam_v, sums, U, y_hat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !do_update) return (int)err;
  if (U > 0) {
    const long long n = (long long)U * (r + 1);
    fm_apply<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        feats, sums, w, acc_w, v, acc_v, U, r, lr_w, lr_v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (intercept) {
    fm_intercept<<<1, 1, 0, st>>>(sums, w0, acc_w0, lr_w);
    err = cudaGetLastError();
  }
  return (int)err;
}
