// K7: one FTRL-proximal row block.
//
// Replaces the TPU program rsparse_tpu/models/ftrl.py:64 _ftrl_block_impl
// (with _lazy_weights :56 and _link :48), and for FTRL the scheduled
// segment sums of rsparse_tpu/ops/segsum.py:784 that it runs on.  Its plain
// PyTorch version is rsparse_tpu_torch/models/ftrl.py _ftrl_block_plain.
//
// Every row of a block reads the block-start (z, n): the reference computes
// all the block's increments from one snapshot (src/FTRL.cpp:78-166 per
// row).  So the work is two launches:
//   A  one warp per row: lazy weights w = -(z - sign(z) l1) /
//      ((decay + sqrt(n)) / lr + l2) where |z| > l1, the prediction
//      link(sum w x) (x dropped and rescaled where a keep mask is given),
//      then per entry g = clip(sample_w (y_hat - y) x, +-1000),
//      sigma = (sqrt(n + g^2) - sqrt(n)) / lr and uz = g - sigma w, added
//      with atomicAdd into the zeroed block-local sums dz[slot], dn[slot];
//   B  one thread per distinct feature of the block: z[feats[u]] += dz[u],
//      n[feats[u]] += dn[u] (the ids are distinct: no race).
// Predict mode is launch A without the increments.
//
// What bounds it on the H100: bytes.  Per entry it reads the index, the
// value, the slot and one (z, n) pair at a random feature (8 bytes from a
// table of up to 40M features, 320 MB, so mostly device memory, not L2),
// and a handful of flops.  What the design does about it: one pass over the
// entries for the prediction and one for the gradient, which re-reads the
// same (z, n) pairs from L2; no (B, L) intermediate; the per-feature sums
// live in a block-sized scratch, so launch B touches each table row once.
// The atomic sums of a popular feature add in an order that changes from
// run to run (f32 rounding, ~1e-6 relative against the plain version).

#include "common.cuh"

namespace {

constexpr float kClipGrad = 1000.f;
constexpr int kWarps = 8;  // rows (warps) per CTA in launch A

__device__ __forceinline__ float lazy_weight(float z, float n, float lr,
                                             float decay, float l1, float l2) {
  if (!(fabsf(z) > l1)) return 0.f;
  const float sgn = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  return -(z - sgn * l1) / ((decay + sqrtf(n)) / lr + l2);
}

__device__ __forceinline__ float link(float x, int family) {
  if (family == 1) return 1.f / (1.f + expf(-x));
  if (family == 2) return x;
  return expf(x);
}

__global__ void ftrl_rows(const int* __restrict__ col,
                          const float* __restrict__ val,
                          const int* __restrict__ nnz,
                          const int* __restrict__ slot,
                          const unsigned char* __restrict__ keep,
                          float keep_scale, const float* __restrict__ y,
                          const float* __restrict__ sample_w,
                          const float* __restrict__ z,
                          const float* __restrict__ n, float* dz, float* dn,
                          int B, int L, float lr, float decay, float l1,
                          float l2, int family, int do_update,
                          float* __restrict__ y_hat) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // b is the same on every lane of the warp
  const int m = nnz[b];
  const size_t base = (size_t)b * L;
  float part = 0.f;
  for (int l = lane; l < m; l += 32) {
    const int c = col[base + l];
    float x = val[base + l];
    if (keep) x = keep[base + l] ? x * keep_scale : 0.f;
    part += lazy_weight(z[c], n[c], lr, decay, l1, l2) * x;
  }
  const float yh = link(rsp::warp_sum(part), family);
  if (lane == 0) y_hat[b] = yh;
  if (!do_update) return;
  const float d = sample_w[b] * (yh - y[b]);
  for (int l = lane; l < m; l += 32) {
    const int c = col[base + l];
    float x = val[base + l];
    if (keep) x = keep[base + l] ? x * keep_scale : 0.f;
    const float zc = z[c], nc = n[c];
    const float w = lazy_weight(zc, nc, lr, decay, l1, l2);
    const float g = fminf(fmaxf(d * x, -kClipGrad), kClipGrad);
    const float g2 = g * g;
    const float sigma = (sqrtf(nc + g2) - sqrtf(nc)) / lr;
    const int s = slot[base + l];
    atomicAdd(dz + s, g - sigma * w);
    atomicAdd(dn + s, g2);
  }
}

__global__ void ftrl_apply(const int* __restrict__ feats,
                           const float* __restrict__ dz,
                           const float* __restrict__ dn, float* z, float* n,
                           int U) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  const int f = feats[u];
  z[f] += dz[u];
  n[f] += dn[u];
}

}  // namespace

// col/val/slot/keep (B, L), nnz/y/sample_w/y_hat (B,), z/n (F + 1,) f32
// updated in place, feats (U,), dzn (2, max(U, 1)) zeroed by the caller
// (null in predict mode).  keep is a bool (B, L) mask or null.
extern "C" int rsp_ftrl_block(const int* col, const float* val,
                              const int* nnz, const int* slot,
                              const unsigned char* keep, float keep_scale,
                              const float* y, const float* sample_w, float* z,
                              float* n, float* dzn, const int* feats, int U,
                              int B, int L, float lr, float decay, float l1,
                              float l2, int family, int do_update,
                              float* y_hat, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || U < 0 || (do_update && !dzn)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* dz = dzn;
  float* dn = dzn ? dzn + (U > 0 ? U : 1) : nullptr;
  ftrl_rows<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      col, val, nnz, slot, keep, keep_scale, y, sample_w, z, n, dz, dn, B, L,
      lr, decay, l1, l2, family, do_update, y_hat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !do_update || U == 0) return (int)err;
  ftrl_apply<<<(U + 255) / 256, 256, 0, st>>>(feats, dz, dn, z, n, U);
  return (int)cudaGetLastError();
}
