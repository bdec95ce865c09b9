// K10: one GloVe sparse-tail shard.
//
// Replaces the TPU programs rsparse_tpu/models/glove.py:50 _glove_epoch_impl
// and :109 _glove_epoch_sched_impl (one scan step each), and for GloVe the
// scheduled segment sums of rsparse_tpu/ops/segsum.py (:600
// build_stacked_col_schedule, :551 sched_reduce_chunks, :757
// sched_apply_sums_multi) that the second one runs on.  Its plain PyTorch
// version is rsparse_tpu_torch/models/glove.py _glove_shard_plain.
//
// Every entry of a shard reads the shard-start tables, and AdaGrad is
// accumulator first (rsparse_tpu/models/glove.py:73-93): a feature's step
// is -lr sum(g) / sqrt(acc + sum(g^2)) over its entries in the shard, for
// w_i / b_i on the row side and w_j / b_j on the column side.  Each side
// carries a slot map (ops/segsum.py shard_slot_maps: the shard's distinct
// ids `feats` and each entry's index into them, U at padding).  Two
// launches:
//   A  one warp per entry: gathers w_i[i], w_j[j], b_i[i], b_j[j]; weight
//      (v / x_max)^alpha below x_max, else 1; the inner cost clipped at
//      +-100; cost = weight * inner and its loss term cost * inner; then
//      atomicAdd into zeroed per-slot sums of g = cost w_j and g^2 on the
//      row side, g = cost w_i and g^2 on the column side, and cost and
//      cost^2 for the biases of both;
//   B  one thread per (side, distinct feature, component): acc += sum g^2,
//      w += -lr sum g / sqrt(acc) (the same for the biases).  The ids of a
//      side are distinct: no race.
//
// Scratch per side is slot-indexed (U rows), not vocabulary-indexed: a
// config #4 tail shard touches ~half the 50,000 ids on each side, and
// launch B then walks only those; no dense per-vocabulary scratch has to
// be zeroed for every shard.
//
// What bounds it on the H100: bytes.  Per entry it reads two ids, a value,
// two slots and two table rows of r floats at random ids (~1 KB at r =
// 128), and does ~6 r flops; every distinct feature's four table rows are
// read and written once more in launch B.  The design reads each entry's
// rows once (lanes over r, so one warp moves a 512-byte row in four
// coalesced loads), writes nothing of (N, r) size, and its 4 r + 4 atomics
// an entry go to consecutive addresses within a warp.  The atomic sums of
// a popular feature add in an order that changes from run to run (f32
// rounding, ~1e-6 relative against the plain version).

#include "common.cuh"

namespace {

constexpr float kClip = 100.f;
constexpr int kMaxR = 128;          // widest embedding (models/glove.py MAX_RANK)
constexpr int kRpl = kMaxR / 32;    // components a lane holds at most
constexpr int kWarps = 8;           // entries (warps) in flight per CTA

// One side's sums: [sum g (U, r) | sum g^2 (U, r) | sum cost (U) |
// sum cost^2 (U)].
struct Side {
  float* g;
  float* g2;
  float* c;
  float* c2;
  __device__ Side(float* sums, int U, int r)
      : g(sums), g2(sums + (size_t)U * r), c(sums + 2 * (size_t)U * r),
        c2(sums + 2 * (size_t)U * r + U) {}
};

__global__ void glove_entries(const int* __restrict__ rows,
                              const int* __restrict__ cols,
                              const float* __restrict__ vals,
                              const int* __restrict__ slot_r,
                              const int* __restrict__ slot_c, int N, int U_r,
                              int U_c, int r, const float* __restrict__ w_i,
                              const float* __restrict__ w_j,
                              const float* __restrict__ b_i,
                              const float* __restrict__ b_j, float x_max,
                              float alpha, float* sums_r, float* sums_c,
                              float* loss) {
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + warp;
  const Side sr(sums_r, U_r, r), sc(sums_c, U_c, r);
  float lterm = 0.f;
  // e and the slot are the same on every lane of the warp; padding entries
  // carry slot U_r
  const int ur = e < N ? slot_r[e] : U_r;
  if (ur < U_r) {
    const int uc = slot_c[e];
    const int i = rows[e], j = cols[e];
    const float v = vals[e];
    const float* wir = w_i + (size_t)i * r;
    const float* wjr = w_j + (size_t)j * r;
    float a[kRpl], b[kRpl];
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < kRpl; ++t) {
      const int k = lane + 32 * t;
      a[t] = k < r ? wir[k] : 0.f;
      b[t] = k < r ? wjr[k] : 0.f;
      dot += a[t] * b[t];
    }
    dot = rsp::warp_sum(dot);
    const float inner =
        fminf(fmaxf(dot + b_i[i] + b_j[j] - logf(v), -kClip), kClip);
    const float weight = v < x_max ? powf(v / x_max, alpha) : 1.f;
    const float cost = weight * inner;
    lterm = cost * inner;
#pragma unroll
    for (int t = 0; t < kRpl; ++t) {
      const int k = lane + 32 * t;
      if (k < r) {
        const float g = cost * b[t], h = cost * a[t];
        atomicAdd(sr.g + (size_t)ur * r + k, g);
        atomicAdd(sr.g2 + (size_t)ur * r + k, g * g);
        atomicAdd(sc.g + (size_t)uc * r + k, h);
        atomicAdd(sc.g2 + (size_t)uc * r + k, h * h);
      }
    }
    if (lane == 0) {
      atomicAdd(sr.c + ur, cost);
      atomicAdd(sr.c2 + ur, cost * cost);
      atomicAdd(sc.c + uc, cost);
      atomicAdd(sc.c2 + uc, cost * cost);
    }
  }
  if (lane == 0) part[warp] = lterm;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w];
    atomicAdd(loss, s);
  }
}

// Threads [0, U_r (r + 1)) apply the row side, the rest the column side;
// within a side, thread u (r + 1) + k is component k of feature u, k = r
// its bias.
__global__ void glove_apply(const int* __restrict__ feats_r,
                            const int* __restrict__ feats_c, int U_r, int U_c,
                            int r, const float* __restrict__ sums_r,
                            const float* __restrict__ sums_c, float* w_i,
                            float* w_j, float* b_i, float* b_j, float* acc_w_i,
                            float* acc_w_j, float* acc_b_i, float* acc_b_j,
                            float lr) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_r = (long long)U_r * (r + 1);
  if (idx >= n_r + (long long)U_c * (r + 1)) return;
  const bool col = idx >= n_r;
  if (col) idx -= n_r;
  const int U = col ? U_c : U_r;
  const Side s(const_cast<float*>(col ? sums_c : sums_r), U, r);
  const int u = (int)(idx / (r + 1)), k = (int)(idx % (r + 1));
  const int f = (col ? feats_c : feats_r)[u];
  if (k < r) {
    float* w = col ? w_j : w_i;
    float* acc = col ? acc_w_j : acc_w_i;
    const size_t e = (size_t)f * r + k, q = (size_t)u * r + k;
    const float a = acc[e] + s.g2[q];
    w[e] += -lr * s.g[q] / sqrtf(a);
    acc[e] = a;
  } else {
    float* b = col ? b_j : b_i;
    float* acc = col ? acc_b_j : acc_b_i;
    const float a = acc[f] + s.c2[u];
    b[f] += -lr * s.c[u] / sqrtf(a);
    acc[f] = a;
  }
}

}  // namespace

// rows/cols/slot_r/slot_c (N,) int32, vals (N,) f32 of one shard; feats_r
// (U_r,), feats_c (U_c,) the distinct ids of its valid entries; the eight
// state tables (n, r) / (n,) f32, updated in place; sums
// (2 (U_r + U_c)(r + 1) + 1) zeroed by the caller, its last float the
// shard's loss sum(cost * inner).
extern "C" int rsp_glove_shard(const int* rows, const int* cols,
                               const float* vals, const int* slot_r,
                               const int* slot_c, const int* feats_r,
                               const int* feats_c, int N, int U_r, int U_c,
                               int r, float* w_i, float* w_j, float* b_i,
                               float* b_j, float* acc_w_i, float* acc_w_j,
                               float* acc_b_i, float* acc_b_j, float x_max,
                               float alpha, float lr, float* sums,
                               void* stream) {
  if (N <= 0) return 0;
  if (U_r < 0 || U_c < 0 || r < 1 || r > kMaxR || !sums)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sums_r = sums;
  float* sums_c = sums + 2 * (size_t)U_r * (r + 1);
  float* loss = sums_c + 2 * (size_t)U_c * (r + 1);
  glove_entries<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      rows, cols, vals, slot_r, slot_c, N, U_r, U_c, r, w_i, w_j, b_i, b_j,
      x_max, alpha, sums_r, sums_c, loss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)(U_r + U_c) * (r + 1);
  if (n > 0) {
    glove_apply<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        feats_r, feats_c, U_r, U_c, r, sums_r, sums_c, w_i, w_j, b_i, b_j,
        acc_w_i, acc_w_j, acc_b_i, acc_b_j, lr);
    err = cudaGetLastError();
  }
  return (int)err;
}
