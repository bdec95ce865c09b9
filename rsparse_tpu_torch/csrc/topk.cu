// K3: exact masked top-k of one chunk of score rows.
//
// Replaces the TPU program rsparse_tpu/ops/topk.py:134 masked_top_k_bits
// (_tournament_steps :33, _expand_bits :125) and the unmasked path
// exact_top_k_tournament :87, as driven by _topk_scan :236 and
// _topk_scan_nomask :252.  Its plain PyTorch version is
// rsparse_tpu_torch/ops/topk.py _masked_top_k_plain.
//
// Row r's value at column j is NEG_INF (float32 min) when bit j of its packed
// little-endian mask is set, else max(score + glob_mean, NEG_INF).  The k
// results come in (value descending, index ascending) order, so ties go to
// the lowest index and a row with fewer than k live columns still returns k
// distinct indices.
//
// One CTA per row.  Thread t owns columns t, t + 256, ... and keeps the best
// of them that is still selectable: strictly below, in (value, -index)
// order, the last entry taken.  Each round the block takes the best of the
// 256 candidates; only the thread that owned the winner rescans its columns,
// since every other candidate is still the best of its columns below the
// new threshold.  The mask bits are expanded on the fly and never written
// out.
//
// What bounds it on the H100: one full read of the row (n * 4 bytes of
// scores + n / 8 bytes of mask) and, per round, a block reduction (two
// __syncthreads) plus one thread's rescan of n / 256 columns, served from
// L1/L2.  Small k is bound by the row read; large k by the k serial rounds.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -FLT_MAX;  // NEG_INF of ops/topk.py

// (v1, i1) comes before (v2, i2): larger value, then lower index
__device__ __forceinline__ bool before(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ float value_at(const float* s, const uint8_t* bits,
                                          int j, float gmean) {
  if (bits != nullptr && ((bits[j >> 3] >> (j & 7)) & 1)) return kNegInf;
  return fmaxf(s[j] + gmean, kNegInf);
}

// best column of this thread that comes after the threshold (tv, ti)
__device__ __forceinline__ void rescan(const float* s, const uint8_t* bits,
                                       int n, float gmean, float tv, int ti,
                                       float& bv, int& bi) {
  bv = -INFINITY;
  bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float v = value_at(s, bits, j, gmean);
    if (before(tv, ti, v, j) && before(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ bits,
            int n, int k, float gmean, float* __restrict__ out_s,
            int* __restrict__ out_i) {
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ float win_v;
  __shared__ int win_i;
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* s = scores + (size_t)row * n;
  const uint8_t* bm = bits == nullptr ? nullptr : bits + (size_t)row * (n >> 3);

  float bv;
  int bi;
  rescan(s, bm, n, gmean, INFINITY, -1, bv, bi);
  for (int r = 0; r < k; ++r) {
    float v = bv;
    int i = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (before(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (before(wv[w], wi[w], v, i)) {
          v = wv[w];
          i = wi[w];
        }
      win_v = v;
      win_i = i;
      out_s[(size_t)row * k + r] = v;
      out_i[(size_t)row * k + r] = i;
    }
    __syncthreads();
    if (win_i == bi) rescan(s, bm, n, gmean, win_v, win_i, bv, bi);
  }
}

}  // namespace

extern "C" int rsp_topk(const float* scores, const uint8_t* bits, int C, int n,
                        int k, float gmean, float* out_s, int* out_i,
                        void* stream) {
  if (C <= 0) return 0;
  if (k <= 0 || k > n || (bits != nullptr && (n & 7))) {
    return (int)cudaErrorInvalidValue;
  }
  topk_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(scores, bits, n, k,
                                                        gmean, out_s, out_i);
  return (int)cudaGetLastError();
}
