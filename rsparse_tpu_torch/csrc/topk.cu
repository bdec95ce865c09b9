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
// distinct indices.  Both routes below give exactly that order.
//
// What bounds it on the H100: one read of the row (n * 4 bytes of scores +
// n / 8 bytes of mask); at C = 256, n = 32,768 that is 34.6 MB, 10.3 us.
// Two routes, chosen by k (ops/topk.py topk_plan):
//
// topk_lists (k <= kMaxK = 32): one pass over the row.  A row is split over
// a cluster of `parts` CTAs of 256 threads (1 to 8, so that small C still
// fills the card), each a contiguous range of 16-byte chunks (the row's
// unaligned head and ragged tail columns go one a thread); a thread reads
// its chunks with 16-byte loads, four ahead of the four it takes, and the
// mask from 32-bit words (one per 32 columns) that the CTA stages in shared
// memory first (bytes from device memory where n % 32 != 0).  First it
// reads kSample chunks spread over its range: the CTA's k-th largest thread
// maximum of those, tau, is a value at least k columns reach, so it is at
// most the row's k-th value, and no column below tau can be in the top k.
// Then each thread keeps the best K >= k columns at or above tau (an
// insertion into a sorted register list, rejecting against its K-th; a
// loop over the few columns of a chunk that pass, so that the warp runs
// the insertion only for them); a warp takes its k best from its lanes'
// lists (k rounds of shuffles, the winning lane popping its head); then
// each of the CTA's 8 k candidates goes straight to its rank among them
// if that is below k, and CTA 0 of a cluster ranks its CTAs' k best the
// same way, read through distributed shared memory.  Every step is exact
// under the (value, -index) order, so the result is the plain version's
// bit for bit.  No round touches the row again or waits on the whole CTA.
// What it costs beyond the row's read: a CTA's fixed chain (the sample,
// tau, the merges) with two rows an SM at C = 256, and a warp's
// insertions, which grow with k (a looser tau, a longer list).

// topk_rounds (any k; the first kernel): one CTA per row.  Thread t owns
// columns t, t + 256, ... and keeps the best of them that is still
// selectable: strictly below, in (value, -index) order, the last entry
// taken.  Each round the block takes the best of the 256 candidates; only
// the thread that owned the winner rescans its columns.  k serial rounds of
// two __syncthreads and one thread's rescan of n / 256 columns.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace cgrp = cooperative_groups;

namespace {

constexpr float kNegInf = -FLT_MAX;  // NEG_INF of ops/topk.py
constexpr int kMaxK = 32;            // largest k of topk_lists (TOPK_KMAX)
constexpr int kListThreads = 256;    // topk_lists' CTA (TOPK_THREADS)
constexpr int kListWarps = kListThreads / 32;
constexpr int kSample = 4;           // chunks a thread reads before tau

// (v1, i1) comes before (v2, i2): larger value, then lower index
__device__ __forceinline__ bool before(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ float live(float s, bool masked, float gmean) {
  return masked ? kNegInf : fmaxf(s + gmean, kNegInf);
}

// -- topk_lists ----------------------------------------------------------------

// bit j of a row's mask
__device__ __forceinline__ bool bit_at(const uint8_t* bm, int j) {
  return (bm[j >> 3] >> (j & 7)) & 1;
}

// the K best (value, index) pairs seen, best first; empty slots are
// (-inf, INT_MAX), which every column value (>= NEG_INF) beats
template <int K>
struct List {
  float v[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      v[q] = -INFINITY;
      i[q] = INT_MAX;
    }
  }

  __device__ __forceinline__ void push(float x, int j) {
    if (!before(x, j, v[K - 1], i[K - 1])) return;
    bool placed = false;
#pragma unroll
    for (int q = K - 1; q >= 0; --q) {
      if (!placed) {
        if (q > 0 && before(x, j, v[q - 1], i[q - 1])) {
          v[q] = v[q - 1];
          i[q] = i[q - 1];
        } else {
          v[q] = x;
          i[q] = j;
          placed = true;
        }
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int q = 0; q + 1 < K; ++q) {
      v[q] = v[q + 1];
      i[q] = i[q + 1];
    }
    v[K - 1] = -INFINITY;
    i[K - 1] = INT_MAX;
  }
};

// the warp's best (v, i), on every lane
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// how many of the n candidates (cv, ci) come before (v, i)
__device__ __forceinline__ int rank_of(const float* cv, const int* ci, int n,
                                       float v, int i) {
  int r = 0;
  for (int u = 0; u < n; ++u) r += before(cv[u], ci[u], v, i);
  return r;
}

template <int K>
__global__ void __launch_bounds__(kListThreads, 2)
topk_lists(const float* __restrict__ scores, const uint8_t* __restrict__ bits,
           int n, int k, float gmean, int parts, int words,
           float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int T = kListThreads;
  extern __shared__ uint32_t mw[];  // the CTA's mask words (with `words`)
  __shared__ float lm[T];
  __shared__ float tau_s;
  __shared__ float wv[kListWarps * kMaxK];
  __shared__ int wi[kListWarps * kMaxK];
  __shared__ float cv[kMaxK];
  __shared__ int ci[kMaxK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / parts, rank = blockIdx.x % parts;
  const float* s = scores + (size_t)row * n;
  const uint8_t* bm = bits == nullptr ? nullptr : bits + (size_t)row * (n >> 3);
  // columns [0, head) before the first 16-byte boundary, then nb chunks of
  // four, then the ragged tail [head + 4 nb, n)
  const int head = min(n, (int)((4 - ((uintptr_t)s >> 2)) & 3));
  const int nb = (n - head) >> 2;
  const int c0 = (int)((long long)nb * rank / parts);
  const int c1 = (int)((long long)nb * (rank + 1) / parts);
  const float4* s4 = reinterpret_cast<const float4*>(s + head);
  const int R = (c1 - c0 + T - 1) / T;  // chunks a thread
  const int stride = max(1, R / kSample);
  const int w0 = (head + 4 * c0) >> 5;
  // the mask bits of chunk c's four columns: from the staged words, or
  // byte by byte where the row's mask is not word aligned
  auto mask4 = [&](int c) -> unsigned {
    if (bm == nullptr) return 0u;
    const int j = head + 4 * c;
    if (words) {
      const int q = (j >> 5) - w0, sh = j & 31;
      uint32_t x = mw[q] >> sh;
      if (sh > 28) x |= mw[q + 1] << (32 - sh);
      return x & 0xFu;
    }
    unsigned x = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) x |= (unsigned)bit_at(bm, j + u) << u;
    return x;
  };

  // the sample, chunks q = 0, stride, ..., (kSample - 1) stride of this
  // thread, and the first four others are read while the mask is staged
  float4 sv[kSample];
#pragma unroll
  for (int q = 0; q < kSample; ++q) {
    const int c = c0 + tid + q * stride * T;
    if (q * stride < R && c < c1) sv[q] = __ldg(s4 + c);
  }
  float4 x[4];
  bool ok[4];
  auto load4 = [&](int q0, float4* xs, bool* oks) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u, c = c0 + tid + q * T;
      oks[u] = q < R && c < c1 && !(q % stride == 0 && q / stride < kSample);
      if (oks[u]) xs[u] = __ldg(s4 + c);
    }
  };
  load4(0, x, ok);
  if (words) {
    const int w1 = min(n >> 5, ((head + 4 * c1 - 1) >> 5) + 1);
    for (int q = w0 + tid; q < w1; q += T)
      mw[q - w0] = __ldg(reinterpret_cast<const uint32_t*>(bm) + q);
    __syncthreads();
  }
  float lmax = -INFINITY;
  unsigned sm[kSample];
#pragma unroll
  for (int q = 0; q < kSample; ++q) {
    const int c = c0 + tid + q * stride * T;
    sm[q] = 0xFu;
    if (q * stride < R && c < c1) {
      sm[q] = mask4(c);
      const float a = live(sv[q].x, sm[q] & 1, gmean);
      const float b = live(sv[q].y, sm[q] & 2, gmean);
      const float d = live(sv[q].z, sm[q] & 4, gmean);
      const float e = live(sv[q].w, sm[q] & 8, gmean);
      lmax = fmaxf(lmax, fmaxf(fmaxf(a, b), fmaxf(d, e)));
    }
  }
  // tau: the CTA's k-th largest thread maximum (at least k of its columns
  // reach it), from the thread whose maximum ranks k-th among the CTA's
  lm[tid] = lmax;
  __syncthreads();
  int above = 0;
  for (int o = 0; o < T; ++o) {
    const float y = lm[o];
    above += y > lmax || (y == lmax && o < tid);
  }
  if (above == k - 1) tau_s = lmax;
  __syncthreads();
  const float tau = tau_s;

  List<K> L;
  L.init();
  // a chunk's columns at or above tau go into the list; a loop over the
  // few that pass, so that the insertion runs only for them
  auto take4 = [&](float4 y, unsigned m, int j) {
    const float a = live(y.x, m & 1, gmean), b = live(y.y, m & 2, gmean);
    const float c = live(y.z, m & 4, gmean), d = live(y.w, m & 8, gmean);
    unsigned pass = (unsigned)(a >= tau) | (unsigned)(b >= tau) << 1 |
                    (unsigned)(c >= tau) << 2 | (unsigned)(d >= tau) << 3;
    while (pass) {
      const int q = __ffs(pass) - 1;
      pass &= pass - 1;
      L.push(q == 0 ? a : q == 1 ? b : q == 2 ? c : d, j + q);
    }
  };
  auto take = [&](float y, int j) {
    if (y >= tau) L.push(y, j);
  };
#pragma unroll
  for (int q = 0; q < kSample; ++q) {
    const int c = c0 + tid + q * stride * T;
    if (q * stride < R && c < c1) take4(sv[q], sm[q], head + 4 * c);
  }
  // the rest of the thread's chunks, four at a time, the next four's loads
  // in flight while these are taken
  for (int q0 = 0; q0 < R; q0 += 4) {
    float4 xn[4];
    bool okn[4];
    load4(q0 + 4, xn, okn);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + tid + (q0 + u) * T;
      if (ok[u]) take4(x[u], mask4(c), head + 4 * c);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = xn[u];
      ok[u] = okn[u];
    }
  }
  // the unaligned head (the first part) and the ragged tail (the last)
  if (rank == 0 && tid < head)
    take(live(s[tid], bm != nullptr && bit_at(bm, tid), gmean), tid);
  const int tail0 = head + 4 * nb;
  if (rank == parts - 1 && tail0 + tid < n) {
    const int j = tail0 + tid;
    take(live(s[j], bm != nullptr && bit_at(bm, j), gmean), j);
  }

  // the warp's k best: lane q holds the q-th
  float rv = -INFINITY;
  int ri = INT_MAX;
  for (int q = 0; q < k; ++q) {
    float hv = L.v[0];
    int hi = L.i[0];
    warp_best(hv, hi);
    if (hv == -INFINITY) break;  // the same on all lanes
    if (L.i[0] == hi) L.pop();
    if (lane == q) {
      rv = hv;
      ri = hi;
    }
  }
  if (lane < k) {
    wv[warp * k + lane] = rv;
    wi[warp * k + lane] = ri;
  }
  __syncthreads();
  // the CTA's k best: each of its warps' candidates goes to its rank among
  // them, if that is below k (no candidate of the CTA's top k is missing:
  // each warp kept its own k best)
  const int nw = kListWarps * k;
  float* dv = parts == 1 ? out_s + (size_t)row * k : cv;
  int* di = parts == 1 ? out_i + (size_t)row * k : ci;
  if (tid < nw && wv[tid] != -INFINITY) {
    const int r = rank_of(wv, wi, nw, wv[tid], wi[tid]);
    if (r < k) {
      dv[r] = wv[tid];
      di[r] = wi[tid];
    }
  }
  if (parts == 1) return;
  // the row's k best: CTA 0 gathers its cluster's lists, in rank order,
  // through distributed shared memory, and ranks them the same way
  cgrp::cluster_group cl = cgrp::this_cluster();
  cl.sync();
  if (rank == 0) {
    const int nc = parts * k;
    if (tid < nc) {
      wv[tid] = cl.map_shared_rank(cv, tid / k)[tid % k];
      wi[tid] = cl.map_shared_rank(ci, tid / k)[tid % k];
    }
    __syncthreads();
    if (tid < nc) {
      const int r = rank_of(wv, wi, nc, wv[tid], wi[tid]);
      if (r < k) {
        out_s[(size_t)row * k + r] = wv[tid];
        out_i[(size_t)row * k + r] = wi[tid];
      }
    }
  }
  cl.sync();  // no CTA leaves while CTA 0 may read its list
}

// -- topk_rounds -----------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
topk_rounds(const float* __restrict__ scores, const uint8_t* __restrict__ bits,
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
    warp_best(v, i);
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

template <int K>
cudaError_t launch_lists(const float* scores, const uint8_t* bits, int C,
                         int n, int k, float gmean, int parts, int words,
                         float* out_s, int* out_i, cudaStream_t st) {
  // a CTA's mask words: at most n / 32 / parts + 2 (its range's ends)
  const int smem = words ? 4 * ((n >> 5) / parts + 3) : 0;
  if (parts == 1) {
    topk_lists<K><<<C, kListThreads, smem, st>>>(scores, bits, n, k, gmean,
                                                 1, words, out_s, out_i);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * parts);
  cfg.blockDim = dim3(kListThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, topk_lists<K>, scores, bits, n, k,
                                     gmean, parts, words, out_s, out_i);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// scores (C, n) f32, bits (C, n / 8) uint8 or null; route 0 topk_rounds
// (any k), 1 topk_lists (k <= 32, a list of `list_k` = 16 or 32 entries a
// thread, `parts` CTAs a row, `words`: the mask read as 32-bit words,
// n % 32 == 0 and bits 4-byte aligned); out_s (C, k) f32, out_i (C, k)
// int32.
extern "C" int rsp_topk(const float* scores, const uint8_t* bits, int C, int n,
                        int k, float gmean, int route, int list_k, int parts,
                        int words, float* out_s, int* out_i, void* stream) {
  if (C <= 0) return 0;
  if (k <= 0 || k > n || (bits != nullptr && (n & 7)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    topk_rounds<<<C, kThreads, 0, st>>>(scores, bits, n, k, gmean, out_s,
                                        out_i);
    return (int)cudaGetLastError();
  }
  if (route != 1 || k > list_k || (parts != 1 && parts != 2 && parts != 4 &&
                                   parts != 8) ||
      (words && (bits == nullptr || (n & 31) || ((uintptr_t)bits & 3))) ||
      ((uintptr_t)scores & 3))
    return (int)cudaErrorInvalidValue;
  // the staged mask words fit the 48 KB of shared memory a launch may ask
  // for without an opt-in: rows of up to 393,216 / parts columns
  if (words && 4 * ((n >> 5) / parts + 3) > 48 * 1024) words = 0;
  if (list_k == 16)
    return (int)launch_lists<16>(scores, bits, C, n, k, gmean, parts, words,
                                 out_s, out_i, st);
  if (list_k == 32)
    return (int)launch_lists<32>(scores, bits, C, n, k, gmean, parts, words,
                                 out_s, out_i, st);
  return (int)cudaErrorInvalidValue;
}
