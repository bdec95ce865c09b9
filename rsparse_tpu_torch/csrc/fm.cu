// K8: one Factorization Machine row block, gathered by feature.
//
// Replaces the TPU program rsparse_tpu/models/fm.py:39 _fm_block_impl, and
// for FM the scheduled segment sums of rsparse_tpu/ops/segsum.py:784 that
// it runs on.  Its plain PyTorch version is rsparse_tpu_torch/models/fm.py
// _fm_block_plain.
//
// Every row of a block reads the block-start tables, and AdaGrad is
// accumulator first: a feature's step is -lr sum(g) / sqrt(acc + sum(g^2))
// over all its entries in the block (rsparse_tpu/models/fm.py:157-167).  As
// the reference's feature-grouped layout does, the update walks the block's
// entries grouped by feature (ops/segsum.py GLMBlock.order: the valid
// entries' flat indices sorted by slot, offs: each slot's range), so each
// feature's table rows are written once, with no atomics and no scratch to
// zero, and the result does not change from run to run:
//   A  rows: the prediction w0 + sum w x + (|s1|^2 - sum |v x|^2) / 2 with
//      s1 = sum v x, the link, dL = dL/draw * sample_w; writes y_hat, the
//      row's [dL, s1] (B, r + 1) and the CTA's sum dL, sum dL^2.  A row
//      takes G lanes (models/fm.py k8_plan: an entry's tpe = min(next power
//      of two >= r, 32) component lanes times the mean row length, rounded
//      up to a power of two, at most 32), so short rows share a warp; a
//      row's lanes load G entries' columns at once and then all their v
//      rows;
//   B  tiles of kTile consecutive entries of `order`, one warp a tile,
//      read 32 entries at a time (one a lane) and 32 / tpe entries a step
//      (loading several steps' table values together measured no faster):
//      each entry's clipped g_w = x dL + 2 lambda_w and g_v = dL x (s1 -
//      v x) + 2 lambda_v v (block-start v), their sums and sums of squares by a
//      segmented scan over the step's entries (an entry's segment is its
//      slot) carried from step to step; a feature whose entries all lie in
//      the tile takes its AdaGrad step there; the tile's first feature, if
//      it began before the tile, and its last, if it runs past it, leave
//      their sums in the tile's head / tail slot;
//   C  the features that run over tiles, a warp for each tile: the tile
//      where a feature begins sums its tail and the heads of the tiles it
//      runs into (offs says how far), its 32 / tpe entry groups taking
//      every (32 / tpe)-th slot, then a fixed tree, and takes the step; one
//      more CTA sums A's CTA partials in a fixed order and takes the
//      intercept's step.
// A feature in every row of a 32,768-row block spans 32,768 / kTile tiles:
// C sums them 32 / tpe at a time.  Tiles keep every warp's work in B the
// same whatever the features' counts; kTile = 128 (models/fm.py K8_TILE)
// was measured against 32 to 256 entries by kernel_times.py k8-tiles, which
// builds this file at other tiles through RSP_FM_TILE.
// Predict mode is launch A alone.
//
// What bounds it on the H100: bytes.  Per entry A reads the column, the
// value, w and one v row of r floats at a random feature; B reads each
// feature's w, v and accumulators and writes them once (at 40M features the
// tables are 1.3 GB, so mostly device memory); the rest ((B, r + 1) rows,
// the entries again) sits in L2.  ~10 r flops an entry.  At r = 8 every
// table access is a 32-byte sector at a random address, ten an entry of a
// hashed block, and device memory serves those near 1 TB/s on the H100, not
// its 3.35 (launch A alone: ~64 MB of sectors in ~0.065 ms).

#include "common.cuh"

namespace {

constexpr float kClip = 100.f;
constexpr int kMaxR = 128;   // widest v (models/fm.py MAX_RANK)
constexpr int kWarps = 8;    // warps a CTA, every launch
constexpr int kThreads = kWarps * 32;
#ifndef RSP_FM_TILE
#define RSP_FM_TILE 128      // models/fm.py K8_TILE
#endif
// entries a tile of launch B
constexpr int kTile = RSP_FM_TILE;
static_assert(kTile > 0 && kTile % 32 == 0, "a tile is whole steps of 32");

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// components a lane holds when an entry takes TPE lanes
template <int TPE>
__host__ __device__ constexpr int comps() {
  return TPE == 32 ? kMaxR / 32 : 1;
}

template <int TPE>
__global__ void __launch_bounds__(kThreads)
fm_rows(const int* __restrict__ col, const float* __restrict__ val,
        const int* __restrict__ nnz, const float* __restrict__ y,
        const float* __restrict__ sample_w, const float* __restrict__ w0,
        const float* __restrict__ w, const float* __restrict__ v, int B,
        int L, int r, int G, int family, int do_update,
        float* __restrict__ y_hat, float* __restrict__ rowbuf,
        float* __restrict__ dl_part) {
  constexpr int KR = comps<TPE>();
  __shared__ float part[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = (blockIdx.x * kWarps + warp) * (32 / G) + lane / G;
  const int gl = lane % G, g = gl / TPE, t = gl % TPE, per = G / TPE;
  const bool live = b < B;
  const int m = live ? nnz[b] : 0;
  const size_t base = (size_t)b * L;
  // the row's lanes: G of the warp's, starting at a multiple of G
  const unsigned gmask =
      G == 32 ? RSP_FULL_MASK : ((1u << G) - 1) << (lane & ~(G - 1));
  float s1[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j) s1[j] = 0.f;
  float sq = 0.f, lin = 0.f;
  // G entries at a time: each lane loads one entry's column and value, and
  // the TPE passes of G / TPE entries (their v rows) go out together
  for (int l0 = 0; l0 < m; l0 += G) {
    int cl = 0;
    float xl = 0.f;
    if (l0 + gl < m) {
      cl = col[base + l0 + gl];
      xl = val[base + l0 + gl];
    }
    const int cnt = min(G, m - l0);
#pragma unroll 8
    for (int i = 0; i < TPE; ++i) {
      const int src = g + per * i;
      const int c = __shfl_sync(gmask, cl, src, G);
      const float x = __shfl_sync(gmask, xl, src, G);
      if (src < cnt) {
        const float* vr = v + (size_t)c * r;
#pragma unroll
        for (int j = 0; j < KR; ++j) {
          const int k = t + j * TPE;
          if (k < r) {
            const float vx = vr[k] * x;
            s1[j] += vx;
            sq += vx * vx;
          }
        }
        if (t == 0) lin += w[c] * x;
      }
    }
  }
  // s1 over the row's entry slots: every slot then holds the row's s1
  for (int o = TPE; o < G; o <<= 1) {
#pragma unroll
    for (int j = 0; j < KR; ++j)
      s1[j] += __shfl_xor_sync(RSP_FULL_MASK, s1[j], o);
  }
  float s1sq = 0.f;
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < KR; ++j)
      if (t + j * TPE < r) s1sq += s1[j] * s1[j];
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    lin += __shfl_xor_sync(RSP_FULL_MASK, lin, o);
    sq += __shfl_xor_sync(RSP_FULL_MASK, sq, o);
    s1sq += __shfl_xor_sync(RSP_FULL_MASK, s1sq, o);
  }
  const float raw = w0[0] + lin + 0.5f * (s1sq - sq);
  if (live && gl == 0) y_hat[b] = family == 1 ? sigmoid(raw) : raw;
  if (!do_update) return;  // a kernel argument: the same on every thread
  float dL = 0.f;
  if (live) {
    const float yb = y[b];
    dL = (family == 1 ? (sigmoid(raw * yb) - 1.f) * yb : 2.f * (raw - yb))
         * sample_w[b];
    float* rb = rowbuf + (size_t)b * (r + 1);
    if (gl == 0) rb[0] = dL;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < KR; ++j)
        if (t + j * TPE < r) rb[1 + t + j * TPE] = s1[j];
    }
  }
  // the CTA's sum dL and sum dL^2, each row once, in a fixed order
  const float a = gl == 0 ? dL : 0.f;
  const float sa = rsp::warp_sum(a), sa2 = rsp::warp_sum(a * a);
  if (lane == 0) {
    part[warp][0] = sa;
    part[warp][1] = sa2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      s += part[i][0];
      s2 += part[i][1];
    }
    dl_part[2 * blockIdx.x] = s;
    dl_part[2 * blockIdx.x + 1] = s2;
  }
}

// A feature's sums as a lane holds them: [g_w, g_w^2, g_v (KR), g_v^2 (KR)]
// for components t + j TPE.
template <int TPE>
struct Sums {
  static constexpr int KR = comps<TPE>();
  static constexpr int NV = 2 + 2 * KR;
  float s[NV];
};

// A feature's table values as a lane holds them: w, acc_w, and v, acc_v at
// components t + j TPE.
template <int TPE>
struct Row {
  static constexpr int KR = comps<TPE>();
  int u, f;  // slot and feature (u = -1: no entry)
  float w, aw, v[KR], av[KR];
};

template <int TPE>
__device__ __forceinline__ void read_row(Row<TPE>& e, int t, int r,
                                         const float* w, const float* acc_w,
                                         const float* v, const float* acc_v) {
  constexpr int KR = comps<TPE>();
  e.w = w[e.f];
  e.aw = acc_w[e.f];
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int k = t + j * TPE;
    e.v[j] = k < r ? v[(size_t)e.f * r + k] : 0.f;
    e.av[j] = k < r ? acc_v[(size_t)e.f * r + k] : 0.f;
  }
}

// accumulator-first AdaGrad of feature e.f from its sums; lane t of the
// entry's lanes
template <int TPE>
__device__ __forceinline__ void adagrad(const Sums<TPE>& a, const Row<TPE>& e,
                                        int t, int r, float* w, float* acc_w,
                                        float* v, float* acc_v, float lr_w,
                                        float lr_v) {
  constexpr int KR = comps<TPE>();
  if (t == 0) {
    const float aw = e.aw + a.s[1];
    w[e.f] = e.w + -lr_w * a.s[0] / sqrtf(aw);
    acc_w[e.f] = aw;
  }
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int k = t + j * TPE;
    if (k < r) {
      const size_t i = (size_t)e.f * r + k;
      const float av = e.av[j] + a.s[2 + KR + j];
      v[i] = e.v[j] + -lr_v * a.s[2 + j] / sqrtf(av);
      acc_v[i] = av;
    }
  }
}

// a tile's head (which 0) or tail (1) slot: [sum g_w, sum g_w^2, sum g_v
// (r), sum g_v^2 (r)]
__device__ __forceinline__ float* span_slot(float* span, int tile, int which,
                                            int r) {
  return span + ((size_t)tile * 2 + which) * (2 + 2 * r);
}

template <int TPE>
__device__ __forceinline__ void store_sums(const Sums<TPE>& a, float* dst,
                                           int t, int r) {
  constexpr int KR = comps<TPE>();
  if (t == 0) {
    dst[0] = a.s[0];
    dst[1] = a.s[1];
  }
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int k = t + j * TPE;
    if (k < r) {
      dst[2 + k] = a.s[2 + j];
      dst[2 + r + k] = a.s[2 + KR + j];
    }
  }
}

template <int TPE>
__device__ __forceinline__ void add_sums(Sums<TPE>& a, const float* src,
                                         int t, int r) {
  constexpr int KR = comps<TPE>();
  a.s[0] += src[0];
  a.s[1] += src[1];
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int k = t + j * TPE;
    if (k < r) {
      a.s[2 + j] += src[2 + k];
      a.s[2 + KR + j] += src[2 + r + k];
    }
  }
}

template <int TPE>
__global__ void __launch_bounds__(kThreads)
fm_feats(const int* __restrict__ order, const int* __restrict__ slot,
         const int* __restrict__ col, const float* __restrict__ val,
         const int* __restrict__ offs, const float* __restrict__ rowbuf,
         float* w, float* acc_w, float* v, float* acc_v, int N, int L, int r,
         int n_tiles, float lr_w, float lr_v, float lam_w, float lam_v,
         float* __restrict__ span, int* __restrict__ tail_u) {
  constexpr int KR = comps<TPE>();
  constexpr int S = 32 / TPE;  // entries a step
  constexpr int NV = Sums<TPE>::NV;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  const int sub = lane / TPE, t = lane % TPE;
  const int e0 = tile * kTile, e1 = min(e0 + kTile, N);
  // the tile's first and last slots, and whether their entries run past
  // the tile (read with the first and the last 32 entries)
  int u_first = -1, u_last = -1;
  bool cross_in = false, own_tail = false;

  // a segment's sums are done: a head or tail slot, or the feature's step
  auto finish = [&](const Sums<TPE>& a, const Row<TPE>& e) {
    if (e.u == u_first && cross_in)
      store_sums<TPE>(a, span_slot(span, tile, 0, r), t, r);
    else if (e.u == u_last && own_tail)
      store_sums<TPE>(a, span_slot(span, tile, 1, r), t, r);
    else
      adagrad<TPE>(a, e, t, r, w, acc_w, v, acc_v, lr_w, lr_v);
  };

  Sums<TPE> c;  // the segment open at the last step's end (every lane)
  Row<TPE> ce;  // and its feature's table values
#pragma unroll
  for (int i = 0; i < NV; ++i) c.s[i] = 0.f;
  ce.u = -1;
  const int R1 = r + 1;
  for (int sb = e0; sb < e1; sb += 32) {
    // 32 entries at a time, one a lane: its flat index, slot, feature, value
    const int n_sub = min(32, e1 - sb);
    int p = 0, u = -1, f = 0;
    float x = 0.f;
    if (lane < n_sub) {
      p = order[sb + lane];
      u = slot[p];
      f = col[p];
      x = val[p];
    }
    const int bq = p / L;
    if (sb == e0) {
      u_first = __shfl_sync(RSP_FULL_MASK, u, 0);
      cross_in = offs[u_first] < e0;
    }
    if (sb + 32 >= e1) {
      u_last = __shfl_sync(RSP_FULL_MASK, u, n_sub - 1);
      own_tail = offs[u_last + 1] > e1 && !(u_last == u_first && cross_in);
    }
    for (int s = 0; s < n_sub; s += S) {
      // the step's entries: one an entry group, its row sums and table values
      const int idx = s + sub;  // < 32
      Row<TPE> en;
      en.u = __shfl_sync(RSP_FULL_MASK, u, idx);
      en.f = __shfl_sync(RSP_FULL_MASK, f, idx);
      const float xe = __shfl_sync(RSP_FULL_MASK, x, idx);
      const int bb = __shfl_sync(RSP_FULL_MASK, bq, idx);
      Sums<TPE> a;
#pragma unroll
      for (int i = 0; i < NV; ++i) a.s[i] = 0.f;
      if (idx < n_sub) {
        const float* rb = rowbuf + (size_t)bb * R1;
        read_row<TPE>(en, t, r, w, acc_w, v, acc_v);
        const float dL = rb[0];
        const float gw = clip(xe * dL + 2.f * lam_w);
        a.s[0] = gw;
        a.s[1] = gw * gw;
#pragma unroll
        for (int j = 0; j < KR; ++j) {
          const int k = t + j * TPE;
          if (k < r) {
            const float vk = en.v[j];
            const float gv = clip(dL * xe * (rb[1 + k] - vk * xe)
                                  + 2.f * lam_v * vk);
            a.s[2 + j] = gv;
            a.s[2 + KR + j] = gv * gv;
          }
        }
      } else {
        en.u = -1;
      }
      const int uu = en.u;
      // segmented inclusive scan over the step's entries: `order` is
      // sorted by slot, so an equal slot d entries back is in the same
      // segment
#pragma unroll
      for (int o = 1; o < S; o <<= 1) {
        const int ou = __shfl_up_sync(RSP_FULL_MASK, uu, o * TPE);
        const bool same = sub >= o && ou == uu;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float q = __shfl_up_sync(RSP_FULL_MASK, a.s[i], o * TPE);
          if (same) a.s[i] += q;
        }
      }
      const int u0 = __shfl_sync(RSP_FULL_MASK, uu, 0);
      if (ce.u >= 0 && ce.u != u0) {
        if (sub == 0) finish(c, ce);  // ended with the last step
      } else if (uu == ce.u) {
#pragma unroll
        for (int i = 0; i < NV; ++i) a.s[i] += c.s[i];
      }
      const int last = min(S, n_sub - s) - 1;
      const int nu = __shfl_down_sync(RSP_FULL_MASK, uu, TPE);
      if (sub < last && nu != uu) finish(a, en);  // ends in the step
      // the segment open at the step's end, on every lane
      const int src = last * TPE + t;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        c.s[i] = __shfl_sync(RSP_FULL_MASK, a.s[i], src);
      ce.u = __shfl_sync(RSP_FULL_MASK, uu, src);
      ce.f = __shfl_sync(RSP_FULL_MASK, en.f, src);
      ce.w = __shfl_sync(RSP_FULL_MASK, en.w, src);
      ce.aw = __shfl_sync(RSP_FULL_MASK, en.aw, src);
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        ce.v[j] = __shfl_sync(RSP_FULL_MASK, en.v[j], src);
        ce.av[j] = __shfl_sync(RSP_FULL_MASK, en.av[j], src);
      }
    }
  }
  if (sub == 0) finish(c, ce);  // the tile's last segment
  if (lane == 0) tail_u[tile] = own_tail ? u_last : -1;
}

template <int TPE>
__global__ void __launch_bounds__(kThreads)
fm_span(const int* __restrict__ tail_u, const int* __restrict__ offs,
        const int* __restrict__ feats, const float* __restrict__ span,
        float* w, float* acc_w, float* v, float* acc_v, int n_tiles, int r,
        float lr_w, float lr_v, const float* __restrict__ dl_part,
        int n_part, float* w0, float* acc_w0, int intercept) {
  if (blockIdx.x == gridDim.x - 1) {
    if (!intercept) return;
    // the intercept: A's CTA partials in a fixed order
    __shared__ float red[kWarps][2];
    float s = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < n_part; i += kThreads) {
      s += dl_part[2 * i];
      s2 += dl_part[2 * i + 1];
    }
    s = rsp::warp_sum(s);
    s2 = rsp::warp_sum(s2);
    if ((threadIdx.x & 31) == 0) {
      red[threadIdx.x >> 5][0] = s;
      red[threadIdx.x >> 5][1] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = 0.f, a2 = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        a += red[i][0];
        a2 += red[i][1];
      }
      const float acc = acc_w0[0] + a2;
      acc_w0[0] = acc;
      w0[0] -= lr_w * a / sqrtf(acc);
    }
    return;
  }
  // one warp a tile; the tile that owns a feature's tail sums its slots:
  // the warp's 32 / TPE entry groups take every (32 / TPE)-th slot in turn,
  // then add their sums in a fixed tree
  constexpr int S = 32 / TPE;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  const int u = tail_u[tile];
  if (u < 0) return;
  const int sub = lane / TPE, t = lane % TPE;
  const int t1 = (offs[u + 1] - 1) / kTile;
  Sums<TPE> a;
#pragma unroll
  for (int i = 0; i < Sums<TPE>::NV; ++i) a.s[i] = 0.f;
  for (int q = tile + sub; q <= t1; q += S)
    add_sums<TPE>(a, span_slot(const_cast<float*>(span), q, q == tile, r), t,
                  r);
#pragma unroll
  for (int o = TPE; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < Sums<TPE>::NV; ++i)
      a.s[i] += __shfl_xor_sync(RSP_FULL_MASK, a.s[i], o);
  }
  if (sub != 0) return;
  Row<TPE> e;
  e.u = u;
  e.f = feats[u];
  read_row<TPE>(e, t, r, w, acc_w, v, acc_v);
  adagrad<TPE>(a, e, t, r, w, acc_w, v, acc_v, lr_w, lr_v);
}

struct Block {
  const int *col, *nnz, *slot, *feats, *order, *offs;
  const float *val, *y, *sample_w;
};

template <int TPE>
cudaError_t run(const Block& k, float* w0, float* acc_w0, float* w, float* v,
                float* acc_w, float* acc_v, float* scratch, int N, int B,
                int L, int r, int G, float lr_w, float lr_v,
                float lam_w, float lam_v, int family, int intercept,
                int do_update, float* y_hat, cudaStream_t st) {
  const int rows_cta = kWarps * (32 / G);
  const int n_part = (B + rows_cta - 1) / rows_cta;
  const int n_tiles = (N + kTile - 1) / kTile;
  // scratch: rows (B, r + 1), A's partials (n_part, 2), tiles' slots
  // (n_tiles, 2, 2 + 2r), tiles' tail slots (n_tiles) int32
  float* rowbuf = scratch;
  float* dl_part = rowbuf + (size_t)B * (r + 1);
  float* span = dl_part + 2 * (size_t)n_part;
  int* tail_u =
      reinterpret_cast<int*>(span + (size_t)n_tiles * 2 * (2 + 2 * r));
  fm_rows<TPE><<<n_part, kThreads, 0, st>>>(
      k.col, k.val, k.nnz, k.y, k.sample_w, w0, w, v, B, L, r, G, family,
      do_update, y_hat, rowbuf, dl_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !do_update) return err;
  if (n_tiles > 0) {
    fm_feats<TPE><<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        k.order, k.slot, k.col, k.val, k.offs, rowbuf, w, acc_w, v, acc_v, N,
        L, r, n_tiles, lr_w, lr_v, lam_w, lam_v, span, tail_u);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = (unsigned)((n_tiles + kWarps - 1) / kWarps) + 1;
  fm_span<TPE><<<grid, kThreads, 0, st>>>(
      tail_u, k.offs, k.feats, span, w, acc_w, v, acc_v, n_tiles, r, lr_w,
      lr_v, dl_part, n_part, w0, acc_w0, intercept);
  return cudaGetLastError();
}

}  // namespace

// col/val/slot (B, L), nnz/y/sample_w/y_hat (B,); w0/acc_w0 one float each,
// w/acc_w (F + 1,), v/acc_v (F + 1, r) f32, updated in place; feats (U,),
// order (N,), offs (U + 1,) int32; scratch of at least k8_plan's scratch
// floats (null in predict mode), whose tiles are kTile entries.  tpe and G
// are models/fm.py k8_plan: lanes an entry, lanes a row (a power of two in
// [tpe, 32]).
extern "C" int rsp_fm_block(const int* col, const float* val, const int* nnz,
                            const int* slot, const float* y,
                            const float* sample_w, float* w0, float* acc_w0,
                            float* w, float* v, float* acc_w, float* acc_v,
                            const int* feats, const int* order,
                            const int* offs, float* scratch, int U, int N,
                            int B, int L, int r, int tpe, int G, float lr_w,
                            float lr_v, float lam_w, float lam_v, int family,
                            int intercept, int do_update, float* y_hat,
                            void* stream) {
  if (B <= 0) return 0;
  int want = 1;
  while (want < r && want < 32) want <<= 1;
  if (L <= 0 || U < 0 || N < 0 || r < 1 || r > kMaxR || tpe != want ||
      G < tpe || G > 32 || (G & (G - 1)) || (do_update && !scratch))
    return (int)cudaErrorInvalidValue;
  const Block k{col, nnz, slot, feats, order, offs, val, y, sample_w};
  cudaStream_t st = (cudaStream_t)stream;
#define RSP_FM_RUN(T)                                                      \
  case T:                                                                  \
    return (int)run<T>(k, w0, acc_w0, w, v, acc_w, acc_v, scratch, N, B, L, \
                       r, G, lr_w, lr_v, lam_w, lam_v, family,           \
                       intercept, do_update, y_hat, st);
  switch (tpe) {
    RSP_FM_RUN(1)
    RSP_FM_RUN(2)
    RSP_FM_RUN(4)
    RSP_FM_RUN(8)
    RSP_FM_RUN(16)
    RSP_FM_RUN(32)
  }
#undef RSP_FM_RUN
  return (int)cudaErrorInvalidValue;
}
