// The wide K2's and the wide K4's shared half: the layout of one row's
// lower triangle in 16-row panels dealt over a cluster of C CTAs, and the
// walk that sums a row's lhs (the Gram of its entries, the head's terms,
// then XtX or the ridge) and rhs into the panels a CTA owns.  See
// als_chol_wide.cu (K2, d <= 514: the factor stays in the cluster's shared
// memory) and als_nnls_wide.cu (K4: each CTA writes its panels out).
//
// The walk: every CTA lists the row's entries and stages their source rows
// itself (cp.async, two buffers of 16 rows, 8 for float32 tables) and sums
// only its own panels' lower m16n8 tiles on the tensor cores, with the
// operand routes of als_chol.cuh (3xTF32 on float32 tables, 2xTF32 or bf16
// mma on bf16 ones, both ways for the bf16-rounded implicit cold rows);
// each chunk goes into fresh fragments added in float32 to the panel in
// shared memory.  No CTA reads another's shared memory here.
//
// HALF says which matrix the panels hold where the lhs is not symmetric
// (the implicit cold rows rounded to bf16, compute_dtype="bfloat16", whose
// lhs is XtX + sum bf16(w x) x'):
//   0  the symmetric part (lhs + lhs') / 2, both products summed and halved,
//      XtX symmetrised (K2, which factors it as the reference does);
//   1  the lhs itself, lhs[i][j] for i >= j: bf16(w x_i) x_j, XtX[i][j];
//   2  its transpose, lhs[j][i] for i >= j: x_i bf16(w x_j), XtX[j][i]
//      (K4, whose G = lhs' lhs reads the whole lhs).
// On every other route the three are the lhs.

#pragma once

#include "als_chol.cuh"

namespace {


constexpr int kWideMaxD = 514;  // ops/als.py CHOL_MAX_D
// CTAs a row at the widest d: the smallest of 1, 2 and 4 whose layout
constexpr int kWidthCluster = 4;
constexpr int kMaxPanels = (kWideMaxD + kPanel - 1) / kPanel;  // 33
constexpr int kMaxOwn = kMaxPanels;  // panels a CTA holds, at most
// threads a CTA: 16 warps (18 Gram tiles a warp at most, 128 registers a
// thread)
constexpr int kWideThreads = 512;
constexpr int kWarpsW = kWideThreads / 32;
// a diagonal slot: L_kk (16 x 16), 1 / L_ii (16), z_k (16)
constexpr int kDiagF = kPanel * kPanel + 2 * kPanel;
constexpr int kLossPer = (kWideMaxD + 31) / 32;  // 17 values a lane
constexpr int kSmemLimit = 232448;

// ---- the cluster's layout, alike on the host and the card -----------------

// Position of `rank` in deal round `round` of a cluster of C CTAs: the
// direction turns each round.
__host__ __device__ constexpr int deal_pos(int round, int rank, int C) {
  return (round & 1) ? C - 1 - rank : rank;
}
// The CTA that holds panel p of nP: panels are dealt from the last down.
__host__ __device__ constexpr int panel_owner(int p, int nP, int C) {
  return deal_pos((nP - 1 - p) / C, (nP - 1 - p) % C, C);
}
// The panel `rank` takes in deal round r (< 0: none).
__host__ __device__ constexpr int own_panel(int r, int rank, int nP, int C) {
  return nP - 1 - (r * C + deal_pos(r, rank, C));
}
// Row stride of panel p: its 16 (p + 1) columns padded to 8 mod 32 floats,
// so a fragment's float2 accesses hit 32 banks.
__host__ __device__ constexpr int panel_lda(int p) {
  return 16 * (p + 1) + ((p & 1) ? 8 : 24);
}
__host__ __device__ constexpr int own_tiles(int rank, int nP, int C) {
  int t = 0;
  for (int r = 0; r * C < nP; ++r) {
    const int p = own_panel(r, rank, nP, C);
    if (p >= 0) t += 2 * (p + 1);
  }
  return t;
}
__host__ __device__ constexpr int own_floats(int rank, int nP, int C) {
  int f = 0;
  for (int r = 0; r * C < nP; ++r) {
    const int p = own_panel(r, rank, nP, C);
    if (p >= 0) f += kPanel * panel_lda(p);
  }
  return f;
}
// lower m16n8 tiles a warp sums, at most (cluster_size keeps to it)
constexpr int kMaxWarpTiles = 18;

struct WideLayout {
  int D, nP;
  int rs;        // bytes of one staged row's slot
  int granules;  // 16-byte granules a row's window can span
  int store;     // floats of the largest CTA's panels
  int rows;      // entries staged a chunk: 16 (bf16 rows), 8 (float32)
  int stage;     // bytes of the two staging buffers (or a column block)
  int list;      // byte offset of the entry list
  int panels;    // byte offset of the panels
  int extra;     // byte offset of the diagonal slots and vectors
  int signal;    // byte offset of the back substitution's mbarrier
  int bytes;     // shared bytes a CTA
};

__host__ __device__ inline WideLayout make_wide_layout(int d, int tbytes,
                                                       int C) {
  WideLayout L;
  L.D = (d + kPanel - 1) / kPanel * kPanel;
  L.nP = L.D / kPanel;
  L.granules = (d * tbytes + 30) / 16;
  int w = 4 * L.granules;
  w += ((8 - w) % 32 + 32) % 32;
  L.rs = 4 * w;
  L.store = 0;
  for (int c = 0; c < C; ++c) {
    const int f = own_floats(c, L.nP, C);
    L.store = f > L.store ? f : L.store;
  }
  L.rows = tbytes == 2 ? kRows : kRows / 2;
  L.stage = 2 * L.rows * L.rs;
  // the staging buffers hold a step's column block copy during the
  // factorisation: 16 floats a row below the first panel
  if (L.stage < 64 * (L.D - kPanel)) L.stage = 64 * (L.D - kPanel);
  L.list = L.stage;
  L.panels = L.list + kSeg * 12 + ((2 * kRows * 4 + 65 * 4 + 15) & ~15);
  L.extra = L.panels + 4 * L.store;
  // 3 diagonal slots; dinv, acc, x, dot operand (D each); z (kMaxOwn
  // blocks); scratch (32), the loss partial (4); panel tables (3 x 33 int)
  L.bytes = L.extra +
            4 * (3 * kDiagF + 4 * L.D + kMaxOwn * kPanel + 36 +
                 3 * kMaxPanels);
  // the back substitution's mbarrier, 8-byte aligned, last
  L.signal = (L.bytes + 15) & ~15;
  L.bytes = L.signal + 16;
  return L;
}

// The cluster size of width d: the smallest of 1, 2 and 4 CTAs a row whose
// layout fits a CTA's shared memory and whose warps sum at most
// kMaxWarpTiles Gram tiles (one CTA a row through d = 256 at float32).
__host__ __device__ inline int cluster_size(int d, int tbytes) {
  for (int C = 1; C < kWidthCluster; C *= 2) {
    const WideLayout L = make_wide_layout(d, tbytes, C);
    bool ok = L.bytes <= kSmemLimit;
    for (int c = 0; c < C; ++c)
      ok = ok && own_tiles(c, L.nP, C) <= kMaxWarpTiles * kWarpsW;
    if (ok) return C;
  }
  return kWidthCluster;
}

// A warp's run of its CTA's lower m16n8 tiles: own panels ascending, tile
// (m, n), n <= 2m + 1, within each.
template <int C>
struct ClusterRun {
  static constexpr int kMaxT = kMaxWarpTiles;
  int count, m0, n0, rank, nP;
  __device__ __forceinline__ ClusterRun(int rank_, int nP_, int warp)
      : rank(rank_), nP(nP_) {
    const int nT = own_tiles(rank, nP, C);
    const int per = (nT + kWarpsW - 1) / kWarpsW;
    int first = warp * per;
    count = max(0, min(per, nT - first));
    m0 = 0;
    n0 = 0;
    for (int r = (nP - 1) / C; r >= 0; --r) {
      const int p = own_panel(r, rank, nP, C);
      if (p < 0) continue;
      if (first < 2 * (p + 1)) {
        m0 = p;
        n0 = first;
        break;
      }
      first -= 2 * (p + 1);
    }
  }
  __device__ __forceinline__ void next(int& m, int& n) const {
    if (++n > 2 * m + 1) {
      n = 0;
      const int r = (nP - 1 - m) / C;
      m = own_panel(r - 1, rank, nP, C);
    }
  }
};

// The shared memory the walk uses, carved by the kernel from its
// WideLayout.
struct WideGramSmem {
  unsigned char* stage;  // the two staging buffers
  int* lidx;             // [kSeg] the listed entries' source rows
  float* lgw;            // [kSeg] their lhs weights
  float* lrw;            // [kSeg] their rhs weights
  int* soff;             // [2][kRows] the staged rows' byte offsets
  int* cnt;              // [64] + total: the head's compaction counts
  float* store;          // this CTA's panels
  const int* goff;       // panel -> float offset in its owner's panels
  const int* spanel;     // this CTA's slot -> panel
  float* zl;             // [kMaxOwn][16] the rhs rows of the own panels
};

// Row b's lhs into this CTA's panels (zeroed first; lower m16n8 tiles of
// each own panel, the diagonal block whole) and its rhs rows into S.zl,
// with the ridge or XtX added and the rhs_init; ends in a barrier.
template <class T, bool EXPLICIT, int C, int HALF>
__device__ __forceinline__ void wide_gram(const rsp::BucketArgs& a,
                                          const rsp::RowEntries<T>& R,
                                          float lam_use, const WideLayout& Ly,
                                          const ClusterRun<C>& run,
                                          const WideGramSmem& S, int n_own,
                                          int n_store) {
  unsigned char* const stage = S.stage;
  int* const lidx = S.lidx;
  float* const lgw = S.lgw;
  float* const lrw = S.lrw;
  int* const soff = S.soff;
  int* const cnt = S.cnt;
  float* const store = S.store;
  const int* const goff = S.goff;
  const int* const spanel = S.spanel;
  float* const zl = S.zl;
  const int d = a.d, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int D = Ly.D, rs = Ly.rs;
  const int nnz = R.nnz;
  const bool rnd = a.round_bf16 != 0;
  const bool doubled = HALF == 0 && rnd && !EXPLICIT && is_bf16<T>();
  const float scale = doubled ? 0.5f : 1.f;

  // the rhs rows of the own panels: thread tid < 16 n_own takes row
  // 16 spanel[tid / 16] + tid % 16
  const int rj = tid < kPanel * n_own ? kPanel * spanel[tid >> 4] + (tid & 15)
                                      : D;
  float rhs_acc = 0.f;
  for (int e = tid; e < n_store; e += kWideThreads) store[e] = 0.f;
  float c[kMaxWarpTiles][4];
#pragma unroll
  for (int t = 0; t < kMaxWarpTiles; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[t][q] = 0.f;

  // ---- (1) the Gram: one walk, each CTA its own panels ------------------
  const int n_cold = (nnz + kSeg - 1) / kSeg;
  const int n_head = R.w != nullptr ? (a.H + kSeg - 1) / kSeg : 0;
  const float head_scale = doubled ? 2.f : 1.f;
  constexpr int kCR = is_bf16<T>() ? kRows : kRows / 2;  // = Ly.rows
  for (int sg = 0; sg < n_cold + n_head; ++sg) {
    const bool head = sg >= n_cold;
    int n_list;
    if (!head) {
      const int c0 = sg * kSeg;
      n_list = min(kSeg, nnz - c0);
      const int n_pad = (n_list + kCR - 1) / kCR * kCR;
      for (int e = tid; e < n_pad; e += kWideThreads) {
        int col = 0;
        float gw = 0.f, rw = 0.f;
        if (e < n_list) {
          col = R.col[c0 + e];
          const float v = R.val[c0 + e];
          const float xb = a.xbias != nullptr ? __ldg(a.xbias + col) : 0.f;
          gw = rsp::lhs_weight<EXPLICIT>(v);
          rw = rnd ? rsp::rhs_weight_bf16<EXPLICIT>(v, xb, a.g_rhs, false)
                   : rsp::rhs_weight<EXPLICIT>(v, xb, a.g_rhs);
        }
        lidx[e] = col;
        lgw[e] = gw;
        lrw[e] = rw;
      }
      __syncthreads();
    } else {
      const int h0 = (sg - n_cold) * kSeg;
      unsigned bal[kSeg / kWideThreads];
      float wv[kSeg / kWideThreads];
#pragma unroll
      for (int q = 0; q < kSeg / kWideThreads; ++q) {
        const int h = h0 + q * kWideThreads + tid;
        wv[q] = h < a.H ? rsp::head_value(R, h) : 0.f;
        bal[q] = __ballot_sync(
            RSP_FULL_MASK, h < a.H && rsp::head_present(R.bits, wv[q], h));
        if (lane == 0) cnt[q * kWarpsW + warp] = __popc(bal[q]);
      }
      __syncthreads();
      constexpr int kCnt = kSeg / 32;  // counts (one a warp a pass): 32
      if (warp == 0) {  // exclusive scan of the counts, in column order
        constexpr int kPer = kCnt / 32;
        int v[kPer], sum = 0;
#pragma unroll
        for (int e = 0; e < kPer; ++e) sum += v[e] = cnt[kPer * lane + e];
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(RSP_FULL_MASK, incl, o);
          if (lane >= o) incl += y;
        }
        int excl = incl - sum;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          cnt[kPer * lane + e] = excl;
          excl += v[e];
        }
        if (lane == 31) cnt[kCnt] = incl;
      }
      __syncthreads();
      n_list = cnt[kCnt];
      const unsigned lt = (1u << lane) - 1u;
#pragma unroll
      for (int q = 0; q < kSeg / kWideThreads; ++q) {
        if ((bal[q] >> lane) & 1u) {
          const int pos = cnt[q * kWarpsW + warp] + __popc(bal[q] & lt);
          const float w = wv[q];
          lidx[pos] = h0 + q * kWideThreads + tid;
          lgw[pos] = head_scale * rsp::head_lhs_weight<EXPLICIT>(w, rnd);
          lrw[pos] = rnd ? rsp::rhs_weight_bf16<EXPLICIT>(w, 0.f, a.g_rhs,
                                                          true)
                         : rsp::rhs_weight<EXPLICIT>(w, 0.f, a.g_rhs);
        }
      }
      if (tid < kCR && n_list + tid < (n_list + kCR - 1) / kCR * kCR) {
        lidx[n_list + tid] = 0;
        lgw[n_list + tid] = 0.f;
        lrw[n_list + tid] = 0.f;
      }
      __syncthreads();
    }
    if (n_list == 0) continue;

    const T* src = head ? R.hot_table : R.table;
    const int row_bytes = d * (int)sizeof(T);
    auto load_chunk = [&](int ch) {
      unsigned char* buf = stage + (ch & 1) * kCR * rs;
      for (int e = tid; e < kCR * Ly.granules; e += kWideThreads) {
        const int l = e / Ly.granules, q = e - l * Ly.granules;
        const int k = ch * kCR + l;
        unsigned char* dst = buf + l * rs + 16 * q;
        if (k < n_list) {
          const size_t p =
              reinterpret_cast<size_t>(src + (size_t)lidx[k] * d);
          const int off = (int)(p & 15);
          if (q == 0) soff[(ch & 1) * kRows + l] = off;
          if (q < (off + row_bytes + 15) >> 4)
            rsp::cp_async16(
                dst,
                reinterpret_cast<const void*>((p & ~(size_t)15) + 16 * q),
                16);
        } else {
          if (q == 0) soff[(ch & 1) * kRows + l] = 0;
          rsp::cp_async16(dst, src, 0);  // zero fill
        }
      }
    };
    const int route = gram_route<T, EXPLICIT>(head, rnd);
    const int n_chunks = (n_list + kCR - 1) / kCR;
    load_chunk(0);
    rsp::cp_async_commit();
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) {
        load_chunk(ch + 1);
        rsp::cp_async_commit();
        rsp::cp_async_wait<1>();
      } else {
        rsp::cp_async_wait<0>();
      }
      __syncthreads();
      const unsigned char* buf = stage + (ch & 1) * kCR * rs;
      const int* off = soff + (ch & 1) * kRows;
      const float* gw = lgw + ch * kCR;
      const float* rw = lrw + ch * kCR;
      if (rj < d) {
#pragma unroll 8
        for (int l = 0; l < kCR; ++l)
          rhs_acc += rw[l] * sld<T>(buf + l * rs + off[l], rj);
      }
      if constexpr (!is_bf16<T>()) {
#pragma unroll
        for (int ks = 0; ks < kCR / 8; ++ks) {
          const int lA = 8 * ks + tig, lB = lA + 4;
          tf32_step<ClusterRun<C>, T, true>(c, run, buf + lA * rs + off[lA],
                                         buf + lB * rs + off[lB], gw[lA],
                                         gw[lB], d, g);
        }
      } else {
        if (route == kRouteTf32x2) {
#pragma unroll
          for (int ks = 0; ks < kCR / 8; ++ks) {
            const int lA = 8 * ks + tig, lB = lA + 4;
            tf32_step<ClusterRun<C>, T, false>(c, run, buf + lA * rs + off[lA],
                                            buf + lB * rs + off[lB], gw[lA],
                                            gw[lB], d, g);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < kCR / 16; ++ks) {
            const int r0 = 16 * ks + 2 * tig;
            const int rr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
            const unsigned char* const p[4] = {
                buf + rr[0] * rs + off[rr[0]], buf + rr[1] * rs + off[rr[1]],
                buf + rr[2] * rs + off[rr[2]], buf + rr[3] * rs + off[rr[3]]};
            const float w[4] = {gw[rr[0]], gw[rr[1]], gw[rr[2]], gw[rr[3]]};
            if (!EXPLICIT && route == kRouteBf16Sym)
              bf16_step<ClusterRun<C>, T, true, HALF>(c, run, p, w, d, g);
            else
              bf16_step<ClusterRun<C>, T, false>(c, run, p, w, d, g);
          }
        }
      }
      // the fresh fragments of 16 staged rows (two float32 chunks) into
      // the panels, in float32
      if (kCR == kRows || (ch & 1) || ch + 1 == n_chunks) {
        int m = run.m0, n = run.n0;
#pragma unroll
        for (int t = 0; t < kMaxWarpTiles; ++t) {
          if (t < run.count) {
            const int lda = panel_lda(m);
            float* P = store + goff[m] + 8 * n + 2 * tig;
            float2* p0 = reinterpret_cast<float2*>(P + g * lda);
            float2* p1 = reinterpret_cast<float2*>(P + (g + 8) * lda);
            float2 v0 = *p0, v1 = *p1;
            v0.x += c[t][0];
            v0.y += c[t][1];
            v1.x += c[t][2];
            v1.y += c[t][3];
            *p0 = v0;
            *p1 = v1;
#pragma unroll
            for (int q = 0; q < 4; ++q) c[t][q] = 0.f;
            run.next(m, n);
          }
        }
      }
      __syncthreads();  // the buffer is free for chunk ch + 2
    }
  }

  // the own panels: XtX or the ridge (identity on the padding) plus the
  // sums; the own z blocks: the rhs
  const float diag_v =
      EXPLICIT ? lam_use + ((nnz == 0 && lam_use == 0.f) ? 1.f : 0.f) : 0.f;
  // (a column of a panel a thread, its 16 rows' XtX loads in flight)
  for (int s = 0; s < n_own; ++s) {
    const int p = spanel[s], w = kPanel * (p + 1), lda = panel_lda(p);
    float* P = store + goff[p];
    for (int j = tid; j < w; j += kWideThreads) {
      float base[kPanel];
#pragma unroll
      for (int rr = 0; rr < kPanel; ++rr) {
        const int i = kPanel * p + rr;
        if (i >= d || j >= d) {
          base[rr] = i == j ? 1.f : 0.f;
        } else if (EXPLICIT) {
          base[rr] = i == j ? diag_v : 0.f;
        } else {
          base[rr] = doubled    ? 0.5f * (__ldg(a.XtX + i * d + j) +
                                          __ldg(a.XtX + j * d + i))
                     : HALF == 2 ? __ldg(a.XtX + j * d + i)
                                 : __ldg(a.XtX + i * d + j);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kPanel; ++rr) {
        float* q = P + rr * lda + j;
        *q = base[rr] + scale * *q;
      }
    }
  }
  if (rj < D)
    zl[tid] = rj < d ? rhs_acc + (a.rhs_init != nullptr ? a.rhs_init[rj]
                                                        : 0.f)
                     : 0.f;
  __syncthreads();
}

}  // namespace
