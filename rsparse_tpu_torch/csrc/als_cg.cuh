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
// For target row b, with x_e the source rows its entries touch (cold
// entries from the bucket, zipf-head entries from the dense weights), c_e
// their values and xb_e their source biases (common.cuh lhs_weight /
// rhs_weight / entry_loss):
//   rhs   = sum_e rw_e x_e + rhs_init
//   A p   = XtX p + sum_e (c_e - 1) (x_e . p) x_e        (implicit)
//   A p   = lam_use p + sum_e (x_e . p) x_e              (explicit)
//   x     = cg_steps of CG from x0, an entity freezing once rsold < tol
//   loss  = sum_e entry_loss + lam_use |x|^2
// Explicit rows see only their observed entries; lam_use is lambda times
// the row's total nnz with dynamic lambda; a head entry is present where its
// packed bit is set, so a stored 0.0 rating enters the lhs and the loss.
//
// The design.  A CTA of 32 warps (one an SM: 64 registers a thread)
// holds a tile of `rows` target rows (16, 8, 4, 2 or 1) and a cluster of
// `cluster` CTAs (1 to 16) shares one tile: ops/als.py cg_split chooses
// both from the bucket's shape, so that short rows share a CTA and a long
// row is split over up to 512 warps.  The passes are: the rhs less A x0 in
// one walk of the entries, cg_steps products A p, the loss.  Each sums
// three kinds of terms into a 16 x d tile, which then meets in every CTA
// of the cluster:
//  - cold entries: each row's 32 / rows warps of each CTA of the cluster
//    take its entries in chunks of 32, dealt round robin, four source rows
//    at a time loaded without a branch (all in flight at once), their four
//    dots reduced together in six shuffles (dots4) and each weight formed
//    by the eight lanes holding its dot;
//  - the dense head, 64 columns a panel.  At the first pass each CTA counts
//    the tile's present cells in its panels (panels are dealt round robin
//    to the cluster's CTAs): a panel with none is skipped, one with fewer
//    than `tau` is walked cell by cell like cold entries (each warp keeps
//    the cells of its row's share in shared memory, L.cache of them, so
//    later passes read W no more; a share that overflows is streamed from
//    W every pass), and a denser one is a tile product on the tensor
//    cores: Vh's panel is staged in shared memory once for the whole tile
//    (cp.async, two buffers), T = P Vh' (P the tile's p, or y for the
//    loss), weighted by the head cells (W1 = Wc - 1 implicit, the presence
//    bit explicit, a uint8 code times its row's scale), then T_w Vh is
//    added to the tile; the rhs term (Wc, or Wc - W1 g) is the second
//    product alone and the loss term reads T.  Operands: at f32 3xTF32 (A
//    and B split into tf32 hi + lo, the lo * lo term dropped; 2xTF32 on a
//    bf16 table, which tf32 holds); with compute_dtype="bfloat16" bf16 mma
//    on the reference's operands, bf16(p) against bf16 Vh, then
//    bf16(bf16(T) W1) (common.cuh matvec_coef_bf16) against Vh (2xTF32 for
//    the first pass's rw - coef, which bf16 does not hold).  Each k-step
//    is summed into fresh fragments, added in f32 (the tensor core
//    truncates as it adds into a growing sum);
//  - the tile's dense terms, P XtX (implicit; one 16 x d x d tile product
//    a pass on the tensor cores, 3xTF32, XtX read once for the tile),
//    lam_use p (explicit) or rhs_init, by the CTA that owns the columns.
// The partial tiles of a cluster meet through distributed shared memory
// (cluster.map_shared_rank, one cluster.sync a reduction, two buffers), each
// CTA summing the ranks in the same order, so every CTA holds the same x,
// r, p and scalars.  The CG scalars of a row are sums over its d values in
// one warp.
//
// compute_dtype="bfloat16" (round_bf16): V and Vh are the bf16 shadow
// tables, and the kernel rounds where the reference's bf16 operands round
// (common.cuh rhs_weight_bf16 / matvec_coef_bf16, dot_operand): bf16(p)
// and bf16(y) before each product against a row, each matvec term before
// its second product, the rhs weights, the head's Wc, W1 and Wc - W1 g;
// sums and the CG recurrences stay float32, except the dots that a walked
// matvec coefficient is formed from: they are summed in float64 (their
// products are exact), so that the coefficient's bf16 rounding falls where
// the plain version's float64 twin puts it.  A uint8 head is dequantised
// where a cell is read (code * scale, common.cuh head_value).
//
// rsp_hot_chain runs the head term of a tile alone (rows with no cold
// entries, no XtX and no rhs_init: the same head code K1 runs), the
// counterpart of the Pallas probe scripts/exp_bisect3.py:15 tryk (kernels
// ka, kb, kc at :40-64, kd at :69 with its pallas_call at :80): mode 1 the
// matvec term bf16(bf16(x.bf16(p)) W1) summed over the present head rows,
// mode 0 the rhs term bf16(Wc - bf16(W1 g)).
//
// What bounds it on the H100: each pass reads every cold entry's and walked
// head cell's d-value source row (nnz * d * 4 bytes, or 2 with a bf16
// table, mostly L2 hits: a 65,536 x 128 f32 table is 32 MB of the 50 MB
// L2), the head's weights and its tile panels of Vh once a tile.  A walked
// entry costs 4 d flops a pass, far below the FP32 peak, so the walk is
// bound by the rate the L2 serves random rows at (about 3 TB/s measured);
// the tile products by their chain of staging, two products and three
// barriers a panel, a cost a panel whatever its cells: they overtake the
// walk at about 72% present cells at 3xTF32, 75% at 2xTF32 and 42% on bf16
// mma (ops/als.py CG_TAU), which is why sparser panels are walked.  Two
// widths are built: d <= 128 keeps 4 values a lane, d <= 160 (rank 128
// with biases is d = 129) 5; each for float and bf16 tables, each in its
// own translation unit (als_cg_{128,160}_{f32,bf16}.cu, compiled in
// parallel; als_cg.cu holds the C entry points); the source biases, the
// rounding and the head's storage kind are runtime flags.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cgrp = cooperative_groups;

namespace rsp_cg {

constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
// output n8 tiles a warp holds in the combine (d <= 160: 20 tiles)
constexpr int kNT = (160 / 8 + kWarps - 1) / kWarps;
constexpr int kTile = 16;    // rows of a tile product (mma M)
constexpr int kPanel = 64;   // head columns a panel
constexpr int kU = 4;        // source rows a warp loads at once
// sparse head cells a warp keeps: what shared memory leaves (Layout.cache),
// within these bounds; a stream refills the buffer two panels at a time
constexpr int kCacheMin = 160, kCacheMax = 1024;
static_assert(31 + 2 * kPanel <= kCacheMin, "the stream's buffer");
constexpr int kSmemLimit = 232448;  // shared bytes a CTA may use (H100)
constexpr int kTw = kPanel + 4;

// The launch ops/als.py cg_plan chooses (ctypes mirror: _kernels.CgPlan).
struct Plan {
  int rows;     // target rows a CTA: 16, 8, 4, 2 or 1
  int cluster;  // CTAs a tile: 1, 2, 4, 8 or 16
  int tau;      // present cells from which a panel is a tile product
};

template <class T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Shared-memory layout of one CTA (byte offsets), alike on host and card.
struct Layout {
  int Dk;    // d rounded up to 16 (the products' depth)
  int sp;    // row stride of the tile's vectors (floats)
  int sv;    // row stride of a staged Vh row (elements of T)
  int npan;  // head panels
  int cache;  // sparse head cells a warp keeps
  int x, r, p, pb, ap, red, tw, vh0, vh1, pbuf0, pbuf1, lbuf0, lbuf1, lossp,
      scal, cache_h, cache_c, pcnt, dlist, slist, misc;
  int bytes;
};

__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += (n + 15) & ~15;
  return at;
}

__host__ __device__ inline Layout make_layout(int d, int H, int tbytes,
                                              int cluster) {
  Layout L;
  int o = 0;
  L.Dk = (d + 15) / 16 * 16;
  L.sp = L.Dk + 4;
  L.sv = tbytes == 4 ? L.Dk + 4 : L.Dk + 8;
  L.npan = (H + kPanel - 1) / kPanel;
  const int vec = kTile * L.sp * 4;
  L.x = take(o, vec);
  L.r = take(o, vec);
  L.p = take(o, vec);
  L.pb = take(o, vec);
  L.ap = take(o, vec);
  L.red = take(o, kWarps * L.sp * 4);
  const bool head = H > 0;
  L.tw = take(o, head ? kTile * kTw * 4 : 0);
  L.vh0 = take(o, head ? kPanel * L.sv * tbytes : 0);
  L.vh1 = take(o, head ? kPanel * L.sv * tbytes : 0);
  L.pbuf0 = take(o, cluster > 1 ? vec : 0);
  L.pbuf1 = take(o, cluster > 1 ? vec : 0);
  L.lbuf0 = take(o, kTile * 4);
  L.lbuf1 = take(o, kTile * 4);
  L.lossp = take(o, (kWarps + 8) * kTile * 4);
  L.scal = take(o, kTile * 8 * 4);
  L.pcnt = take(o, L.npan * 4);
  L.dlist = take(o, L.npan * 4);
  L.slist = take(o, L.npan * 4);
  L.misc = take(o, 16);
  int cap = ((kSmemLimit - o) / (kWarps * 8)) & ~31;
  cap = cap < kCacheMin ? kCacheMin : (cap > kCacheMax ? kCacheMax : cap);
  L.cache = head ? cap : 0;
  L.cache_h = take(o, kWarps * L.cache * 4);
  L.cache_c = take(o, kWarps * L.cache * 4);
  L.bytes = o;
  return L;
}

// scal[row * 8 + k]
constexpr int kRsold = 0, kDot = 1, kLam = 2;

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// two floats that bf16 holds exactly, as an mma operand register
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = rsp::to_tf32(v);
  lo = rsp::to_tf32(v - __uint_as_float(hi));
}
// element k of a staged Vh row as float
template <class T>
__device__ __forceinline__ float vld(const T* row, int k) {
  if constexpr (is_bf16<T>()) {
    return __uint_as_float(
        (unsigned)reinterpret_cast<const unsigned short*>(row)[k] << 16);
  } else {
    return row[k];
  }
}

// The per-warp state of its share of the sparse head cells.
struct WarpCache {
  int n;      // cells cached (valid when !over)
  bool over;  // more than L.cache: walk the panels again every pass
};

template <int KD, class T, bool EXPLICIT>
struct Tile {
  static constexpr int PL = KD / 32;
  const rsp::BucketArgs a;
  Layout L;
  int d, RT, CS, rank, wpr, tau, b0, nvalid;
  int warp, lane, g, tig, wr, wj;
  bool rnd;
  float *x, *r, *p, *pb, *ap, *red, *tw, *pbuf0, *pbuf1, *lbuf0, *lbuf1,
      *lossp, *scal;
  T *vh0, *vh1;
  int* cache_h;
  float* cache_c;
  int *pcnt, *dlist, *slist, *misc;
  int par;  // which of the two cluster buffers the next reduction uses

  __device__ Tile(const rsp::BucketArgs& args, const Plan& pl,
                  unsigned char* smem, int tile, int rank_)
      : a(args) {
    d = a.d;
    L = make_layout(d, a.W != nullptr ? a.H : 0, (int)sizeof(T), pl.cluster);
    RT = pl.rows;
    CS = pl.cluster;
    rank = rank_;
    wpr = kWarps / RT;
    tau = pl.tau;
    b0 = tile * RT;
    nvalid = min(RT, a.B - b0);
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    tig = lane & 3;
    wr = warp / wpr;
    wj = warp % wpr;
    rnd = a.round_bf16 != 0;
    auto F = [&](int off) { return reinterpret_cast<float*>(smem + off); };
    x = F(L.x);
    r = F(L.r);
    p = F(L.p);
    pb = F(L.pb);
    ap = F(L.ap);
    red = F(L.red);
    tw = F(L.tw);
    pbuf0 = F(L.pbuf0);
    pbuf1 = F(L.pbuf1);
    lbuf0 = F(L.lbuf0);
    lbuf1 = F(L.lbuf1);
    lossp = F(L.lossp);
    scal = F(L.scal);
    vh0 = reinterpret_cast<T*>(smem + L.vh0);
    vh1 = reinterpret_cast<T*>(smem + L.vh1);
    cache_h = reinterpret_cast<int*>(smem + L.cache_h) + warp * L.cache;
    cache_c = F(L.cache_c) + warp * L.cache;
    pcnt = reinterpret_cast<int*>(smem + L.pcnt);
    dlist = reinterpret_cast<int*>(smem + L.dlist);
    slist = reinterpret_cast<int*>(smem + L.slist);
    misc = reinterpret_cast<int*>(smem + L.misc);
    par = 0;
  }

  __device__ bool has_head() const { return a.W != nullptr && a.H > 0; }
  // the buffers by parity (selects, so no array is indexed at run time)
  __device__ T* vhb(int i) const { return (i & 1) ? vh1 : vh0; }
  __device__ float* pbf(int i) const { return (i & 1) ? pbuf1 : pbuf0; }
  __device__ float* lbf(int i) const { return (i & 1) ? lbuf1 : lbuf0; }

  // ---- set-up ---------------------------------------------------------------

  // Zero the tile's vectors (padding rows and columns stay 0) and both Vh
  // buffers (the columns past d stay 0); x = x0; the rows' ridges.
  __device__ void init() {
    const int n = 5 * kTile * L.sp;  // x, r, p, pb, ap are contiguous
    for (int i = threadIdx.x; i < n; i += kThreads) x[i] = 0.f;
    if (has_head()) {
      const int nv = 2 * kPanel * L.sv * (int)sizeof(T) / 4;
      float* v = reinterpret_cast<float*>(vh0);
      for (int i = threadIdx.x; i < nv; i += kThreads) v[i] = 0.f;
    }
    __syncthreads();
    if (a.x0 != nullptr) {
      for (int i = threadIdx.x; i < nvalid * d; i += kThreads) {
        const int rr = i / d, t = i - rr * d;
        x[rr * L.sp + t] = a.x0[(size_t)(b0 + rr) * d + t];
      }
    }
    if (threadIdx.x < kTile) {
      const int rr = threadIdx.x;
      scal[rr * 8 + kLam] = rr < nvalid ? rsp::row_lambda(a, b0 + rr) : 0.f;
    }
    __syncthreads();
  }

  // Whether head column h of a row is present, and its value.
  __device__ __forceinline__ bool cell(const rsp::RowEntries<T>& R, int h,
                                       float* c) const {
    if (h >= a.H) {
      *c = 0.f;
      return false;
    }
    *c = rsp::head_value(R, h);
    return rsp::head_present(R.bits, *c, h);
  }

  // Count the tile's present cells in this CTA's panels; list its dense
  // panels (>= tau cells) and sparse ones (1 to tau - 1), in order.
  __device__ void classify() {
    for (int i = threadIdx.x; i < L.npan; i += kThreads) pcnt[i] = 0;
    __syncthreads();
    if (wr < nvalid) {
      const rsp::RowEntries<T> R = rsp::row_entries<T>(a, b0 + wr);
      // this warp's panels: rank + CS (wj + wpr q)
      for (int q0 = wj; rank + CS * q0 < L.npan; q0 += 4 * wpr) {
        float cv[8];
        bool pr[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pn = rank + CS * (q0 + u * wpr);
#pragma unroll
          for (int s = 0; s < 2; ++s)
            pr[2 * u + s] = pn < L.npan &&
                            cell(R, pn * kPanel + 32 * s + lane, &cv[2 * u + s]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pn = rank + CS * (q0 + u * wpr);
          const int n = __popc(__ballot_sync(RSP_FULL_MASK, pr[2 * u])) +
                        __popc(__ballot_sync(RSP_FULL_MASK, pr[2 * u + 1]));
          if (lane == 0 && pn < L.npan && n > 0) atomicAdd(pcnt + pn, n);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      int nd = 0, ns = 0;
      for (int base = 0; base < L.npan; base += 32) {
        const int pn = base + lane;
        const int n = (pn < L.npan && pn % CS == rank) ? pcnt[pn] : 0;
        const unsigned md = __ballot_sync(RSP_FULL_MASK, n >= tau);
        const unsigned ms = __ballot_sync(RSP_FULL_MASK, n > 0 && n < tau);
        const unsigned below = (1u << lane) - 1u;
        if (n >= tau) dlist[nd + __popc(md & below)] = pn;
        if (n > 0 && n < tau) slist[ns + __popc(ms & below)] = pn;
        nd += __popc(md);
        ns += __popc(ms);
      }
      if (lane == 0) {
        misc[0] = nd;
        misc[1] = ns;
      }
    }
    __syncthreads();
  }

  // ---- entries walked one source row each ------------------------------------

  // Four dot products summed over the warp with six shuffles: halves
  // exchanged at lane distance 16 and 8, then a butterfly over the eight
  // lanes that share lane bits 4 and 3.  Lane l ends with the sum of entry
  // (l >> 3) & 3.
  template <class A>
  __device__ __forceinline__ A dots4(A s0, A s1, A s2, A s3) const {
    const bool hi = (lane & 16) != 0, b3 = (lane & 8) != 0;
    const A k0 = (hi ? s2 : s0) +
                 __shfl_xor_sync(RSP_FULL_MASK, hi ? s0 : s2, 16);
    const A k1 = (hi ? s3 : s1) +
                 __shfl_xor_sync(RSP_FULL_MASK, hi ? s1 : s3, 16);
    A v = (b3 ? k1 : k0) + __shfl_xor_sync(RSP_FULL_MASK, b3 ? k0 : k1, 8);
    v += __shfl_xor_sync(RSP_FULL_MASK, v, 4);
    v += __shfl_xor_sync(RSP_FULL_MASK, v, 2);
    v += __shfl_xor_sync(RSP_FULL_MASK, v, 1);
    return v;
  }

  // This lane's part of the dot of a lane-distributed row with vec.
  template <class A>
  __device__ __forceinline__ A part_dot(const float (&r)[PL],
                                        const float* vec) const {
    A s = 0;
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int t = lane + 32 * m;
      if (t < d) s += (A)r[m] * (A)vec[t];
    }
    return s;
  }

  // The n (<= 32) entries held by the lanes (entry l in lane l: source row
  // index, value, source bias where has_xb) over `table`, four at a time:
  // their rows are loaded without a branch (lanes past n hold row 0, a
  // valid address, and weigh 0), so the four loads are in flight at once;
  // the four dots are reduced together (dots4), the eight lanes holding an
  // entry's dot form its weight, and four shuffles hand the weights to
  // every lane.  MODE 0 adds rw x_e into acc, MODE 1 -coef(x_e . vdot) x_e,
  // MODE 3 (rw - coef) x_e (the rhs less A x0 in one walk), MODE 2 the
  // loss term into lacc (rotating over the lanes).
  template <int MODE>
  __device__ __forceinline__ void walk(const T* table, int my_idx,
                                       float my_c, float my_xb, bool has_xb,
                                       int n, bool head, const float* vdot,
                                       float (&acc)[PL], float& lacc,
                                       int& k) const {
    static_assert(kU == 4, "the dot products are reduced four at a time");
    const int mu = (lane >> 3) & 3;  // the entry whose dot this lane gets
    for (int j0 = 0; j0 < n; j0 += kU) {
      int ci[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        ci[u] = __shfl_sync(RSP_FULL_MASK, my_idx, (j0 + u) & 31);
      float rr[kU][PL];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        rsp::load_row<PL>(table + (size_t)ci[u] * d, d, rr[u]);
      const int src = (j0 + mu) & 31;
      const float c = __shfl_sync(RSP_FULL_MASK, my_c, src);
      const float xb = has_xb ? __shfl_sync(RSP_FULL_MASK, my_xb, src) : 0.f;
      const bool ok = j0 + mu < n;
      float w = 0.f;
      if (MODE != 1 && MODE != 2)
        w = rnd ? rsp::rhs_weight_bf16<EXPLICIT>(c, xb, a.g_rhs, head)
                : rsp::rhs_weight<EXPLICIT>(c, xb, a.g_rhs);
      if (MODE != 0) {
        if (rnd && MODE != 2) {
          const double dot = dots4<double>(
              part_dot<double>(rr[0], vdot), part_dot<double>(rr[1], vdot),
              part_dot<double>(rr[2], vdot), part_dot<double>(rr[3], vdot));
          w -= coef_bf16(c, dot, head);
        } else {
          const float dot = dots4<float>(
              part_dot<float>(rr[0], vdot), part_dot<float>(rr[1], vdot),
              part_dot<float>(rr[2], vdot), part_dot<float>(rr[3], vdot));
          if (MODE == 2)
            w = rsp::entry_loss<EXPLICIT>(c, xb, a.g_loss, dot);
          else
            w -= rsp::lhs_weight<EXPLICIT>(c) * dot;
        }
      }
      if (MODE == 2) {
        if (ok && (lane & 7) == (k & 7)) lacc += w;
        ++k;
        continue;
      }
      w = ok ? w : 0.f;
      // MODE 1 sums -coef x_e (negated once in the combine); the group's
      // sum is added to acc once (shorter chains)
      float grp[PL];
#pragma unroll
      for (int m = 0; m < PL; ++m) grp[m] = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float wu = __shfl_sync(RSP_FULL_MASK, w, 8 * u);
#pragma unroll
        for (int m = 0; m < PL; ++m) grp[m] += wu * rr[u][m];
      }
#pragma unroll
      for (int m = 0; m < PL; ++m) acc[m] += grp[m];
    }
  }

  // compute_dtype="bfloat16": a matvec coefficient formed from a float64
  // dot of a row with the bf16 operand (the products are exact), as the
  // float64 twin of the plain version forms it (rsp::matvec_coef_bf16 on a
  // float64 dot), so that its bf16 rounding falls where a float64 sum puts
  // it and not where one float32 order or another does.
  __device__ __forceinline__ float coef_bf16(float c, double dot,
                                             bool head) const {
    if (EXPLICIT) return rsp::rbf((float)dot);
    if (head) return rsp::rbf(__fmul_rn(rsp::rbf((float)dot), rsp::rbf(c - 1.f)));
    return rsp::rbf((float)(dot * (double)(c - 1.f)));
  }

  // Append the present cells of sparse panel pn (of this warp's row) to
  // the warp's buffer at `at` (cells past L.cache are counted, not kept);
  // returns the new count.  cv/pr: the lanes' two cells, loaded already.
  __device__ __forceinline__ int append(int pn, const float (&cv)[2],
                                        const bool (&pr)[2], int at) const {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const unsigned m = __ballot_sync(RSP_FULL_MASK, pr[s]);
      const int pos = at + __popc(m & ((1u << lane) - 1u));
      if (pr[s] && pos < L.cache) {
        cache_h[pos] = pn * kPanel + 32 * s + lane;
        cache_c[pos] = cv[s];
      }
      at += __popc(m);
    }
    return at;
  }

  // N of this warp's sparse panels (the slist entries q0, q0 + wpr, ...),
  // their weights loaded at once, appended to the warp's buffer at `at`
  // (cells past L.cache are counted, not kept); returns the new count.
  template <int N>
  __device__ int scan(const rsp::RowEntries<T>& R, int q0, int at) const {
    const int ns = misc[1];
    float cv[N][2];
    bool pr[N][2];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int q = q0 + u * wpr;
      const int pn = q < ns ? slist[q] : 0;
#pragma unroll
      for (int s = 0; s < 2; ++s)
        pr[u][s] = q < ns && cell(R, pn * kPanel + 32 * s + lane, &cv[u][s]);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int q = q0 + u * wpr;
      if (q < ns) at = append(slist[q], cv[u], pr[u], at);
    }
    return at;
  }

  // The first pass: this warp's share of its row's sparse head panels
  // (the slist entries wj, wj + wpr, ...) into the warp's cache.  Returns
  // the cells (more than L.cache: the cache is not used, and every pass
  // streams the panels through the buffer again).
  __device__ int fill_cache(const rsp::RowEntries<T>& R) const {
    int total = 0;
    for (int q0 = wj; q0 < misc[1]; q0 += 4 * wpr) total = scan<4>(R, q0, total);
    __syncwarp();
    return total;
  }

  // The cold entries and sparse head cells of this warp's row: the cold
  // entries in chunks of 32, then the head cells 32 at a time from the
  // warp's cache, or, where they overflow it, streamed through it panel by
  // panel.
  template <int MODE>
  __device__ void warp_terms(const float* vdot_row, float (&acc)[PL],
                             float& lacc, WarpCache& wc, bool first) const {
    if (wr >= nvalid) return;
    const rsp::RowEntries<T> R = rsp::row_entries<T>(a, b0 + wr);
    const bool has_xb = R.xbias != nullptr;
    int k = 0;
    const int units = CS * wpr, me = rank * wpr + wj;
    for (int c0 = 32 * me; c0 < R.nnz; c0 += 32 * units) {
      const int l = c0 + lane;
      const bool in = l < R.nnz;
      const int col = in ? R.col[l] : 0;
      const float val = in ? R.val[l] : 0.f;
      const float xb = (has_xb && in) ? __ldg(R.xbias + col) : 0.f;
      walk<MODE>(R.table, col, val, xb, has_xb, min(32, R.nnz - c0), false,
                 vdot_row, acc, lacc, k);
    }
    if (R.w == nullptr || misc[1] == 0) return;
    if (first) {
      wc.n = fill_cache(R);
      wc.over = wc.n > L.cache;
    }
    const int ns = misc[1];
    int done = 0, queued = 0, q = wj;
    while (true) {
      int n;
      if (wc.over) {  // stream: refill the buffer to 32 cells or the end
        // two panels at a time: 31 queued + 128 cells fit the buffer
        for (; queued < 32 && q < ns; q += 2 * wpr)
          queued = scan<2>(R, q, queued);
        __syncwarp();
        n = min(32, queued);
      } else {
        n = min(32, wc.n - done);
      }
      if (n <= 0) break;
      const int l = (wc.over ? 0 : done) + lane;
      const bool in = lane < n;
      walk<MODE>(R.hot_table, in ? cache_h[l] : 0, in ? cache_c[l] : 0.f,
                 0.f, false, n, true, vdot_row, acc, lacc, k);
      if (wc.over) {  // move the cells past the n walked to the front
        const int rest = queued - n;
        __syncwarp();
        for (int base = 0; base < rest; base += 32) {
          const bool mv = base + lane < rest;
          int hh = 0;
          float cc = 0.f;
          if (mv) {
            hh = cache_h[n + base + lane];
            cc = cache_c[n + base + lane];
          }
          __syncwarp();
          if (mv) {
            cache_h[base + lane] = hh;
            cache_c[base + lane] = cc;
          }
          __syncwarp();
        }
        queued = rest;
      } else {
        done += n;
      }
    }
  }

  // ---- the dense head panels as tile products ---------------------------------

  // Stage Vh rows [h0, h0 + 64) into buf: 16-byte cp.async where rows are
  // 16-byte aligned, else element copies; rows past H are zeros.
  __device__ void stage(T* buf, int h0) const {
    const T* V = static_cast<const T*>(a.Vh);
    const int rb = d * (int)sizeof(T);
    if ((rb & 15) == 0 && (reinterpret_cast<size_t>(V) & 15) == 0) {
      const int gpr = rb >> 4;
      for (int e = threadIdx.x; e < kPanel * gpr; e += kThreads) {
        const int i = e / gpr, q = e - i * gpr;
        const int h = h0 + i;
        const char* src = reinterpret_cast<const char*>(V) +
                          (size_t)min(h, a.H - 1) * rb + 16 * q;
        rsp::cp_async16(reinterpret_cast<char*>(buf + i * L.sv) + 16 * q, src,
                        h < a.H ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < kPanel * d; e += kThreads) {
        const int i = e / d, kk = e - i * d;
        const int h = h0 + i;
        buf[i * L.sv + kk] = h < a.H ? V[(size_t)h * d + kk] : T(0.f);
      }
    }
  }

  // T = P Vh' for this warp's 8 columns (warps 0..7) of the panel in buf,
  // each k-step into fresh fragments added in f32 (the tensor core
  // truncates as it adds into a running sum).
  __device__ void first_product(const T* buf, const float* P,
                                float (&t)[4]) const {
    t[0] = t[1] = t[2] = t[3] = 0.f;
    const T* vrow = buf + (8 * warp + g) * L.sv;
    if constexpr (is_bf16<T>()) {
      if (rnd) {
        for (int k0 = 0; k0 < L.Dk; k0 += 16) {
          const float* P0 = P + g * L.sp + k0 + 2 * tig;
          const float* P8 = P0 + 8 * L.sp;
          const unsigned af[4] = {pack2(P0[0], P0[1]), pack2(P8[0], P8[1]),
                                  pack2(P0[8], P0[9]), pack2(P8[8], P8[9])};
          const unsigned* vb =
              reinterpret_cast<const unsigned*>(vrow + k0 + 2 * tig);
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          rsp::mma_bf16(f, af, vb[0], vb[4]);
#pragma unroll
          for (int q = 0; q < 4; ++q) t[q] += f[q];
        }
        return;
      }
    }
    for (int k0 = 0; k0 < L.Dk; k0 += 8) {
      const float* P0 = P + g * L.sp + k0 + tig;
      const float* P8 = P0 + 8 * L.sp;
      unsigned ah[4], al[4];
      split_tf32(P0[0], ah[0], al[0]);
      split_tf32(P8[0], ah[1], al[1]);
      split_tf32(P0[4], ah[2], al[2]);
      split_tf32(P8[4], ah[3], al[3]);
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(vld(vrow, k0 + tig), bh0, bl0);
      split_tf32(vld(vrow, k0 + tig + 4), bh1, bl1);
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!is_bf16<T>()) rsp::mma_tf32(f, ah, bl0, bl1);
      rsp::mma_tf32(f, al, bh0, bh1);
      rsp::mma_tf32(f, ah, bh0, bh1);
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] += f[q];
    }
  }

  // acc2 += T_w Vh over the panel in buf (each k-step into fresh
  // fragments, added in f32):
  // this warp's output columns 8 nt + [0, 8), nt = warp + kWarps i.
  __device__ void second_product(const T* buf, float (&acc2)[kNT][4],
                                 bool tf32) const {
    const int nN = L.Dk / 8;
    float c[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[i][q] = 0.f;
    if constexpr (is_bf16<T>()) {
      if (rnd && !tf32) {
        const unsigned short* vb = reinterpret_cast<const unsigned short*>(buf);
#pragma unroll
        for (int k0 = 0; k0 < kPanel; k0 += 16) {
          const float* A0 = tw + g * kTw + k0 + 2 * tig;
          const float* A8 = A0 + 8 * kTw;
          const unsigned af[4] = {pack2(A0[0], A0[1]), pack2(A8[0], A8[1]),
                                  pack2(A0[8], A0[9]), pack2(A8[8], A8[9])};
#pragma unroll
          for (int i = 0; i < kNT; ++i) {
            const int nt = warp + kWarps * i;
            if (nt >= nN) continue;
            const unsigned short* col = vb + (k0 + 2 * tig) * L.sv + 8 * nt + g;
            const unsigned b0 = (unsigned)col[0] | ((unsigned)col[L.sv] << 16);
            const unsigned b1 =
                (unsigned)col[8 * L.sv] | ((unsigned)col[9 * L.sv] << 16);
            float f[4] = {0.f, 0.f, 0.f, 0.f};
            rsp::mma_bf16(f, af, b0, b1);
#pragma unroll
            for (int q = 0; q < 4; ++q) c[i][q] += f[q];
          }
        }
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc2[i][q] += c[i][q];
        return;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < kPanel; k0 += 8) {
      const float* A0 = tw + g * kTw + k0 + tig;
      const float* A8 = A0 + 8 * kTw;
      unsigned ah[4], al[4];
      split_tf32(A0[0], ah[0], al[0]);
      split_tf32(A8[0], ah[1], al[1]);
      split_tf32(A0[4], ah[2], al[2]);
      split_tf32(A8[4], ah[3], al[3]);
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int nt = warp + kWarps * i;
        if (nt >= nN) continue;
        const T* col = buf + (k0 + tig) * L.sv + 8 * nt + g;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(vld(col, 0), bh0, bl0);
        split_tf32(vld(col, 4 * L.sv), bh1, bl1);
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (!is_bf16<T>()) rsp::mma_tf32(f, ah, bl0, bl1);
        rsp::mma_tf32(f, al, bh0, bh1);
        rsp::mma_tf32(f, ah, bh0, bh1);
#pragma unroll
        for (int q = 0; q < 4; ++q) c[i][q] += f[q];
      }
    }
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc2[i][q] += c[i][q];
  }

  // The dense panels of this CTA: MODE 0 the rhs term, MODE 1 minus the
  // matvec term (P = vdot), MODE 3 the two together, into acc2; MODE 2 the
  // loss terms (P = bf16(y) or
  // y) into lg (row g) and lg8 (row g + 8).
  template <int MODE>
  __device__ void head_tiles(const float* P, float (&acc2)[kNT][4], float& lg,
                             float& lg8) const {
    const int nd = misc[0];
    if (nd == 0) return;
    // the rows and columns of this thread's four cells (warps 0..7)
    rsp::RowEntries<T> R0{}, R8{};
    const bool v0 = warp < 8 && g < nvalid, v8 = warp < 8 && g + 8 < nvalid;
    if (v0) R0 = rsp::row_entries<T>(a, b0 + g);
    if (v8) R8 = rsp::row_entries<T>(a, b0 + g + 8);
    stage(vh0, dlist[0] * kPanel);
    rsp::cp_async_commit();
    for (int i = 0; i < nd; ++i) {
      if (i + 1 < nd) stage(vhb(i + 1), dlist[i + 1] * kPanel);
      rsp::cp_async_commit();
      float cv[4] = {0.f, 0.f, 0.f, 0.f};
      bool pr[4] = {false, false, false, false};
      const int hc = dlist[i] * kPanel + 8 * warp + 2 * tig;
      if (v0) {
        pr[0] = cell(R0, hc, &cv[0]);
        pr[1] = cell(R0, hc + 1, &cv[1]);
      }
      if (v8) {
        pr[2] = cell(R8, hc, &cv[2]);
        pr[3] = cell(R8, hc + 1, &cv[3]);
      }
      rsp::cp_async_wait<1>();
      __syncthreads();
      const T* buf = vhb(i);
      if (warp < 8) {
        float t[4];
        if (MODE != 0) first_product(buf, P, t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float c = cv[q];
          float v = 0.f;
          if (MODE == 2) {
            if (pr[q]) v = rsp::entry_loss<EXPLICIT>(c, 0.f, a.g_loss, t[q]);
          } else if (pr[q]) {
            if (MODE != 1)
              v = rnd ? rsp::rhs_weight_bf16<EXPLICIT>(c, 0.f, a.g_rhs, true)
                      : rsp::rhs_weight<EXPLICIT>(c, 0.f, a.g_rhs);
            if (MODE != 0)
              v -= rnd ? rsp::matvec_coef_bf16<EXPLICIT>(c, t[q], true)
                       : rsp::lhs_weight<EXPLICIT>(c) * t[q];
          }
          if (MODE == 2) {
            if (q < 2) lg += v;
            else lg8 += v;
          } else {
            tw[(g + 8 * (q >> 1)) * kTw + 8 * warp + 2 * tig + (q & 1)] = v;
          }
        }
      }
      if (MODE != 2) {
        __syncthreads();
        // MODE 3's operand rw - coef is not exact in bf16: 2xTF32 there
        second_product(buf, acc2, MODE == 3);
      }
      __syncthreads();
    }
  }

  // dense += vec XtX for this warp's cells (the columns it owns), one
  // 16 x d x d tile product a pass on the tensor cores: 3xTF32, XtX read
  // as the B operand straight from global memory (L2), each k-step into
  // fresh fragments added in f32.
  __device__ void xtx_product(const float* vec,
                              float (&dense)[kNT][4]) const {
    const int nN = L.Dk / 8;
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int nt = warp + kWarps * i;
      if (nt >= nN || nt % CS != rank) continue;
      const int n = 8 * nt + g;
#pragma unroll 4
      for (int k0 = 0; k0 < L.Dk; k0 += 8) {
        const float* P0 = vec + g * L.sp + k0 + tig;
        const float* P8 = P0 + 8 * L.sp;
        unsigned ah[4], al[4];
        split_tf32(P0[0], ah[0], al[0]);
        split_tf32(P8[0], ah[1], al[1]);
        split_tf32(P0[4], ah[2], al[2]);
        split_tf32(P8[4], ah[3], al[3]);
        const int k1 = k0 + tig, k2 = k1 + 4;
        const float x1 = (k1 < d && n < d) ? __ldg(a.XtX + (size_t)k1 * d + n) : 0.f;
        const float x2 = (k2 < d && n < d) ? __ldg(a.XtX + (size_t)k2 * d + n) : 0.f;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(x1, bh0, bl0);
        split_tf32(x2, bh1, bl1);
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        rsp::mma_tf32(f, ah, bl0, bl1);
        rsp::mma_tf32(f, al, bh0, bh1);
        rsp::mma_tf32(f, ah, bh0, bh1);
#pragma unroll
        for (int q = 0; q < 4; ++q) dense[i][q] += f[q];
      }
    }
  }

  // ---- one pass -------------------------------------------------------------

  // out (16 x d tile, every CTA of the cluster the same) = the pass's sums:
  // MODE 0 the rhs, MODE 1 A vec (vdot the products' operand: vec or
  // bf16(vec)), MODE 3 the rhs less A vec (one walk of the entries for
  // both), MODE 2 the rows' losses of y = vec into loss_out[rows].
  template <int MODE>
  __device__ void pass(const float* vec, const float* vdot, float* out,
                       WarpCache& wc, bool first) {
    float acc[PL];
#pragma unroll
    for (int m = 0; m < PL; ++m) acc[m] = 0.f;
    float lacc = 0.f;
    warp_terms<MODE>(vdot + wr * L.sp, acc, lacc, wc, first);
    if (MODE != 2) {
#pragma unroll
      for (int m = 0; m < PL; ++m) {
        const int t = lane + 32 * m;
        if (t < d) red[warp * L.sp + t] = acc[m];
      }
    } else {
      lacc = rsp::warp_sum(lacc);
      if (lane == 0) lossp[warp] = lacc;
    }
    float acc2[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc2[i][q] = 0.f;
    float lg = 0.f, lg8 = 0.f;
    if (has_head()) head_tiles<MODE>(vdot, acc2, lg, lg8);
    if (MODE == 2) {
      lg += __shfl_xor_sync(RSP_FULL_MASK, lg, 1);
      lg += __shfl_xor_sync(RSP_FULL_MASK, lg, 2);
      lg8 += __shfl_xor_sync(RSP_FULL_MASK, lg8, 1);
      lg8 += __shfl_xor_sync(RSP_FULL_MASK, lg8, 2);
      if (warp < 8 && tig == 0) {
        lossp[kWarps + warp * kTile + g] = lg;
        lossp[kWarps + warp * kTile + g + 8] = lg8;
      }
    }
    __syncthreads();
    if (MODE == 2) {
      finish_loss(vec, out);
      return;
    }

    // the dense terms of this thread's cells, by the columns' owner
    const int nN = L.Dk / 8;
    float dense[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) dense[i][q] = 0.f;
    if (MODE != 0 && !EXPLICIT && a.XtX != nullptr) xtx_product(vec, dense);

    float val[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int nt = warp + kWarps * i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = g + 8 * (q >> 1), t = 8 * nt + 2 * tig + (q & 1);
        float s = 0.f;
        if (nt < nN && row < nvalid && t < d) {
          for (int jj = 0; jj < wpr; ++jj)
            s += red[(row * wpr + jj) * L.sp + t];
          s += acc2[i][q];
          if (nt % CS == rank) {
            // the dense terms: - (XtX vec or lam_use vec), + rhs_init
            if (MODE != 0)
              s -= EXPLICIT ? scal[row * 8 + kLam] * vec[row * L.sp + t]
                            : dense[i][q];
            if (MODE != 1 && a.rhs_init != nullptr) s += a.rhs_init[t];
          }
        }
        val[i][q] = MODE == 1 ? -s : s;
      }
    }
    if (CS == 1) {
      __syncthreads();  // red is read above; out may alias nothing read later
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int nt = warp + kWarps * i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q >> 1), t = 8 * nt + 2 * tig + (q & 1);
          if (nt < nN && row < RT && t < d) out[row * L.sp + t] = val[i][q];
        }
      }
    } else {
      float* mine = pbf(par);
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int nt = warp + kWarps * i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q >> 1), t = 8 * nt + 2 * tig + (q & 1);
          if (nt < nN && row < RT && t < d) mine[row * L.sp + t] = val[i][q];
        }
      }
      cgrp::cluster_group cl = cgrp::this_cluster();
      cl.sync();
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int nt = warp + kWarps * i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q >> 1), t = 8 * nt + 2 * tig + (q & 1);
          if (nt < nN && row < RT && t < d) {
            float s = 0.f;
            for (int qq = 0; qq < CS; ++qq)
              s += cl.map_shared_rank(mine, qq)[row * L.sp + t];
            out[row * L.sp + t] = s;
          }
        }
      }
      par ^= 1;
    }
    __syncthreads();
  }

  // The rows' losses: the warps' cold and sparse terms, the head tiles'
  // terms and lam_use |y|^2 (rank 0), summed over the cluster by rank 0
  // into loss_out (global, one per valid row).
  __device__ void finish_loss(const float* y, float* loss_out) {
    if (warp == 0) {
      float s = 0.f;
      const int row = lane;
      if (row < nvalid) {
        for (int jj = 0; jj < wpr; ++jj) s += lossp[row * wpr + jj];
        for (int w8 = 0; w8 < 8; ++w8) s += lossp[kWarps + w8 * kTile + row];
      }
      if (row < kTile) lbf(par)[row] = s;
    }
    // lam_use |y|^2 of each row by its own warp (rank 0)
    if (rank == 0 && wr < nvalid && wj == 0) {
      float s = 0.f;
      for (int t = lane; t < d; t += 32) s += y[wr * L.sp + t] * y[wr * L.sp + t];
      s = rsp::warp_sum(s);
      if (lane == 0) scal[wr * 8 + kDot] = s;
    }
    if (CS > 1) {
      cgrp::cluster_group cl = cgrp::this_cluster();
      cl.sync();
      if (rank == 0 && warp == 0 && lane < nvalid) {
        float s = 0.f;
        for (int qq = 0; qq < CS; ++qq)
          s += cl.map_shared_rank(lbf(par), qq)[lane];
        loss_out[b0 + lane] = s + scal[lane * 8 + kLam] * scal[lane * 8 + kDot];
      }
      cl.sync();  // no CTA leaves while its buffers may still be read
      par ^= 1;
    } else {
      __syncthreads();
      if (warp == 0 && lane < nvalid)
        loss_out[b0 + lane] =
            lbf(par)[lane] + scal[lane * 8 + kLam] * scal[lane * 8 + kDot];
    }
  }

  // ---- CG ---------------------------------------------------------------------

  // scal[row * 8 + slot] = sum_t u[row, t] v[row, t], one warp a row.
  __device__ void row_dots(const float* u, const float* v, int slot) {
    if (warp < RT) {
      float s = 0.f;
      for (int t = lane; t < d; t += 32) s += u[warp * L.sp + t] * v[warp * L.sp + t];
      s = rsp::warp_sum(s);
      if (lane == 0) scal[warp * 8 + slot] = s;
    }
    __syncthreads();
  }

  // bf16(v) into pb where the solve rounds, else v itself.
  __device__ const float* dot_operand(const float* v) {
    if (!rnd) return v;
    for (int i = threadIdx.x; i < RT * d; i += kThreads) {
      const int row = i / d, t = i - row * d;
      pb[row * L.sp + t] = rsp::rbf(v[row * L.sp + t]);
    }
    __syncthreads();
    return pb;
  }
};

template <int KD, class T, bool EXPLICIT>
__global__ void __launch_bounds__(kThreads, 1)
als_cg_kernel(rsp::BucketArgs a, Plan pl, int cg_steps, float tol) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<KD, T, EXPLICIT> S(a, pl, smem, blockIdx.x / pl.cluster,
                              blockIdx.x % pl.cluster);
  const int RT = S.RT, d = S.d, sp = S.L.sp;
  S.init();
  if (S.has_head()) S.classify();
  WarpCache wc{0, false};

  // r = rhs - A x0 in one pass, p = r; then the freeze rule of batched_cg:
  // live = rsold >= tol, masked alpha/beta
  S.template pass<3>(S.x, S.dot_operand(S.x), S.r, wc, true);
  for (int i = threadIdx.x; i < RT * d; i += kThreads) {
    const int row = i / d, o = row * sp + (i - row * d);
    S.p[o] = S.r[o];
  }
  __syncthreads();
  S.row_dots(S.r, S.r, kRsold);
  float* scal = S.scal;
  for (int step = 0; step < cg_steps; ++step) {
    S.template pass<1>(S.p, S.dot_operand(S.p), S.ap, wc, false);
    S.row_dots(S.p, S.ap, kDot);
    for (int i = threadIdx.x; i < RT * d; i += kThreads) {
      const int row = i / d, t = i - row * d, o = row * sp + t;
      const float rsold = scal[row * 8 + kRsold], pAp = scal[row * 8 + kDot];
      const float alpha = rsold >= tol ? rsold / (pAp == 0.f ? 1.f : pAp) : 0.f;
      S.x[o] += alpha * S.p[o];
      S.r[o] -= alpha * S.ap[o];
    }
    __syncthreads();
    S.row_dots(S.r, S.r, kDot);  // rsnew
    for (int i = threadIdx.x; i < RT * d; i += kThreads) {
      const int row = i / d, t = i - row * d, o = row * sp + t;
      const float rsold = scal[row * 8 + kRsold], rsnew = scal[row * 8 + kDot];
      const float beta = rsold >= tol ? rsnew / (rsold == 0.f ? 1.f : rsold) : 0.f;
      S.p[o] = S.r[o] + beta * S.p[o];
    }
    __syncthreads();
    if (threadIdx.x < RT) {
      const int row = threadIdx.x;
      if (scal[row * 8 + kRsold] >= tol) scal[row * 8 + kRsold] = scal[row * 8 + kDot];
    }
    __syncthreads();
  }

  if (S.rank == 0) {
    for (int i = threadIdx.x; i < S.nvalid * d; i += kThreads) {
      const int row = i / d, t = i - row * d;
      a.y[(size_t)(S.b0 + row) * d + t] = S.x[row * sp + t];
    }
  }
  S.template pass<2>(S.x, S.dot_operand(S.x), a.loss, wc, false);
}

// The head term of a tile alone: MODE 1 the matvec term of p = x0, MODE 0
// the rhs term with g = g_rhs (see the note at the top).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
hot_chain_kernel(rsp::BucketArgs a, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<128, __nv_bfloat16, false> S(a, pl, smem, blockIdx.x, 0);
  S.init();  // x = x0 (p)
  S.classify();
  WarpCache wc{0, false};
  S.template pass<MODE>(S.x, MODE == 1 ? S.dot_operand(S.x) : S.x, S.ap, wc,
                        true);
  for (int i = threadIdx.x; i < S.nvalid * S.d; i += kThreads) {
    const int row = i / S.d, t = i - row * S.d;
    a.y[(size_t)(S.b0 + row) * S.d + t] = S.ap[row * S.L.sp + t];
  }
}

inline bool plan_ok(const Plan& pl) {
  const bool rows = pl.rows == 1 || pl.rows == 2 || pl.rows == 4 ||
                    pl.rows == 8 || pl.rows == 16;
  const bool cl = pl.cluster == 1 || pl.cluster == 2 || pl.cluster == 4 ||
                  pl.cluster == 8 || pl.cluster == 16;
  return rows && cl && pl.tau >= 1;
}

inline int smem_bytes(const rsp::BucketArgs& a, int cluster) {
  return make_layout(a.d, a.W != nullptr ? a.H : 0,
                     a.table_bf16 ? 2 : 4, cluster).bytes;
}

// Launch kern over the tiles of `pl`, as clusters of pl.cluster CTAs.
template <class K, class... Args>
cudaError_t launch(K kern, const Plan& pl, int tiles, int smem,
                   cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (pl.cluster > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * pl.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// K1 at one width and table type (both feedback modes).
template <int KD, class T>
cudaError_t run(const rsp::BucketArgs& a, const Plan& pl, int cg_steps,
                float tol, cudaStream_t st) {
  const int tiles = (a.B + pl.rows - 1) / pl.rows;
  const int smem = smem_bytes(a, pl.cluster);
  return a.explicit_fb
             ? launch(als_cg_kernel<KD, T, true>, pl, tiles, smem, st, a, pl,
                      cg_steps, tol)
             : launch(als_cg_kernel<KD, T, false>, pl, tiles, smem, st, a, pl,
                      cg_steps, tol);
}

// What the card offers K1's launch at a's width, table and head: info[0]
// the shared bytes a CTA (no cluster), info[1] CTAs an SM, info[2 + k] the
// clusters of 2^k CTAs that can run at once (k = 0..4; 0 where a cluster
// of that size cannot run).
template <class K>
cudaError_t occupancy(K kern, const rsp::BucketArgs& a, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  for (int k = 0; k < 5; ++k) {
    const int cs = 1 << k;
    const int sm = smem_bytes(a, cs);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return err;
    if (k == 0) {
      info[0] = sm;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kern,
                                                          kThreads, sm);
      if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(16 * cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = sm;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a size the card cannot schedule: 0 clusters
      n = 0;
    }
    info[2 + k] = n;
  }
  return cudaSuccess;
}

template <int KD, class T>
cudaError_t info(const rsp::BucketArgs& a, int* out) {
  return a.explicit_fb ? occupancy(als_cg_kernel<KD, T, true>, a, out)
                       : occupancy(als_cg_kernel<KD, T, false>, a, out);
}

// One translation unit each (compiled in parallel): K1 at d <= 128 / d <=
// 160 with float / bf16 tables, and the head term alone.
cudaError_t run_128_f32(const rsp::BucketArgs&, const Plan&, int, float,
                        cudaStream_t);
cudaError_t run_128_bf16(const rsp::BucketArgs&, const Plan&, int, float,
                         cudaStream_t);
cudaError_t run_160_f32(const rsp::BucketArgs&, const Plan&, int, float,
                        cudaStream_t);
cudaError_t run_160_bf16(const rsp::BucketArgs&, const Plan&, int, float,
                         cudaStream_t);
cudaError_t info_128_f32(const rsp::BucketArgs&, int*);
cudaError_t info_128_bf16(const rsp::BucketArgs&, int*);
cudaError_t info_160_f32(const rsp::BucketArgs&, int*);
cudaError_t info_160_bf16(const rsp::BucketArgs&, int*);
cudaError_t hot_chain_run(const rsp::BucketArgs&, const Plan&, int mode,
                          cudaStream_t);

}  // namespace rsp_cg
