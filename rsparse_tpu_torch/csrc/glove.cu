// K10: one GloVe sparse-tail shard, walked by feature.
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
// w_i / b_i on the row side and w_j / b_j on the column side.  As K8 does
// (csrc/fm.cu), each side walks the shard's valid entries grouped by its own
// id (ops/segsum.py ShardMaps: `order`, the entries sorted by slot, and
// `bounds`, each slot's range in it), so a feature's sums are taken in
// registers in a fixed order and its table rows written once: no atomics,
// no zeroed scratch, and the same result on every run.
//
// The snapshot: the row side's gradients need the shard-start w_j, b_j and
// the column side's the shard-start w_i, b_i, so neither side may write its
// tables while the other still reads them.  Three launches:
//   R  the row side: tiles of kTile consecutive entries of its `order`, one
//      warp a tile, lanes over r.  At a feature's first entry the warp takes
//      its w_i, b_i and accumulators and copies w_i, b_i, once a feature,
//      into the slot-indexed snapshot `snap` (U_r, r + 1); per entry it
//      reads w_j[j], b_j[j], forms the cost from both rows (weight, clip at
//      +-100) and its loss term, and sums g = cost w_j, g^2, cost and cost^2
//      in registers.  A feature whose entries all lie in the tile takes its
//      AdaGrad step there, in place; the tile's first feature, if it began
//      before the tile, and its last, if it runs past it, leave their sums
//      in the tile's head / tail slot.  One loss partial a tile;
//   C  the column side the same way over its own `order`: its w_j, b_j are
//      still the shard's start, and the row side's rows come from `snap` by
//      the entry's row slot, whatever R wrote to w_i, b_i;
//   F  the features of both sides that run over tiles: the tile where a
//      feature's tail lies sums it and the heads of the tiles it runs into
//      (`bounds` say how far) in four running sums taken in turn, added in
//      a fixed order, and takes the step; one more CTA sums the loss
//      partials in a fixed order.
// A walk's warp reads its next 32 entries one a lane (ids, log x, weight),
// then takes them kDepth at a time: all the group's row loads first, then
// its entries in order.  Each entry's cost is formed twice, from the same
// two rows in the same order, so both sides see the same value.
//
// What bounds it on the H100: bytes.  Per entry each side reads the other
// side's row (r floats, at a random id) and a few indices; per distinct id
// it reads its own four table rows once and writes them once.  At r = 128
// a row is 512 bytes, read by a warp in four coalesced loads.  Nothing of
// (N, r) size is written; the snapshot is U_r (r + 1) floats, read from L2.
// The walks' registers are capped for kMinBlocks CTAs an SM (128 a thread
// at two), so that enough entries' rows are in flight.
//
// Two widths are built, chosen by r: the walks hold r / 32 components a
// lane (4 at r <= 128, 10 at r <= 320), so the wide instance's kDepth rows
// in flight, its sums and its open feature's rows take ~130 registers a
// thread: it runs at one CTA an SM.  A row at r = 300 is 1,200 bytes, ten
// coalesced loads a warp.  The order of every sum is the same as at
// r <= 128: the wide route is as deterministic.
//
// The bf16 instance (bf16 != 0, GloVe(precision="bfloat16"), T =
// __nv_bfloat16): the eight tables and the counts are bf16, and every
// value is rounded where the JAX function run op by op rounds it (log x,
// x / x_max, its power, the products of w_i . w_j before their f32 sum,
// each of + b_i, + b_j, - log x, cost, g = cost w, g^2, cost^2, each step
// term).  A tile is one feature's entries (bounds[u], bounds[u + 1]), so
// one warp walks all of a feature's entries in order and launch F only
// sums the loss; its updates follow the JAX path of the same settings:
//   ordered = 0 (shuffle off, rsparse_tpu/models/glove.py:109, the
//     scheduled sums): the entries in chunks of kChunk, each chunk's sums
//     taken at f32 and rounded to bf16, the chunks' sum rounded again, then
//     acc += sum g^2 and w += -lr sum g / sqrt(acc), each op rounded;
//   ordered = 1 (shuffle on, :50, the scatter-adds): two passes over the
//     entries, the first adding each g^2 (cost^2) to the accumulator with
//     one rounding an entry, the second each -lr g / sqrt(acc) to the row
//     (bias), one rounding an entry, with the final accumulator.
// Every sum keeps its order: the bf16 instance is as deterministic.

#include <type_traits>

#include "common.cuh"

namespace {

using bf16_t = __nv_bfloat16;
template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16_t>::value;

constexpr float kClip = 100.f;
// the two widths built (models/glove.py GLOVE_WIDTHS): lanes hold kRpl =
// width / 32 components each; the walks are templated on it, so the
// r <= 128 route keeps its registers (kMinBlocks CTAs an SM) and r <= 320
// (GloVe's published 300) runs at one CTA an SM with up to 255 registers
constexpr int kMaxR = 128;
constexpr int kMaxRWide = 320;      // widest embedding (models/glove.py MAX_RANK)
constexpr int kWarps = 8;           // tiles (warps) a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;           // entries a tile of the walks
                                    // (models/glove.py K10_TILE)
static_assert(kTile > 0 && kTile % 32 == 0, "a tile is whole steps of 32");
constexpr int kDepth = 4;           // entries whose rows a walk's warp loads
                                    // together
constexpr int kMinBlocks = 2;       // CTAs an SM the walks' register cap is
                                    // set for
// entries of a feature a chunk of the bf16 scheduled sums takes
// (rsparse_tpu/ops/segsum.py build_stacked_col_schedule chunk_len,
// ops/segsum.py SCHED_CHUNK)
constexpr int kChunk = 128;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16_t* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16_t* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float rd(float x) {
  if constexpr (kIsBf16<T>)
    return rsp::rbf(x);
  else
    return x;
}

// One side of a shard as its walk takes it.
template <typename T>
struct Side {
  const int* own;     // (N,) the side's ids (rows or cols)
  const int* slot;    // (N,) each entry's index into feats
  const int* order;   // (N,) the valid entries grouped by slot
  const int* bounds;  // (U + 1,) slot u's range in order; bounds[U] entries
  const int* feats;   // (U,) the side's distinct ids
  T *w, *b, *acc_w, *acc_b;  // the side's own tables
  float* span;        // (n_tiles, 2, 2r + 2) the tiles' head / tail sums
  int* tail_u;        // (n_tiles,) the slot whose tail a tile holds, or -1
  int U;
};

// A feature's sums as a lane holds them: g and g^2 at components
// lane + 32 t, cost and cost^2.
template <int kRpl>
struct Sums {
  float g[kRpl], g2[kRpl], c, c2;
};

template <int kRpl>
__device__ __forceinline__ void zero(Sums<kRpl>& a) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) a.g[t] = a.g2[t] = 0.f;
  a.c = a.c2 = 0.f;
}

template <int kRpl>
__device__ __forceinline__ void add(Sums<kRpl>& a, const Sums<kRpl>& b) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    a.g[t] += b.g[t];
    a.g2[t] += b.g2[t];
  }
  a.c += b.c;
  a.c2 += b.c2;
}

// a += bf16(b) (the bf16 scheduled sums: a chunk's sums rounded, added to
// the chunks' running sums)
template <int kRpl>
__device__ __forceinline__ void add_rounded(Sums<kRpl>& a,
                                            const Sums<kRpl>& b) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    a.g[t] += rsp::rbf(b.g[t]);
    a.g2[t] += rsp::rbf(b.g2[t]);
  }
  a.c += rsp::rbf(b.c);
  a.c2 += rsp::rbf(b.c2);
}

// running sums launch F keeps for a feature over tiles
constexpr int kSpanWays = 4;
static_assert(kSpanWays == 4, "glove_final adds the four in a fixed tree");

// a tile's head (which 0) or tail (1) slot: [g (r), g^2 (r), cost, cost^2]
__device__ __forceinline__ float* span_slot(float* span, int tile, int which,
                                            int r) {
  return span + ((size_t)tile * 2 + which) * (2 * r + 2);
}

template <int kRpl>
__device__ __forceinline__ void store_sums(const Sums<kRpl>& a, float* dst,
                                           int lane, int r) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    const int k = lane + 32 * t;
    if (k < r) {
      dst[k] = a.g[t];
      dst[r + k] = a.g2[t];
    }
  }
  if (lane == 0) {
    dst[2 * r] = a.c;
    dst[2 * r + 1] = a.c2;
  }
}

template <int kRpl>
__device__ __forceinline__ void add_sums(Sums<kRpl>& a, const float* src, int lane,
                                         int r) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    const int k = lane + 32 * t;
    if (k < r) {
      a.g[t] += src[k];
      a.g2[t] += src[r + k];
    }
  }
  a.c += src[2 * r];
  a.c2 += src[2 * r + 1];
}

// A feature's shard-start rows as a lane holds them: w and acc_w at
// components lane + 32 t, b and acc_b.
template <int kRpl>
struct Row {
  float w[kRpl], aw[kRpl], b, ab;
};

template <int kRpl, typename T>
__device__ __forceinline__ void read_row(const Side<T>& sd, int f, int lane,
                                         int r, Row<kRpl>& e) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    const int k = lane + 32 * t;
    const size_t i = (size_t)f * r + k;
    e.w[t] = k < r ? ld(sd.w + i) : 0.f;
    e.aw[t] = k < r ? ld(sd.acc_w + i) : 0.f;
  }
  e.b = ld(sd.b + f);
  e.ab = ld(sd.acc_b + f);
}

// accumulator-first AdaGrad of feature f from its sums and shard-start rows
// (at bf16 from the rounded sums, each op rounded, as the reference's
// -lr * s1 / sqrt(acc + s2))
template <int kRpl, typename T>
__device__ __forceinline__ void adagrad(const Sums<kRpl>& a, const Side<T>& sd,
                                        int f, const Row<kRpl>& e, int lane,
                                        int r, float lr) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    const int k = lane + 32 * t;
    if (k < r) {
      const size_t i = (size_t)f * r + k;
      const float acc = rd<T>(e.aw[t] + a.g2[t]);
      if constexpr (kIsBf16<T>)
        st(sd.w + i,
           e.w[t] + rsp::rbf(rsp::rbf(-lr * a.g[t]) / rsp::rbf(sqrtf(acc))));
      else
        sd.w[i] = e.w[t] + -lr * a.g[t] / sqrtf(acc);
      st(sd.acc_w + i, acc);
    }
  }
  if (lane == 0) {
    const float acc = rd<T>(e.ab + a.c2);
    if constexpr (kIsBf16<T>)
      st(sd.b + f, e.b + rsp::rbf(rsp::rbf(-lr * a.c) / rsp::rbf(sqrtf(acc))));
    else
      sd.b[f] = e.b + -lr * a.c / sqrtf(acc);
    st(sd.acc_b + f, acc);
  }
}

// A feature's shard-start row and bias, as a lane holds them
template <int kRpl>
struct Own {
  float w[kRpl], b;
};

// Launch R (kRow) or C: one warp a tile of the side's `order`.  R reads the
// other side's rows from w_o, b_o (w_j, b_j) at the entry's column id and
// writes the snapshot; C reads them from the snapshot at the entry's row
// slot (`other`).  Each lane first reads one of 32 entries (its ids, log
// and weight); then the entries go kDepth at a time: first the group's
// loads (the other side's rows, and the own row of each feature that
// begins there), then the entries in order, so that a warp keeps kDepth
// entries' rows in flight instead of waiting on each.  A feature's
// accumulators are read when it begins, for its step.  The bf16 instance
// takes one feature a tile, its entries once (ordered = 0) or twice (1).
template <bool kRow, int kRpl, typename T>
__global__ void __launch_bounds__(kThreads, kRpl <= kMaxR / 32 ? kMinBlocks : 1)
glove_walk(Side<T> sd, const int* __restrict__ other,
           const T* __restrict__ vals, const T* __restrict__ w_o,
           const T* __restrict__ b_o, float* snap, int r, int n_tiles,
           float x_max, float alpha, float lr, int ordered,
           float* __restrict__ loss_part) {
  constexpr bool kB = kIsBf16<T>;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  const int R1 = r + 1;
  const int n_valid = sd.bounds[sd.U];
  const int e0 = kB ? sd.bounds[tile] : tile * kTile;
  const int e1 = kB ? sd.bounds[tile + 1] : min(e0 + kTile, n_valid);
  // the tile's first and last slots, and whether their entries run past
  // the tile (read with the first and the last 32 entries)
  int u_first = -1, u_last = -1;
  bool cross_in = false, own_tail = false;
  float lpart = 0.f;
  Sums<kRpl> a, tot;  // tot: the bf16 scheduled sums' rounded chunks
  zero(a);
  if constexpr (kB) zero(tot);
  int cu = -1, cf = 0;  // the open segment's slot and feature
  Row<kRpl> ce;               // and its shard-start rows
#pragma unroll
  for (int t = 0; t < kRpl; ++t) ce.w[t] = ce.aw[t] = 0.f;
  ce.b = ce.ab = 0.f;

  // the open segment's sums are done: a head or tail slot, or its step
  auto finish = [&]() {
    if (cu == u_first && cross_in)
      store_sums(a, span_slot(sd.span, tile, 0, r), lane, r);
    else if (cu == u_last && own_tail)
      store_sums(a, span_slot(sd.span, tile, 1, r), lane, r);
    else
      adagrad<kRpl, T>(a, sd, cf, ce, lane, r, lr);
  };

  const int passes = kB && ordered ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    if (kB && pass == 1) {  // the rows' own running values
#pragma unroll
      for (int t = 0; t < kRpl; ++t) a.g[t] = ce.w[t];
      a.c = ce.b;
    }
  for (int sb = e0; sb < e1; sb += 32) {
    // 32 entries at a time, one a lane: slot, own id, the other side's id
    // (R) or slot (C), log x and the weight
    const int n_sub = min(32, e1 - sb);
    int u = -1, f = 0, o = 0;
    float lx = 0.f, wt = 0.f;
    if (lane < n_sub) {
      const int p = sd.order[sb + lane];
      u = sd.slot[p];
      f = sd.own[p];
      o = other[p];
      const float v = ld(vals + p);
      if constexpr (kB) {
        lx = rsp::rbf(logf(v));
        wt = v < x_max ? rsp::rbf(powf(rsp::rbf(v / x_max), alpha)) : 1.f;
      } else {
        lx = logf(v);
        wt = v < x_max ? powf(v / x_max, alpha) : 1.f;
      }
    }
    if (!kB && sb == e0) {
      u_first = __shfl_sync(RSP_FULL_MASK, u, 0);
      cross_in = sd.bounds[u_first] < e0;
    }
    if (!kB && sb + 32 >= e1) {
      u_last = __shfl_sync(RSP_FULL_MASK, u, n_sub - 1);
      own_tail = sd.bounds[u_last + 1] > e1 &&
                 !(u_last == u_first && cross_in);
    }
    for (int s0 = 0; s0 < n_sub; s0 += kDepth) {
      // the group's loads
      int gu[kDepth], gf[kDepth];
      float fr[kDepth][kRpl], fb[kDepth];
      Own<kRpl> own[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int s = min(s0 + d, n_sub - 1);
        gu[d] = __shfl_sync(RSP_FULL_MASK, u, s);
        gf[d] = __shfl_sync(RSP_FULL_MASK, f, s);
        const int oe = __shfl_sync(RSP_FULL_MASK, o, s);
        if (kRow) {
          const T* orow = w_o + (size_t)oe * r;
#pragma unroll
          for (int t = 0; t < kRpl; ++t) {
            const int k = lane + 32 * t;
            fr[d][t] = k < r ? ld(orow + k) : 0.f;
          }
          fb[d] = ld(b_o + oe);
        } else {
          const float* orow = snap + (size_t)oe * R1;
#pragma unroll
          for (int t = 0; t < kRpl; ++t) {
            const int k = lane + 32 * t;
            fr[d][t] = k < r ? orow[k] : 0.f;
          }
          fb[d] = orow[r];
        }
        if (gu[d] != (d == 0 ? cu : gu[d - 1])) {
#pragma unroll
          for (int t = 0; t < kRpl; ++t) {
            const int k = lane + 32 * t;
            own[d].w[t] = k < r ? ld(sd.w + (size_t)gf[d] * r + k) : 0.f;
          }
          own[d].b = ld(sd.b + gf[d]);
        }
      }
      // the group's entries, in order
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (s0 + d < n_sub) {
          if (gu[d] != cu) {  // a new feature (the same on every lane)
            if (cu >= 0) finish();
            cu = gu[d];
            cf = gf[d];
#pragma unroll
            for (int t = 0; t < kRpl; ++t) {
              const int k = lane + 32 * t;
              ce.w[t] = own[d].w[t];
              ce.aw[t] = k < r ? ld(sd.acc_w + (size_t)cf * r + k) : 0.f;
            }
            ce.b = own[d].b;
            ce.ab = ld(sd.acc_b + cf);
            zero(a);
            if (kB && ordered) {  // the accumulators' running values
#pragma unroll
              for (int t = 0; t < kRpl; ++t) a.g2[t] = ce.aw[t];
              a.c2 = ce.ab;
            }
            if (kRow && !(cu == u_first && cross_in)) {
              // the feature begins in this tile: its snapshot, once
              float* dst = snap + (size_t)cu * R1;
#pragma unroll
              for (int t = 0; t < kRpl; ++t) {
                const int k = lane + 32 * t;
                if (k < r) dst[k] = ce.w[t];
              }
              if (lane == 0) dst[r] = ce.b;
            }
          }
          const int s = s0 + d;
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < kRpl; ++t) dot += rd<T>(ce.w[t] * fr[d][t]);
          dot = rd<T>(rsp::warp_sum(dot));
          const float bi = kRow ? ce.b : fb[d], bj = kRow ? fb[d] : ce.b;
          const float lxs = __shfl_sync(RSP_FULL_MASK, lx, s);
          const float inner =
              kB ? fminf(fmaxf(rsp::rbf(rsp::rbf(rsp::rbf(dot + bi) + bj) -
                                        lxs),
                               -kClip),
                         kClip)
                 : fminf(fmaxf(dot + bi + bj - lxs, -kClip), kClip);
          const float cost = rd<T>(__shfl_sync(RSP_FULL_MASK, wt, s) * inner);
          if (kRow && pass == 0) lpart += rd<T>(cost * inner);
          if constexpr (kB) {
            if (ordered && pass == 0) {  // the accumulators, an entry each
#pragma unroll
              for (int t = 0; t < kRpl; ++t) {
                const float g = rsp::rbf(cost * fr[d][t]);
                a.g2[t] = rsp::rbf(a.g2[t] + rsp::rbf(g * g));
              }
              a.c2 = rsp::rbf(a.c2 + rsp::rbf(cost * cost));
            } else if (ordered) {  // the rows, an entry each
#pragma unroll
              for (int t = 0; t < kRpl; ++t) {
                const float g = rsp::rbf(cost * fr[d][t]);
                a.g[t] = rsp::rbf(
                    a.g[t] + rsp::rbf(rsp::rbf(-lr * g) /
                                      rsp::rbf(sqrtf(a.g2[t]))));
              }
              a.c = rsp::rbf(a.c + rsp::rbf(rsp::rbf(-lr * cost) /
                                            rsp::rbf(sqrtf(a.c2))));
            } else {  // the scheduled sums, in chunks
#pragma unroll
              for (int t = 0; t < kRpl; ++t) {
                const float g = rsp::rbf(cost * fr[d][t]);
                a.g[t] += g;
                a.g2[t] += rsp::rbf(g * g);
              }
              a.c += cost;
              a.c2 += rsp::rbf(cost * cost);
              if ((sb + s - e0) % kChunk == kChunk - 1) {
                add_rounded(tot, a);
                zero(a);
              }
            }
          } else {
#pragma unroll
            for (int t = 0; t < kRpl; ++t) {
              const float g = cost * fr[d][t];
              a.g[t] += g;
              a.g2[t] += g * g;
            }
            a.c += cost;
            a.c2 += cost * cost;
          }
        }
      }
    }
  }
  }
  if constexpr (kB) {
    if (cu >= 0 && ordered) {  // the walked rows and accumulators
#pragma unroll
      for (int t = 0; t < kRpl; ++t) {
        const int k = lane + 32 * t;
        if (k < r) {
          const size_t i = (size_t)cf * r + k;
          st(sd.w + i, a.g[t]);
          st(sd.acc_w + i, a.g2[t]);
        }
      }
      if (lane == 0) {
        st(sd.b + cf, a.c);
        st(sd.acc_b + cf, a.c2);
      }
    } else if (cu >= 0) {  // the last chunk, then the chunks' sums rounded
      add_rounded(tot, a);
#pragma unroll
      for (int t = 0; t < kRpl; ++t) {
        a.g[t] = rsp::rbf(tot.g[t]);
        a.g2[t] = rsp::rbf(tot.g2[t]);
      }
      a.c = rsp::rbf(tot.c);
      a.c2 = rsp::rbf(tot.c2);
      adagrad<kRpl, T>(a, sd, cf, ce, lane, r, lr);
    }
    if (lane == 0 && kRow) loss_part[tile] = lpart;
  } else {
    if (cu >= 0) finish();  // the tile's last segment
    if (lane == 0) {
      sd.tail_u[tile] = own_tail ? u_last : -1;
      if (kRow) loss_part[tile] = lpart;
    }
  }
}

// Launch F: CTAs [0, n_blk) the row side's tiles, [n_blk, 2 n_blk) the
// column side's, one warp a tile; the last CTA the loss (bf16: rounded
// once, as the reference's bf16 sum of its rounded terms).
template <int kRpl, typename T>
__global__ void __launch_bounds__(kThreads)
glove_final(Side<T> rs, Side<T> cs, int r, int n_tiles, float lr,
            const float* __restrict__ loss_part, int n_part,
            float* __restrict__ loss) {
  const int n_blk = (n_tiles + kWarps - 1) / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 2 * n_blk) {
    // the loss partials in a fixed order: strided by thread, then a fixed
    // tree
    __shared__ float red[kWarps];
    float s = 0.f;
    for (int i = threadIdx.x; i < n_part; i += kThreads) s += loss_part[i];
    s = rsp::warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) t += red[i];
      loss[0] = rd<T>(t);
    }
    return;
  }
  const bool col = blockIdx.x >= n_blk;
  // a copy, not a reference: a reference to a parameter puts both sides
  // in every thread's local memory
  const Side<T> sd = col ? cs : rs;
  const int tile = (blockIdx.x - (col ? n_blk : 0)) * kWarps + warp;
  if (tile >= n_tiles) return;  // the whole warp
  const int u = sd.tail_u[tile];
  if (u < 0) return;
  const int t1 = (sd.bounds[u + 1] - 1) / kTile;
  // kSpanWays running sums, sum j over the slots tile + j, tile + j +
  // kSpanWays, ..., so that their loads are in flight together; then
  // ((0 + 1) + (2 + 3))
  Sums<kRpl> p[kSpanWays];
#pragma unroll
  for (int j = 0; j < kSpanWays; ++j) zero(p[j]);
  for (int q0 = tile; q0 <= t1; q0 += kSpanWays) {
#pragma unroll
    for (int j = 0; j < kSpanWays; ++j) {
      const int q = q0 + j;
      if (q <= t1)
        add_sums(p[j], span_slot(sd.span, q, q == tile, r), lane, r);
    }
  }
  Sums<kRpl> a = p[0];
  add(a, p[1]);
  add(p[2], p[3]);
  add(a, p[2]);
  const int f = sd.feats[u];
  Row<kRpl> e;
  read_row(sd, f, lane, r, e);
  adagrad<kRpl, T>(a, sd, f, e, lane, r, lr);
}

// The three launches of a shard at one instance width (the bf16 instance:
// a tile a feature on each side, launch F the loss alone).
template <int kRpl, typename T>
int launch_shard(const Side<T>& rs, const Side<T>& cs, const int* cols,
                 const int* slot_r, const T* vals, const T* w_j,
                 const T* b_j, float* snap, int r, int n_tiles,
                 float x_max, float alpha, float lr, int ordered,
                 float* loss_part, float* loss, cudaStream_t st) {
  const int t_r = kIsBf16<T> ? rs.U : n_tiles;
  const int t_c = kIsBf16<T> ? cs.U : n_tiles;
  const unsigned g_r = (unsigned)((t_r + kWarps - 1) / kWarps);
  const unsigned g_c = (unsigned)((t_c + kWarps - 1) / kWarps);
  if (g_r > 0) {
    glove_walk<true, kRpl, T><<<g_r, kThreads, 0, st>>>(
        rs, cols, vals, w_j, b_j, snap, r, t_r, x_max, alpha, lr, ordered,
        loss_part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (g_c > 0) {
    glove_walk<false, kRpl, T><<<g_c, kThreads, 0, st>>>(
        cs, slot_r, vals, nullptr, nullptr, snap, r, t_c, x_max, alpha, lr,
        ordered, nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int t_f = kIsBf16<T> ? 0 : n_tiles;
  const unsigned g_f = (unsigned)((t_f + kWarps - 1) / kWarps);
  glove_final<kRpl, T><<<2 * g_f + 1, kThreads, 0, st>>>(
      rs, cs, r, t_f, lr, loss_part, t_r, loss);
  return (int)cudaGetLastError();
}

// Floats of scratch a shard of N entries with U_r distinct row ids at rank
// r takes: the snapshot (U_r, r + 1), the two sides' span slots
// (n_tiles, 2, 2r + 2) each, one loss partial a tile, and the two sides'
// tail slots (n_tiles) int32; the bf16 instance the snapshot and one loss
// partial a row feature.
__host__ __device__ constexpr long long shard_scratch(int N, int U_r, int r,
                                                      int bf16) {
  const long long n_tiles = (N + kTile - 1) / kTile;
  if (bf16) return (long long)U_r * (r + 1) + U_r + 1;
  return (long long)U_r * (r + 1) + 2 * n_tiles * 2 * (2 * r + 2) + n_tiles +
         2 * n_tiles;
}

template <typename T>
int shard(const int* rows, const int* cols, const void* vals,
          const int* slot_r, const int* slot_c, const int* feats_r,
          const int* feats_c, const int* order_r, const int* order_c,
          const int* bounds_r, const int* bounds_c, int N, int U_r, int U_c,
          int r, void* const* tabs, float x_max, float alpha, float lr,
          int ordered, float* scratch, float* loss, cudaStream_t st) {
  const int n_tiles = (N + kTile - 1) / kTile;
  const size_t span_n = (size_t)n_tiles * 2 * (2 * r + 2);
  float* snap = scratch;
  float* span_r = snap + (size_t)U_r * (r + 1);
  float* span_c = kIsBf16<T> ? span_r : span_r + span_n;
  float* loss_part = kIsBf16<T> ? span_r : span_c + span_n;
  int* tail_r = reinterpret_cast<int*>(loss_part + n_tiles);
  int* tail_c = tail_r + n_tiles;
  T* const* t = reinterpret_cast<T* const*>(tabs);
  // tabs: w_i, w_j, b_i, b_j, acc_w_i, acc_w_j, acc_b_i, acc_b_j
  const Side<T> rs{rows, slot_r, order_r, bounds_r, feats_r, t[0], t[2],
                   t[4], t[6], span_r, tail_r, U_r};
  const Side<T> cs{cols, slot_c, order_c, bounds_c, feats_c, t[1], t[3],
                   t[5], t[7], span_c, tail_c, U_c};
  const T* v = static_cast<const T*>(vals);
  return r <= kMaxR
             ? launch_shard<kMaxR / 32, T>(rs, cs, cols, slot_r, v, t[1],
                                           t[3], snap, r, n_tiles, x_max,
                                           alpha, lr, ordered, loss_part,
                                           loss, st)
             : launch_shard<kMaxRWide / 32, T>(rs, cs, cols, slot_r, v, t[1],
                                               t[3], snap, r, n_tiles, x_max,
                                               alpha, lr, ordered, loss_part,
                                               loss, st);
}

}  // namespace

extern "C" long long rsp_glove_shard_scratch(int N, int U_r, int U_c, int r,
                                             int bf16) {
  (void)U_c;
  return shard_scratch(N, U_r, r, bf16);
}

// rows/cols/slot_r/slot_c/order_r/order_c (N,) int32, vals (N,) of one
// shard; feats_r (U_r,), feats_c (U_c,) the distinct ids of its valid
// entries, bounds_r (U_r + 1,), bounds_c (U_c + 1,) each slot's range in
// its side's order (ops/segsum.py ShardMaps); the eight state tables
// (n, r) / (n,), updated in place, and vals f32, or bf16 when bf16 != 0
// (then `ordered` picks the JAX path whose roundings the updates follow,
// and x_max, alpha and lr are bf16 values); scratch of
// rsp_glove_shard_scratch floats (written before it is read: no zeroing);
// loss one float, the shard's sum(cost * inner).
extern "C" int rsp_glove_shard(
    const int* rows, const int* cols, const void* vals, const int* slot_r,
    const int* slot_c, const int* feats_r, const int* feats_c,
    const int* order_r, const int* order_c, const int* bounds_r,
    const int* bounds_c, int N, int U_r, int U_c, int r, void* w_i,
    void* w_j, void* b_i, void* b_j, void* acc_w_i, void* acc_w_j,
    void* acc_b_i, void* acc_b_j, float x_max, float alpha, float lr,
    int bf16, int ordered, float* scratch, float* loss, void* stream) {
  if (N <= 0) return 0;
  if (U_r < 0 || U_c < 0 || r < 1 || r > kMaxRWide || !scratch || !loss)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  void* const tabs[8] = {w_i, w_j, b_i, b_j, acc_w_i, acc_w_j, acc_b_i,
                         acc_b_j};
  return bf16 ? shard<bf16_t>(rows, cols, vals, slot_r, slot_c, feats_r,
                              feats_c, order_r, order_c, bounds_r, bounds_c,
                              N, U_r, U_c, r, tabs, x_max, alpha, lr,
                              ordered, scratch, loss, st)
              : shard<float>(rows, cols, vals, slot_r, slot_c, feats_r,
                             feats_c, order_r, order_c, bounds_r, bounds_c,
                             N, U_r, U_c, r, tabs, x_max, alpha, lr, 0,
                             scratch, loss, st);
}

// The instance width that takes rank r (128 or 320), 0 above the widest.
extern "C" int rsp_glove_shard_width(int r) {
  return r < 1 ? 0 : r <= kMaxR ? kMaxR : r <= kMaxRWide ? kMaxRWide : 0;
}
