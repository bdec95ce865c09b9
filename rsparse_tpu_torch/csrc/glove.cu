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

// The bf16 instance (bf16 != 0, GloVe(precision="bfloat16"), its own
// kernels below): the eight tables and the counts are bf16, and every
// value is rounded where the JAX function run op by op rounds it (log x,
// x / x_max, its power, the products of w_i . w_j before their f32 sum,
// each of + b_i, + b_j, - log x, cost, g = cost w, g^2, cost^2, each step
// term).  Three launches, none of which puts a feature's entries on one
// warp:
//   E  each valid entry's cost and loss term once, for both sides (a warp
//      a tile of the row side's order, the cost summed as the f32 walk
//      sums it), and both sides' shard-start rows into slot-indexed bf16
//      snapshots, so that neither side reads a table the other writes;
//   S  both sides' work lists (ops/segsum.py k10_work_lists, built with the
//      slot maps): an item is a chunk of kChunk entries of a long feature,
//      a feature of its own, or the short features of one window of kPack
//      entries; a CTA an item, a thread a component (r + 1 chains: thread r,
//      or 0 at r = 128 and 320, also the bias), the entries' other rows
//      read from the snapshots kAhead entries ahead;
//   F  the features over several chunks and the loss.
// The updates follow the JAX path of the same settings:
//   ordered = 0 (shuffle off, rsparse_tpu/models/glove.py:109, the
//     scheduled sums): a feature's entries in chunks of kChunk, each
//     chunk's sums taken at f32 in entry order and rounded to bf16 (one
//     CTA a chunk), the chunks' sum taken in chunk order and rounded again
//     (launch F, or at once for a feature of one chunk), then acc += sum
//     g^2 and w += -lr sum g / sqrt(acc), each op rounded: the same sums in
//     the same order as a walk of each feature on one warp, so the same
//     tables;
//   ordered = 1 (shuffle on, :50, the scatter-adds): per (feature,
//     component) the chain acc = bf16(acc + bf16(g^2)) over the feature's
//     entries in order, then w = bf16(w + bf16(bf16(-lr g) / bf16(sqrt(acc))))
//     with the final acc, one thread a chain, the whole feature in one CTA.
// What bounds the bf16 instance: bytes, as the f32 walk (2-byte rows); the
// ordered path's longest feature is a chain of two rounded adds an entry.
// Every sum keeps its order: the bf16 instance is as deterministic.

#include "common.cuh"

namespace {

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

// One side of a shard as its walk takes it.
struct Side {
  const int* own;     // (N,) the side's ids (rows or cols)
  const int* slot;    // (N,) each entry's index into feats
  const int* order;   // (N,) the valid entries grouped by slot
  const int* bounds;  // (U + 1,) slot u's range in order; bounds[U] entries
  const int* feats;   // (U,) the side's distinct ids
  float *w, *b, *acc_w, *acc_b;  // the side's own tables
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

template <int kRpl>
__device__ __forceinline__ void read_row(const Side& sd, int f, int lane,
                                         int r, Row<kRpl>& e) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    const int k = lane + 32 * t;
    const size_t i = (size_t)f * r + k;
    e.w[t] = k < r ? sd.w[i] : 0.f;
    e.aw[t] = k < r ? sd.acc_w[i] : 0.f;
  }
  e.b = sd.b[f];
  e.ab = sd.acc_b[f];
}

// accumulator-first AdaGrad of feature f from its sums and shard-start rows
template <int kRpl>
__device__ __forceinline__ void adagrad(const Sums<kRpl>& a, const Side& sd, int f,
                                        const Row<kRpl>& e, int lane, int r,
                                        float lr) {
#pragma unroll
  for (int t = 0; t < kRpl; ++t) {
    const int k = lane + 32 * t;
    if (k < r) {
      const size_t i = (size_t)f * r + k;
      const float acc = e.aw[t] + a.g2[t];
      sd.w[i] = e.w[t] + -lr * a.g[t] / sqrtf(acc);
      sd.acc_w[i] = acc;
    }
  }
  if (lane == 0) {
    const float acc = e.ab + a.c2;
    sd.b[f] = e.b + -lr * a.c / sqrtf(acc);
    sd.acc_b[f] = acc;
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
// accumulators are read when it begins, for its step.
template <bool kRow, int kRpl>
__global__ void __launch_bounds__(kThreads, kRpl <= kMaxR / 32 ? kMinBlocks : 1)
glove_walk(Side sd, const int* __restrict__ other,
           const float* __restrict__ vals, const float* __restrict__ w_o,
           const float* __restrict__ b_o, float* snap, int r, int n_tiles,
           float x_max, float alpha, float lr,
           float* __restrict__ loss_part) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  const int R1 = r + 1;
  const int n_valid = sd.bounds[sd.U];
  const int e0 = tile * kTile, e1 = min(e0 + kTile, n_valid);
  // the tile's first and last slots, and whether their entries run past
  // the tile (read with the first and the last 32 entries)
  int u_first = -1, u_last = -1;
  bool cross_in = false, own_tail = false;
  float lpart = 0.f;
  Sums<kRpl> a;
  zero(a);
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
      adagrad(a, sd, cf, ce, lane, r, lr);
  };

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
      const float v = vals[p];
      lx = logf(v);
      wt = v < x_max ? powf(v / x_max, alpha) : 1.f;
    }
    if (sb == e0) {
      u_first = __shfl_sync(RSP_FULL_MASK, u, 0);
      cross_in = sd.bounds[u_first] < e0;
    }
    if (sb + 32 >= e1) {
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
        const float* orow =
            kRow ? w_o + (size_t)oe * r : snap + (size_t)oe * R1;
#pragma unroll
        for (int t = 0; t < kRpl; ++t) {
          const int k = lane + 32 * t;
          fr[d][t] = k < r ? orow[k] : 0.f;
        }
        fb[d] = kRow ? b_o[oe] : orow[r];
        if (gu[d] != (d == 0 ? cu : gu[d - 1])) {
#pragma unroll
          for (int t = 0; t < kRpl; ++t) {
            const int k = lane + 32 * t;
            own[d].w[t] = k < r ? sd.w[(size_t)gf[d] * r + k] : 0.f;
          }
          own[d].b = sd.b[gf[d]];
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
              ce.aw[t] = k < r ? sd.acc_w[(size_t)cf * r + k] : 0.f;
            }
            ce.b = own[d].b;
            ce.ab = sd.acc_b[cf];
            zero(a);
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
          for (int t = 0; t < kRpl; ++t) dot += ce.w[t] * fr[d][t];
          dot = rsp::warp_sum(dot);
          const float bi = kRow ? ce.b : fb[d], bj = kRow ? fb[d] : ce.b;
          const float inner =
              fminf(fmaxf(dot + bi + bj - __shfl_sync(RSP_FULL_MASK, lx, s),
                          -kClip),
                    kClip);
          const float cost = __shfl_sync(RSP_FULL_MASK, wt, s) * inner;
          if (kRow) lpart += cost * inner;
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
  if (cu >= 0) finish();  // the tile's last segment
  if (lane == 0) {
    sd.tail_u[tile] = own_tail ? u_last : -1;
    if (kRow) loss_part[tile] = lpart;
  }
}

// Launch F: CTAs [0, n_blk) the row side's tiles, [n_blk, 2 n_blk) the
// column side's, one warp a tile; the last CTA the loss.
template <int kRpl>
__global__ void __launch_bounds__(kThreads)
glove_final(Side rs, Side cs, int r, int n_tiles, float lr,
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
      loss[0] = t;
    }
    return;
  }
  const bool col = blockIdx.x >= n_blk;
  // a copy, not a reference: a reference to a parameter puts both sides
  // in every thread's local memory
  const Side sd = col ? cs : rs;
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
  adagrad(a, sd, f, e, lane, r, lr);
}

// The three launches of a shard at one instance width.
template <int kRpl>
int launch_shard(const Side& rs, const Side& cs, const int* cols,
                 const int* slot_r, const float* vals, const float* w_j,
                 const float* b_j, float* snap, int r, int n_tiles,
                 float x_max, float alpha, float lr, float* loss_part,
                 float* loss, cudaStream_t st) {
  const unsigned grid = (unsigned)((n_tiles + kWarps - 1) / kWarps);
  glove_walk<true, kRpl><<<grid, kThreads, 0, st>>>(
      rs, cols, vals, w_j, b_j, snap, r, n_tiles, x_max, alpha, lr, loss_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glove_walk<false, kRpl><<<grid, kThreads, 0, st>>>(
      cs, slot_r, vals, nullptr, nullptr, snap, r, n_tiles, x_max, alpha, lr,
      nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glove_final<kRpl><<<2 * grid + 1, kThreads, 0, st>>>(
      rs, cs, r, n_tiles, lr, loss_part, n_tiles, loss);
  return (int)cudaGetLastError();
}

// Floats of scratch a shard of N entries with U_r distinct row ids at rank
// r takes: the snapshot (U_r, r + 1), the two sides' span slots
// (n_tiles, 2, 2r + 2) each, one loss partial a tile, and the two sides'
// tail slots (n_tiles) int32.
__host__ __device__ constexpr long long shard_scratch(int N, int U_r, int r) {
  const long long n_tiles = (N + kTile - 1) / kTile;
  return (long long)U_r * (r + 1) + 2 * n_tiles * 2 * (2 * r + 2) + n_tiles +
         2 * n_tiles;
}


// ---- the bf16 instance ----------------------------------------------------

using bf16_t = __nv_bfloat16;

// entries of a feature a chunk of the scheduled sums takes
// (rsparse_tpu/ops/segsum.py build_stacked_col_schedule chunk_len,
// ops/segsum.py SCHED_CHUNK)
constexpr int kChunk = 128;
// entries a packed item holds at most (ops/segsum.py K10_PACK)
constexpr int kPack = 32;
static_assert(kPack <= kChunk, "an item of the scheduled sums is one stage");
// entries whose other slot and cost a CTA of the walk stages at a time:
// every item of the scheduled sums, and every feature of at most this many
// entries on the ordered path, is one stage
constexpr int kStage = 512;
// entries whose other-side values (and features' own rows) a thread of the
// walk loads together
constexpr int kAhead = 16;

__device__ __forceinline__ float ldb(const bf16_t* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stb(bf16_t* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Launch E: each valid entry's cost and loss term, once for both sides,
// and both sides' shard-start snapshots (slot-indexed, bf16, r + 1 a row:
// w then b).  CTAs [0, n_eblk): one warp a tile of kTile entries of the
// row side's order, lanes over r as the f32 walk takes them (the row's w_i
// loaded when a feature begins, kDepth entries' w_j rows in flight); the
// cost is formed as a one-warp walk of either side forms it (the
// products rounded, summed over t at a lane, then the warp's butterfly),
// written to cost[p]; the tile's loss partial sums the rounded terms in
// entry order; the first entry of a row feature copies its w_i, b_i into
// snap_r.  The CTAs past n_eblk copy w_j, b_j of one column slot a warp
// into snap_c.
template <int kRpl>
__global__ void __launch_bounds__(kThreads)
glove_bf16_cost(const int* __restrict__ rows, const int* __restrict__ cols,
                const bf16_t* __restrict__ vals,
                const int* __restrict__ slot_r,
                const int* __restrict__ order_r,
                const int* __restrict__ bounds_r, int U_r,
                const int* __restrict__ feats_c, int U_c,
                const bf16_t* __restrict__ w_i, const bf16_t* __restrict__ b_i,
                const bf16_t* __restrict__ w_j, const bf16_t* __restrict__ b_j,
                int r, int n_tiles, float x_max, float alpha,
                float* __restrict__ cost, float* __restrict__ loss_part,
                bf16_t* __restrict__ snap_r, bf16_t* __restrict__ snap_c) {
  const int lane = threadIdx.x & 31;
  const int n_eblk = (n_tiles + kWarps - 1) / kWarps;
  const int R1 = r + 1;
  if ((int)blockIdx.x >= n_eblk) {  // a column slot's snapshot
    const int u = (blockIdx.x - n_eblk) * kWarps + (threadIdx.x >> 5);
    if (u >= U_c) return;
    const int f = feats_c[u];
    for (int k = lane; k < r; k += 32)
      snap_c[(size_t)u * R1 + k] = w_j[(size_t)f * r + k];
    if (lane == 0) snap_c[(size_t)u * R1 + r] = b_j[f];
    return;
  }
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  const int n_valid = bounds_r[U_r];
  const int e0 = tile * kTile, e1 = min(e0 + kTile, n_valid);
  float lpart = 0.f;
  int cu = -1;
  Own<kRpl> ce;  // the open feature's w_i and b_i
#pragma unroll
  for (int t = 0; t < kRpl; ++t) ce.w[t] = 0.f;
  ce.b = 0.f;
  for (int sb = e0; sb < e1; sb += 32) {
    const int n_sub = min(32, e1 - sb);
    int u = -1, f = 0, o = 0, p = 0;
    float lx = 0.f, wt = 0.f, mine = 0.f;
    if (lane < n_sub) {
      p = order_r[sb + lane];
      u = slot_r[p];
      f = rows[p];
      o = cols[p];
      const float v = ldb(vals + p);
      lx = rsp::rbf(logf(v));
      wt = v < x_max ? rsp::rbf(powf(rsp::rbf(v / x_max), alpha)) : 1.f;
    }
    for (int s0 = 0; s0 < n_sub; s0 += kDepth) {
      int gu[kDepth];
      float fr[kDepth][kRpl], fb[kDepth];
      Own<kRpl> own[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int s = min(s0 + d, n_sub - 1);
        gu[d] = __shfl_sync(RSP_FULL_MASK, u, s);
        const int gf = __shfl_sync(RSP_FULL_MASK, f, s);
        const int oe = __shfl_sync(RSP_FULL_MASK, o, s);
        const bf16_t* orow = w_j + (size_t)oe * r;
#pragma unroll
        for (int t = 0; t < kRpl; ++t) {
          const int k = lane + 32 * t;
          fr[d][t] = k < r ? ldb(orow + k) : 0.f;
        }
        fb[d] = ldb(b_j + oe);
        if (gu[d] != (d == 0 ? cu : gu[d - 1])) {
#pragma unroll
          for (int t = 0; t < kRpl; ++t) {
            const int k = lane + 32 * t;
            own[d].w[t] = k < r ? ldb(w_i + (size_t)gf * r + k) : 0.f;
          }
          own[d].b = ldb(b_i + gf);
        }
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int s = s0 + d;
        if (s < n_sub) {
          if (gu[d] != cu) {  // a new feature (the same on every lane)
            cu = gu[d];
            ce = own[d];
            if (bounds_r[cu] == sb + s) {  // its first entry: the snapshot
              bf16_t* dst = snap_r + (size_t)cu * R1;
#pragma unroll
              for (int t = 0; t < kRpl; ++t) {
                const int k = lane + 32 * t;
                if (k < r) stb(dst + k, ce.w[t]);
              }
              if (lane == 0) stb(dst + r, ce.b);
            }
          }
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < kRpl; ++t) dot += rsp::rbf(ce.w[t] * fr[d][t]);
          dot = rsp::rbf(rsp::warp_sum(dot));
          const float inner = fminf(
              fmaxf(rsp::rbf(rsp::rbf(rsp::rbf(dot + ce.b) + fb[d]) -
                             __shfl_sync(RSP_FULL_MASK, lx, s)),
                    -kClip),
              kClip);
          const float c =
              rsp::rbf(__shfl_sync(RSP_FULL_MASK, wt, s) * inner);
          lpart += rsp::rbf(c * inner);
          if (lane == s) mine = c;
        }
      }
    }
    if (lane < n_sub) cost[p] = mine;
  }
  if (lane == 0) loss_part[tile] = lpart;
}

// One side of a shard as the bf16 walk takes it.
struct BSide {
  const int* own;     // (N,) the side's ids
  const int* other;   // (N,) each entry's slot on the other side: its row
                      // of `snap`
  const int* order;   // (N,) the valid entries grouped by slot
  const int* bounds;  // (U + 1,) slot u's range in order
  const int* feats;   // (U,) the side's distinct ids
  const int4* items;  // (n_items,) (e0, e1, chunk slot q or -1, end)
  const int2* multi;  // (n_multi,) (slot, first chunk slot)
  const bf16_t* snap;       // the other side's shard-start rows by its slot
  bf16_t *w, *b, *acc_w, *acc_b;  // the side's own tables
  float* csum;        // (chunk slots, 2r + 2): rounded chunk sums
  int n_items, n_multi;
};

// The step of the scheduled sums from a feature's rounded sums s1, s2 and
// its shard-start w (or b) and acc: acc + s2 rounded, then -lr s1 /
// sqrt(acc) op by op and one rounded add.
__device__ __forceinline__ void step_bf16(bf16_t* w, bf16_t* acc, float w0,
                                          float a0, float s1, float s2,
                                          float lr) {
  const float av = rsp::rbf(a0 + s2);
  stb(w, w0 + rsp::rbf(rsp::rbf(-lr * s1) / rsp::rbf(sqrtf(av))));
  stb(acc, av);
}

// Threads of a CTA of the bf16 walk at rank r: one a column of the r + 1
// (the components, then the bias), in whole warps.
__host__ __device__ constexpr int walk_threads(int r) {
  return 32 * ((r + 32) / 32);
}

// Launch S: both sides' items, one CTA an item (the row side's items
// first), thread k column k of the item's features: component k < r, or
// the bias at k = r, which is component r of a row whose other-side value
// is 1 (g = bf16(cost 1) = cost, g^2 = bf16(cost^2): the bias's sums and
// chains).  The CTA stages the item's entries (the other side's slot, the
// own id, the cost; a feature's first and last entries flagged); each
// thread then walks them in groups of kAhead, each group's loads issued
// together before its chains run: the other side's snapshot value of each
// entry, and the shard-start row (or bias) and accumulator of each feature
// that begins in the group.
//   ordered = 0 (the scheduled sums): per feature g = bf16(cost x) summed
//     at f32 with bf16(g^2); an item of whole features steps each at its
//     last entry (its sums rounded, as a single chunk's); an item that
//     is a chunk of a longer feature writes its rounded sums to chunk slot
//     q for launch F;
//   ordered = 1 (the ordered scatter): an item's features, or the whole
//     feature from its first chunk (later chunks return), each as two
//     chains a thread: acc = bf16(acc + bf16(g^2)) over its entries in
//     order, then w = bf16(w + bf16(bf16(-lr g) / bf16(sqrt(acc)))) with
//     the final acc.  The groups end at a feature's end, so a group's
//     features run both chains from its registers; a feature longer than
//     a group is walked twice in groups, its values loaded again.
// No thread reads what another writes: the other side's rows come from
// the snapshots of launch E, and a feature's rows are its CTA's alone.
template <int kT>
__global__ void __launch_bounds__(kT)
glove_bf16_walk(BSide rs, BSide cs, const float* __restrict__ cost, int r,
                float lr, int ordered) {
  __shared__ int s_o[kStage], s_f[kStage];
  __shared__ float s_c[kStage];
  __shared__ unsigned char s_fl[kStage];  // 1: a feature's first, 2: last
  const bool col = (int)blockIdx.x >= rs.n_items;
  const BSide sd = col ? cs : rs;  // a copy (see glove_final)
  const int4 it = sd.items[blockIdx.x - (col ? rs.n_items : 0)];
  const int e0 = it.x, q = it.z;
  const int e1 = ordered ? it.w : it.y;
  if (e1 < 0) return;  // a later chunk, walked from the first (ordered)
  const int k = threadIdx.x, R1 = r + 1;
  const bool on = k <= r;
  // the column's own tables (element f * ld) and other-side values
  bf16_t* const tw = k < r ? sd.w + k : sd.b;
  bf16_t* const ta = k < r ? sd.acc_w + k : sd.acc_b;
  const int ld = k < r ? r : 1;

  // entries [a, a + n) of the order into the stage, n <= kStage; a and b
  // bound the feature flags (the item's own ends)
  auto stage = [&](int a, int n) {
    __syncthreads();  // the stage before is read
    for (int t = k; t < n; t += blockDim.x) {
      const int p = sd.order[a + t];
      s_o[t] = sd.other[p];
      s_f[t] = sd.own[p];
      s_c[t] = cost[p];
    }
    __syncthreads();
    for (int t = k; t < n; t += blockDim.x)
      s_fl[t] = (t == 0 || s_f[t - 1] != s_f[t] ? 1 : 0) |
                (t == n - 1 || s_f[t + 1] != s_f[t] ? 2 : 0);
    __syncthreads();
  };
  auto xval = [&](int t) {
    return k < r ? ldb(sd.snap + (size_t)s_o[t] * R1 + k) : 1.f;
  };
  // the group [t0, t0 + kAhead) ∩ [t0, t1): x, and at each first entry the
  // feature's w (or b) and acc
  auto load = [&](int t0, int t1, float (&x)[kAhead], float (&pw)[kAhead],
                  float (&pa)[kAhead], bool rows) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int t = t0 + d;
      x[d] = pw[d] = pa[d] = 0.f;
      if (t < t1) {
        x[d] = xval(t);
        if (rows && (s_fl[t] & 1)) {
          const size_t i = (size_t)s_f[t] * ld;
          pw[d] = ldb(tw + i);
          pa[d] = ldb(ta + i);
        }
      }
    }
  };

  if (!ordered) {
    const int n = e1 - e0;  // at most kChunk
    stage(e0, n);
    if (!on) return;
    float sg = 0.f, sg2 = 0.f, ow = 0.f, oa = 0.f;  // the open feature's
    for (int t0 = 0; t0 < n; t0 += kAhead) {
      float x[kAhead], pw[kAhead], pa[kAhead];
      load(t0, n, x, pw, pa, q < 0);
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int t = t0 + d;
        if (t < n) {
          if (q < 0 && (s_fl[t] & 1)) {  // a feature begins
            sg = sg2 = 0.f;
            ow = pw[d];
            oa = pa[d];
          }
          const float g = rsp::rbf(s_c[t] * x[d]);
          sg += g;
          sg2 += rsp::rbf(g * g);
          if (q < 0 && (s_fl[t] & 2)) {  // it ends: its step
            const size_t i = (size_t)s_f[t] * ld;
            step_bf16(tw + i, ta + i, ow, oa, rsp::rbf(0.f + rsp::rbf(sg)),
                      rsp::rbf(0.f + rsp::rbf(sg2)), lr);
          }
        }
      }
    }
    if (q >= 0) {  // a chunk of a longer feature: its rounded sums
      float* dst = sd.csum + (size_t)q * (2 * r + 2);
      dst[k < r ? k : 2 * r] = rsp::rbf(sg);
      dst[k < r ? r + k : 2 * r + 1] = rsp::rbf(sg2);
    }
    return;
  }

  // the ordered scatter.  One feature's entries [t_lo, t_hi) of the stage
  // through one chain (0: the accumulator, 1: the row with divisor dv), in
  // groups of kAhead with their values loaded first.
  auto chain = [&](int pass, int t_lo, int t_hi, float& v, float dv) {
    for (int t0 = t_lo; t0 < t_hi; t0 += kAhead) {
      float x[kAhead];
#pragma unroll
      for (int d = 0; d < kAhead; ++d)
        x[d] = t0 + d < t_hi ? xval(t0 + d) : 0.f;
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        if (t0 + d < t_hi) {
          const float g = rsp::rbf(s_c[t0 + d] * x[d]);
          v = pass == 0 ? rsp::rbf(v + rsp::rbf(g * g))
                        : rsp::rbf(v + rsp::rbf(rsp::rbf(-lr * g) / dv));
        }
      }
    }
  };
  const int n = e1 - e0;
  if (n > kStage) {  // one long feature, staged kStage entries at a time
    const int f = sd.own[sd.order[e0]];
    const size_t i = (size_t)f * ld;
    float a = on ? ldb(ta + i) : 0.f, w = on ? ldb(tw + i) : 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      const float dv = rsp::rbf(sqrtf(a));
      for (int s0 = e0; s0 < e1; s0 += kStage) {
        const int m = min(kStage, e1 - s0);
        stage(s0, m);
        if (on) chain(pass, 0, m, pass == 0 ? a : w, dv);
      }
    }
    if (on) {
      stb(tw + i, w);
      stb(ta + i, a);
    }
    return;
  }
  stage(e0, n);
  if (!on) return;
  for (int t0 = 0; t0 < n;) {
    // a group of whole features of at most kAhead entries
    int t1 = min(t0 + kAhead, n);
    while (t1 > t0 && !(s_fl[t1 - 1] & 2)) --t1;
    if (t1 == t0) {  // a feature longer than a group: walked twice
      int te = t0 + kAhead;
      while (!(s_fl[te - 1] & 2)) ++te;
      const size_t i = (size_t)s_f[t0] * ld;
      float a = ldb(ta + i), w = ldb(tw + i);
      chain(0, t0, te, a, 1.f);
      chain(1, t0, te, w, rsp::rbf(sqrtf(a)));
      stb(tw + i, w);
      stb(ta + i, a);
      t0 = te;
      continue;
    }
    float x[kAhead], pw[kAhead], pa[kAhead], dv[kAhead];
    load(t0, t1, x, pw, pa, true);
    // the accumulators' chains, then each feature's divisor carried back
    // from its last entry to its first
    float a = 0.f;
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      dv[d] = 1.f;
      if (t0 + d < t1) {
        if (s_fl[t0 + d] & 1) a = pa[d];
        const float g = rsp::rbf(s_c[t0 + d] * x[d]);
        a = rsp::rbf(a + rsp::rbf(g * g));
        pa[d] = a;
        if (s_fl[t0 + d] & 2) dv[d] = rsp::rbf(sqrtf(a));
      }
    }
#pragma unroll
    for (int d = kAhead - 2; d >= 0; --d)
      if (t0 + d < t1 && !(s_fl[t0 + d] & 2)) dv[d] = dv[d + 1];
    // the rows' chains; each feature's rows stored at its last entry
    float w = 0.f;
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int t = t0 + d;
      if (t < t1) {
        if (s_fl[t] & 1) w = pw[d];
        const float g = rsp::rbf(s_c[t] * x[d]);
        w = rsp::rbf(w + rsp::rbf(rsp::rbf(-lr * g) / dv[d]));
        if (s_fl[t] & 2) {
          const size_t i = (size_t)s_f[t] * ld;
          stb(tw + i, w);
          stb(ta + i, pa[d]);
        }
      }
    }
    t0 = t1;
  }
}

// Launch F of the bf16 instance: CTAs [0, n_multi_r) the row side's
// features over several chunks, then the column side's, one a CTA: thread
// k sums column k's rounded chunk sums in chunk order at f32, rounds once
// and takes the step (the bias at k = r); the last CTA sums the loss
// partials in a fixed order (strided by thread, then a fixed tree) and
// rounds once.
template <int kT>
__global__ void __launch_bounds__(kT)
glove_bf16_final(BSide rs, BSide cs, int r, float lr,
                 const float* __restrict__ loss_part, int n_part,
                 float* __restrict__ loss) {
  const int k = threadIdx.x;
  if ((int)blockIdx.x == rs.n_multi + cs.n_multi) {
    __shared__ float red[kT / 32];
    float s = 0.f;
    for (int i = k; i < n_part; i += blockDim.x) s += loss_part[i];
    s = rsp::warp_sum(s);
    if ((k & 31) == 0) red[k >> 5] = s;
    __syncthreads();
    if (k == 0) {
      float t = 0.f;
      for (int i = 0; i < (int)(blockDim.x / 32); ++i) t += red[i];
      loss[0] = rsp::rbf(t);
    }
    return;
  }
  if (k > r) return;
  const bool col = (int)blockIdx.x >= rs.n_multi;
  const BSide sd = col ? cs : rs;
  const int2 m = sd.multi[blockIdx.x - (col ? rs.n_multi : 0)];
  const int nc = (sd.bounds[m.x + 1] - sd.bounds[m.x] + kChunk - 1) / kChunk;
  const int W = 2 * r + 2;
  const float* src = sd.csum + (size_t)m.y * W;
  const int i1 = k < r ? k : 2 * r, i2 = k < r ? r + k : 2 * r + 1;
  float t1 = 0.f, t2 = 0.f;
  for (int c = 0; c < nc; ++c) {
    t1 += src[(size_t)c * W + i1];
    t2 += src[(size_t)c * W + i2];
  }
  const size_t i = (size_t)sd.feats[m.x] * (k < r ? r : 1);
  bf16_t* const tw = (k < r ? sd.w + k : sd.b) + i;
  bf16_t* const ta = (k < r ? sd.acc_w + k : sd.acc_b) + i;
  step_bf16(tw, ta, ldb(tw), ldb(ta), rsp::rbf(t1), rsp::rbf(t2), lr);
}

// Floats of scratch the bf16 instance takes: cost (N), the loss partials
// (one a tile of kTile entries), both snapshots ((U_r + U_c)(r + 1) bf16)
// and both sides' chunk slots (a feature of n > kChunk entries takes
// ceil(n / kChunk) < 2 n / kChunk slots: fewer than N / 64 + 1 a side).
struct BScratch {
  long long loss_part, snap, csum_r, csum_c, total;
};
__host__ __device__ constexpr long long bf16_slots(int N) {
  return N / (kChunk / 2) + 1;
}
BScratch bf16_scratch(int N, int U_r, int U_c, int r) {
  const long long n_tiles = (N + kTile - 1) / kTile;
  BScratch s{};
  s.loss_part = N;
  s.snap = s.loss_part + n_tiles;
  const long long snap_f = ((long long)(U_r + U_c) * (r + 1) + 1) / 2;
  s.csum_r = s.snap + snap_f;
  s.csum_c = s.csum_r + bf16_slots(N) * (2LL * r + 2);
  s.total = s.csum_c + bf16_slots(N) * (2LL * r + 2);
  return s;
}

// The three launches of the bf16 instance at width 32 kRpl.
template <int kRpl>
int launch_bf16(const int* rows, const int* cols, const bf16_t* vals,
                const int* slot_r, const int* order_r, const int* bounds_r,
                int U_r, const int* feats_c, int U_c, BSide rs, BSide cs,
                int N, int r, float x_max, float alpha, float lr,
                int ordered, float* scratch, float* loss, cudaStream_t st) {
  constexpr int kT = walk_threads(32 * kRpl);
  const int nt = walk_threads(r);
  const BScratch m = bf16_scratch(N, U_r, U_c, r);
  float* cost = scratch;
  float* loss_part = scratch + m.loss_part;
  const int n_tiles = (N + kTile - 1) / kTile;
  const int n_eblk = (n_tiles + kWarps - 1) / kWarps;
  const int n_cblk = (U_c + kWarps - 1) / kWarps;
  glove_bf16_cost<kRpl><<<n_eblk + n_cblk, kThreads, 0, st>>>(
      rows, cols, vals, slot_r, order_r, bounds_r, U_r, feats_c, U_c,
      rs.w, rs.b, cs.w, cs.b, r, n_tiles, x_max, alpha, cost, loss_part,
      const_cast<bf16_t*>(cs.snap), const_cast<bf16_t*>(rs.snap));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (rs.n_items + cs.n_items > 0) {
    glove_bf16_walk<kT><<<rs.n_items + cs.n_items, nt, 0, st>>>(
        rs, cs, cost, r, lr, ordered);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (ordered) rs.n_multi = cs.n_multi = 0;  // walked whole in launch S
  glove_bf16_final<kT><<<rs.n_multi + cs.n_multi + 1, nt, 0, st>>>(
      rs, cs, r, lr, loss_part, n_tiles, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long rsp_glove_shard_scratch(int N, int U_r, int U_c, int r,
                                             int bf16) {
  return bf16 ? bf16_scratch(N, U_r, U_c, r).total : shard_scratch(N, U_r, r);
}

// rows/cols/slot_r/slot_c/order_r/order_c (N,) int32, vals (N,) of one
// shard; feats_r (U_r,), feats_c (U_c,) the distinct ids of its valid
// entries, bounds_r (U_r + 1,), bounds_c (U_c + 1,) each slot's range in
// its side's order (ops/segsum.py ShardMaps); the eight state tables
// (n, r) / (n,), updated in place, and vals f32, or bf16 when bf16 != 0
// (then `ordered` picks the JAX path whose roundings the updates follow,
// x_max, alpha and lr are bf16 values, and items_* / multi_* are each
// side's work list, ops/segsum.py WorkList: (n_items, 4) and (n_multi, 2)
// int32; the f32 instance reads none of them); scratch of
// rsp_glove_shard_scratch floats (written before it is read: no zeroing);
// loss one float, the shard's sum(cost * inner).
extern "C" int rsp_glove_shard(
    const int* rows, const int* cols, const void* vals, const int* slot_r,
    const int* slot_c, const int* feats_r, const int* feats_c,
    const int* order_r, const int* order_c, const int* bounds_r,
    const int* bounds_c, int N, int U_r, int U_c, int r, void* w_i,
    void* w_j, void* b_i, void* b_j, void* acc_w_i, void* acc_w_j,
    void* acc_b_i, void* acc_b_j, float x_max, float alpha, float lr,
    int bf16, int ordered, const int* items_r, int n_items_r,
    const int* multi_r, int n_multi_r, const int* items_c, int n_items_c,
    const int* multi_c, int n_multi_c, float* scratch, float* loss,
    void* stream) {
  if (N <= 0) return 0;
  if (U_r < 0 || U_c < 0 || r < 1 || r > kMaxRWide || !scratch || !loss)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (n_items_r < 0 || n_items_c < 0 || n_multi_r < 0 || n_multi_c < 0 ||
        n_multi_r > bf16_slots(N) || n_multi_c > bf16_slots(N))
      return (int)cudaErrorInvalidValue;
    const BScratch m = bf16_scratch(N, U_r, U_c, r);
    auto* snap_r = reinterpret_cast<bf16_t*>(scratch + m.snap);
    bf16_t* snap_c = snap_r + (size_t)U_r * (r + 1);
    auto t = [](void* p) { return static_cast<bf16_t*>(p); };
    const BSide rs{rows, slot_c, order_r, bounds_r, feats_r,
                   reinterpret_cast<const int4*>(items_r),
                   reinterpret_cast<const int2*>(multi_r), snap_c, t(w_i),
                   t(b_i), t(acc_w_i), t(acc_b_i), scratch + m.csum_r,
                   n_items_r, n_multi_r};
    const BSide cs{cols, slot_r, order_c, bounds_c, feats_c,
                   reinterpret_cast<const int4*>(items_c),
                   reinterpret_cast<const int2*>(multi_c), snap_r, t(w_j),
                   t(b_j), t(acc_w_j), t(acc_b_j), scratch + m.csum_c,
                   n_items_c, n_multi_c};
    const auto* v = static_cast<const bf16_t*>(vals);
    return r <= kMaxR
               ? launch_bf16<kMaxR / 32>(rows, cols, v, slot_r, order_r,
                                         bounds_r, U_r, feats_c, U_c, rs,
                                         cs, N, r, x_max, alpha, lr, ordered,
                                         scratch, loss, st)
               : launch_bf16<kMaxRWide / 32>(rows, cols, v, slot_r, order_r,
                                             bounds_r, U_r, feats_c, U_c, rs,
                                             cs, N, r, x_max, alpha, lr,
                                             ordered, scratch, loss, st);
  }
  const int n_tiles = (N + kTile - 1) / kTile;
  const size_t span_n = (size_t)n_tiles * 2 * (2 * r + 2);
  float* snap = scratch;
  float* span_r = snap + (size_t)U_r * (r + 1);
  float* span_c = span_r + span_n;
  float* loss_part = span_c + span_n;
  int* tail_r = reinterpret_cast<int*>(loss_part + n_tiles);
  int* tail_c = tail_r + n_tiles;
  auto f = [](void* p) { return static_cast<float*>(p); };
  const Side rs{rows, slot_r, order_r, bounds_r, feats_r, f(w_i), f(b_i),
                f(acc_w_i), f(acc_b_i), span_r, tail_r, U_r};
  const Side cs{cols, slot_c, order_c, bounds_c, feats_c, f(w_j), f(b_j),
                f(acc_w_j), f(acc_b_j), span_c, tail_c, U_c};
  const auto* v = static_cast<const float*>(vals);
  return r <= kMaxR
             ? launch_shard<kMaxR / 32>(rs, cs, cols, slot_r, v, f(w_j),
                                        f(b_j), snap, r, n_tiles, x_max,
                                        alpha, lr, loss_part, loss, st)
             : launch_shard<kMaxRWide / 32>(rs, cs, cols, slot_r, v, f(w_j),
                                            f(b_j), snap, r, n_tiles, x_max,
                                            alpha, lr, loss_part, loss, st);
}

// The instance width that takes rank r (128 or 320), 0 above the widest.
extern "C" int rsp_glove_shard_width(int r) {
  return r < 1 ? 0 : r <= kMaxR ? kMaxR : r <= kMaxRWide ? kMaxRWide : 0;
}
