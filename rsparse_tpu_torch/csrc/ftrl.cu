// K7: one FTRL-proximal row block, walked by feature.
//
// Replaces the TPU program rsparse_tpu/models/ftrl.py:64 _ftrl_block_impl
// (with _lazy_weights :56 and _link :48), and for FTRL the scheduled
// segment sums of rsparse_tpu/ops/segsum.py:784 that it runs on.  Its plain
// PyTorch version is rsparse_tpu_torch/models/ftrl.py _ftrl_block_plain.
//
// Every row of a block reads the block-start (z, n): the reference computes
// all the block's increments from one snapshot (src/FTRL.cpp:78-166 per
// row), and a feature's increments add up.  As K8 does (csrc/fm.cu), the
// update walks the block's entries grouped by feature (ops/segsum.py
// GLMBlock.order: the valid entries' flat indices sorted by slot, offs:
// each slot's range), so each feature's pair is written once, with no
// atomics and no scratch to zero, and the result does not change from run
// to run.  Three launches:
//   A  one warp a row: lazy weights w = -(z - sign(z) l1) /
//      ((decay + sqrt(n)) / lr + l2) where |z| > l1 from each entry's
//      block-start pair, the prediction link(sum w x) (x dropped and
//      rescaled where a keep mask is given), the row's d = sample_w (y_hat
//      - y), and, from the pair it already holds, each entry's g = clip(d x,
//      +-1000), sigma = (sqrt(n + g^2) - sqrt(n)) / lr and increments
//      (uz = g - sigma w, g^2), written with the pair at the entry's flat
//      index;
//   B  tiles of kTile consecutive entries of `order`, one warp a tile, 32
//      entries a step (one a lane): the entries' increments summed by a
//      segmented scan over the step (an entry's segment is its feature),
//      carried from step to step; a feature whose entries all lie in the
//      tile has its pair written there, once, from the block-start pair A
//      kept; the tile's first feature, if it began before the tile, and its
//      last, if it runs past it, leave their sums in the tile's head / tail
//      slot;
//   C  the features that run over tiles, a warp for each: the tile where a
//      feature's tail lies sums it and the heads of the tiles it runs into
//      (offs says how far), its lanes taking every 32nd slot, then a fixed
//      tree, and adds them to the pair.
// Predict mode is launch A alone.
//
// (z, n) are either the two columns of one (F + 1, 2) pair table (pair = 1:
// a feature's z and n in one 8-byte load from one 32-byte sector) or two
// 1-D tables (pair = 0).
//
// What bounds it on the H100: bytes.  Per entry A reads the index, the
// value and one (z, n) pair at a random feature of up to 40M (320 MB of
// table, so device memory, not L2) and writes 16 bytes (increments and
// pair, coalesced); B reads the index, the feature and those 16 bytes from
// L2 and writes each feature's pair once, without reading the table again.
// At the hashed shape nearly every feature of a block is distinct: about 2
// random 32-byte sectors of device memory an entry on the pair table (A's
// read, B's write), twice that on two tables; a handful of flops.

#include "common.cuh"

namespace {

constexpr float kClipGrad = 1000.f;
constexpr int kWarps = 8;  // warps a CTA, every launch
constexpr int kThreads = kWarps * 32;
#ifndef RSP_FTRL_TILE
#define RSP_FTRL_TILE 128  // models/ftrl.py K7_TILE
#endif
// entries a tile of launch B
constexpr int kTile = RSP_FTRL_TILE;
static_assert(kTile > 0 && kTile % 32 == 0, "a tile is whole steps of 32");

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

// (z, n) of feature f
template <bool kPair>
__device__ __forceinline__ float2 read_zn(const float* z, const float* n,
                                          int f) {
  if (kPair) return reinterpret_cast<const float2*>(z)[f];
  return make_float2(z[f], n[f]);
}

template <bool kPair>
__device__ __forceinline__ void write_zn(float* z, float* n, int f,
                                         float2 v) {
  if (kPair) {
    reinterpret_cast<float2*>(z)[f] = v;
  } else {
    z[f] = v.x;
    n[f] = v.y;
  }
}

// an entry's value as the block sees it: dropped or rescaled by the mask
__device__ __forceinline__ float entry_value(const float* val,
                                             const unsigned char* keep,
                                             float keep_scale, size_t p) {
  const float x = val[p];
  if (!keep) return x;
  return keep[p] ? x * keep_scale : 0.f;
}

struct Params {
  float lr, decay, l1, l2, keep_scale;
};

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
ftrl_rows(const int* __restrict__ col, const float* __restrict__ val,
          const int* __restrict__ nnz, const unsigned char* __restrict__ keep,
          const float* __restrict__ y, const float* __restrict__ sample_w,
          const float* __restrict__ z, const float* __restrict__ n, int B,
          int L, Params hp, int family, float* __restrict__ y_hat,
          float4* __restrict__ ent) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // b is the same on every lane of the warp
  const int m = nnz[b];
  const size_t base = (size_t)b * L;
  float part = 0.f, x0 = 0.f;
  float2 zn0 = make_float2(0.f, 0.f);  // the lane's first entry's
  for (int l = lane; l < m; l += 32) {
    const float x = entry_value(val, keep, hp.keep_scale, base + l);
    const float2 zn = read_zn<kPair>(z, n, col[base + l]);
    if (l == lane) {
      x0 = x;
      zn0 = zn;
    }
    part += lazy_weight(zn.x, zn.y, hp.lr, hp.decay, hp.l1, hp.l2) * x;
  }
  const float yh = link(rsp::warp_sum(part), family);
  if (lane == 0) y_hat[b] = yh;
  if (!ent) return;  // predict mode
  // each entry's increments (uz, g^2) from the same block-start pair, and
  // the pair
  const float d = sample_w[b] * (yh - y[b]);
  for (int l = lane; l < m; l += 32) {
    float x = x0;
    float2 zn = zn0;
    if (l != lane) {
      x = entry_value(val, keep, hp.keep_scale, base + l);
      zn = read_zn<kPair>(z, n, col[base + l]);
    }
    const float w = lazy_weight(zn.x, zn.y, hp.lr, hp.decay, hp.l1, hp.l2);
    const float g = fminf(fmaxf(d * x, -kClipGrad), kClipGrad);
    const float g2 = g * g;
    const float sigma = (sqrtf(zn.y + g2) - sqrtf(zn.y)) / hp.lr;
    ent[base + l] = make_float4(g - sigma * w, g2, zn.x, zn.y);
  }
}

// a tile's head (which 0) or tail (1) slot: [sum uz, sum g^2]
__device__ __forceinline__ float* span_slot(float* span, int tile,
                                            int which) {
  return span + ((size_t)tile * 2 + which) * 2;
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
ftrl_feats(const int* __restrict__ order, const int* __restrict__ slot,
           const int* __restrict__ col, const int* __restrict__ offs,
           const float4* __restrict__ ent, float* z, float* n, int N,
           int n_tiles, float* __restrict__ span, int* __restrict__ tail_u) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  const int e0 = tile * kTile, e1 = min(e0 + kTile, N);
  // the tile's first and last features (and the last one's slot), and
  // whether their entries run past the tile (read with the first and the
  // last 32 entries)
  int f_first = -1, f_last = -1, u_last = -1;
  bool cross_in = false, own_tail = false;

  // a segment's sums are done: a head or tail slot, or the feature's pair,
  // from its block-start value zn
  auto finish = [&](float suz, float sg2, int f, float2 zn) {
    if (f == f_first && cross_in) {
      float* s = span_slot(span, tile, 0);
      s[0] = suz;
      s[1] = sg2;
    } else if (f == f_last && own_tail) {
      float* s = span_slot(span, tile, 1);
      s[0] = suz;
      s[1] = sg2;
    } else {
      write_zn<kPair>(z, n, f, make_float2(zn.x + suz, zn.y + sg2));
    }
  };

  // the segment open at the last step's end (every lane)
  float c_uz = 0.f, c_g2 = 0.f;
  float2 czn = make_float2(0.f, 0.f);
  int cf = -1;
  for (int sb = e0; sb < e1; sb += 32) {
    // 32 entries at a time, one a lane: feature, increments, block-start
    // pair
    const int n_sub = min(32, e1 - sb);
    int p = 0, f = -1;
    float uz = 0.f, g2 = 0.f;
    float2 zn = make_float2(0.f, 0.f);
    if (lane < n_sub) {
      p = order[sb + lane];
      f = col[p];
      const float4 q = ent[p];
      uz = q.x;
      g2 = q.y;
      zn = make_float2(q.z, q.w);
    }
    if (sb == e0) {
      f_first = __shfl_sync(RSP_FULL_MASK, f, 0);
      cross_in = offs[slot[__shfl_sync(RSP_FULL_MASK, p, 0)]] < e0;
    }
    if (sb + 32 >= e1) {
      f_last = __shfl_sync(RSP_FULL_MASK, f, n_sub - 1);
      u_last = slot[__shfl_sync(RSP_FULL_MASK, p, n_sub - 1)];
      own_tail = offs[u_last + 1] > e1 && !(f_last == f_first && cross_in);
    }
    // segmented inclusive scan over the step's entries: `order` is sorted
    // by slot, and so by feature, so an equal feature o lanes back is in
    // the same segment
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int of = __shfl_up_sync(RSP_FULL_MASK, f, o);
      const float q1 = __shfl_up_sync(RSP_FULL_MASK, uz, o);
      const float q2 = __shfl_up_sync(RSP_FULL_MASK, g2, o);
      if (lane >= o && of == f) {
        uz += q1;
        g2 += q2;
      }
    }
    const int f0 = __shfl_sync(RSP_FULL_MASK, f, 0);
    if (cf >= 0 && cf != f0) {
      if (lane == 0) finish(c_uz, c_g2, cf, czn);  // ended last step
    } else if (f == cf) {
      uz += c_uz;
      g2 += c_g2;
    }
    const int last = n_sub - 1;
    const int nf = __shfl_down_sync(RSP_FULL_MASK, f, 1);
    if (lane < last && nf != f) finish(uz, g2, f, zn);  // ends in the step
    // the segment open at the step's end, on every lane
    c_uz = __shfl_sync(RSP_FULL_MASK, uz, last);
    c_g2 = __shfl_sync(RSP_FULL_MASK, g2, last);
    cf = __shfl_sync(RSP_FULL_MASK, f, last);
    czn.x = __shfl_sync(RSP_FULL_MASK, zn.x, last);
    czn.y = __shfl_sync(RSP_FULL_MASK, zn.y, last);
  }
  if (lane == 0) {
    finish(c_uz, c_g2, cf, czn);  // the tile's last segment
    tail_u[tile] = own_tail ? u_last : -1;
  }
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
ftrl_span(const int* __restrict__ tail_u, const int* __restrict__ offs,
          const int* __restrict__ feats, const float* __restrict__ span,
          float* z, float* n, int n_tiles) {
  // one warp a tile; the tile that holds a feature's tail sums its slots,
  // lane j every 32nd from the tail's tile + j, then a fixed tree
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  const int u = tail_u[tile];
  if (u < 0) return;
  const int t1 = (offs[u + 1] - 1) / kTile;
  float suz = 0.f, sg2 = 0.f;
  for (int q = tile + lane; q <= t1; q += 32) {
    const float* s = span_slot(const_cast<float*>(span), q, q == tile);
    suz += s[0];
    sg2 += s[1];
  }
  suz = rsp::warp_sum(suz);
  sg2 = rsp::warp_sum(sg2);
  if (lane == 0) {
    const int f = feats[u];
    const float2 zn = read_zn<kPair>(z, n, f);
    write_zn<kPair>(z, n, f, make_float2(zn.x + suz, zn.y + sg2));
  }
}

template <bool kPair>
cudaError_t run(const int* col, const float* val, const int* nnz,
                const int* slot, const unsigned char* keep, const float* y,
                const float* sample_w, float* z, float* n, const int* feats,
                const int* order, const int* offs, float* scratch, int N,
                int B, int L, Params hp, int family, int do_update,
                float* y_hat, cudaStream_t st) {
  const int n_tiles = (N + kTile - 1) / kTile;
  // scratch: the entries' increments and block-start pairs (B, L) float4,
  // the tiles' slots (n_tiles, 2, 2), the tiles' tail slots (n_tiles) int32
  float4* ent = do_update ? reinterpret_cast<float4*>(scratch) : nullptr;
  ftrl_rows<kPair><<<(B + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      col, val, nnz, keep, y, sample_w, z, n, B, L, hp, family, y_hat, ent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !do_update || n_tiles == 0) return err;
  float* span = scratch + 4 * (size_t)B * L;
  int* tail_u = reinterpret_cast<int*>(span + (size_t)n_tiles * 4);
  const unsigned grid = (unsigned)((n_tiles + kWarps - 1) / kWarps);
  ftrl_feats<kPair><<<grid, kThreads, 0, st>>>(
      order, slot, col, offs, ent, z, n, N, n_tiles, span, tail_u);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ftrl_span<kPair><<<grid, kThreads, 0, st>>>(tail_u, offs, feats, span, z,
                                              n, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// col/val/slot/keep (B, L), nnz/y/sample_w/y_hat (B,); z/n (F + 1,) f32
// updated in place: with pair = 1 the two columns of one (F + 1, 2) table
// (n == z + 1, 8-byte aligned), with pair = 0 two 1-D tables; feats (U,),
// order (N,), offs (U + 1,) int32; scratch of models/ftrl.py k7_plan's
// floats (null in predict mode: written before it is read, no zeroing).
// keep is a bool (B, L) mask or null.
extern "C" int rsp_ftrl_block(const int* col, const float* val,
                              const int* nnz, const int* slot,
                              const unsigned char* keep, float keep_scale,
                              const float* y, const float* sample_w, float* z,
                              float* n, int pair, const int* feats,
                              const int* order, const int* offs,
                              float* scratch, int U, int N, int B, int L,
                              float lr, float decay, float l1, float l2,
                              int family, int do_update, float* y_hat,
                              void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || U < 0 || N < 0 || (do_update && !scratch) ||
      (pair && (n != z + 1 || reinterpret_cast<size_t>(z) % 8)) ||
      reinterpret_cast<size_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const Params hp{lr, decay, l1, l2, keep_scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (pair)
    return (int)run<true>(col, val, nnz, slot, keep, y, sample_w, z, n,
                          feats, order, offs, scratch, N, B, L, hp, family,
                          do_update, y_hat, st);
  return (int)run<false>(col, val, nnz, slot, keep, y, sample_w, z, n, feats,
                         order, offs, scratch, N, B, L, hp, family, do_update,
                         y_hat, st);
}
