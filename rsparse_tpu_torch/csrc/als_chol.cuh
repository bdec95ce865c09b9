// K2's pieces, shared by the narrow kernel (als_chol.cu, d <= 160, the
// factor in shared memory) and the wide one (als_chol_wide.cu, d <= 514,
// the factor in a cluster's shared memory): the Gram's operand routes and
// its tensor-core k-steps over a run of lower m16n8 tiles, and the blocked
// factorisation's diagonal block and trailing update.  See als_chol.cu for
// the design.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;    // entries staged per chunk
// entries listed at once (cold), or head columns scanned at once
constexpr int kSeg = 1024;
constexpr int kPanel = 16;

// Gram routes (rsp_als_chol_info reports them)
enum Route : int {
  kRouteBf16 = 0,     // one bf16 mma
  kRouteBf16Sym = 1,  // two bf16 mmas: (bf16(w x), x) and (x, bf16(w x))
  kRouteTf32x2 = 2,   // tf32, A split into hi + lo
  kRouteTf32x3 = 3    // tf32, A and B split
};

template <class T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

template <class T, bool EXPLICIT>
__host__ __device__ constexpr int gram_route(bool head, bool round) {
  return !is_bf16<T>() ? kRouteTf32x3
         : EXPLICIT    ? kRouteBf16
         : (round && !head) ? kRouteBf16Sym
                            : kRouteTf32x2;
}

// Shared-memory layout of one CTA, computed alike on the host and the card.
struct Layout {
  int D;        // d padded to a multiple of 16
  int lda;      // row stride of the factorised matrix (floats)
  int rs;       // bytes of one staged row's slot
  int granules; // 16-byte granules a row's window can span
  int per;      // lower m16n8 tiles a warp
  int list;     // byte offset of the entry list (after the two buffers)
  int totals;   // byte offset of the warps' Gram sums
  int extra;    // byte offset of dinv, x, dot operand, scratch
  int bytes;    // total
};

__host__ __device__ inline Layout make_layout(int d, int tbytes) {
  Layout L;
  L.D = (d + kPanel - 1) / kPanel * kPanel;
  L.lda = L.D + 4;
  L.granules = (d * tbytes + 30) / 16;
  int w = 4 * L.granules;                 // words; 8 mod 32 spreads a
  w += ((8 - w) % 32 + 32) % 32;          // fragment's 4 rows over the banks
  L.rs = 4 * w;
  const int nM = L.D / 16;
  L.per = (nM * (nM + 1) + 7) / 8;
  L.list = 2 * kRows * L.rs;
  L.totals = L.list + kSeg * 12 + ((2 * kRows * 4 + 65 * 4 + 15) & ~15);
  const int gram = L.totals + 8 * L.per * 4 * 32 * 4;
  const int lhs = (L.D + 1) * L.lda * 4;
  L.extra = ((gram > lhs ? gram : lhs) + 15) & ~15;
  L.bytes = L.extra + (3 * L.D + 32) * 4;
  return L;
}

// ---- device helpers ---------------------------------------------------------

// Element i of a staged row (raw bytes of type T) as float.
template <class T>
__device__ __forceinline__ float sld(const unsigned char* row, int i) {
  if constexpr (is_bf16<T>()) {
    return __uint_as_float(
        (unsigned)*reinterpret_cast<const unsigned short*>(row + 2 * i) << 16);
  } else {
    return *reinterpret_cast<const float*>(row + 4 * i);
  }
}

// bf16 bits of a float that is exact in bf16, or rounded to nearest even
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// The warp's run of lower m16n8 tiles: tile (m, n), n <= 2m + 1, in
// row-major order; MAXT covers the widest D of the template.  (The k-steps
// below take any run type with kMaxT, count, m0, n0 and next(m, n), the
// tile after (m, n): the wide kernel's runs walk a CTA's own panels.)
template <int KD>
struct TileRun {
  static constexpr int kMaxT = ((KD / 16) * (KD / 16 + 1) + 7) / 8;
  int count, m0, n0;
  __device__ __forceinline__ TileRun(int D, int warp) {
    const int nM = D / 16, nT = nM * (nM + 1);
    const int per = (nT + 7) / 8;
    const int first = warp * per;
    count = max(0, min(per, nT - first));
    int m = 0;
    while ((m + 1) * (m + 2) <= first) ++m;
    m0 = m;
    n0 = first - m * (m + 1);
  }
  __device__ __forceinline__ void next(int& m, int& n) const {
    if (++n > 2 * m + 1) {
      n = 0;
      ++m;
    }
  }
};

// One k-step of 8 staged rows on the tf32 route: rows pA (k = tig) and pB
// (k = tig + 4) with lhs weights wA, wB; A = w x split into hi + lo, B = x
// split when SPLIT_B (a float32 table).  Columns at or past d read as 0.
template <class Run, class T, bool SPLIT_B>
__device__ __forceinline__ void tf32_step(float (&c)[Run::kMaxT][4],
                                          const Run& run,
                                          const unsigned char* pA,
                                          const unsigned char* pB, float wA,
                                          float wB, int d, int g) {
  int m = run.m0, n = run.n0, cur = -1;
  unsigned ah[4], al[4];
#pragma unroll
  for (int t = 0; t < Run::kMaxT; ++t) {
    if (t < run.count) {
      if (m != cur) {
        const int i0 = 16 * m + g, i1 = i0 + 8;
        const float v[4] = {i0 < d ? wA * sld<T>(pA, i0) : 0.f,
                            i1 < d ? wA * sld<T>(pA, i1) : 0.f,
                            i0 < d ? wB * sld<T>(pB, i0) : 0.f,
                            i1 < d ? wB * sld<T>(pB, i1) : 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[q] = rsp::to_tf32(v[q]);
          al[q] = rsp::to_tf32(v[q] - __uint_as_float(ah[q]));
        }
        cur = m;
      }
      const int j = 8 * n + g;
      const float u0 = j < d ? sld<T>(pA, j) : 0.f;
      const float u1 = j < d ? sld<T>(pB, j) : 0.f;
      const unsigned bh0 = rsp::to_tf32(u0), bh1 = rsp::to_tf32(u1);
      if constexpr (SPLIT_B) {
        rsp::mma_tf32(c[t], ah, rsp::to_tf32(u0 - __uint_as_float(bh0)),
                 rsp::to_tf32(u1 - __uint_as_float(bh1)));
      }
      rsp::mma_tf32(c[t], al, bh0, bh1);
      rsp::mma_tf32(c[t], ah, bh0, bh1);
      run.next(m, n);
    }
  }
}


// One k-step of 16 staged rows on a bf16 route: p[0..3] are the rows
// k = 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 with weights w[0..3].  SYM adds
// the transposed term: c += bf16(w x) x' + x bf16(w x)' (HALF 1: the first
// term alone, HALF 2: the second alone); else (explicit) c += x x'.
template <class Run, class T, bool SYM, int HALF = 0>
__device__ __forceinline__ void bf16_step(float (&c)[Run::kMaxT][4],
                                          const Run& run,
                                          const unsigned char* const (&p)[4],
                                          const float (&w)[4], int d, int g) {
  int m = run.m0, n = run.n0, cur = -1;
  unsigned ax[4], aw[4];
#pragma unroll
  for (int t = 0; t < Run::kMaxT; ++t) {
    if (t < run.count) {
      if (m != cur) {
        const int i0 = 16 * m + g, i1 = i0 + 8;
        float x0[4], x1[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x0[q] = i0 < d ? sld<T>(p[q], i0) : 0.f;
          x1[q] = i1 < d ? sld<T>(p[q], i1) : 0.f;
        }
        ax[0] = pack2(x0[0], x0[1]);
        ax[1] = pack2(x1[0], x1[1]);
        ax[2] = pack2(x0[2], x0[3]);
        ax[3] = pack2(x1[2], x1[3]);
        if constexpr (SYM) {
          aw[0] = pack2(w[0] * x0[0], w[1] * x0[1]);
          aw[1] = pack2(w[0] * x1[0], w[1] * x1[1]);
          aw[2] = pack2(w[2] * x0[2], w[3] * x0[3]);
          aw[3] = pack2(w[2] * x1[2], w[3] * x1[3]);
        }
        cur = m;
      }
      const int j = 8 * n + g;
      float u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = j < d ? sld<T>(p[q], j) : 0.f;
      const unsigned bx0 = pack2(u[0], u[1]), bx1 = pack2(u[2], u[3]);
      if constexpr (SYM) {
        if constexpr (HALF != 2) rsp::mma_bf16(c[t], aw, bx0, bx1);
        if constexpr (HALF != 1)
          rsp::mma_bf16(c[t], ax, pack2(w[0] * u[0], w[1] * u[1]),
                        pack2(w[2] * u[2], w[3] * u[3]));
      } else {
        rsp::mma_bf16(c[t], ax, bx0, bx1);
      }
      run.next(m, n);
    }
  }
}

// ---- the factorisation's pieces ---------------------------------------------

// Warp 0: factor the 16 x 16 diagonal block at (s, s) in registers, one row
// a lane (lanes 0..15; lanes 16..31 shadow them), column by column with the
// reference's guard (piv = sqrt(max(A_jj, 0)), divisor 1 where it is 0);
// writes L back and dinv[s + i] = 1 / L_ii, or 1 where L_ii is not positive
// (the divisor of _trsm_lower and of the substitutions).
__device__ __forceinline__ void factor_diag(float* Lm, int lda, int s,
                                            float* dinv, int lane) {
  float r[kPanel];
  float* row = Lm + (s + (lane & 15)) * lda + s;
#pragma unroll
  for (int k = 0; k < kPanel; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    r[k] = v.x; r[k + 1] = v.y; r[k + 2] = v.z; r[k + 3] = v.w;
  }
  float ljj = 0.f;
  // the pivot of column j: lane j's A_jj, broadcast.  Lane j + 1 forms the
  // next pivot from its own L_{j+1,j} before the other lanes' shuffles, so
  // only one shuffle a column lies on the chain.
  float ajj = __shfl_sync(RSP_FULL_MASK, r[0], 0);
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    // 1 / piv, piv = sqrt(max(A_jj, 0)), or 1 where piv is 0
    const float inv = ajj > 0.f ? rsqrtf(ajj) : 1.f;
    if (lane >= j) r[j] *= inv;
    if (lane == j) ljj = r[j];
    if (j + 1 < kPanel) {
      // lane j + 1's updated A_{j+1,j+1} (its own L_{j+1,j} twice: the
      // same fmaf as the update below gives it), broadcast
      ajj = __shfl_sync(RSP_FULL_MASK, fmaf(-r[j], r[j], r[j + 1]), j + 1);
      const float own = r[j];
#pragma unroll
      for (int k = j + 1; k < kPanel; ++k)
        r[k] = fmaf(-own, __shfl_sync(RSP_FULL_MASK, own, k), r[k]);
    }
  }
  if (lane < kPanel) {
#pragma unroll
    for (int k = 0; k < kPanel; k += 4)
      *reinterpret_cast<float4*>(row + k) =
          make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]);
    dinv[s + lane] = 1.f / (ljj > 0.f ? ljj : 1.f);
  }
}

// One 4 x 4 tile t of the rank-16 trailing update after the panel at s:
// tiles t < nb (nb + 1) / 2 walk the lower triangle of the nb x nb blocks
// of rows and columns [s + 16, D) row by row; the next nb are the rhs row
// D against each block of columns.
__device__ __forceinline__ void update_tile(float* Lm, int lda, int s, int nb,
                                            int t) {
  const int n_tri = nb * (nb + 1) / 2, c0 = s + kPanel;
  int rb, cb;
  if (t < n_tri) {
    rb = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (rb * (rb + 1) / 2 > t) --rb;
    while ((rb + 1) * (rb + 2) / 2 <= t) ++rb;
    cb = t - rb * (rb + 1) / 2;
  } else {
    rb = nb;
    cb = t - n_tri;
  }
  const int i0 = c0 + 4 * rb, j0 = c0 + 4 * cb, nr = rb == nb ? 1 : 4;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    if (ii < nr) {
      const float4 v = *reinterpret_cast<const float4*>(Lm + (i0 + ii) * lda + j0);
      acc[ii][0] = v.x; acc[ii][1] = v.y; acc[ii][2] = v.z; acc[ii][3] = v.w;
    }
  }
#pragma unroll
  for (int kq = 0; kq < kPanel; kq += 4) {
    float4 li[4], lj[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      li[q] = q < nr ? *reinterpret_cast<const float4*>(Lm + (i0 + q) * lda + s + kq)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      lj[q] = *reinterpret_cast<const float4*>(Lm + (j0 + q) * lda + s + kq);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[ii][jj] -= li[ii].x * lj[jj].x + li[ii].y * lj[jj].y +
                       li[ii].z * lj[jj].z + li[ii].w * lj[jj].w;
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
    if (ii < nr)
      *reinterpret_cast<float4*>(Lm + (i0 + ii) * lda + j0) =
          make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
}

}  // namespace
