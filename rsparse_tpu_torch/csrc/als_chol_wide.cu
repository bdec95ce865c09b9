// K2 at the wide widths (160 < d <= 514): one bucket of exact ALS solves by
// Cholesky, implicit or explicit feedback, with an optional dense zipf head,
// the factor held on chip across a thread-block cluster.
//
// Replaces the same TPU programs as als_chol.cu (rsparse_tpu/ops/als.py:138
// _solve_bucket_implicit exact branch :228-247 and :269
// _solve_bucket_explicit exact branch :346-362, :125 _hot_lhs, and
// rsparse_tpu/ops/solvers.py:134 batched_spd_solve_blocked) at the widths
// where als_chol.cu's (D + 1) x (D + 4) factor no longer fits a CTA's
// shared memory (267 KB at D = 256, 1.1 MB at D = 528).  Its plain PyTorch
// versions are rsparse_tpu_torch/ops/als.py _solve_bucket_implicit /
// _explicit.
//
// The design: one cluster of C CTAs (one an SM, 16 warps each) solves one
// row, C the smallest of 1, 2 and 4 whose layout fits (cluster_size: 1
// through d = 256 at float32, 2 at 258, 4 at 512 and 514), or, for a
// bucket of few long rows, 6 or 8 (bucket_plan); a persistent grid of
// as many clusters as the card runs at once
// (cudaOccupancyMaxActiveClusters: 30 of 4 on 132 SMs) takes the bucket's
// rows in turn.  The lower triangle of the padded D x D matrix is kept by
// 16-row panels (panel p: rows 16p..16p + 15, columns 0..16p + 15, row
// stride panel_lda(p) = 8 mod 32 floats), dealt over the cluster from the
// widest panel down, C a round, the direction turning each round
// (panel_owner): at D = 528 each of 4 CTAs holds 140 or 141 of the 561 16
// x 16 blocks, ~151 KB (215 KB of shared memory with the staging).  Nothing
// of the factor goes to device memory.  A CTA reads the other CTAs' panel
// rows in place through DSMEM, so no CTA holds a copy of a column panel (at
// 8 CTAs a row those copies, two buffers of D x 16, took more shared
// memory than the factor's share and a copy phase every panel); fewer
// SMs a row means more rows in flight, and a row's chain of panels,
// latency-bound on eight SMs, gets more work a step.
// (1) The Gram in one walk of the row's entries: every CTA lists the
//     entries and stages their source rows itself (als_chol.cu's lists,
//     cp.async staging, two buffers of 16 rows, 8 for float32 tables) and
//     sums only its own panels' lower m16n8 tiles, ~18 a warp, with the
//     operand routes of als_chol.cuh unchanged (3xTF32 on float32 tables,
//     2xTF32 or bf16 mma on bf16 ones, both ways for the bf16-rounded
//     implicit cold rows); each chunk goes into fresh fragments added in
//     float32 to the panel in shared memory.  Then XtX or the ridge
//     (identity on the padding, the symmetrised halving under
//     compute_dtype="bfloat16") is added.  The rhs rows of a panel are
//     summed by its owner and kept beside it as z.  (The layout and this
//     walk live in als_chol_wide.cuh, shared with the wide K4.)
// (2) The factorisation right-looking in 16-column panels, one cluster
//     barrier a panel.  For panel k: every CTA solves its own rows below
//     the diagonal block against L_kk (a thread a row); warp 0 of the owner
//     of panel k + 1 meanwhile updates its diagonal block and z block with
//     its own rows, factors the block (the reference's pivot guard), solves
//     z_k+1 = L^-1 z and sends (L, 1 / diag, z) to every CTA (three slots);
//     barrier; then each CTA applies the rank-16 trailing update to its own
//     blocks (j, i) on the tensor cores (3xTF32 mma.sync into fresh
//     fragments, added in float32), the rows of panel i read from their
//     owner's shared memory, and z_j -= L_jk z_k to its own z blocks.  A
//     CTA ahead writes only its rows' next column block, which no CTA still
//     in this step reads.  z = L^-1 rhs comes out with the factor.
// (3) The back substitution L' x = z by blocks from the last: the owner of
//     block p sums what the blocks after it took off (one partial vector a
//     CTA, read through DSMEM in a fixed order), solves the 16 x 16
//     transposed block in one warp and adds L_p.' x_p into its partial,
//     spread over its threads; then it signals the owner of block p - 1 by
//     an mbarrier arrival in that CTA (no cluster barrier a block).  Then
//     each CTA reads x and sums the loss over 1 / C of the entries;
//     CTA 0 adds the partials in order.
//
// What bounds it on the H100: per row the Gram is (n + Hp) d^2 products on
// the tensor cores and the factorisation d^3 / 3 FMAs; at D = 528 that is
// ~20 us of tensor-core time on a cluster's 4 SMs.  What is left is the
// chain: D pivots in one warp, D / 16 cluster barriers and D / 16 signals,
// which no SM can shorten; 30 rows run at once at D = 528, 132 through D =
// 256.  A row of many entries is bound by its Gram instead, whose time
// falls with the tiles a warp sums: a bucket whose rows hold at least 2 D
// entries takes the cluster of 1, 2, 4, 6 or 8 CTAs (no fewer than the
// width's) with the fewest waves of rows times tiles a warp (bucket_plan):
// the 16 x 8,192 long-row bucket at d = 514 runs on 6 CTAs a row (96 SMs,
// one wave; 8 would take two: the H100 runs 15 clusters of 8).  Every CTA
// stages the row's entries itself; the cluster's copies are read from L2.
//
// rsp_als_chol_wide's `stages` stops a launch after the Gram (1: the lhs is
// built, nothing is written), after the factorisation (4: z = L^-1 rhs,
// nothing is written) or after the solve (2: y written, no loss); 3 runs
// everything.

#include <cooperative_groups.h>

#include <mutex>

#include "als_chol_wide.cuh"

namespace cgrp = cooperative_groups;

// RSP_CHOL_CLOCKS (a timing build, kernel_times.py k2-wide): thread 0 of
// each CTA of the first cluster sums the clock cycles of each phase, and
// the launch writes them over loss[8 rank + phase] at its end.
#ifdef RSP_CHOL_CLOCKS
#define RSP_CLK(i)                   \
  do {                               \
    if (tid == 0) {                  \
      const long long c_ = clock64(); \
      clk[i] += c_ - clk_t;          \
      clk_t = c_;                    \
    }                                \
  } while (0)
#else
#define RSP_CLK(i) \
  do {             \
  } while (0)
#endif

namespace {

// CTAs a row for a bucket of few long rows (bucket_plan)
constexpr int kSizes[] = {1, 2, 4, 6, 8};

// The back substitution's point-to-point signal: an mbarrier of one
// arrival in each CTA, arrived on from another CTA of the cluster.
__device__ __forceinline__ void signal_cta(unsigned long long* bar, int cta) {
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(cta));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          ra)
      : "memory");
}
__device__ __forceinline__ void wait_signal(unsigned long long* bar,
                                            unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// The loss of row b over the cluster: the cluster's 16 C warps take the cold
// entries in turn and the head's 32-column strips (rsp::for_each_entry);
// CTA 0 adds lam_use |y|^2; the CTA's sum.  Every lane computes each term;
// lane k % 32 adds the warp's k-th, as rsp::row_loss does.
template <bool EXPLICIT, int C, class T>
__device__ __forceinline__ float cluster_loss(const rsp::RowEntries<T>& R,
                                              const rsp::BucketArgs& a,
                                              const float* y,
                                              const float* y_dot,
                                              float lam_use, float* scratch,
                                              int rank) {
  constexpr int kNw = C * kWarpsW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = rank * kWarpsW + warp;
  const bool has_xb = R.xbias != nullptr;
  float acc = 0.f;
  int k = 0;
  for (int e = gw; e < R.nnz; e += kNw) {
    float r[kLossPer];
    rsp::load_row<kLossPer>(R.table + (size_t)R.col[e] * R.d, R.d, r);
    const float xb = has_xb ? __ldg(R.xbias + R.col[e]) : 0.f;
    const float term = rsp::entry_loss<EXPLICIT>(
        R.val[e], xb, a.g_loss, rsp::row_dot<kLossPer>(r, y_dot, R.d));
    if ((k++ & 31) == lane) acc += term;
  }
  if (R.w != nullptr) {
    rsp::RowEntries<T> head = R;
    head.nnz = 0;  // the cold entries are done
    rsp::for_each_entry<true>(head, gw, kNw,
                              [&](const T* row, float c, float xb, bool) {
      float rr[kLossPer];
      rsp::load_row<kLossPer>(row, R.d, rr);
      const float term = rsp::entry_loss<EXPLICIT>(
          c, xb, a.g_loss, rsp::row_dot<kLossPer>(rr, y_dot, R.d));
      if ((k++ & 31) == lane) acc += term;
    });
  }
  float part = acc;
  if (rank == 0)
    for (int t = threadIdx.x; t < R.d; t += blockDim.x)
      part += lam_use * y[t] * y[t];
  return rsp::block_sum(part, scratch);
}

// Element (row, col) of a step's column block copy: 16 floats a row, the
// row's four float4 quads permuted by bits 1-2 of the row, so that a
// fragment's 8 rows x 4 columns hit 32 banks.
__device__ __forceinline__ float cb_at(const float* cb, int row, int col) {
  return cb[row * kPanel + ((((col >> 2) ^ (row >> 1)) & 3) << 2) + (col & 3)];
}

// out_u -= a_u b_u' for two m16n8 tiles (u = 0, 1) on the tensor cores,
// 3xTF32: a_u the 16 rows from ra_u and b_u the 8 rows from rb_u of the
// column block copy cb; each k8 step into fresh fragments, added to the
// panel (row stride lda_u) in float32.  `two` false: the second tile is the
// first again and is not written (the same instructions, no branch).
__device__ __forceinline__ void trail_pair(float* out0, int lda0, int ra0,
                                           int rb0, float* out1, int lda1,
                                           int ra1, int rb1, bool two,
                                           const float* cb, int g, int tig) {
  float t[2][2][4] = {};  // [tile][k8 step]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ks = 8 * h;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ra = u ? ra1 : ra0, rb = u ? rb1 : rb0;
      const float av[4] = {-cb_at(cb, ra + g, ks + tig),
                           -cb_at(cb, ra + g + 8, ks + tig),
                           -cb_at(cb, ra + g, ks + tig + 4),
                           -cb_at(cb, ra + g + 8, ks + tig + 4)};
      unsigned ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ah[q] = rsp::to_tf32(av[q]);
        al[q] = rsp::to_tf32(av[q] - __uint_as_float(ah[q]));
      }
      const float b0 = cb_at(cb, rb + g, ks + tig);
      const float b1 = cb_at(cb, rb + g, ks + tig + 4);
      const unsigned bh0 = rsp::to_tf32(b0), bh1 = rsp::to_tf32(b1);
      rsp::mma_tf32(t[u][h], ah, rsp::to_tf32(b0 - __uint_as_float(bh0)),
                    rsp::to_tf32(b1 - __uint_as_float(bh1)));
      rsp::mma_tf32(t[u][h], al, bh0, bh1);
      rsp::mma_tf32(t[u][h], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u == 1 && !two) break;
    float* out = u ? out1 : out0;
    const int lda = u ? lda1 : lda0;
    float2* p0 = reinterpret_cast<float2*>(out + g * lda + 2 * tig);
    float2* p1 = reinterpret_cast<float2*>(out + (g + 8) * lda + 2 * tig);
    float2 v0 = *p0, v1 = *p1;
    v0.x += t[u][0][0] + t[u][1][0];
    v0.y += t[u][0][1] + t[u][1][1];
    v1.x += t[u][0][2] + t[u][1][2];
    v1.y += t[u][0][3] + t[u][1][3];
    *p0 = v0;
    *p1 = v1;
  }
}

template <class T, bool EXPLICIT, int C>
__global__ void __launch_bounds__(kWideThreads, 1)
als_chol_wide_kernel(rsp::BucketArgs a, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int rank = (int)cl.block_rank();
  const int d = a.d, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const WideLayout Ly = make_wide_layout(d, (int)sizeof(T), C);
  const int D = Ly.D, nP = Ly.nP;

  unsigned char* stage = smem;
  int* lidx = reinterpret_cast<int*>(smem + Ly.list);
  float* lgw = reinterpret_cast<float*>(lidx + kSeg);
  float* lrw = lgw + kSeg;
  int* soff = reinterpret_cast<int*>(lrw + kSeg);  // [2][kRows]
  int* cnt = soff + 2 * kRows;                      // [64] + total
  float* store = reinterpret_cast<float*>(smem + Ly.panels);
  float* diag = reinterpret_cast<float*>(smem + Ly.extra);  // [3][kDiagF]
  float* dinv = diag + 3 * kDiagF;  // [D], own panels' only
  float* acc = dinv + D;            // back substitution partial
  float* xs = acc + D;
  float* colv = xs + D;
  float* zl = colv + D;             // [kMaxOwn][16]
  float* scratch = zl + kMaxOwn * kPanel;
  float* lpart = scratch + 32;
  // panel -> float offset in its owner's panels (any CTA's), z slot, and
  // this CTA's slot -> panel
  int* goff = reinterpret_cast<int*>(lpart + 4);
  int* zslot = goff + kMaxPanels;
  int* spanel = zslot + kMaxPanels;               // slot -> panel
  auto* bsig = reinterpret_cast<unsigned long long*>(smem + Ly.signal);
  unsigned bsig_waits = 0;  // the signal's phases this CTA has waited out

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(bsig))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int off[C] = {}, slot = 0;
    for (int p = 0; p < nP; ++p) {
      const int o = panel_owner(p, nP, C);
      goff[p] = off[o];
      off[o] += kPanel * panel_lda(p);
      zslot[p] = o == rank ? slot : -1;
      if (o == rank) spanel[slot++] = p;
    }
  }
  cl.sync();  // every CTA's signal is initialised before any arrives
  int n_own = 0;  // panels this CTA holds
  for (int r = 0; r * C < nP; ++r) n_own += own_panel(r, rank, nP, C) >= 0;
  const int n_store = own_floats(rank, nP, C);

  const bool rnd = a.round_bf16 != 0;
  const ClusterRun<C> run(rank, nP, warp);
  const int n_clusters = gridDim.x / C;
#ifdef RSP_CHOL_CLOCKS
  long long clk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, clk_t = clock64();
#endif

  for (int b = blockIdx.x / C; b < a.B; b += n_clusters) {
    const float lam_use = rsp::row_lambda(a, b);
    const rsp::RowEntries<T> R = rsp::row_entries<T>(a, b);
    for (int e = tid; e < D; e += kWideThreads) acc[e] = 0.f;
    const WideGramSmem S{stage, lidx, lgw, lrw, soff, cnt,
                         store, goff, spanel, zl};
    wide_gram<T, EXPLICIT, C, 0>(a, R, lam_use, Ly, run, S, n_own, n_store);
    RSP_CLK(0);  // the Gram
    if (stages < 2) continue;

    // ---- (2) the factorisation, one cluster barrier a panel ---------------
    // Warp 0 of the owner of panel k: factor its diagonal block, solve z_k,
    // and send (L_kk, 1 / L_ii, z_k) to every CTA's slot k % 3.
    auto factor_send = [&](int k) {
      const int lda = panel_lda(k);
      float* P = store + goff[k];
      float* dg = diag + (k % 3) * kDiagF;
      factor_diag(P + kPanel * k, lda, 0, dg + kPanel * kPanel, lane);
      __syncwarp();
      const int r = lane & 15;
      const float* Lr = P + r * lda + kPanel * k;
      float zv = zl[zslot[k] * kPanel + r];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float zj =
            __shfl_sync(RSP_FULL_MASK, zv, j) * dg[kPanel * kPanel + j];
        if (r == j) zv = zj;
        if (r > j) zv -= zj * Lr[j];
      }
      if (lane < kPanel) {
        zl[zslot[k] * kPanel + r] = zv;
        dg[kPanel * kPanel + kPanel + r] = zv;
        dinv[kPanel * k + r] = dg[kPanel * kPanel + r];
#pragma unroll
        for (int j = 0; j < kPanel; j += 4)
          *reinterpret_cast<float4*>(dg + kPanel * r + j) =
              *reinterpret_cast<const float4*>(Lr + j);
      }
      __syncwarp();
      constexpr int kQ = kDiagF / 4;
      for (int e = lane; e < (C - 1) * kQ; e += 32) {
        const int cc = e / kQ, q = e - cc * kQ;
        float4* dst = reinterpret_cast<float4*>(
            cl.map_shared_rank(dg, cc < rank ? cc : cc + 1));
        dst[q] = reinterpret_cast<const float4*>(dg)[q];
      }
    };

    if (panel_owner(0, nP, C) == rank && warp == 0) factor_send(0);
    RSP_CLK(2);
    cl.sync();  // slot 0 has arrived
    RSP_CLK(3);
    for (int k = 0; k < nP; ++k) {
      const float* dg = diag + (k % 3) * kDiagF;
      // own rows below the diagonal block against L_kk, a thread a row
      for (int e = tid; e < kPanel * n_own; e += kWideThreads) {
        const int p = spanel[e >> 4];
        if (p <= k) continue;
        float* row = store + goff[p] + (e & 15) * panel_lda(p) + kPanel * k;
        float r[kPanel];
#pragma unroll
        for (int j = 0; j < kPanel; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + j);
          r[j] = v.x; r[j + 1] = v.y; r[j + 2] = v.z; r[j + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          r[j] *= dg[kPanel * kPanel + j];
#pragma unroll
          for (int q = j + 1; q < kPanel; ++q) r[q] -= r[j] * dg[kPanel * q + j];
        }
#pragma unroll
        for (int j = 0; j < kPanel; j += 4)
          *reinterpret_cast<float4*>(row + j) =
              make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
      }
      __syncthreads();
      RSP_CLK(1);  // own rows solved
      // the owner of panel k + 1: warp 0 updates its diagonal block and z
      // block with its own rows, factors the block and sends it
      const bool next_own = k + 1 < nP && panel_owner(k + 1, nP, C) == rank;
      if (next_own && warp == 0) {
        const int p = k + 1, lda = panel_lda(p);
        float* P = store + goff[p];
        // lane L: row L / 2 of the block, columns 8 (L % 2) .. + 8
        const int i = lane >> 1, j0 = 8 * (lane & 1);
        const float* Li = P + i * lda + kPanel * k;
        float li[kPanel];
#pragma unroll
        for (int q = 0; q < kPanel; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(Li + q);
          li[q] = v.x; li[q + 1] = v.y; li[q + 2] = v.z; li[q + 3] = v.w;
        }
        float sv[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* Lj = P + (j0 + jj) * lda + kPanel * k;
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < kPanel; ++q) a += li[q] * Lj[q];
          sv[jj] = a;
        }
        float zs = 0.f;
        const float* dzk = dg + kPanel * kPanel + kPanel;
        if (lane < kPanel) {
          const float* Lz = P + lane * lda + kPanel * k;
#pragma unroll
          for (int q = 0; q < kPanel; ++q) zs += Lz[q] * dzk[q];
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) P[i * lda + kPanel * p + j0 + jj] -= sv[jj];
        if (lane < kPanel) zl[zslot[p] * kPanel + lane] -= zs;
        __syncwarp();
        factor_send(p);
      }
      RSP_CLK(2);  // the next diagonal block
      cl.sync();   // column block k of every row is solved
      RSP_CLK(3);  // the barrier
      // column block k of the rows below the block, to this CTA's last
      // panel, read once from their owners (DSMEM) into the staging buffers
      // (free until the next row)
      float* cbuf = reinterpret_cast<float*>(smem);
      const int last = n_own > 0 ? spanel[n_own - 1] : -1;
      const int n_below = last > k ? kPanel * (last - k) : 0;
      for (int e = tid; e < n_below * 4; e += kWideThreads) {
        const int row = e >> 2, q = e & 3;
        const int i = k + 1 + (row >> 4), rr = row & 15;
        const float4 v = *reinterpret_cast<const float4*>(
            cl.map_shared_rank(store, panel_owner(i, nP, C)) + goff[i] +
            rr * panel_lda(i) + kPanel * k + 4 * q);
        *reinterpret_cast<float4*>(cbuf + row * kPanel +
                                   (((q ^ (row >> 1)) & 3) << 2)) = v;
      }
      __syncthreads();
      // the trailing update of the own blocks (j, i), k < i <= j, on the
      // tensor cores: two m16n8 tiles a block, dealt over the warps a panel
      // at a time, two tiles a warp at a time (the owner of panel k + 1
      // updated its block (k + 1, k + 1) above)
      for (int s = 0; s < n_own; ++s) {
        const int p = spanel[s];
        if (p <= k || (next_own && p == k + 1)) continue;
        const int lda = panel_lda(p);
        float* P = store + goff[p];
        const int ra = kPanel * (p - k - 1);  // the block row's copy
        const int nt = 2 * (p - k);
        for (int t = warp; t < nt; t += 2 * kWarpsW) {
          const int t1 = t + kWarpsW < nt ? t + kWarpsW : t;
          const int i0 = k + 1 + (t >> 1), i1 = k + 1 + (t1 >> 1);
          const int h0 = t & 1, h1 = t1 & 1;
          trail_pair(P + kPanel * i0 + 8 * h0, lda, ra,
                     kPanel * (i0 - k - 1) + 8 * h0,
                     P + kPanel * i1 + 8 * h1, lda, ra,
                     kPanel * (i1 - k - 1) + 8 * h1, t1 != t, cbuf, g, tig);
        }
      }
      // z_j -= L_jk z_k for the own blocks j > k (z_k+1 done above)
      const float* dz = dg + kPanel * kPanel + kPanel;
      if (tid < kPanel * n_own) {
        const int p = spanel[tid >> 4];
        if (p > k && !(next_own && p == k + 1)) {
          const float* Lr = store + goff[p] + (tid & 15) * panel_lda(p) +
                            kPanel * k;
          float zs = 0.f;
#pragma unroll
          for (int q = 0; q < kPanel; ++q) zs += Lr[q] * dz[q];
          zl[tid] -= zs;
        }
      }
      __syncthreads();
      RSP_CLK(4);  // the trailing update
    }

    if (stages == 4) {
      cl.sync();  // no CTA reads another's panels any more
      continue;
    }

    // ---- (3) L' x = z by blocks from the last --------------------------
    // The owner of block p waits for the owner of block p + 1's signal (so
    // every later block's part has been added, in order), takes them off
    // z_p, solves, adds its own part to its partial and signals the owner
    // of block p - 1.
    for (int p = nP - 1; p >= 0; --p) {
      if (panel_owner(p, nP, C) != rank) continue;
      if (p < nP - 1) wait_signal(bsig, bsig_waits++ & 1);
      const int lda = panel_lda(p);
      const float* P = store + goff[p];
      if (warp == 0) {
        const int r = lane & 15;
        float v = zl[zslot[p] * kPanel + r];
        for (int cc = 0; cc < C; ++cc)
          v -= cl.map_shared_rank(acc, cc)[kPanel * p + r];
        float x = 0.f;
#pragma unroll
        for (int j = kPanel - 1; j >= 0; --j) {
          const float xj =
              __shfl_sync(RSP_FULL_MASK, v, j) * dinv[kPanel * p + j];
          if (r == j) x = xj;
          if (r < j) v -= P[j * lda + kPanel * p + r] * xj;
        }
        if (lane < kPanel) {
          xs[kPanel * p + r] = x;
          if (kPanel * p + r < d) a.y[(size_t)b * d + kPanel * p + r] = x;
        }
      }
      __syncthreads();
      // this block's part of every earlier block: acc += L_p.' x_p
      for (int j = tid; j < kPanel * p; j += kWideThreads) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPanel; ++i)
          s += P[i * lda + j] * xs[kPanel * p + i];
        acc[j] += s;
      }
      __syncthreads();
      if (p > 0 && tid == 0) signal_cta(bsig, panel_owner(p - 1, nP, C));
      RSP_CLK(5);  // a block of the back substitution
    }
    cl.sync();  // every block is solved; the partials are free again
    RSP_CLK(6);
    if (stages < 3) continue;

    // ---- the loss, 1 / C of the entries a CTA ----------------------------
    for (int j = tid; j < D; j += kWideThreads) {
      const int o = panel_owner(j / kPanel, nP, C);
      if (o != rank) xs[j] = cl.map_shared_rank(xs, o)[j];
    }
    __syncthreads();
    const float part = cluster_loss<EXPLICIT, C>(
        R, a, xs, rsp::dot_operand(xs, colv, d, rnd), lam_use, scratch, rank);
    if (tid == 0) lpart[0] = part;
    cl.sync();
    if (rank == 0 && tid == 0) {
      float total = 0.f;
      for (int cc = 0; cc < C; ++cc)
        total += cl.map_shared_rank(lpart, cc)[0];
      a.loss[b] = total;
    }
    RSP_CLK(7);  // the loss
  }
  cl.sync();  // no CTA leaves while another may read its shared memory
#ifdef RSP_CHOL_CLOCKS
  if (tid == 0 && blockIdx.x < C)
    for (int i = 0; i < 8; ++i) a.loss[8 * rank + i] = (float)clk[i];
#endif
}

using WideKernel = void (*)(rsp::BucketArgs, int);

template <int C>
WideKernel pick_wide_c(const rsp::BucketArgs& a) {
  using bf16 = __nv_bfloat16;
  // [bf16 table][explicit]
  static const WideKernel kernels[2][2] = {
      {als_chol_wide_kernel<float, false, C>,
       als_chol_wide_kernel<float, true, C>},
      {als_chol_wide_kernel<bf16, false, C>,
       als_chol_wide_kernel<bf16, true, C>}};
  return kernels[a.table_bf16 != 0][a.explicit_fb != 0];
}
WideKernel pick_wide(const rsp::BucketArgs& a, int C) {
  return C == 1   ? pick_wide_c<1>(a)
         : C == 2 ? pick_wide_c<2>(a)
         : C == 4 ? pick_wide_c<4>(a)
         : C == 6 ? pick_wide_c<6>(a)
                  : pick_wide_c<8>(a);
}

int check_wide(const rsp::BucketArgs& a) {
  if (a.d <= 160 || a.d > kWideMaxD) return (int)cudaErrorInvalidValue;
  // compute_dtype="bfloat16" reads bf16 tables (ops/als.py casts them)
  if (a.round_bf16 && !a.table_bf16) return (int)cudaErrorInvalidValue;
  return 0;
}

cudaLaunchConfig_t cluster_config(int clusters, int C, int smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the kernel that run at once at `smem` bytes a CTA on the
// current device (cached by device, kernel and bytes).
cudaError_t active_clusters(WideKernel kern, int C, int smem, int* n) {
  struct Seen {
    int dev;
    WideKernel kern;
    int smem, n;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i)
      if (seen[i].dev == dev && seen[i].kern == kern && seen[i].smem == smem) {
        *n = seen[i].n;
        return cudaSuccess;
      }
  }
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, C, smem, 0, attr);
  err = cudaOccupancyMaxActiveClusters(n, kern, &cfg);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (used < 64) seen[used++] = {dev, kern, smem, *n};
  return cudaSuccess;
}

// How a bucket runs: CTAs a cluster (one row), the kernel, the layout and
// the clusters that run at once.
struct WidePlan {
  int C, n;
  WideKernel kern;
  WideLayout Ly;
};

// The bucket's plan: cluster_size's cluster, or, when the rows hold at
// least 2 D cold entries (then the Gram, whose time falls with the tiles a
// warp sums, outweighs the factorisation's chain, which more CTAs
// lengthen), the larger size of kSizes with the fewest waves of rows times
// tiles a warp (ties: the smaller).  A size the card cannot launch is
// passed over.
cudaError_t bucket_plan(const rsp::BucketArgs& a, WidePlan* w) {
  const int tb = a.table_bf16 ? 2 : 4, C0 = cluster_size(a.d, tb);
  long best = 0;
  for (const int C : kSizes) {
    if (C < C0) continue;
    const WideKernel kern = pick_wide(a, C);
    const WideLayout Ly = make_wide_layout(a.d, tb, C);
    if (C > C0 && a.L < 2 * Ly.D) break;
    if (Ly.bytes > kSmemLimit) {
      if (C == C0) return cudaErrorInvalidValue;
      continue;
    }
    int n = 0;
    const cudaError_t err = active_clusters(kern, C, Ly.bytes, &n);
    if (err != cudaSuccess) {
      if (C == C0) return err;
      (void)cudaGetLastError();
      continue;
    }
    int tiles = 0;
    for (int c = 0; c < C; ++c) {
      const int t = own_tiles(c, Ly.nP, C);
      tiles = t > tiles ? t : tiles;
    }
    const long score = n > 0 ? (long)((a.B + n - 1) / n) *
                                   ((tiles + kWarpsW - 1) / kWarpsW)
                             : -1;
    if (C == C0 || (score > 0 && score < best)) {
      *w = {C, n, kern, Ly};
      best = score;
    }
    if (best <= 0) return cudaSuccess;  // the width's size cannot run
  }
  return cudaSuccess;
}

}  // namespace

// info: [0] clusters that run at once, [1] the cold entries' Gram route,
// [2] the head's, [3] D, [4] shared bytes a CTA, [5] CTAs a cluster (one
// row), [6] floats of the largest CTA's panels.
extern "C" int rsp_als_chol_wide_info(const rsp::BucketArgs* args,
                                      int* info) {
  const rsp::BucketArgs a = *args;
  if (int e = check_wide(a)) return e;
  WidePlan w;
  if (cudaError_t err = bucket_plan(a, &w)) return (int)err;
  const bool rnd = a.round_bf16 != 0;
  int cold, head;
  if (!a.table_bf16) {
    cold = gram_route<float, false>(false, rnd);
    head = gram_route<float, false>(true, rnd);
  } else if (a.explicit_fb) {
    cold = gram_route<__nv_bfloat16, true>(false, rnd);
    head = gram_route<__nv_bfloat16, true>(true, rnd);
  } else {
    cold = gram_route<__nv_bfloat16, false>(false, rnd);
    head = gram_route<__nv_bfloat16, false>(true, rnd);
  }
  info[0] = w.n;
  info[1] = cold;
  info[2] = head;
  info[3] = w.Ly.D;
  info[4] = w.Ly.bytes;
  info[5] = w.C;
  info[6] = w.Ly.store;
  return 0;
}

// stages: 1 the Gram only, 4 the Gram and the factorisation, 2 also the
// back substitution (y), 3 everything (y, loss).
extern "C" int rsp_als_chol_wide(const rsp::BucketArgs* args, int stages,
                                 void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (int e = check_wide(a)) return e;
  WidePlan w;
  cudaError_t err = bucket_plan(a, &w);
  if (err != cudaSuccess) return (int)err;
  if (w.n <= 0) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      w.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, w.Ly.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      a.B < w.n ? a.B : w.n, w.C, w.Ly.bytes, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, w.kern, a, stages);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
