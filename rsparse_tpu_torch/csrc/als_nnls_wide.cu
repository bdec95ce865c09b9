// K4 at the wide widths (160 < d <= 514): one bucket of non-negative ALS
// solves (NNLS by sequential coordinate descent), implicit or explicit
// feedback, with an optional dense zipf head.
//
// Replaces the same TPU program as als_nnls.cu (rsparse_tpu/ops/solvers.py
// :254 batched_nnls, reached from rsparse_tpu/ops/als.py:243-245 implicit
// and :358-360 explicit) at the widths where als_nnls.cu's build (lhs and G
// in one CTA's shared memory, 2 d^2 floats: 2.1 MB at d = 514) and its
// sweeps (a system's packed G in one warp's slice of an SM: 529 KB at d =
// 514) no longer fit.  Its plain PyTorch version is
// rsparse_tpu_torch/ops/solvers.py batched_nnls behind ops/als.py
// _solve_bucket_implicit / _explicit; tests/test_torch_k4_wide.py replays
// this kernel's split in plain torch.
//
// It computes what als_nnls.cu does, row by row: lhs, rhs as K2 builds
// them; G = lhs' lhs + eps I and mu = G x0 - lhs' rhs, summed in float64
// and rounded once; coordinate sweeps x_k' = max(x_k - mu_k / G_kk, 0), mu
// += (x_k' - x_k) G[:, k], each system stopping on its own after the first
// sweep whose largest relative change is at most rel_tol, or after
// max_iter; the sweeps each system ran; the loss as K1.
//
// The wrapper's scratch holds, for a slice of systems, each system's G and
// mu (row stride ds, d rounded up to 8 floats), and after them the lhs and
// rhs of up to kLhsSub systems at a time (a sub-slice: lhs is read only by
// G and mu, so a slice of G holds twice the systems a slice of both would:
// ~870 at d = 514 in 1 GiB).  Per sub-slice three launches, per slice one
// more; then one for the loss of the whole bucket:
// (1) Build: the wide K2's walk (als_chol_wide.cuh wide_gram) sums each
//     row's lhs into 16-row panels dealt over C CTAs (C from cluster_size:
//     1 through d = 256 at float32, 2 at 258, 4 at 512 and 514), each CTA
//     its own panels, no CTA reading another's: so they run as C plain
//     CTAs of one grid, a system each C.  Each CTA writes its panels to the
//     sub-slice's lhs as rows (row stride ds) and the mirror of each
//     off-diagonal block, and its rhs rows.  The bf16-rounded
//     implicit rows (compute_dtype="bfloat16") make lhs non-symmetric, and
//     G reads all of it, as the plain version's lhs' lhs does: there the
//     walk runs twice, the lower triangle of lhs, then of lhs' (HALF 1,
//     2), the second pass writing the upper blocks.
// (2) G = lhs' lhs + eps I: 64 x 64 tiles of the lower triangle, a CTA of
//     256 threads each, 16 rows of lhs staged a step, summed in float64 on
//     mma.sync (m8n8k4: 1.8-1.9x float64 FMAs, 4 x 4 a thread, at d = 258
//     and 514), each tile's lower entries written and mirrored, so G is
//     exactly symmetric.
// (3) mu = G x0 - lhs' rhs in float64: a CTA 32 coordinates of a system,
//     a lane a coordinate (a column of G and of lhs, read row by row,
//     coalesced), its 8 warps each an eighth of the rows.
// (4) Sweeps (a launch a slice): one warp a system, a persistent grid of
//     one-warp blocks taking systems from a counter (launch (3) zeroes it),
//     at most kPerSm an SM.
//     G stays in device memory (the L2 holds ~45 at d = 514); a step reads
//     row k (= column k) whole, and the warp streams rows through a ring
//     of kRing rows in its shared memory, a chunk of kChunk rows at a time
//     by the copy engine (cp.async.bulk, one lane issuing a row an
//     instruction, the chunk completing on its mbarrier), three chunks
//     ahead, the sweeps wrapping to row 0 (a stopped system's chunks in
//     flight are drained).  (Per-lane 16-byte cp.async copies, a row or
//     eight a copy group, made each step slower.)  A step is the narrow kernel's: the shuffle of mu_k, the
//     correctly rounded quotient, the clamp and PL FMAs a lane, the next
//     row's values read from the ring during the step.
// (5) Loss: a CTA a row from the solved x, as K1 (rsp::row_loss at 17
//     values a lane).
//
// What bounds it: the sweeps, a chain of d dependent steps a sweep, and the
// G rows a sweep streams (d^2 floats: 1.06 MB a system at d = 514, whose
// in-flight systems no longer fit the L2 at more than ~45).
//
// rsp_als_nnls_wide_staged's `stages` stops after launch (1) .. (5) of each
// slice (5: everything): kernel_times.py k4-wide times them apart.

#include <math.h>

#include "als_chol_wide.cuh"

namespace {

constexpr float kNnlsEps = 1e-16f;  // NNLS_EPS of ops/solvers.py
constexpr int kChunk = 4;           // G rows a bulk-copy chunk (mbarrier)
constexpr int kRing = 16;           // G rows in a sweep warp's ring
constexpr int kLhsSub = 128;        // systems whose lhs the scratch holds
// sweeping warps an SM: one was slower at 256 systems, 3 to 6 no faster
constexpr int kPerSm = 2;
constexpr int kGT = 64;             // G's tile
constexpr int kGK = 16;             // lhs rows staged a step of G
constexpr int kLossThreads = 256;
constexpr int kMuWarps = 8;         // warps a CTA of mu (32 coordinates)


// row stride of lhs and G in the scratch: d rounded up to 8 floats (32 B)
__host__ __device__ constexpr int nnls_ds(int d) { return (d + 7) & ~7; }
// floats of one system's G (d x ds) and mu (ds), or lhs and rhs
__host__ __device__ constexpr long long nnls_stride(int d) {
  return (long long)d * nnls_ds(d) + nnls_ds(d);
}
// floats of the lhs sub-slice after a bucket's G slice
__host__ __device__ constexpr long long nnls_lhs_floats(int d, int B) {
  return (long long)(B < kLhsSub ? B : kLhsSub) * nnls_stride(d);
}

// (1) Row s0 + blockIdx.x / C's lhs panels of CTA blockIdx.x % C into the
// sub-slice's lhs (system blockIdx.x / C, `lhs`): HALF 1 writes each own panel's rows
// (lhs[i][j], j <= the diagonal block), and with `mirror` (lhs symmetric)
// their off-diagonal blocks transposed, and the rhs rows; HALF 2 (lhs'
// lower triangle) writes the off-diagonal blocks transposed, the upper
// blocks of lhs.
template <class T, bool EXPLICIT, int C, int HALF>
__global__ void __launch_bounds__(kWideThreads, 1)
nnls_wide_build_kernel(rsp::BucketArgs a, int s0, float* __restrict__ lhs,
                       int mirror) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x % C, s = blockIdx.x / C, b = s0 + s;
  const int d = a.d, tid = threadIdx.x, warp = tid >> 5;
  const int ds = nnls_ds(d);
  const WideLayout Ly = make_wide_layout(d, (int)sizeof(T), C);
  const int nP = Ly.nP;
  int* lidx = reinterpret_cast<int*>(smem + Ly.list);
  float* lgw = reinterpret_cast<float*>(lidx + kSeg);
  float* lrw = lgw + kSeg;
  int* soff = reinterpret_cast<int*>(lrw + kSeg);  // [2][kRows]
  int* cnt = soff + 2 * kRows;                      // [64] + total
  float* store = reinterpret_cast<float*>(smem + Ly.panels);
  float* zl = reinterpret_cast<float*>(smem + Ly.extra);  // [kMaxOwn][16]
  int* goff = reinterpret_cast<int*>(zl + kMaxOwn * kPanel);
  int* spanel = goff + kMaxPanels;  // slot -> panel
  if (tid == 0) {
    int off = 0, slot = 0;
    for (int p = 0; p < nP; ++p) {
      if (panel_owner(p, nP, C) != rank) continue;
      goff[p] = off;
      off += kPanel * panel_lda(p);
      spanel[slot++] = p;
    }
  }
  __syncthreads();
  int n_own = 0;
  for (int r = 0; r * C < nP; ++r) n_own += own_panel(r, rank, nP, C) >= 0;
  const ClusterRun<C> run(rank, nP, warp);
  const WideGramSmem S{smem, lidx, lgw, lrw, soff, cnt,
                       store, goff, spanel, zl};
  wide_gram<T, EXPLICIT, C, HALF>(a, rsp::row_entries<T>(a, b),
                                  rsp::row_lambda(a, b), Ly, run, S, n_own,
                                  own_floats(rank, nP, C));

  float* A = lhs + (long long)s * nnls_stride(d);
  float* rhs = A + (long long)d * ds;
  for (int sl = 0; sl < n_own; ++sl) {
    const int p = spanel[sl], w = kPanel * (p + 1), lda = panel_lda(p);
    const float* P = store + goff[p];
    const int i0 = kPanel * p;
    if (HALF == 1) {  // the panel's rows, a row's columns across threads
      for (int e = tid; e < kPanel * w; e += kWideThreads) {
        const int r = e / w, j = e - r * w, i = i0 + r;
        if (i < d && j < d) A[(long long)i * ds + j] = P[r * lda + j];
      }
    }
    if (HALF == 2 || mirror) {  // blocks left of the diagonal, transposed
      for (int e = tid; e < kPanel * i0; e += kWideThreads) {
        const int r = e & (kPanel - 1), j = e >> 4, i = i0 + r;
        if (i < d) A[(long long)j * ds + i] = P[r * lda + j];
      }
    }
  }
  if (HALF == 1 && tid < kPanel * n_own) {
    const int i = kPanel * spanel[tid >> 4] + (tid & 15);
    if (i < d) rhs[i] = zl[tid];
  }
}

// G's tile (ti, tj) of the lower 64 x 64 tiles, numbered row by row.
__device__ __forceinline__ void g_tile_of(int t, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tj = t - ti * (ti + 1) / 2;
}

// Rows k0 .. k0 + kGK - 1 of lhs, columns i0 .. and j0 .. + kGT, into
// shared memory (zero past d).
__device__ __forceinline__ void g_stage(const float* A, int d, int ds, int k0,
                                        int i0, int j0, float (*sa)[kGT + 8],
                                        float (*sb)[kGT + 8]) {
  for (int e = threadIdx.x; e < kGK * kGT; e += 256) {
    const int kk = e / kGT, c = e - kk * kGT, k = k0 + kk;
    sa[kk][c] = k < d && i0 + c < d ? A[(long long)k * ds + i0 + c] : 0.f;
    sb[kk][c] = k < d && j0 + c < d ? A[(long long)k * ds + j0 + c] : 0.f;
  }
}

// The tile's G values (rounded, eps on the diagonal, in `tile`) to G at
// (i, j) and (j, i): a diagonal tile writes its lower triangle and its
// mirror, so G is exactly symmetric whatever order the mma summed in.
__device__ __forceinline__ void g_write(float* G, int d, int ds, int i0,
                                        int j0, bool diag,
                                        float (*tile)[kGT + 1]) {
  __syncthreads();
  for (int e = threadIdx.x; e < kGT * kGT; e += 256) {
    const int r = e / kGT, c = e - r * kGT;
    if (i0 + r < d && j0 + c < d && (!diag || c <= r))
      G[(long long)(i0 + r) * ds + j0 + c] = tile[r][c];  // G[i][j]
    if (j0 + r < d && i0 + c < d && (!diag || c > r))
      G[(long long)(j0 + r) * ds + i0 + c] = tile[c][r];  // G[j][i]
  }
}

// (2) Tile blockIdx.x of G's lower 64 x 64 tiles of system blockIdx.y of
// the sub-slice (lhs at `lhs`, G at `g`): G[i][j] = sum_k lhs[k][i]
// lhs[k][j] (+ eps on the diagonal), summed in float64 on mma.sync
// (m8n8k4; warp w: tile rows 8 w + lane / 4, n-tile nt: columns 8 nt +
// 2 (lane % 4) and + 1, the accumulator fragment), k in order, rounded
// once.
__global__ void __launch_bounds__(256)
nnls_wide_g_kernel(const float* __restrict__ lhs, float* __restrict__ g,
                   int d) {
  __shared__ float sa[kGK][kGT + 8], sb[kGK][kGT + 8];
  __shared__ float tile[kGT][kGT + 1];
  const int ds = nnls_ds(d), tid = threadIdx.x;
  int ti, tj;
  g_tile_of(blockIdx.x, ti, tj);
  const int i0 = kGT * ti, j0 = kGT * tj;
  const float* A = lhs + (long long)blockIdx.y * nnls_stride(d);
  float* G = g + (long long)blockIdx.y * nnls_stride(d);
  const int w = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  double acc[kGT / 8][2];
#pragma unroll
  for (int nt = 0; nt < kGT / 8; ++nt) acc[nt][0] = acc[nt][1] = 0.0;
  for (int k0 = 0; k0 < d; k0 += kGK) {
    g_stage(A, d, ds, k0, i0, j0, sa, sb);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 4) {
      const double a = sa[kk + tq][8 * w + gq];
#pragma unroll
      for (int nt = 0; nt < kGT / 8; ++nt) {
        const double b = sb[kk + tq][8 * nt + gq];
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, "
            "{%2}, {%3}, {%0, %1};\n"
            : "+d"(acc[nt][0]), "+d"(acc[nt][1])
            : "d"(a), "d"(b));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < kGT / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * w + gq, c = 8 * nt + 2 * tq + h;
      tile[r][c] = (float)acc[nt][h] + (i0 + r == j0 + c ? kNnlsEps : 0.f);
    }
  g_write(G, d, ds, i0, j0, ti == tj, tile);
}

// (3) mu of system blockIdx.y of the sub-slice (bucket row s0 +
// blockIdx.y), coordinates t = 32 blockIdx.x + lane: mu[t] = sum_i G[i][t]
// x0[i] - sum_i lhs[i][t] rhs[i] (G is symmetric: G[i][t] = G[t][i]), the
// i of warp w those = w mod kMuWarps, each warp's partial summed in
// float64, the warps' partials added in order, rounded once; block (0, 0)
// zeroes the sweeps' counter.
__global__ void __launch_bounds__(32 * kMuWarps)
nnls_wide_mu_kernel(const float* __restrict__ lhs, float* __restrict__ g,
                    int s0, int d, const float* __restrict__ x0,
                    int* __restrict__ counter) {
  __shared__ float xs[kWideMaxD], rs[kWideMaxD];
  __shared__ double part[kMuWarps][32];
  const int ds = nnls_ds(d), b = s0 + blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = 32 * blockIdx.x + lane;
  const float* A = lhs + (long long)blockIdx.y * nnls_stride(d);
  const float* rhs = A + (long long)d * ds;
  const float* G = g + (long long)blockIdx.y * nnls_stride(d);
  float* mu = g + (long long)blockIdx.y * nnls_stride(d) + (long long)d * ds;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *counter = 0;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    xs[i] = x0 != nullptr ? x0[(long long)b * d + i] : 0.f;
    rs[i] = rhs[i];
  }
  __syncthreads();
  double gx = 0.0, ar = 0.0;
  if (t < d) {
#pragma unroll 4
    for (int i = w; i < d; i += kMuWarps) {
      gx = fma((double)G[(long long)i * ds + t], (double)xs[i], gx);
      ar = fma((double)A[(long long)i * ds + t], (double)rs[i], ar);
    }
  }
  part[w][lane] = gx - ar;
  __syncthreads();
  if (w == 0 && t < d) {
    double s = 0.0;
#pragma unroll
    for (int v = 0; v < kMuWarps; ++v) s += part[v][lane];
    mu[t] = (float)s;
  }
}

// ---- the sweeps' row stream: bulk copies on an mbarrier a chunk ---------

__device__ __forceinline__ unsigned su32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(su32(b))
               : "memory");
}
__device__ __forceinline__ void bar_expect(unsigned long long* b,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(su32(b)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of parity `parity` of b to complete.
__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         unsigned parity) {
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(su32(b)), "r"(parity)
        : "memory");
    if (done) return;
  }
}
// `bytes` (a multiple of 16) from global src to shared dst by the copy
// engine, completing on b's transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(su32(dst)),
      "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes),
      "r"(su32(b))
      : "memory");
}

// (4) The sweeps of systems 0 .. n_sys - 1 of the slice (bucket rows s0 +
// s, G and mu at g + s * nnls_stride(d)), one warp each, taken from
// *counter; writes y and the sweeps each ran.  Lane l holds coordinates
// l + 32 m (m < PL).  Shared memory: kChunks mbarriers (128 bytes), then
// the ring.  The warp's stream of chunks runs on over its systems: chunk
// c lands in ring rows kChunk (c % kChunks) on, its mbarrier's phase c /
// kChunks.
template <int PL>
__global__ void __launch_bounds__(32)
nnls_wide_sweep_kernel(const float* __restrict__ g, int s0, int n_sys, int d,
                       const float* __restrict__ x0, float* __restrict__ y,
                       int max_iter, float rel_tol, int* __restrict__ sweeps,
                       int* __restrict__ counter) {
  extern __shared__ __align__(128) unsigned char sweep_smem[];
  constexpr int kChunks = kRing / kChunk;
  auto* bars = reinterpret_cast<unsigned long long*>(sweep_smem);
  float* ring = reinterpret_cast<float*>(sweep_smem + 128);
  const int lane = threadIdx.x, ds = nnls_ds(d);
  const unsigned row_bytes = 4u * (unsigned)ds;
  if (lane == 0) {
    for (int c = 0; c < kChunks; ++c) bar_init(&bars[c]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // this lane's offset of coordinate lane + 32 m in a row (0 past d: such
  // a lane reads G[k][0], and its x and mu are never read)
  int off[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) off[m] = lane + 32 * m < d ? lane + 32 * m : 0;
  unsigned ic = 0, iw = 0;  // chunks fetched, chunks waited for

  for (;;) {
    int s = 0;
    if (lane == 0) s = atomicAdd(counter, 1);
    s = __shfl_sync(RSP_FULL_MASK, s, 0);
    if (s >= n_sys) break;
    const int b = s0 + s;
    const float* G = g + (long long)s * nnls_stride(d);
    const float* mu0 = G + (long long)d * ds;
    // the system's stream: position p (row p % d) in ring row (base + p) %
    // kRing; the next chunk's first row
    const unsigned base = ic * kChunk;
    int irow = 0;
    auto fetch = [&]() {
      if (lane == 0) {
        unsigned long long* bar = &bars[ic % kChunks];
        float* dst = ring + (ic % kChunks) * kChunk * ds;
        bar_expect(bar, kChunk * row_bytes);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int r = irow + u < d ? irow + u : irow + u - d;
          bulk_copy(dst + u * ds, G + (long long)r * ds, row_bytes, bar);
        }
      }
      ++ic;
      irow = irow + kChunk < d ? irow + kChunk : irow + kChunk - d;
    };
    auto wait_next = [&]() {
      bar_wait(&bars[iw % kChunks], (iw / kChunks) & 1u);
      ++iw;
    };
#pragma unroll 1
    for (int u = 0; u < kChunks - 1; ++u) fetch();
    float xr[PL], mr[PL], gd[PL], rd[PL];
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int k = lane + 32 * m;
      xr[m] = k < d && x0 != nullptr ? x0[(long long)b * d + k] : 0.f;
      mr[m] = k < d ? mu0[k] : 0.f;
      gd[m] = k < d ? G[(long long)k * ds + k] : 1.f;
      rd[m] = __frcp_rn(gd[m]);
    }
    wait_next();  // the first chunk is in
    float gc[PL];  // G[k][lane + 32 m] of the current step's row k
    {
      const float* row0 = ring + (base & (kRing - 1)) * ds;
#pragma unroll
      for (int mm = 0; mm < PL; ++mm) gc[mm] = row0[off[mm]];
    }
    unsigned q = base;  // the current step's position in the warp's stream

    int t = 0;
    bool go = true;
    while (t < max_iter && go) {
      float xs[PL];  // x at the sweep's start
#pragma unroll
      for (int m = 0; m < PL; ++m) xs[m] = xr[m];
#pragma unroll
      for (int m = 0; m < PL; ++m) {
        const int jn = min(32, d - 32 * m);
#pragma unroll 2
        for (int j = 0; j < jn; ++j) {
          if ((q & (kChunk - 1)) == 0) {
            // chunk c = q / kChunk starts: chunk c + kChunks - 1 into the
            // ring rows chunk c - 1 left (every lane has read them), then
            // chunk c + 1 (the last step of chunk c reads its first row)
            __syncwarp();
            fetch();
            wait_next();
          }
          const float* nrow = ring + ((q + 1) & (kRing - 1)) * ds;
          float gn[PL];
#pragma unroll
          for (int mm = 0; mm < PL; ++mm) gn[mm] = nrow[off[mm]];
          const float old = __shfl_sync(RSP_FULL_MASK, xr[m], j);
          const float gk = __shfl_sync(RSP_FULL_MASK, gd[m], j);
          const float r = __shfl_sync(RSP_FULL_MASK, rd[m], j);
          const float mk = __shfl_sync(RSP_FULL_MASK, mr[m], j);
          // mk / gk correctly rounded, as the plain version divides
          const float q0 = mk * r;
          const float qt = fmaf(fmaf(-gk, q0, mk), r, q0);
          const float nw = fmaxf(old - qt, 0.f);
          const float diff = nw - old;
#pragma unroll
          for (int mm = 0; mm < PL; ++mm) mr[mm] += diff * gc[mm];
          if (lane == j) xr[m] = nw;
#pragma unroll
          for (int mm = 0; mm < PL; ++mm) gc[mm] = gn[mm];
          ++q;
        }
      }
      // the stop test of the sweep, as the plain version takes it
      bool moved = false;
#pragma unroll
      for (int m = 0; m < PL; ++m)
        moved |= lane + 32 * m < d &&
                 fabsf(xr[m] - xs[m]) / (fabsf(xs[m]) + kNnlsEps) > rel_tol;
      go = __any_sync(RSP_FULL_MASK, moved);
      ++t;
    }
    while (iw < ic) wait_next();  // the chunks still in flight land
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int k = lane + 32 * m;
      if (k < d) y[(long long)b * d + k] = xr[m];
    }
    if (lane == 0 && sweeps != nullptr) sweeps[b] = t;
    __syncwarp();  // every lane is done with the ring before the next copy
  }
}

// (5) The loss of row blockIdx.x from its solution y.
template <class T, bool EXPLICIT>
__global__ void __launch_bounds__(kLossThreads)
nnls_wide_loss_kernel(rsp::BucketArgs a) {
  extern __shared__ float lsm[];
  const int d = a.d, b = blockIdx.x;
  float* x = lsm;             // d
  float* buf = x + d;         // d
  float* scratch = buf + d;   // 32
  for (int t = threadIdx.x; t < d; t += kLossThreads)
    x[t] = a.y[(long long)b * d + t];
  __syncthreads();
  const float total = rsp::row_loss<kLossPer, EXPLICIT>(
      rsp::row_entries<T>(a, b), a, x,
      rsp::dot_operand(x, buf, d, a.round_bf16 != 0), rsp::row_lambda(a, b),
      scratch);
  if (threadIdx.x == 0) a.loss[b] = total;
}

using Build = void (*)(rsp::BucketArgs, int, float*, int);
using Sweep = void (*)(const float*, int, int, int, const float*, float*, int,
                       float, int*, int*);
using Loss = void (*)(rsp::BucketArgs);

template <class T, bool EX, int HALF>
Build pick_build_t(int C) {
  return C == 1   ? nnls_wide_build_kernel<T, EX, 1, HALF>
         : C == 2 ? nnls_wide_build_kernel<T, EX, 2, HALF>
                  : nnls_wide_build_kernel<T, EX, 4, HALF>;
}

// The build's kernel: [bf16 table][explicit], HALF 1, or HALF 2 (the
// second pass of the bf16-rounded implicit rows).
Build pick_build(const rsp::BucketArgs& a, int C, int half) {
  using bf16 = __nv_bfloat16;
  if (half == 2) return pick_build_t<bf16, false, 2>(C);
  if (a.table_bf16)
    return a.explicit_fb ? pick_build_t<bf16, true, 1>(C)
                         : pick_build_t<bf16, false, 1>(C);
  return a.explicit_fb ? pick_build_t<float, true, 1>(C)
                       : pick_build_t<float, false, 1>(C);
}

Sweep sweep_kernel(int d) {
  return d <= 192   ? nnls_wide_sweep_kernel<6>
         : d <= 288 ? nnls_wide_sweep_kernel<9>
         : d <= 416 ? nnls_wide_sweep_kernel<13>
                    : nnls_wide_sweep_kernel<17>;
}

int check_wide(const rsp::BucketArgs& a) {
  if (a.d <= 160 || a.d > kWideMaxD) return (int)cudaErrorInvalidValue;
  // compute_dtype="bfloat16" reads bf16 tables (ops/als.py casts them)
  if (a.round_bf16 && !a.table_bf16) return (int)cudaErrorInvalidValue;
  return 0;
}

// Sweeping warps an SM at width d: kPerSm, at most what shared memory
// allows; sets the sweep kernel's attributes.  Minus a CUDA error.
int sweep_per_sm(int d, size_t* smem_out) {
  const Sweep kern = sweep_kernel(d);
  const size_t smem = 128 + sizeof(float) * (size_t)kRing * nnls_ds(d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 32, smem);
  if (smem_out != nullptr) *smem_out = smem;
  if (err != cudaSuccess) return -(int)err;
  return n < kPerSm ? n : kPerSm;
}

}  // namespace

// Floats of scratch one system of a slice takes (G, mu).
extern "C" long long rsp_als_nnls_wide_stride(int d) {
  if (d <= 160 || d > kWideMaxD) return -(long long)cudaErrorInvalidValue;
  return nnls_stride(d);
}

// Floats of scratch after a bucket of B systems' slice of G (the lhs and
// rhs of a sub-slice).
extern "C" long long rsp_als_nnls_wide_extra(int d, int B) {
  if (d <= 160 || d > kWideMaxD) return -(long long)cudaErrorInvalidValue;
  return nnls_lhs_floats(d, B);
}

// Systems sweeping at once on one SM at width d, or minus a CUDA error.
extern "C" int rsp_als_nnls_wide_inflight(int d) {
  if (d <= 160 || d > kWideMaxD) return -(int)cudaErrorInvalidValue;
  return sweep_per_sm(d, nullptr);
}

// info: [0] CTAs a system in the build, [1] its shared bytes a CTA, [2]
// build passes (2: the bf16-rounded implicit rows), [3] G's tiles a
// system, [4] the row stride ds, [5] sweeping warps an SM, [6] the ring's
// shared bytes, [7] systems a sub-slice of lhs holds at most.
extern "C" int rsp_als_nnls_wide_info(const rsp::BucketArgs* args,
                                      int* info) {
  const rsp::BucketArgs a = *args;
  if (int e = check_wide(a)) return e;
  const int tb = a.table_bf16 ? 2 : 4, C = cluster_size(a.d, tb);
  const int nt = (a.d + kGT - 1) / kGT;
  size_t ring = 0;
  const int per_sm = sweep_per_sm(a.d, &ring);
  if (per_sm < 0) return -per_sm;
  info[0] = C;
  info[1] = make_wide_layout(a.d, tb, C).bytes;
  info[2] = a.round_bf16 && !a.explicit_fb ? 2 : 1;
  info[3] = nt * (nt + 1) / 2;
  info[4] = nnls_ds(a.d);
  info[5] = per_sm;
  info[6] = (int)ring;
  info[7] = kLhsSub;
  return 0;
}

// As rsp_als_nnls (als_nnls.cu) at 160 < d <= 514, its scratch `slice`
// systems' G and mu (rsp_als_nnls_wide_stride each), then
// rsp_als_nnls_wide_extra(d, B) floats; `stages` stops each slice after
// launch 1 (the build), 2 (G), 3 (mu) or 4 (the sweeps); 5 runs
// everything, the loss last.
extern "C" int rsp_als_nnls_wide_staged(const rsp::BucketArgs* args,
                                        int max_iter, float rel_tol,
                                        int* sweeps, float* scratch,
                                        int slice, int* counter, int stages,
                                        void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (int e = check_wide(a)) return e;
  if (slice <= 0) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const int d = a.d, tb = a.table_bf16 ? 2 : 4, C = cluster_size(d, tb);
  const WideLayout Ly = make_wide_layout(d, tb, C);
  if (Ly.bytes > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  const bool two_pass = a.round_bf16 && !a.explicit_fb;
  const Build build = pick_build(a, C, 1);
  const Build build2 = two_pass ? pick_build(a, C, 2) : nullptr;
  cudaError_t err = cudaFuncSetAttribute(
      build, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly.bytes);
  if (err == cudaSuccess && build2 != nullptr)
    err = cudaFuncSetAttribute(
        build2, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly.bytes);
  if (err != cudaSuccess) return (int)err;
  size_t ring = 0;
  const int per_sm = sweep_per_sm(d, &ring);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const Sweep sweep = sweep_kernel(d);
  const cudaStream_t st = (cudaStream_t)stream;
  const long long stride = nnls_stride(d);
  const int nt = (d + kGT - 1) / kGT;
  const int sub = slice < kLhsSub ? slice : kLhsSub;
  float* lhs = scratch + (long long)slice * stride;

  for (int s0 = 0; s0 < a.B; s0 += slice) {
    const int n = a.B - s0 < slice ? a.B - s0 : slice;
    for (int u0 = 0; u0 < n; u0 += sub) {
      const int m = n - u0 < sub ? n - u0 : sub;
      float* g = scratch + (long long)u0 * stride;
      build<<<m * C, kWideThreads, Ly.bytes, st>>>(a, s0 + u0, lhs,
                                                   two_pass ? 0 : 1);
      if (build2 != nullptr)
        build2<<<m * C, kWideThreads, Ly.bytes, st>>>(a, s0 + u0, lhs, 0);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      if (stages < 2) continue;
      nnls_wide_g_kernel<<<dim3(nt * (nt + 1) / 2, m), 256, 0, st>>>(lhs, g,
                                                                      d);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      if (stages < 3) continue;
      nnls_wide_mu_kernel<<<dim3((d + 31) / 32, m), 32 * kMuWarps, 0, st>>>(
          lhs, g, s0 + u0, d, a.x0, counter);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (stages < 4) continue;
    const int grid = n < per_sm * n_sm ? n : per_sm * n_sm;
    sweep<<<grid, 32, ring, st>>>(scratch, s0, n, d, a.x0, a.y, max_iter,
                                  rel_tol, sweeps, counter);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages < 5) return 0;
  static const Loss losses[2][2] = {
      {nnls_wide_loss_kernel<float, false>, nnls_wide_loss_kernel<float, true>},
      {nnls_wide_loss_kernel<bf16, false>, nnls_wide_loss_kernel<bf16, true>}};
  const Loss loss = losses[a.table_bf16 != 0][a.explicit_fb != 0];
  loss<<<a.B, kLossThreads, sizeof(float) * (2 * (size_t)d + 32), st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int rsp_als_nnls_wide(const rsp::BucketArgs* args, int max_iter,
                                 float rel_tol, int* sweeps, float* scratch,
                                 int slice, int* counter, void* stream) {
  return rsp_als_nnls_wide_staged(args, max_iter, rel_tol, sweeps, scratch,
                                  slice, counter, 5, stream);
}
