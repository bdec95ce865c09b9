// K2 at the wide widths (160 < d <= 514): one bucket of exact ALS solves by
// Cholesky, implicit or explicit feedback, with an optional dense zipf head,
// the factor held in a global workspace.
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
// The design: of the two that serve (the factor's row blocks over a
// cluster's distributed shared memory, or a workspace in global memory),
// this one takes the workspace: it keeps als_chol.cu's Gram and
// factorisation code as it is, and one layout serves every width to 514,
// where a cluster of 227 KB CTAs would need 5 of them and a trailing update
// that reads panels across the cluster.  A persistent grid of `slots` CTAs
// (one an SM) takes the bucket's rows in turn, b = blockIdx.x, + gridDim.x,
// ..., each CTA with its own slot of (D + 1) x (D + 4) floats in a
// workspace the wrapper allocates: 1.13 MB a slot at d = 514, ~150 MB for
// the card's 132 slots whatever the bucket's size.
// (1) The Gram exactly as in als_chol.cu: the same entry lists (cold
//     entries, then the head's present cells compacted by ballots), the
//     same cp.async staging of 16 rows a chunk, the same operand routes
//     (3xTF32 on float32 tables, 2xTF32 on bf16 ones, bf16 mma where both
//     operands are exact, summed both ways for the bf16-rounded implicit
//     cold rows) and fresh fragments a chunk added in float32.  The lower
//     m16n8 tiles no longer fit a warp's registers at once (1,122 at D =
//     528), so they are taken in rounds of kRoundT tiles a warp (128 a
//     round): each round walks the row's entries again and writes its tiles,
//     with XtX or the ridge (the symmetrised halving under
//     compute_dtype="bfloat16"), into the slot.  The rhs is summed in the
//     first round, three values a thread.
// (2) The factorisation right-looking in panels of 16 columns on the slot,
//     with als_chol.cu's pieces: warp 0 factors the diagonal block (the
//     reference's pivot guard), the rows below (the rhs row last, so z =
//     L^-1 rhs comes out of it) are solved against it, a thread a row, and
//     the rank-16 trailing update runs in 4 x 4 register tiles, reading and
//     writing the slot through L1 and L2.
// (3) The back substitution L' x = z in one warp, the running values in
//     shared memory; then the loss as in K1.
//
// What bounds it on the H100: per row the Gram is (n + Hp) d^2 products on
// the tensor cores, the factorisation d^3 / 3 FMAs (67 TFLOP/s f32).  This
// first wide version is bound by neither: every panel reads and writes
// the trailing matrix in the slot (about D^3 / 24 floats a row, ~0.2 GB
// at D = 528, mostly in L2: 132 slots of 1.13 MB are ~3 times the L2), and
// each of the D back-substitution steps waits on a row of L from L2.

#include "als_chol.cuh"

namespace {

constexpr int kWideMaxD = 514;  // ops/als.py CHOL_MAX_D
constexpr int kRoundT = 16;     // lower m16n8 tiles a warp sums a round
constexpr int kWarpsW = kThreads / 32;
constexpr int kRhsPer = (kWideMaxD + kThreads - 1) / kThreads;  // 3
constexpr int kLossPer = (kWideMaxD + 31) / 32;  // 17 values a lane

// A warp's share of one round: tiles [first, first + count) of the lower
// m16n8 tiles in row-major order (tile (m, n), n <= 2m + 1).
struct RoundRun {
  static constexpr int kMaxT = kRoundT;
  int count, m0, n0;
  __device__ __forceinline__ RoundRun(int first, int nT) {
    count = max(0, min(kRoundT, nT - first));
    int m = 0;
    while ((m + 1) * (m + 2) <= first) ++m;
    m0 = m;
    n0 = first - m * (m + 1);
  }
};

// Shared-memory layout of one CTA and the floats of a workspace slot,
// alike on the host and the card.
struct WideLayout {
  int D;         // d padded to a multiple of 16
  int lda;       // row stride of the factor in the slot (floats)
  int rs;        // bytes of one staged row's slot
  int granules;  // 16-byte granules a row's window can span
  int list;      // byte offset of the entry list (after the two buffers)
  int totals;    // byte offset of the warps' Gram sums
  int extra;     // byte offset of dinv, x, the running values, scratch
  int bytes;     // total shared bytes
  long long slot;  // floats of a workspace slot: (D + 1) x lda
};

__host__ __device__ inline WideLayout make_wide_layout(int d, int tbytes) {
  WideLayout L;
  L.D = (d + kPanel - 1) / kPanel * kPanel;
  L.lda = L.D + 4;
  L.granules = (d * tbytes + 30) / 16;
  int w = 4 * L.granules;
  w += ((8 - w) % 32 + 32) % 32;
  L.rs = 4 * w;
  L.list = 2 * kRows * L.rs;
  L.totals = L.list + kSeg * 12 + ((2 * kRows * 4 + 65 * 4 + 15) & ~15);
  L.extra = L.totals + kWarpsW * kRoundT * 4 * 32 * 4;
  L.bytes = L.extra + (3 * L.D + 32) * 4;
  L.slot = (long long)(L.D + 1) * L.lda;
  return L;
}

template <class T, bool EXPLICIT>
__global__ void __launch_bounds__(kThreads, 1)
als_chol_wide_kernel(rsp::BucketArgs a, int stages, float* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const WideLayout Ly = make_wide_layout(d, (int)sizeof(T));
  const int D = Ly.D, lda = Ly.lda, rs = Ly.rs;

  unsigned char* stage = smem;
  int* lidx = reinterpret_cast<int*>(smem + Ly.list);
  float* lgw = reinterpret_cast<float*>(lidx + kSeg);
  float* lrw = lgw + kSeg;
  int* soff = reinterpret_cast<int*>(lrw + kSeg);  // [2][kRows]
  int* cnt = soff + 2 * kRows;                      // [64] + total
  // the warp's Gram sums of a round: [tile][component][lane]
  float* tot = reinterpret_cast<float*>(smem + Ly.totals) +
               warp * kRoundT * 128 + lane;
  float* dinv = reinterpret_cast<float*>(smem + Ly.extra);
  float* xs = dinv + D;
  float* colv = xs + D;
  float* scratch = colv + D;
  // this CTA's slot: the factor (D rows) and the rhs row D
  float* Lm = ws + (size_t)blockIdx.x * Ly.slot;

  const bool rnd = a.round_bf16 != 0;
  const int nM = D / 16, nT = nM * (nM + 1);
  const int rounds = (nT + kWarpsW * kRoundT - 1) / (kWarpsW * kRoundT);
  const bool doubled = rnd && !EXPLICIT && is_bf16<T>();
  const float scale = doubled ? 0.5f : 1.f;

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float lam_use = rsp::row_lambda(a, b);
    const rsp::RowEntries<T> R = rsp::row_entries<T>(a, b);
    const int nnz = R.nnz;
    float rhs_acc[kRhsPer];
#pragma unroll
    for (int q = 0; q < kRhsPer; ++q) rhs_acc[q] = 0.f;

    // ---- (1) the Gram, a round of tiles at a time -------------------------
    for (int round = 0; round < rounds; ++round) {
      const RoundRun run(round * kWarpsW * kRoundT + warp * kRoundT, nT);
      const bool first = round == 0;
      float c[kRoundT][4];
#pragma unroll
      for (int t = 0; t < kRoundT; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[t][q] = 0.f;
      for (int e = 0; e < run.count * 4; ++e) tot[32 * e] = 0.f;

      const int n_cold = (nnz + kSeg - 1) / kSeg;
      const int n_head = R.w != nullptr ? (a.H + kSeg - 1) / kSeg : 0;
      const float head_scale = (rnd && !EXPLICIT) ? 2.f : 1.f;
      for (int sg = 0; sg < n_cold + n_head; ++sg) {
        const bool head = sg >= n_cold;
        int n_list;
        if (!head) {
          const int c0 = sg * kSeg;
          n_list = min(kSeg, nnz - c0);
          const int n_pad = (n_list + kRows - 1) / kRows * kRows;
          for (int e = tid; e < n_pad; e += kThreads) {
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
          unsigned bal[kSeg / kThreads];
          float wv[kSeg / kThreads];
#pragma unroll
          for (int q = 0; q < kSeg / kThreads; ++q) {
            const int h = h0 + q * kThreads + tid;
            wv[q] = h < a.H ? rsp::head_value(R, h) : 0.f;
            bal[q] = __ballot_sync(
                RSP_FULL_MASK, h < a.H && rsp::head_present(R.bits, wv[q], h));
            if (lane == 0) cnt[q * 8 + warp] = __popc(bal[q]);
          }
          __syncthreads();
          constexpr int kCnt = kSeg / kThreads * 8;  // counts, a multiple of 32
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
          for (int q = 0; q < kSeg / kThreads; ++q) {
            if ((bal[q] >> lane) & 1u) {
              const int pos = cnt[q * 8 + warp] + __popc(bal[q] & lt);
              const float w = wv[q];
              lidx[pos] = h0 + q * kThreads + tid;
              lgw[pos] = head_scale * rsp::head_lhs_weight<EXPLICIT>(w, rnd);
              lrw[pos] = rnd ? rsp::rhs_weight_bf16<EXPLICIT>(w, 0.f, a.g_rhs,
                                                              true)
                             : rsp::rhs_weight<EXPLICIT>(w, 0.f, a.g_rhs);
            }
          }
          if (tid < kRows &&
              n_list + tid < (n_list + kRows - 1) / kRows * kRows) {
            lidx[n_list + tid] = 0;
            lgw[n_list + tid] = 0.f;
            lrw[n_list + tid] = 0.f;
          }
          __syncthreads();
        }
        if (n_list == 0) continue;

        const T* src = head ? R.hot_table : R.table;
        const int row_bytes = d * (int)sizeof(T);
        auto issue = [&](int ch) {
          unsigned char* buf = stage + (ch & 1) * kRows * rs;
          for (int e = tid; e < kRows * Ly.granules; e += kThreads) {
            const int l = e / Ly.granules, q = e - l * Ly.granules;
            const int k = ch * kRows + l;
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
        const int n_chunks = (n_list + kRows - 1) / kRows;
        issue(0);
        rsp::cp_async_commit();
        for (int ch = 0; ch < n_chunks; ++ch) {
          if (ch + 1 < n_chunks) {
            issue(ch + 1);
            rsp::cp_async_commit();
            rsp::cp_async_wait<1>();
          } else {
            rsp::cp_async_wait<0>();
          }
          __syncthreads();
          const unsigned char* buf = stage + (ch & 1) * kRows * rs;
          const int* off = soff + (ch & 1) * kRows;
          const float* gw = lgw + ch * kRows;
          const float* rw = lrw + ch * kRows;
          if (first) {
#pragma unroll
            for (int q = 0; q < kRhsPer; ++q) {
              const int j = tid + kThreads * q;
              if (j < d) {
#pragma unroll 8
                for (int l = 0; l < kRows; ++l)
                  rhs_acc[q] += rw[l] * sld<T>(buf + l * rs + off[l], j);
              }
            }
          }
          if constexpr (!is_bf16<T>()) {
#pragma unroll
            for (int ks = 0; ks < kRows / 8; ++ks) {
              const int lA = 8 * ks + tig, lB = lA + 4;
              tf32_step<RoundRun, T, true>(c, run, buf + lA * rs + off[lA],
                                           buf + lB * rs + off[lB], gw[lA],
                                           gw[lB], d, g);
            }
          } else {
            if (route == kRouteTf32x2) {
#pragma unroll
              for (int ks = 0; ks < kRows / 8; ++ks) {
                const int lA = 8 * ks + tig, lB = lA + 4;
                tf32_step<RoundRun, T, false>(c, run, buf + lA * rs + off[lA],
                                              buf + lB * rs + off[lB], gw[lA],
                                              gw[lB], d, g);
              }
            } else {
#pragma unroll
              for (int ks = 0; ks < kRows / 16; ++ks) {
                const int r0 = 16 * ks + 2 * tig;
                const int rr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
                const unsigned char* const p[4] = {
                    buf + rr[0] * rs + off[rr[0]],
                    buf + rr[1] * rs + off[rr[1]],
                    buf + rr[2] * rs + off[rr[2]],
                    buf + rr[3] * rs + off[rr[3]]};
                const float w[4] = {gw[rr[0]], gw[rr[1]], gw[rr[2]],
                                    gw[rr[3]]};
                if (!EXPLICIT && route == kRouteBf16Sym)
                  bf16_step<RoundRun, T, true>(c, run, p, w, d, g);
                else
                  bf16_step<RoundRun, T, false>(c, run, p, w, d, g);
              }
            }
          }
#pragma unroll
          for (int t = 0; t < kRoundT; ++t) {
            if (t < run.count) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                tot[32 * (4 * t + q)] += c[t][q];
                c[t][q] = 0.f;
              }
            }
          }
          __syncthreads();
        }
      }

      // the round's lower tiles into the slot: XtX or the ridge (identity
      // on the padding) plus the sums
      const float diag =
          EXPLICIT ? lam_use + ((nnz == 0 && lam_use == 0.f) ? 1.f : 0.f)
                   : 0.f;
      int m = run.m0, n = run.n0;
#pragma unroll
      for (int t = 0; t < kRoundT; ++t) {
        if (t < run.count) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 16 * m + g + 8 * (q >> 1),
                      j = 8 * n + 2 * tig + (q & 1);
            float base;
            if (i >= d || j >= d) {
              base = i == j ? 1.f : 0.f;
            } else if (EXPLICIT) {
              base = i == j ? diag : 0.f;
            } else {
              base = doubled ? 0.5f * (__ldg(a.XtX + i * d + j) +
                                       __ldg(a.XtX + j * d + i))
                             : __ldg(a.XtX + i * d + j);
            }
            Lm[(size_t)i * lda + j] = base + scale * tot[32 * (4 * t + q)];
          }
          if (++n > 2 * m + 1) {
            n = 0;
            ++m;
          }
        }
      }
      __syncthreads();  // the round's sums and list are free again
    }
#pragma unroll
    for (int q = 0; q < kRhsPer; ++q) {
      const int j = tid + kThreads * q;
      if (j < D)
        Lm[(size_t)D * lda + j] =
            j < d ? rhs_acc[q] + (a.rhs_init != nullptr ? a.rhs_init[j] : 0.f)
                  : 0.f;
    }
    __syncthreads();
    if (stages < 2) continue;

    // ---- (2) blocked right-looking Cholesky; row D carries z = L^-1 rhs ---
    for (int s = 0;; s += kPanel) {
      if (warp == 0) factor_diag(Lm, lda, s, dinv, lane);
      __syncthreads();
      const int below = D - s - kPanel;  // rows below the block, then the rhs
      for (int i = tid; i <= below; i += kThreads) {
        float* row = Lm + (size_t)(s + kPanel + i) * lda + s;
        float r[kPanel];
#pragma unroll
        for (int k = 0; k < kPanel; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + k);
          r[k] = v.x; r[k + 1] = v.y; r[k + 2] = v.z; r[k + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          r[j] *= dinv[s + j];
#pragma unroll
          for (int k = j + 1; k < kPanel; ++k)
            r[k] -= r[j] * Lm[(size_t)(s + k) * lda + s + j];
        }
#pragma unroll
        for (int k = 0; k < kPanel; k += 4)
          *reinterpret_cast<float4*>(row + k) =
              make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]);
      }
      __syncthreads();
      if (below == 0) break;
      const int nb = below / 4;
      for (int t = tid; t < nb * (nb + 1) / 2 + nb; t += kThreads)
        update_tile(Lm, lda, s, nb, t);
      __syncthreads();
    }

    // ---- (3) L' x = z in one warp, the running values in colv -------------
    if (warp == 0) {
      for (int j = lane; j < D; j += 32) colv[j] = Lm[(size_t)D * lda + j];
      __syncwarp();
      for (int i = D - 1; i >= 0; --i) {
        const float xi = colv[i] * dinv[i];
        if (lane == 0) xs[i] = xi;
        const float* Li = Lm + (size_t)i * lda;
        for (int j = lane; j < i; j += 32) colv[j] -= Li[j] * xi;
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- output and loss ---------------------------------------------------
    for (int t = tid; t < d; t += kThreads) a.y[(size_t)b * d + t] = xs[t];
    if (stages >= 3) {
      const float total = rsp::row_loss<kLossPer, EXPLICIT>(
          R, a, xs, rsp::dot_operand(xs, colv, d, rnd), lam_use, scratch);
      if (tid == 0) a.loss[b] = total;
    }
    __syncthreads();  // the next row reuses the slot and the buffers
  }
}

using WideKernel = void (*)(rsp::BucketArgs, int, float*);

WideKernel pick_wide(const rsp::BucketArgs& a) {
  using bf16 = __nv_bfloat16;
  // [bf16 table][explicit]
  static const WideKernel kernels[2][2] = {
      {als_chol_wide_kernel<float, false>, als_chol_wide_kernel<float, true>},
      {als_chol_wide_kernel<bf16, false>, als_chol_wide_kernel<bf16, true>}};
  return kernels[a.table_bf16 != 0][a.explicit_fb != 0];
}

int check_wide(const rsp::BucketArgs& a) {
  if (a.d <= 160 || a.d > kWideMaxD) return (int)cudaErrorInvalidValue;
  // compute_dtype="bfloat16" reads bf16 tables (ops/als.py casts them)
  if (a.round_bf16 && !a.table_bf16) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// info: [0] CTAs an SM, [1] the cold entries' Gram route, [2] the head's,
// [3] D, [4] shared bytes a CTA, [5] workspace slots (CTAs of the
// persistent grid: SMs x CTAs an SM), [6] floats a slot.
extern "C" int rsp_als_chol_wide_info(const rsp::BucketArgs* args,
                                      int* info) {
  const rsp::BucketArgs a = *args;
  if (int e = check_wide(a)) return e;
  const WideKernel kern = pick_wide(a);
  const WideLayout Ly = make_wide_layout(a.d, a.table_bf16 ? 2 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly.bytes);
  if (err != cudaSuccess) return (int)err;
  int n = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                      Ly.bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
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
  info[0] = n;
  info[1] = cold;
  info[2] = head;
  info[3] = Ly.D;
  info[4] = Ly.bytes;
  info[5] = n * sms;
  info[6] = (int)Ly.slot;
  return 0;
}

// ws: at least min(B, slots) x info[6] floats (uninitialised; each CTA
// writes its slot before it reads it).  stages: 1 the Gram only, 2 also
// the solve (y), 3 everything (y, loss).
extern "C" int rsp_als_chol_wide(const rsp::BucketArgs* args, int stages,
                                 float* ws, int slots, void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (int e = check_wide(a)) return e;
  if (ws == nullptr || slots <= 0) return (int)cudaErrorInvalidValue;
  const WideKernel kern = pick_wide(a);
  const int smem = make_wide_layout(a.d, a.table_bf16 ? 2 : 4).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.B < slots ? a.B : slots;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a, stages, ws);
  return (int)cudaGetLastError();
}
