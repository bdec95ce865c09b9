// K2: one bucket of exact ALS solves by Cholesky, implicit or explicit
// feedback, with an optional dense zipf head.
//
// Replaces the TPU programs rsparse_tpu/ops/als.py:138
// _solve_bucket_implicit (exact branch :228-247, loss :249-266) and :269
// _solve_bucket_explicit (exact branch :346-362, loss :364-373), their
// dense-head lhs term :125 _hot_lhs over :116 hot_outer_table, and
// rsparse_tpu/ops/solvers.py:28 batched_spd_solve -> :134
// batched_spd_solve_blocked (_chol_panel :59, _trsm_lower :85,
// _trsm_lower_t :103).  Its plain PyTorch versions are
// rsparse_tpu_torch/ops/als.py _solve_bucket_implicit / _explicit (einsum
// Gram + torch.linalg.cholesky + torch.cholesky_solve).  transform() and
// the closing half-sweep of fit_transform run it.
//
// One CTA of 8 warps solves one target row, in three stages.
//
// (1) The Gram on tensor cores.  The row's lhs is one weighted product
//     X' diag(w) X over its entries: cold entries, then the dense head's
//     present entries.  Entries are listed kSeg at a time in shared memory
//     (cold: source row, lhs and rhs weights; head: each kSeg-column
//     stretch of W scanned by the whole block and compacted in column
//     order by ballots), then their source rows are staged kRows at a time
//     with cp.async into two buffers (the next chunk lands while the
//     tensor cores work on this one).  A row is copied as the 16-byte
//     granules that hold it, so rows of any width and alignment stage with
//     16-byte copies; its offset inside the first granule is kept beside
//     it.  Only the lower m16n8 tiles of the d x d Gram are computed
//     (nM (nM + 1) tiles, nM = D / 16), dealt to the warps in row-major
//     runs; each chunk is summed into fresh register fragments, which are
//     added in float32 to the warp's sums in shared memory (the tensor core
//     truncates as it adds into a running sum: over a row of thousands of
//     entries that cost more than K2's limit).  The operand rule:
//       - both operands exact in bf16 -> mma.m16n8k16 bf16 (explicit
//         feedback on a bf16 table, w = 1; implicit cold entries under
//         compute_dtype="bfloat16", whose A operand is bf16(w x));
//       - otherwise mma.m16n8k8 tf32 with each operand that tf32 does not
//         hold split into hi + lo and the lo * lo term dropped (3xTF32 on
//         a float32 table; 2xTF32 on a bf16 table, whose rows tf32 holds).
//     Under compute_dtype="bfloat16" the implicit Gram is not symmetric,
//     and the plain version factors (A + A') / 2: the kernel sums each cold
//     entry twice, as (bf16(w x), x) and (x, bf16(w x)), and each head
//     entry with weight 2 W1 (its term is symmetric), and halves, so the
//     lower tiles hold the symmetric part.  The rhs is summed by the first
//     d threads with FMAs from the same staged rows.
// (2) The factorisation, right-looking in panels of 16 columns, in shared
//     memory as (D + 1) x (D + 4) floats whose last row is the rhs: each
//     panel's forward substitution is the same triangular solve as the
//     rows below it, so z = L^-1 rhs comes out of the factorisation.  Per
//     panel: one warp factors the 16 x 16 diagonal block in registers with
//     shuffles (the reference's guard for a non-positive pivot, piv =
//     sqrt(max(A_jj, 0)), divisor 1 if 0, column by column); one thread per
//     row below solves that row against it (divisor L_jj, or 1 where it is
//     not positive, as _trsm_lower); all threads apply the rank-16 trailing
//     update in 4 x 4 register tiles.  Three block barriers per panel, none
//     per column.  d is padded to D, a multiple of 16, with an identity
//     block (d = 129 runs at D = 144).
// (3) The back substitution L' x = z in one warp: lane k % 32 keeps the
//     running u_k in registers; each step is a multiply, a shuffle and one
//     FMA per lane over a contiguous row of L (no barrier).  Then the loss
//     as in K1.
//
// The staging buffers, the entry list and the warps' Gram sums share one
// shared-memory region with the factorised matrix, which is written only
// after the last chunk: 70 KB a CTA at d = 128 (three CTAs an SM), 88 KB at
// d = 129 (D = 144, two).
//
// What bounds it on the H100: per row the Gram is (n + Hp) d^2 products
// (on the tensor cores, at 989 TFLOP/s bf16 or 495 / 3 TFLOP/s 3xTF32) and
// the factorisation d^3 / 3 FMAs; at the table's shapes the bound is tens
// of microseconds for a whole bucket, while one row's chain of 16-column
// panels and D back-substitution steps is latency: the design keeps that
// chain to a few barriers a panel and fills the SM with three rows at once.
//
// rsp_als_chol's `stages` stops a launch after the Gram (1: the lhs is
// built, nothing is written) or after the solve (2: y written, no loss);
// 3 runs everything.  chip_smoke.py times the stages apart.

#include "als_chol.cuh"

namespace {

// ---- the kernel -------------------------------------------------------------


template <int KD, class T, bool EXPLICIT>
__global__ void __launch_bounds__(kThreads, KD <= 128 ? 3 : 2)
als_chol_kernel(rsp::BucketArgs a, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMaxT = TileRun<KD>::kMaxT;
  const int d = a.d, b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const Layout Ly = make_layout(d, (int)sizeof(T));
  const int D = Ly.D, lda = Ly.lda, rs = Ly.rs;

  unsigned char* stage = smem;
  int* lidx = reinterpret_cast<int*>(smem + Ly.list);
  float* lgw = reinterpret_cast<float*>(lidx + kSeg);
  float* lrw = lgw + kSeg;
  int* soff = reinterpret_cast<int*>(lrw + kSeg);  // [2][kRows]
  int* cnt = soff + 2 * kRows;                      // [64] + total
  // the warp's Gram sums: [tile][component][lane]
  float* tot = reinterpret_cast<float*>(smem + Ly.totals) +
               warp * Ly.per * 128 + lane;
  float* Lm = reinterpret_cast<float*>(smem);       // (D + 1) x lda, after the Gram
  float* dinv = reinterpret_cast<float*>(smem + Ly.extra);
  float* xs = dinv + D;
  float* colv = xs + D;
  float* scratch = colv + D;

  const float lam_use = rsp::row_lambda(a, b);
  const rsp::RowEntries<T> R = rsp::row_entries<T>(a, b);
  const bool rnd = a.round_bf16 != 0;
  const TileRun<KD> run(D, warp);


  // Each chunk is summed by the tensor cores into fresh fragments c, which
  // are then added to the warp's sums in shared memory in float32: the
  // tensor core truncates when it adds into a running sum, and over
  // thousands of entries (a long row, a wide head) that loss would grow
  // past K2's limit.
  float c[kMaxT][4];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[t][q] = 0.f;
  for (int e = 0; e < run.count * 4; ++e) tot[32 * e] = 0.f;
  float rhs_acc = 0.f;

  // ---- (1) the Gram, segment by segment ------------------------------------
  const int nnz = R.nnz;
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
        bal[q] = __ballot_sync(RSP_FULL_MASK,
                               h < a.H && rsp::head_present(R.bits, wv[q], h));
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
          lrw[pos] = rnd ? rsp::rhs_weight_bf16<EXPLICIT>(w, 0.f, a.g_rhs, true)
                         : rsp::rhs_weight<EXPLICIT>(w, 0.f, a.g_rhs);
        }
      }
      if (tid < kRows && n_list + tid < (n_list + kRows - 1) / kRows * kRows) {
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
          const size_t p = reinterpret_cast<size_t>(src + (size_t)lidx[k] * d);
          const int off = (int)(p & 15);
          if (q == 0) soff[(ch & 1) * kRows + l] = off;
          if (q < (off + row_bytes + 15) >> 4)
            rsp::cp_async16(
                dst, reinterpret_cast<const void*>((p & ~(size_t)15) + 16 * q),
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
      if (tid < d) {
#pragma unroll 8
        for (int l = 0; l < kRows; ++l)
          rhs_acc += rw[l] * sld<T>(buf + l * rs + off[l], tid);
      }
      if constexpr (!is_bf16<T>()) {
#pragma unroll
        for (int ks = 0; ks < kRows / 8; ++ks) {
          const int lA = 8 * ks + tig, lB = lA + 4;
          tf32_step<TileRun<KD>, T, true>(c, run, buf + lA * rs + off[lA],
                                 buf + lB * rs + off[lB], gw[lA], gw[lB], d, g);
        }
      } else {
        if (route == kRouteTf32x2) {
#pragma unroll
          for (int ks = 0; ks < kRows / 8; ++ks) {
            const int lA = 8 * ks + tig, lB = lA + 4;
            tf32_step<TileRun<KD>, T, false>(c, run, buf + lA * rs + off[lA],
                                    buf + lB * rs + off[lB], gw[lA], gw[lB], d,
                                    g);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < kRows / 16; ++ks) {
            const int r0 = 16 * ks + 2 * tig;
            const int rr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
            const unsigned char* const p[4] = {
                buf + rr[0] * rs + off[rr[0]], buf + rr[1] * rs + off[rr[1]],
                buf + rr[2] * rs + off[rr[2]], buf + rr[3] * rs + off[rr[3]]};
            const float w[4] = {gw[rr[0]], gw[rr[1]], gw[rr[2]], gw[rr[3]]};
            if (!EXPLICIT && route == kRouteBf16Sym)
              bf16_step<TileRun<KD>, T, true>(c, run, p, w, d, g);
            else
              bf16_step<TileRun<KD>, T, false>(c, run, p, w, d, g);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
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
  __syncthreads();

  // ---- the lhs (lower tiles) and the rhs row into the factor's matrix ------
  {
    const bool doubled = rnd && !EXPLICIT && is_bf16<T>();
    const float scale = doubled ? 0.5f : 1.f;
    const float diag =
        EXPLICIT ? lam_use + ((nnz == 0 && lam_use == 0.f) ? 1.f : 0.f) : 0.f;
    int m = run.m0, n = run.n0;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < run.count) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 16 * m + g + 8 * (q >> 1), j = 8 * n + 2 * tig + (q & 1);
          float base;
          if (i >= d || j >= d) {
            base = i == j ? 1.f : 0.f;
          } else if (EXPLICIT) {
            base = i == j ? diag : 0.f;
          } else {
            base = doubled ? 0.5f * (__ldg(a.XtX + i * d + j) + __ldg(a.XtX + j * d + i))
                           : __ldg(a.XtX + i * d + j);
          }
          c[t][q] = base + scale * tot[32 * (4 * t + q)];
        }
        if (++n > 2 * m + 1) {
          n = 0;
          ++m;
        }
      }
    }
    const float rv =
        tid < d ? rhs_acc + (a.rhs_init != nullptr ? a.rhs_init[tid] : 0.f)
                : 0.f;
    __syncthreads();  // every warp holds its sums: the matrix may cover them
    m = run.m0;
    n = run.n0;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < run.count) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          Lm[(16 * m + g + 8 * (q >> 1)) * lda + 8 * n + 2 * tig + (q & 1)] =
              c[t][q];
        if (++n > 2 * m + 1) {
          n = 0;
          ++m;
        }
      }
    }
    if (tid < D) Lm[D * lda + tid] = rv;
  }
  __syncthreads();
  if (stages < 2) return;

  // ---- (2) blocked right-looking Cholesky; row D carries z = L^-1 rhs -------
  // Per panel, three barriers: warp 0 factors the diagonal block; one
  // thread per row below (the rhs row last) solves that row against it;
  // all threads apply the trailing update.
  for (int s = 0;; s += kPanel) {
    if (warp == 0) factor_diag(Lm, lda, s, dinv, lane);
    __syncthreads();
    const int below = D - s - kPanel;  // rows below the block, the rhs row after them
    if (tid <= below) {
      float* row = Lm + (s + kPanel + tid) * lda + s;
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
          r[k] -= r[j] * Lm[(s + k) * lda + s + j];
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

  // ---- (3) L' x = z in one warp --------------------------------------------
  if (warp == 0) {
    constexpr int kPer = KD / 32;
    float u[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = 32 * q + lane;
      u[q] = j < D ? Lm[D * lda + j] : 0.f;
    }
#pragma unroll
    for (int q = kPer - 1; q >= 0; --q) {
      if (32 * q >= D) continue;
#pragma unroll
      for (int o = 31; o >= 0; --o) {
        const int i = 32 * q + o;
        if (i >= D) continue;
        const float xi = __shfl_sync(RSP_FULL_MASK, u[q] * dinv[i], o);
        if (lane == o) xs[i] = xi;
        const float* Li = Lm + i * lda;
#pragma unroll
        for (int qq = 0; qq <= q; ++qq) {
          const int j = 32 * qq + lane;
          if (j < i) u[qq] -= Li[j] * xi;
        }
      }
    }
  }
  __syncthreads();

  // ---- output and loss -----------------------------------------------------
  for (int t = tid; t < d; t += kThreads) a.y[(size_t)b * d + t] = xs[t];
  if (stages >= 3) {
    const float total = rsp::row_loss<KD / 32, EXPLICIT>(
        R, a, xs, rsp::dot_operand(xs, colv, d, rnd), lam_use, scratch);
    if (tid == 0) a.loss[b] = total;
  }
}

using Kernel = void (*)(rsp::BucketArgs, int);

Kernel pick(const rsp::BucketArgs& a) {
  using bf16 = __nv_bfloat16;
  // [D <= 128 ? 0 : 1][bf16 table][explicit]
  static const Kernel kernels[2][2][2] = {
      {{als_chol_kernel<128, float, false>, als_chol_kernel<128, float, true>},
       {als_chol_kernel<128, bf16, false>, als_chol_kernel<128, bf16, true>}},
      {{als_chol_kernel<160, float, false>, als_chol_kernel<160, float, true>},
       {als_chol_kernel<160, bf16, false>, als_chol_kernel<160, bf16, true>}}};
  return kernels[a.d > 128][a.table_bf16 != 0][a.explicit_fb != 0];
}

int check_args(const rsp::BucketArgs& a) {
  if (a.d <= 0 || a.d > 160) return (int)cudaErrorInvalidValue;
  // compute_dtype="bfloat16" reads bf16 tables (ops/als.py casts them)
  if (a.round_bf16 && !a.table_bf16) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// stages: 1 the Gram only, 2 also the solve (y), 3 everything (y, loss).
extern "C" int rsp_als_chol(const rsp::BucketArgs* args, int stages,
                            void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.B <= 0) return 0;
  if (int e = check_args(a)) return e;
  const Kernel kern = pick(a);
  const int smem = make_layout(a.d, a.table_bf16 ? 2 : 4).bytes;
  // above 48 KB a block's dynamic shared memory must be opted into; the
  // attribute is per device, so it is set before every launch
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.B, kThreads, smem, (cudaStream_t)stream>>>(a, stages);
  return (int)cudaGetLastError();
}

// info: [0] CTAs an SM, [1] the cold entries' Gram route, [2] the head's,
// [3] D, [4] shared bytes a CTA (routes: 0 bf16 mma, 1 bf16 mma summed
// both ways, 2 2xTF32, 3 3xTF32).
extern "C" int rsp_als_chol_info(const rsp::BucketArgs* args, int* info) {
  const rsp::BucketArgs a = *args;
  if (int e = check_args(a)) return e;
  const Kernel kern = pick(a);
  const Layout Ly = make_layout(a.d, a.table_bf16 ? 2 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly.bytes);
  if (err != cudaSuccess) return (int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                      Ly.bytes);
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
  return 0;
}
