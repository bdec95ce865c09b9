// Shared device code of the ALS kernels (als_cg.cu, als_chol.cu,
// als_nnls.cu) and the tensor-core helpers of als_chol.cu and
// glove_dense.cu: the bucket arguments, the per-entry weights of the two
// feedback modes (and their bf16-rounded forms), the walk over a row's
// entries, the normal-equation build of the exact solvers, and the per-row
// loss.  Source tables are float (T = float) or bf16 (T = __nv_bfloat16);
// every sum is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RSP_FULL_MASK 0xffffffffu

namespace rsp {

// ---- async copies and tensor-core products (sm_80 and later) ---------------

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// D += A B: m16n8k8 with tf32 operands (f32 bit patterns, rounded by
// to_tf32), or m16n8k16 with bf16 operands (two to a register, the lower
// index in the low half); float32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One bucket of B target rows, as the wrappers in ops/als.py pass it (the
// ctypes mirror is _kernels.BucketArgs; keep the two in the same order).
// Row b's cold entries are col/val[b, :nnz[b]] over the source table V;
// its dense zipf-head entries are W[b, :H] over the head's source rows Vh,
// present where the packed bit is set (bits given) or where W != 0.
struct BucketArgs {
  const void* V;               // (n_src, d) active source rows, T
  const float* xbias;          // (n_src,) source biases, or null
  const int* col;              // (B, L)
  const float* val;            // (B, L) confidences or ratings
  const int* nnz;              // (B,) cold entries per row
  const int* nnz_total;        // (B,) hot + cold entries, or null
  const float* XtX;            // (d, d) Gram + lambda ridge (implicit)
  const float* rhs_init;       // (d,) or null
  const void* W;               // (B, H) dense head (w_kind), 0 = absent
  const void* Vh;              // (H, d) head source rows, T
  const unsigned char* bits;   // (B, ceil(H / 8)) head presence, or null
  const float* x0;             // (B, d) warm start (CG, NNLS)
  float* y;                    // (B, d) solutions
  float* loss;                 // (B,) per-row loss
  const float* w_scale;        // (B,) scale of uint8 head codes, or null
  int B, L, d, H;
  int explicit_fb;             // 0: implicit feedback, 1: explicit
  int dynamic_lambda;          // explicit: lambda * total row nnz
  int table_bf16;              // V and Vh hold bf16 (T = __nv_bfloat16)
  int w_kind;                  // W: 0 float32, 1 bfloat16, 2 uint8 codes
  int round_bf16;              // compute_dtype="bfloat16" rounding points
  float lam, g_rhs, g_loss;    // ridge; global bias in the rhs / the loss
};

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// float -> bf16 -> float, round to nearest even (as torch and XLA round)
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(RSP_FULL_MASK, v, o);
  return v;
}

// Sum of `v` over the block; every thread gets the total.  `scratch` holds
// at least 32 floats.  Contains two __syncthreads, so every thread calls it.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < n_warps ? scratch[lane] : 0.f);
}

// Weights of one entry with value c over a source row with bias xb.
// Implicit (c a confidence): lhs c - 1, rhs c - (c - 1)(xb + g_rhs),
// loss c (1 - g_loss - xb - x.y)^2 (ops/als.py _solve_bucket_implicit).
// Explicit (c a rating): lhs 1, rhs c - xb, loss (c - xb - x.y)^2
// (_solve_bucket_explicit).  Head entries have xb = 0.
template <bool EXPLICIT>
__device__ __forceinline__ float lhs_weight(float c) {
  return EXPLICIT ? 1.f : c - 1.f;
}
template <bool EXPLICIT>
__device__ __forceinline__ float rhs_weight(float c, float xb, float g_rhs) {
  return EXPLICIT ? c - xb : c - (c - 1.f) * (xb + g_rhs);
}
template <bool EXPLICIT>
__device__ __forceinline__ float entry_loss(float c, float xb, float g_loss,
                                            float pred) {
  if (EXPLICIT) {
    const float e = c - xb - pred;
    return e * e;
  }
  const float base = 1.f - g_loss - xb - pred;
  return c * base * base;
}

// The same weights with compute_dtype="bfloat16", rounded where the
// reference rounds them (rsparse_tpu/ops/als.py:189-225, :313-343): the
// rhs weight (for an implicit head entry Wc - bf16(W1 bf16(g)) with
// W1 = bf16(Wc - 1), each step in bf16), and a matvec term's coefficient
// for dot = x . bf16(p): implicit cold bf16(dot (c - 1)), implicit head
// bf16(bf16(dot) W1), explicit bf16(dot).  The head value c is Wc, already
// bf16.  Products are __fmul_rn, so no FMA contraction moves a value across
// a bf16 rounding boundary that the plain version's separate ops keep.
template <bool EXPLICIT>
__device__ __forceinline__ float rhs_weight_bf16(float c, float xb,
                                                 float g_rhs, bool head) {
  if (EXPLICIT) return rbf(c - xb);
  if (head) return rbf(c - rbf(__fmul_rn(rbf(c - 1.f), rbf(g_rhs))));
  return rbf(c - __fmul_rn(c - 1.f, xb + g_rhs));
}
template <bool EXPLICIT>
__device__ __forceinline__ float matvec_coef_bf16(float c, float dot,
                                                  bool head) {
  if (EXPLICIT) return rbf(dot);
  if (head) return rbf(__fmul_rn(rbf(dot), rbf(c - 1.f)));
  return rbf(__fmul_rn(dot, c - 1.f));
}
// The lhs weight of a head entry in the exact solvers' Gram (W1 or 1).
template <bool EXPLICIT>
__device__ __forceinline__ float head_lhs_weight(float c, bool round) {
  return (!EXPLICIT && round) ? rbf(c - 1.f) : lhs_weight<EXPLICIT>(c);
}

// The ridge of row b: lambda, or lambda * total nnz with explicit dynamic
// lambda (the head's entries count, ops/als.py nnz_total).
__device__ __forceinline__ float row_lambda(const BucketArgs& a, int b) {
  if (!a.explicit_fb || !a.dynamic_lambda) return a.lam;
  const int n = a.nnz_total != nullptr ? a.nnz_total[b] : a.nnz[b];
  return a.lam * (float)n;
}

__device__ __forceinline__ bool head_present(const unsigned char* bits_row,
                                             float w, int h) {
  return bits_row != nullptr ? ((bits_row[h >> 3] >> (h & 7)) & 1) != 0
                             : w != 0.f;
}

// The entries of one target row (see BucketArgs).  Rows are `d` values.
template <class T>
struct RowEntries {
  const T* table;
  const float* xbias;
  const int* col;
  const float* val;
  int nnz;
  const T* hot_table;
  const void* w;               // nullptr: no dense head
  const unsigned char* bits;
  int H;
  int d;
  int w_kind;                  // BucketArgs::w_kind
  float w_scale;               // uint8 codes: the row's scale
  bool round_w;                // the head value is bf16 (implicit Wc)
};

template <class T>
__device__ __forceinline__ RowEntries<T> row_entries(const BucketArgs& a,
                                                     int b) {
  const int wb = a.w_kind == 0 ? 4 : (a.w_kind == 1 ? 2 : 1);
  float scale = a.w_scale != nullptr ? a.w_scale[b] : 1.f;
  if (a.round_bf16) scale = rbf(scale);
  const bool cold = a.nnz != nullptr;
  return RowEntries<T>{
      static_cast<const T*>(a.V), a.xbias,
      cold ? a.col + (size_t)b * a.L : nullptr,
      cold ? a.val + (size_t)b * a.L : nullptr, cold ? a.nnz[b] : 0,
      static_cast<const T*>(a.Vh),
      a.W == nullptr ? nullptr
                     : static_cast<const char*>(a.W) + (size_t)b * a.H * wb,
      a.bits == nullptr ? nullptr : a.bits + (size_t)b * ((a.H + 7) >> 3),
      a.H, a.d, a.w_kind, scale, a.round_bf16 && !a.explicit_fb};
}

// Head value of column h: the stored weight, or a uint8 code times the
// row's scale (code * scale in the compute dtype: bf16(scale) and a bf16
// product when rounding), rounded to bf16 where the reference's Wc is bf16.
template <class T>
__device__ __forceinline__ float head_value(const RowEntries<T>& R, int h) {
  float v;
  if (R.w_kind == 0) {
    v = __ldg(static_cast<const float*>(R.w) + h);
  } else if (R.w_kind == 1) {
    v = ldf(static_cast<const __nv_bfloat16*>(R.w) + h);
  } else {
    v = __fmul_rn((float)__ldg(static_cast<const unsigned char*>(R.w) + h),
                  R.w_scale);
  }
  return R.round_w ? rbf(v) : v;
}

// Calls f(row_ptr, c, xb, head) once per entry of the row, with all 32
// lanes of the calling warp; the entries are dealt to the block's
// `n_warps` warps in chunks of 32.  Absent head entries are skipped by a
// ballot over each 32-column strip, so the head costs per present entry.
// XB = false compiles the source biases out (xb = 0); XB = true reads them
// where R.xbias is set.
template <bool XB, class T, class F>
__device__ __forceinline__ void for_each_entry(const RowEntries<T>& R,
                                               int warp, int n_warps, F&& f) {
  const int lane = threadIdx.x & 31;
  const bool has_xb = XB && R.xbias != nullptr;
  for (int base = warp * 32; base < R.nnz; base += n_warps * 32) {
    const int l = base + lane;
    const int my_col = l < R.nnz ? R.col[l] : 0;
    const float my_val = l < R.nnz ? R.val[l] : 0.f;
    const float my_xb = (has_xb && l < R.nnz) ? __ldg(R.xbias + my_col) : 0.f;
    const int cnt = min(32, R.nnz - base);
    for (int j = 0; j < cnt; ++j) {
      const int c = __shfl_sync(RSP_FULL_MASK, my_col, j);
      const float v = __shfl_sync(RSP_FULL_MASK, my_val, j);
      const float xb = has_xb ? __shfl_sync(RSP_FULL_MASK, my_xb, j) : 0.f;
      f(R.table + (size_t)c * R.d, v, xb, false);
    }
  }
  if (R.w == nullptr) return;
  for (int base = warp * 32; base < R.H; base += n_warps * 32) {
    const int h = base + lane;
    const float my_w = h < R.H ? head_value(R, h) : 0.f;
    unsigned present = __ballot_sync(
        RSP_FULL_MASK, h < R.H && head_present(R.bits, my_w, h));
    while (present) {
      const int j = __ffs(present) - 1;
      present &= present - 1;
      const float v = __shfl_sync(RSP_FULL_MASK, my_w, j);
      f(R.hot_table + (size_t)(base + j) * R.d, v, 0.f, true);
    }
  }
}

// Lane `lane` holds elements lane, lane + 32, ... of a d-value row.
template <int PER_LANE, class T>
__device__ __forceinline__ void load_row(const T* row, int d,
                                         float (&r)[PER_LANE]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    const int k = lane + 32 * m;
    r[m] = k < d ? ldf(row + k) : 0.f;
  }
}

// Dot product of a lane-distributed row with a shared-memory vector,
// summed over the warp (every lane gets it).
template <int PER_LANE>
__device__ __forceinline__ float row_dot(const float (&r)[PER_LANE],
                                         const float* vec, int d) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    const int k = lane + 32 * m;
    if (k < d) s += r[m] * vec[k];
  }
  return warp_sum(s);
}

// `vec` itself, or with compute_dtype="bfloat16" its bf16 rounding written
// to `buf`: the operand the reference's products read (bf16(p), bf16(y)).
// Every thread calls it; `vec` must be complete (synchronised) before.
__device__ __forceinline__ const float* dot_operand(const float* vec,
                                                    float* buf, int d,
                                                    bool round) {
  if (!round) return vec;
  for (int t = threadIdx.x; t < d; t += blockDim.x) buf[t] = rbf(vec[t]);
  __syncthreads();
  return buf;
}

// Loss of row b with solution y (shared memory): the entries' terms, with
// predictions against y_dot (y, or bf16(y) from dot_operand), plus
// lam_use |y|^2, summed over the block (every thread gets it).  Every lane
// of a warp computes each term; lane k % 32 adds the warp's k-th, so no
// lane sums more than 1/32 of the warp's terms in sequence (a row with a
// 16,384-wide head and thousands of cold entries would otherwise carry the
// rounding of that many float32 additions in a row).
template <int PER_LANE, bool EXPLICIT, bool XB = true, class T>
__device__ __forceinline__ float row_loss(const RowEntries<T>& R,
                                          const BucketArgs& a, const float* y,
                                          const float* y_dot, float lam_use,
                                          float* scratch) {
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  int k = 0;
  for_each_entry<XB>(R, warp, n_warps,
                     [&](const T* row, float c, float xb, bool) {
    float r[PER_LANE];
    load_row<PER_LANE>(row, R.d, r);
    const float term = entry_loss<EXPLICIT>(
        c, xb, a.g_loss, row_dot<PER_LANE>(r, y_dot, R.d));
    if ((k++ & 31) == lane) acc += term;
  });
  float part = acc;
  for (int t = threadIdx.x; t < R.d; t += blockDim.x) part += lam_use * y[t] * y[t];
  return block_sum(part, scratch);
}

// ---- the normal equations of the exact solvers (K2, K4) --------------------

constexpr int kGramThreads = 256;  // a 16 x 16 grid over the d x d matrix
constexpr int kChunk = 32;         // source rows staged per pass

// Shared-memory workspace of build_normal_equations.
struct GramSmem {
  float* rows;  // kChunk x d staged source rows
  float* gw;    // kChunk lhs weights
  float* rw;    // kChunk rhs weights
  int* hidx;    // kChunk head columns of the staged strip
  int* cnt;     // 1: present head entries in the strip
};

// acc += sum over the staged rows of (gw[l] row_l) row_l' (thread (ty, tx)
// owns the entries (ty + 16 i, tx + 16 j)), rhs_acc += sum rw[l] row_l[tid].
// round_rows rounds each gw[l] row_l[i] to bf16 first (compute_dtype=
// "bfloat16": the reference's Xgw = bf16(Xg (c - 1)), ops/als.py:229).
template <int KT>
__device__ __forceinline__ void gram_accumulate(float (&acc)[KT][KT],
                                                float& rhs_acc,
                                                const GramSmem& S, int cnt,
                                                int d, bool round_rows) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int l = 0; l < cnt; ++l) {
    const float wl = S.gw[l];
    const float* row = S.rows + l * d;
    float av[KT], bv[KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int ri = ty + 16 * i, ci = tx + 16 * i;
      const float w = ri < d ? wl * row[ri] : 0.f;
      av[i] = round_rows ? rbf(w) : w;
      bv[i] = ci < d ? row[ci] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) acc[i][j] += av[i] * bv[j];
    if (tid < d) rhs_acc += S.rw[l] * row[tid];
  }
}

// Builds row b's lhs into A (d x d, row-major, full) and its rhs into `rhs`,
// both in shared memory, with kGramThreads threads:
//   implicit: A = XtX + sum_e (c_e - 1) x_e x_e',  rhs = sum_e rw_e x_e + rhs_init
//   explicit: A = sum_e x_e x_e' + lam_use I (+ I for an empty row with
//             lam_use = 0, which keeps padding rows nonsingular),
//             rhs = sum_e (c_e - xb_e) x_e
// over the cold entries (staged kChunk source rows at a time, read as T)
// and the present head entries (each 32-column strip of W compacted by a
// ballot), so the head costs per present entry and no (H, d^2) table
// exists.  With compute_dtype="bfloat16" the rhs weights are rounded as in
// K1, the cold implicit rows are weighted with rounding (gram_accumulate),
// the head's lhs weight is W1 = bf16(Wc - 1) and its rows are not (the
// reference's _hot_lhs sums W1 v v' in float32).
template <int KMAXD, bool EXPLICIT, class T>
__device__ void build_normal_equations(const BucketArgs& a, int b,
                                       float lam_use, float* A, float* rhs,
                                       const GramSmem& S) {
  constexpr int KT = KMAXD / 16;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, d = a.d;
  const RowEntries<T> R = row_entries<T>(a, b);
  const bool rnd = a.round_bf16 != 0;
  const int nnz = R.nnz;
  float acc[KT][KT];
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[i][j] = 0.f;
  float rhs_acc = 0.f;

  for (int base = 0; base < nnz; base += kChunk) {
    const int cnt = min(kChunk, nnz - base);
    for (int e = tid; e < cnt * d; e += kGramThreads) {
      const int l = e / d, k = e - l * d;
      S.rows[e] = ldf(R.table + (size_t)R.col[base + l] * d + k);
    }
    if (tid < cnt) {
      const float c = R.val[base + tid];
      const float xb =
          a.xbias != nullptr ? __ldg(a.xbias + R.col[base + tid]) : 0.f;
      S.gw[tid] = lhs_weight<EXPLICIT>(c);
      S.rw[tid] = rnd ? rhs_weight_bf16<EXPLICIT>(c, xb, a.g_rhs, false)
                      : rhs_weight<EXPLICIT>(c, xb, a.g_rhs);
    }
    __syncthreads();
    gram_accumulate<KT>(acc, rhs_acc, S, cnt, d, rnd && !EXPLICIT);
    __syncthreads();
  }

  if (R.w != nullptr) {
    for (int base = 0; base < a.H; base += 32) {
      if (tid < 32) {
        const int h = base + tid;
        const float w = h < a.H ? head_value(R, h) : 0.f;
        const bool pres = h < a.H && head_present(R.bits, w, h);
        const unsigned m = __ballot_sync(RSP_FULL_MASK, pres);
        if (pres) {
          const int p = __popc(m & ((1u << tid) - 1u));
          S.hidx[p] = h;
          S.gw[p] = head_lhs_weight<EXPLICIT>(w, rnd);
          S.rw[p] = rnd ? rhs_weight_bf16<EXPLICIT>(w, 0.f, a.g_rhs, true)
                        : rhs_weight<EXPLICIT>(w, 0.f, a.g_rhs);
        }
        if (tid == 0) *S.cnt = __popc(m);
      }
      __syncthreads();
      const int cnt = *S.cnt;
      if (cnt > 0) {
        for (int e = tid; e < cnt * d; e += kGramThreads) {
          const int l = e / d, k = e - l * d;
          S.rows[e] = ldf(R.hot_table + (size_t)S.hidx[l] * d + k);
        }
        __syncthreads();
        gram_accumulate<KT>(acc, rhs_acc, S, cnt, d, false);
      }
      __syncthreads();
    }
  }

  const float diag =
      EXPLICIT ? lam_use + ((nnz == 0 && lam_use == 0.f) ? 1.f : 0.f) : 0.f;
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int ri = ty + 16 * i, ci = tx + 16 * j;
      if (ri < d && ci < d) {
        const float base =
            EXPLICIT ? (ri == ci ? diag : 0.f) : __ldg(a.XtX + ri * d + ci);
        A[ri * d + ci] = base + acc[i][j];
      }
    }
  if (tid < d) rhs[tid] = rhs_acc + (a.rhs_init != nullptr ? a.rhs_init[tid] : 0.f);
  __syncthreads();
}

// Shared floats of build_normal_equations' workspace beside A and rhs
// (the ints are counted as floats: both are 4 bytes).
__host__ __device__ constexpr int gram_smem_floats(int d) {
  return kChunk * d + 3 * kChunk + 1;
}

__device__ __forceinline__ GramSmem gram_smem(float* p, int d) {
  float* gw = p + kChunk * d;
  float* rw = gw + kChunk;
  int* hidx = reinterpret_cast<int*>(rw + kChunk);
  return GramSmem{p, gw, rw, hidx, hidx + kChunk};
}

}  // namespace rsp
