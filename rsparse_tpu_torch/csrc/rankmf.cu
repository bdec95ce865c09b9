// K9: one RankMF (BPR / WARP) minibatch.
//
// Replaces the TPU program rsparse_tpu/models/rankmf.py:202 _rankmf_batch
// (with _in_hash_set :167 and _combine :79; build_user_hash :98 stays host
// numpy).  Its plain PyTorch version is rsparse_tpu_torch/models/rankmf.py
// _rankmf_batch_plain.
//
// All samples of a batch read the batch-start tables, and the optimizers
// are accumulator first: a feature's AdaGrad denominator is its
// accumulator after every sample of the batch has added its g^2, and the
// RMSprop delta (gamma - 1) old / duplicates + (1 - gamma) g^2 reads the
// batch-start accumulator and the batch's duplicate count
// (rsparse_tpu/models/rankmf.py:290-329).  So the work is two launches, and
// a third for RMSprop:
//   A  one warp per sample: decode the user, the positive and the K
//      candidates from the raw bits (%, as :226-237), combine the
//      embeddings, and find the first acceptable candidate (BPR: not a
//      positive; WARP: also d + margin >= 0).  Where r <= 32 the candidates
//      are scored side by side, one a lane, in windows that keep the
//      reference's order (the first kWindow candidates, then up to 32 at
//      a time): each lane decodes its id, probes its hash bucket ((h >>
//      shift) & mask; the bucket's lanes read by 16-byte loads), loads its
//      combined embedding into its own registers (float4 loads, the
//      feature loop for side features) against the user's, also held
//      whole by every lane, and scores it; one ballot of "acceptable" and
//      __ffs give the first, so a window costs one chain bits -> bucket ->
//      row for all its candidates.  Wider ranks keep lanes over the rank
//      and score candidates one after another.  Then the WARP rank weight
//      log1p((n_item - 1)/(k + 1) + 1) / log1p(n_item + 1), the AUC
//      counters (summed a CTA in shared memory, one atomic a CTA each),
//      and the gradients of the user, the positive and the negative; write
//      them and the combined embeddings to scratch; AdaGrad adds g^2 / r
//      into the accumulators with atomics; RMSprop instead counts
//      duplicates and keeps each feature's batch-start accumulator in
//      scratch;
//   A2 (RMSprop) one thread per (entity, feature): add the EMA delta;
//   B  one warp per entity: step = grad / sqrt(acc + eps) + lambda comb,
//      added as -lr step into every feature row of the entity with atomics.
// A thread never reads an accumulator or a table that another thread of
// the same launch adds to.  The positive and negative item updates share
// launch B and its accumulators, as at :339-345.
//
// What bounds it on the H100: bytes and latency.  Per sample it reads up to
// K + 2 embedding rows (r floats each) and K hash buckets at random
// addresses and does ~4 r (K + 3) flops; a sample is a chain of dependent
// loads (bits -> user -> positive -> its row; bits -> bucket -> candidate
// row).  What the design does about it: the candidates of a window share
// one chain (one round trip a window instead of two a candidate tried);
// the window stops at the first acceptable candidate (their scores are
// needed no further, as in the reference's rejection loop); one warp per
// sample keeps S = 8192 samples in flight at once.  The atomic sums over
// duplicate features add in an order that changes from run to run (f32
// rounding).
//
// Row-map mode (a mesh fit, rsparse_tpu_torch/parallel/sgd_sharded.py):
// with `wmap` / `hmap` set, W / accW (cntW) and H / accH (cntH) are compact
// tables of the rows the batch reaches, and every read and write of feature
// row f goes to row map[f] (global feature row -> compact row, built by
// the caller from the same bits).  The entity ids the bits decode, the
// feature lists and the hash sets stay global, so the samples, their
// candidates and their order are the one-process batch's; one more
// dependent load a row.  Both maps null is the one-process launch.
//
// The bf16 instance (table_bf16 != 0, RankMF(precision="bfloat16"), T =
// __nv_bfloat16): W, H, accW, accH and the feature values are bf16, every
// value is computed at f32 and rounded to bf16 where the JAX function run
// op by op rounds it (each op whose result is bf16: the products of r_ui
// before their sum, r_uj and the combined embeddings as one f32 sum each,
// the logistic as bf16(1 / bf16(1 + bf16(exp(-x)))), the WARP weight's
// log1p factor cast to bf16 through f32, every gradient and step term).
// There every scatter-add is a bf16 scatter of bf16 updates, which adds a
// feature row's duplicates one at a time in the batch's update order,
// rounding each (a hot row's accumulator stalls when its increments are
// below half a spacing).  Atomics cannot keep that order, so launch A
// leaves the accumulators alone and launch W replaces A2 and B: the
// caller sorts the batch's (table row, update) pairs stably by row, one
// list a table in the JAX scatter's update order (W: sample, feature
// slot; H: the positives' updates, then the negatives'), and one warp a
// row walks its updates in that order: the accumulator first (AdaGrad:
// acc += g^2 / r per update; RMSprop: the duplicate count, then acc +=
// (gamma - 1) old / count + (1 - gamma) g^2 per update, old the
// batch-start value), then each component of the row, one rounded add an
// update.  No atomics: the bf16 batch gives the same tables every run.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxR = 128;          // widest embedding (MAX_RANK)
constexpr int kRpl = kMaxR / 32;    // components a lane holds
constexpr int kWarps = 8;           // warps per CTA
// candidates launch A scores side by side before its first ballot (r <=
// 32; later windows take up to 32): BPR accepts the first candidate that
// is not a positive, and WARP tries 1 to 2.2 candidates a sample on
// config #5 and at chip_smoke.py's kernel checks, so one window of 8
// settles nearly every sample at a quarter of the loads of a window of 32
constexpr int kWindow = 8;
constexpr float kEps = 1e-10f;
constexpr unsigned kHashMult = 2654435761u;

}  // namespace

// ctypes mirror: _kernels.RankMFArgs (same fields, same order).
struct RankMFArgs {
  const long long* bits;          // (S, K + 2) uint32 values
  const int* flat_idx;            // (flat_len,) positives, CSR order
  const int* indptr;              // (n_user,) row starts
  const int* row_nnz;             // (n_user,)
  const int* table;               // (TB, lanes) hash buckets, -1 empty
  const int* boff;                // (n_user,) first bucket
  const int* bmask;               // (n_user,) buckets - 1
  const int* bshift;              // (n_user,) 32 - log2(buckets)
  const int* uf_idx;              // (n_user, Fu) or null: identity
  const float* uf_val;
  const unsigned char* uf_mask;
  const int* if_idx;              // (n_item, Fi) or null: identity
  const float* if_val;
  const unsigned char* if_mask;
  float* W;                       // (n_user_feat, r)
  float* H;                       // (n_item_feat, r)
  float* accW;                    // (n_user_feat,)
  float* accH;                    // (n_item_feat,)
  int* iscratch;                  // (2, 3 S): entity ids, update flags
  float* fscratch;                // g2 (3S), grad (3S, r), comb (3S, r),
                                  // old (3S, F) (RMSprop)
  float* cntW;                    // (n_user_feat,) zeroed (RMSprop)
  float* cntH;                    // (n_item_feat,) zeroed (RMSprop, items)
  unsigned long long* counters;   // (4,) auc_num, valid (at least 1),
                                  // found, tried: zeroed here
  const int* wmap;                // (n_user_feat,) compact row, or null
  const int* hmap;                // (n_item_feat,) compact row, or null
  int S, K, r, n_user, n_item, flat_len, lanes, Fu, Fi, loss, kernel,
      optimizer, update_items;
  int table_bf16;                 // W, H, accW, accH, feature values bf16
  float lr, gamma, lam_u, lam_ip, lam_in, margin, norm;  // (bf16 values
                                                          // at bf16)
};

namespace {

using bf16_t = __nv_bfloat16;
template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16_t>::value;

// Loads of a table value (T = float as before: plain and read-only-cache
// loads; T = bf16 widened exactly), and the rounding of a value the
// reference holds at the table dtype (none at float).
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16_t* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16_t* p) { return rsp::ldf(p); }
template <typename T>
__device__ __forceinline__ float rd(float x) {
  if constexpr (kIsBf16<T>)
    return rsp::rbf(x);
  else
    return x;
}

template <typename T>
struct FeatList {
  const int* idx;                 // null: identity features
  const T* val;
  const unsigned char* mask;
  int F;
  const int* map;                 // feature row -> table row, or null

  __device__ int count() const { return idx ? F : 1; }
  // The table row of the l-th feature of entity id: false at padding.
  __device__ bool at(int id, int l, int* f, float* x) const {
    int g = id;
    *x = 1.f;
    if (idx) {
      const size_t q = (size_t)id * F + l;
      if (!mask[q]) return false;
      g = idx[q];
      *x = ld(val + q);
    }
    *f = map ? __ldg(map + g) : g;
    return true;
  }
};

// The logistic as the reference computes it at the table dtype: at bf16
// XLA expands it to 1 / (1 + exp(-x)) with each op rounded.
template <typename T>
__device__ __forceinline__ float sigmoid(float x) {
  if constexpr (kIsBf16<T>)
    return rsp::rbf(1.f / rsp::rbf(1.f + rsp::rbf(expf(-x))));
  else
    return 1.f / (1.f + expf(-x));
}

// out[j] = component lane + 32 j of the entity's combined embedding (at
// bf16 the feature sum rounded once, as the reference's einsum).
template <typename T>
__device__ __forceinline__ void combine(const T* emb, const FeatList<T>& fl,
                                        int id, int r, int lane,
                                        float (&out)[kRpl]) {
#pragma unroll
  for (int j = 0; j < kRpl; ++j) out[j] = 0.f;
  for (int l = 0; l < fl.count(); ++l) {
    int f;
    float x;
    if (!fl.at(id, l, &f, &x)) continue;
    const T* row = emb + (size_t)f * r;
#pragma unroll
    for (int j = 0; j < kRpl; ++j) {
      const int k = lane + 32 * j;
      if (k < r) out[j] = fl.idx ? out[j] + x * ld(row + k) : ld(row + k);
    }
  }
  if constexpr (kIsBf16<T>) {
    if (fl.idx) {
#pragma unroll
      for (int j = 0; j < kRpl; ++j) out[j] = rsp::rbf(out[j]);
    }
  }
}

// sum_k a_k b_k over the warp; `round_terms` (r_ui at bf16, a sum of the
// elementwise product) rounds each product first
template <typename T>
__device__ __forceinline__ float dot(const float (&a)[kRpl],
                                     const float (&b)[kRpl],
                                     bool round_terms) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kRpl; ++j)
    s += round_terms ? rd<T>(a[j] * b[j]) : a[j] * b[j];
  return rd<T>(rsp::warp_sum(s));
}

template <typename T>
__device__ __forceinline__ FeatList<T> user_feats(const RankMFArgs& a) {
  return FeatList<T>{a.uf_idx, reinterpret_cast<const T*>(a.uf_val),
                     a.uf_mask, a.Fu, a.wmap};
}
template <typename T>
__device__ __forceinline__ FeatList<T> item_feats(const RankMFArgs& a) {
  return FeatList<T>{a.if_idx, reinterpret_cast<const T*>(a.if_val),
                     a.if_mask, a.Fi, a.hmap};
}
// Features per entity in the RMSprop snapshot: max(Fu, Fi, 1).
__host__ __device__ __forceinline__ int old_stride(const RankMFArgs& a) {
  const int F = a.Fu > a.Fi ? a.Fu : a.Fi;
  return F > 1 ? F : 1;
}

// Write one entity's update to scratch (slot q = 3 s + e) and start its
// accumulator step (the float instance; the bf16 instance's walk takes the
// accumulators).  Every lane of the warp calls it.
template <typename T>
__device__ void stage_entity(const RankMFArgs& a, int q, int id,
                             const float (&grad)[kRpl],
                             const float (&comb)[kRpl], bool enabled,
                             int lane) {
  const int r = a.r, S3 = 3 * a.S;
  bool nz = false;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kRpl; ++j) {
    const int k = lane + 32 * j;
    if (k < r) {
      nz |= grad[j] != 0.f;
      sq += rd<T>(grad[j] * grad[j]);
    }
  }
  const bool flag = enabled && __any_sync(RSP_FULL_MASK, nz);
  const float g2 = rd<T>(rd<T>(rsp::warp_sum(sq)) / rd<T>((float)r));
  float* g2s = a.fscratch;
  float* grads = g2s + S3;
  float* combs = grads + (size_t)S3 * r;
  if (lane == 0) {
    a.iscratch[q] = id;
    a.iscratch[S3 + q] = flag;
    g2s[q] = g2;
  }
  if (!flag) return;
#pragma unroll
  for (int j = 0; j < kRpl; ++j) {
    const int k = lane + 32 * j;
    if (k < r) {
      grads[(size_t)q * r + k] = grad[j];
      combs[(size_t)q * r + k] = comb[j];
    }
  }
  if constexpr (!kIsBf16<T>) {
    const bool user = q % 3 == 0;
    const FeatList<T> fl = user ? user_feats<T>(a) : item_feats<T>(a);
    float* acc = user ? a.accW : a.accH;
    float* cnt = user ? a.cntW : a.cntH;
    float* old = combs + (size_t)S3 * r;
    const int F = old_stride(a);
    for (int l = lane; l < fl.count(); l += 32) {
      int f;
      float x;
      if (!fl.at(id, l, &f, &x)) continue;
      if (a.optimizer == 0) {
        atomicAdd(acc + f, g2);
      } else {
        atomicAdd(cnt + f, 1.f);
        old[(size_t)q * F + l] = acc[f];
      }
    }
  }
}

// The counters of one sample, into the CTA's sums (lane 0).
__device__ __forceinline__ void count(int* cnt, bool auc_hit, bool valid,
                                      bool found, int first_k, int K) {
  atomicAdd(cnt, (int)auc_hit);
  atomicAdd(cnt + 1, (int)valid);
  atomicAdd(cnt + 2, (int)found);
  atomicAdd(cnt + 3, found ? first_k + 1 : K);
}

// The WARP rank weight's factor log1p((n_item - 1)/(k + 1) + 1): at bf16
// the reference forms it at float64 (a weak Python float) and casts it to
// bf16 through float32.
template <typename T>
__device__ __forceinline__ float warp_factor(int n_item, int first_k) {
  if constexpr (kIsBf16<T>)
    return rsp::rbf(
        (float)log1p((double)(n_item - 1) / (double)(first_k + 1) + 1.0));
  else
    return log1pf((float)(n_item - 1) / (float)(first_k + 1) + 1.f);
}

// The gradients of a sample whose first acceptable candidate is found at
// first_k (j, d_sel, hj_adj), in lanes over the rank, staged to scratch.
template <typename T>
__device__ void finish_sample(const RankMFArgs& a, int s, int u, int i,
                              bool found, int first_k, int j, float d_sel,
                              float hi_adj, float hj_adj,
                              const float (&wu)[kRpl],
                              const float (&hi)[kRpl], float (&hj)[kRpl],
                              int lane) {
  float weight = 0.f;
  if (found) {
    weight = sigmoid<T>(d_sel);
    if (a.loss == 1)
      weight = rd<T>(rd<T>(weight * warp_factor<T>(a.n_item, first_k)) /
                     a.norm);
  } else {
#pragma unroll
    for (int q = 0; q < kRpl; ++q) hj[q] = 0.f;
  }
  float gu[kRpl], gp[kRpl], gn[kRpl];
  const float wp = rd<T>(-weight * hi_adj), wn = rd<T>(weight * hj_adj);
#pragma unroll
  for (int q = 0; q < kRpl; ++q) {
    if constexpr (kIsBf16<T>) {
      gu[q] = rsp::rbf(weight * rsp::rbf(rsp::rbf(hj_adj * hj[q]) -
                                         rsp::rbf(hi_adj * hi[q])));
      gp[q] = rsp::rbf(wp * wu[q]);
      gn[q] = rsp::rbf(wn * wu[q]);
    } else {
      gu[q] = weight * (hj_adj * hj[q] - hi_adj * hi[q]);
      gp[q] = -weight * hi_adj * wu[q];
      gn[q] = weight * hj_adj * wu[q];
    }
  }
  stage_entity<T>(a, 3 * s, u, gu, wu, found, lane);
  stage_entity<T>(a, 3 * s + 1, i, gp, hi, found && a.update_items, lane);
  stage_entity<T>(a, 3 * s + 2, j, gn, hj, found && a.update_items, lane);
}

// ---- candidates side by side (r <= RL <= 32) ---------------------------------

// out = the entity's combined embedding, all r values in this lane
// (float4 loads where float rows are 16-byte aligned).
template <int RL, typename T>
__device__ __forceinline__ void combine_whole(const T* emb,
                                              const FeatList<T>& fl, int id,
                                              int r, float (&out)[RL]) {
#pragma unroll
  for (int k = 0; k < RL; ++k) out[k] = 0.f;
  for (int l = 0; l < fl.count(); ++l) {
    int f;
    float x;
    if (!fl.at(id, l, &f, &x)) continue;
    const T* row = emb + (size_t)f * r;
    if (!kIsBf16<T> && (r & 3) == 0) {
#pragma unroll
      for (int k = 0; k < RL; k += 4) {
        if (k < r) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row + k));
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            out[k + q] = fl.idx ? out[k + q] + x * vv[q] : vv[q];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < RL; ++k)
        if (k < r) out[k] = fl.idx ? out[k] + x * ldg(row + k) : ldg(row + k);
    }
  }
  if constexpr (kIsBf16<T>) {
    if (fl.idx) {
#pragma unroll
      for (int k = 0; k < RL; ++k) out[k] = rsp::rbf(out[k]);
    }
  }
}

template <int RL, typename T>
__device__ __forceinline__ float dot_whole(const float (&u)[RL],
                                           const float (&v)[RL]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < RL; ++k) s += u[k] * v[k];
  return rd<T>(s);
}

// Whether item jc is in the user's hash set: its bucket's `lanes` entries.
__device__ __forceinline__ bool probe(const int* bucket0, unsigned hmask,
                                      unsigned hshift, int lanes, int jc) {
  const unsigned h = (unsigned)jc * kHashMult;
  const int* bucket = bucket0 + (size_t)((h >> hshift) & hmask) * lanes;
  bool member = false;
  if ((lanes & 3) == 0) {
    for (int q = 0; q < lanes; q += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(bucket + q));
      member |= v.x == jc || v.y == jc || v.z == jc || v.w == jc;
    }
  } else {
    for (int q = 0; q < lanes; ++q) member |= __ldg(bucket + q) == jc;
  }
  return member;
}

// d of a candidate, its acceptability (WARP: d + margin >= 0, the sum at
// the table dtype) and its sigmoid adjustment.
template <typename T>
__device__ __forceinline__ float cand_d(const RankMFArgs& a, bool sig,
                                        float r_uj, float r_ui, float rui_k,
                                        float* hja) {
  const float ruj_k = sig ? sigmoid<T>(r_uj) : r_uj;
  *hja = sig ? rd<T>(ruj_k * rd<T>(1.f - ruj_k)) : 1.f;
  return rd<T>(sig ? ruj_k - rui_k : r_uj - r_ui);
}

template <int RL, typename T>
__global__ void rankmf_samples_lanes(RankMFArgs a) {
  __shared__ int cnt[4];
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const T* W = reinterpret_cast<const T*>(a.W);
  const T* H = reinterpret_cast<const T*>(a.H);
  if (s < a.S) {  // s is the same on every lane of the warp
    const int r = a.r, K = a.K;
    const long long* bs = a.bits + (size_t)s * (K + 2);
    const int u = (int)((unsigned)bs[0] % (unsigned)a.n_user);
    const int nnz_u = a.row_nnz[u];
    const bool valid = nnz_u > 0;
    const unsigned pos_off = (unsigned)bs[1] % (unsigned)max(nnz_u, 1);
    long long pi = (long long)a.indptr[u] + pos_off;
    pi = pi < 0 ? 0 : (pi > a.flat_len - 1 ? a.flat_len - 1 : pi);
    const int i = a.flat_idx[pi];
    const FeatList<T> ufl = user_feats<T>(a), ifl = item_feats<T>(a);
    float wu[RL], hi[RL];
    combine_whole<RL, T>(W, ufl, u, r, wu);
    combine_whole<RL, T>(H, ifl, i, r, hi);
    float r_ui;
    if constexpr (kIsBf16<T>) {  // a sum of the rounded products
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < RL; ++k) t += rsp::rbf(wu[k] * hi[k]);
      r_ui = rsp::rbf(t);
    } else {
      r_ui = dot_whole<RL, T>(wu, hi);
    }
    const bool sig = a.kernel == 1;
    const float rui_k = sig ? sigmoid<T>(r_ui) : r_ui;
    const float hi_adj = sig ? rd<T>(rui_k * rd<T>(1.f - rui_k)) : 1.f;
    const int* bucket0 = a.table + (size_t)a.boff[u] * a.lanes;
    const unsigned hmask = (unsigned)a.bmask[u], hshift = (unsigned)a.bshift[u];

    bool found = false, auc_hit = false;
    int first_k = 0, j = 0;
    float d_sel = 0.f, hj_adj = 1.f;
    for (int k0 = 0, w = kWindow; k0 < K; k0 += w, w = 32) {
      const int k = k0 + lane;
      bool member = true, ok = false;
      int jc = 0;
      float d = 0.f, hja = 1.f;
      if (lane < w && k < K) {
        jc = (int)((unsigned)bs[2 + k] % (unsigned)a.n_item);
        member = probe(bucket0, hmask, hshift, a.lanes, jc);
        if (!member) {
          float hj[RL];
          combine_whole<RL, T>(H, ifl, jc, r, hj);
          const float r_uj = dot_whole<RL, T>(wu, hj);
          d = cand_d<T>(a, sig, r_uj, r_ui, rui_k, &hja);
          ok = a.loss == 0 || rd<T>(d + a.margin) >= 0.f;
        }
      }
      // AUC reads candidate 0 where it is not a positive
      if (k0 == 0)
        auc_hit = __shfl_sync(RSP_FULL_MASK, valid && !member && d < 0.f, 0);
      const unsigned m = __ballot_sync(RSP_FULL_MASK, ok);
      if (m) {
        const int f = __ffs(m) - 1;
        found = true;
        first_k = k0 + f;
        j = __shfl_sync(RSP_FULL_MASK, jc, f);
        d_sel = __shfl_sync(RSP_FULL_MASK, d, f);
        hj_adj = __shfl_sync(RSP_FULL_MASK, hja, f);
        break;
      }
    }
    found = found && valid;
    if (lane == 0) count(cnt, auc_hit, valid, found, first_k, K);
    // the update in lanes over the rank
    float wl[kRpl], hl[kRpl], jl[kRpl];
    combine<T>(W, ufl, u, r, lane, wl);
    combine<T>(H, ifl, i, r, lane, hl);
    if (found) combine<T>(H, ifl, j, r, lane, jl);
    finish_sample<T>(a, s, u, i, found, first_k, j, d_sel, hi_adj, hj_adj,
                     wl, hl, jl, lane);
  }
  __syncthreads();
  if (threadIdx.x < 4 && cnt[threadIdx.x] != 0)
    atomicAdd(a.counters + threadIdx.x, (unsigned long long)cnt[threadIdx.x]);
}

// ---- candidates one after another (r > 32) -----------------------------------

// One sample with lanes over the rank: each candidate's bucket, then its
// row, in turn.
template <typename T>
__device__ void sample_serial(const RankMFArgs& a, int s, int lane,
                              int* cnt) {
  const int r = a.r;
  const T* W = reinterpret_cast<const T*>(a.W);
  const T* H = reinterpret_cast<const T*>(a.H);
  const long long* bs = a.bits + (size_t)s * (a.K + 2);
  const int u = (int)((unsigned)bs[0] % (unsigned)a.n_user);
  const int nnz_u = a.row_nnz[u];
  const bool valid = nnz_u > 0;
  const unsigned pos_off = (unsigned)bs[1] % (unsigned)max(nnz_u, 1);
  long long pi = (long long)a.indptr[u] + pos_off;
  pi = pi < 0 ? 0 : (pi > a.flat_len - 1 ? a.flat_len - 1 : pi);
  const int i = a.flat_idx[pi];
  const FeatList<T> ufl = user_feats<T>(a), ifl = item_feats<T>(a);
  float wu[kRpl], hi[kRpl], hj[kRpl];
  combine<T>(W, ufl, u, r, lane, wu);
  combine<T>(H, ifl, i, r, lane, hi);
  const float r_ui = dot<T>(wu, hi, kIsBf16<T>);
  const bool sig = a.kernel == 1;
  const float rui_k = sig ? sigmoid<T>(r_ui) : r_ui;
  const float hi_adj = sig ? rd<T>(rui_k * rd<T>(1.f - rui_k)) : 1.f;

  const int* bucket0 = a.table + (size_t)a.boff[u] * a.lanes;
  const unsigned hmask = (unsigned)a.bmask[u], hshift = (unsigned)a.bshift[u];
  bool found = false, auc_hit = false;
  int first_k = 0, j = 0;
  float d_sel = 0.f, hj_adj = 1.f;
  for (int k = 0; k < a.K; ++k) {
    const int jc = (int)((unsigned)bs[2 + k] % (unsigned)a.n_item);
    const unsigned h = (unsigned)jc * kHashMult;
    const int* bucket = bucket0 + (size_t)((h >> hshift) & hmask) * a.lanes;
    const bool member = __any_sync(
        RSP_FULL_MASK, lane < a.lanes && bucket[lane] == jc);
    if (member) continue;  // not acceptable; AUC needs candidate 0 negative
    combine<T>(H, ifl, jc, r, lane, hj);
    const float r_uj = dot<T>(wu, hj, false);
    float hja;
    const float d = cand_d<T>(a, sig, r_uj, r_ui, rui_k, &hja);
    if (k == 0) auc_hit = valid && d < 0.f;
    if (a.loss == 0 || rd<T>(d + a.margin) >= 0.f) {
      found = true;
      first_k = k;
      j = jc;
      d_sel = d;
      hj_adj = hja;
      break;
    }
  }
  found = found && valid;
  if (lane == 0) count(cnt, auc_hit, valid, found, first_k, a.K);
  finish_sample<T>(a, s, u, i, found, first_k, j, d_sel, hi_adj, hj_adj, wu,
                   hi, hj, lane);
}

template <typename T>
__global__ void rankmf_samples(RankMFArgs a) {
  __shared__ int cnt[4];
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s < a.S) sample_serial<T>(a, s, lane, cnt);  // s is warp-uniform
  __syncthreads();
  if (threadIdx.x < 4 && cnt[threadIdx.x] != 0)
    atomicAdd(a.counters + threadIdx.x, (unsigned long long)cnt[threadIdx.x]);
}

// RMSprop: acc += (gamma - 1) old / duplicates + (1 - gamma) g^2, once per
// (entity, feature) of the batch.
__global__ void rankmf_rmsprop(RankMFArgs a) {
  const int F = old_stride(a), S3 = 3 * a.S;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)S3 * F) return;
  const int q = (int)(idx / F), l = (int)(idx % F);
  if (!a.iscratch[S3 + q]) return;
  const bool user = q % 3 == 0;
  const FeatList<float> fl =
      user ? user_feats<float>(a) : item_feats<float>(a);
  if (l >= fl.count()) return;
  int f;
  float x;
  if (!fl.at(a.iscratch[q], l, &f, &x)) return;
  float* acc = user ? a.accW : a.accH;
  const float* cnt = user ? a.cntW : a.cntH;
  const float* g2s = a.fscratch;
  const float* old = g2s + S3 + 2 * (size_t)S3 * a.r;
  const float delta = (a.gamma - 1.f) * old[(size_t)q * F + l] /
                          fmaxf(cnt[f], 1.f) +
                      (1.f - a.gamma) * g2s[q];
  atomicAdd(acc + f, delta);
}

// One warp per staged entity: -lr (grad / sqrt(acc + eps) + lambda comb)
// into each of its feature rows.
__global__ void rankmf_apply(RankMFArgs a) {
  const int lane = threadIdx.x & 31;
  const int S3 = 3 * a.S, r = a.r;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // launch A's counters are complete: the AUC denominator is at least 1
  if (q == 0 && lane == 0 && a.counters[1] == 0) a.counters[1] = 1;
  if (q >= S3 || !a.iscratch[S3 + q]) return;
  const int e = q % 3, id = a.iscratch[q];
  const FeatList<float> fl = e == 0 ? user_feats<float>(a)
                                    : item_feats<float>(a);
  float* emb = e == 0 ? a.W : a.H;
  const float* acc = e == 0 ? a.accW : a.accH;
  const float lam = e == 0 ? a.lam_u : (e == 1 ? a.lam_ip : a.lam_in);
  const float* grads = a.fscratch + S3;
  const float* combs = grads + (size_t)S3 * r;
  float g[kRpl], c[kRpl];
#pragma unroll
  for (int j = 0; j < kRpl; ++j) {
    const int k = lane + 32 * j;
    g[j] = k < r ? grads[(size_t)q * r + k] : 0.f;
    c[j] = k < r ? combs[(size_t)q * r + k] : 0.f;
  }
  for (int l = 0; l < fl.count(); ++l) {
    int f;
    float x;
    if (!fl.at(id, l, &f, &x)) continue;
    const float denom = sqrtf(acc[f] + kEps);
    float* row = emb + (size_t)f * r;
#pragma unroll
    for (int j = 0; j < kRpl; ++j) {
      const int k = lane + 32 * j;
      if (k < r) atomicAdd(row + k, -a.lr * (g[j] / denom + lam * c[j]));
    }
  }
}

// Launch W of the bf16 instance: one warp a table row, over one table's
// (row, update) pairs sorted stably by row (`keys` the rows, -1 for a
// pair that updates nothing, sorted first; `codes` q F + l: staged entity
// q = 3 s + e, feature slot l), at a position where the row's run begins.
// Its updates in order: the accumulator (one rounded add each), then every
// component (one rounded add each), as a bf16 scatter-add of bf16 updates.
__global__ void rankmf_walk(RankMFArgs a, const int* __restrict__ keys,
                            const int* __restrict__ codes, int n_pairs,
                            int user_side) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p == 0 && lane == 0 && user_side && a.counters[1] == 0)
    a.counters[1] = 1;
  if (p >= n_pairs) return;  // the whole warp
  const int f = keys[p];
  if (f < 0 || (p > 0 && keys[p - 1] == f)) return;
  int end = p + 1;
  while (end < n_pairs && keys[end] == f) ++end;
  const int S3 = 3 * a.S, r = a.r, F = old_stride(a);
  bf16_t* emb = reinterpret_cast<bf16_t*>(user_side ? a.W : a.H);
  bf16_t* accp = reinterpret_cast<bf16_t*>(user_side ? a.accW : a.accH);
  const float* g2s = a.fscratch;
  const float* grads = g2s + S3;
  const float* combs = grads + (size_t)S3 * r;
  float acc = ld(accp + f);
  if (a.optimizer == 0) {
    for (int t = p; t < end; ++t) acc = rsp::rbf(acc + g2s[codes[t] / F]);
  } else {
    float cnt = 0.f;
    for (int t = p; t < end; ++t) cnt = rsp::rbf(cnt + 1.f);
    const float n_dup = fmaxf(cnt, 1.f), old = acc;
    const float gm1 = rsp::rbf(a.gamma - 1.f), omg = rsp::rbf(1.f - a.gamma);
    const float od = rsp::rbf(rsp::rbf(gm1 * old) / n_dup);
    for (int t = p; t < end; ++t)
      acc = rsp::rbf(acc + rsp::rbf(od + rsp::rbf(omg * g2s[codes[t] / F])));
  }
  const float denom = rsp::rbf(sqrtf(rsp::rbf(acc + rsp::rbf(kEps))));
  if (lane == 0) accp[f] = __float2bfloat16_rn(acc);
  const float nlr = -a.lr;
  bf16_t* row = emb + (size_t)f * r;
  for (int k = lane; k < r; k += 32) {
    float w = ld(row + k);
    for (int t = p; t < end; ++t) {
      const int q = codes[t] / F, e = q % 3;
      const float lam = e == 0 ? a.lam_u : (e == 1 ? a.lam_ip : a.lam_in);
      const float step =
          rsp::rbf(rsp::rbf(grads[(size_t)q * r + k] / denom) +
                   rsp::rbf(lam * combs[(size_t)q * r + k]));
      w = rsp::rbf(w + rsp::rbf(nlr * step));
    }
    row[k] = __float2bfloat16_rn(w);
  }
}

template <typename T>
int launch_samples(const RankMFArgs& a, cudaStream_t st) {
  const dim3 grid((a.S + kWarps - 1) / kWarps), block(kWarps * 32);
  if (a.r <= 8) {
    rankmf_samples_lanes<8, T><<<grid, block, 0, st>>>(a);
  } else if (a.r <= 16) {
    rankmf_samples_lanes<16, T><<<grid, block, 0, st>>>(a);
  } else if (a.r <= 32) {
    rankmf_samples_lanes<32, T><<<grid, block, 0, st>>>(a);
  } else {
    rankmf_samples<T><<<grid, block, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch, counters and (RMSprop) the duplicate counts are allocated by
// the caller (_kernels.RankMFArgs), the duplicate counts zeroed; the
// counters are zeroed here.  `stages`: 2 runs the batch; 1 stops after
// launch A (the counters are left unclamped and the tables unchanged but
// AdaGrad's accumulators), so that chip_smoke.py times launch A apart.
// The bf16 instance (table_bf16) runs launch A here, whatever `stages`,
// and its launch W by rsp_rankmf_walk.
extern "C" int rsp_rankmf_batch(const RankMFArgs* args, int stages,
                                void* stream) {
  const RankMFArgs a = *args;
  if (a.S <= 0) return 0;
  if (a.r < 1 || a.r > kMaxR || a.K < 1 || a.n_user < 1 || a.n_item < 1 ||
      a.flat_len < 1 || a.lanes < 1 || a.lanes > 32 ||
      (stages != 1 && stages != 2) ||
      (!a.table_bf16 && a.optimizer == 1 &&
       (!a.cntW || (a.update_items && !a.cntH))) ||
      (!a.wmap != !a.hmap))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(a.counters, 0, 4 * sizeof(*a.counters), st);
  if (err != cudaSuccess) return (int)err;
  if (a.table_bf16) return launch_samples<bf16_t>(a, st);
  const int S3 = 3 * a.S;
  err = (cudaError_t)launch_samples<float>(a, st);
  if (err != cudaSuccess || stages == 1) return (int)err;
  if (a.optimizer == 1) {
    const long long n = (long long)S3 * old_stride(a);
    rankmf_rmsprop<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rankmf_apply<<<(S3 + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Launch W of the bf16 instance, after rsp_rankmf_batch: W's pairs
// (n_w of wkeys / wcodes), then H's (n_h), each sorted stably by table
// row in the reference's update order (launch W above).
extern "C" int rsp_rankmf_walk(const RankMFArgs* args, const int* wkeys,
                               const int* wcodes, int n_w, const int* hkeys,
                               const int* hcodes, int n_h, void* stream) {
  const RankMFArgs a = *args;
  if (a.S <= 0) return 0;
  if (!a.table_bf16 || n_w < 0 || n_h < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the W walk runs even without pairs: it clamps the AUC denominator
  const int grid_w = n_w > 0 ? (n_w + kWarps - 1) / kWarps : 1;
  rankmf_walk<<<grid_w, kWarps * 32, 0, st>>>(a, wkeys, wcodes, n_w, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_h == 0) return (int)err;
  rankmf_walk<<<(n_h + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      a, hkeys, hcodes, n_h, 0);
  return (int)cudaGetLastError();
}
