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
  int S, K, r, n_user, n_item, flat_len, lanes, Fu, Fi, loss, kernel,
      optimizer, update_items;
  float lr, gamma, lam_u, lam_ip, lam_in, margin, norm;
};

namespace {

struct FeatList {
  const int* idx;                 // null: identity features
  const float* val;
  const unsigned char* mask;
  int F;

  __device__ int count() const { return idx ? F : 1; }
  // The l-th feature of entity id: false at padding.
  __device__ bool at(int id, int l, int* f, float* x) const {
    if (!idx) {
      *f = id;
      *x = 1.f;
      return true;
    }
    const size_t q = (size_t)id * F + l;
    if (!mask[q]) return false;
    *f = idx[q];
    *x = val[q];
    return true;
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// out[j] = component lane + 32 j of the entity's combined embedding.
__device__ __forceinline__ void combine(const float* emb, const FeatList& fl,
                                        int id, int r, int lane,
                                        float (&out)[kRpl]) {
#pragma unroll
  for (int j = 0; j < kRpl; ++j) out[j] = 0.f;
  for (int l = 0; l < fl.count(); ++l) {
    int f;
    float x;
    if (!fl.at(id, l, &f, &x)) continue;
    const float* row = emb + (size_t)f * r;
#pragma unroll
    for (int j = 0; j < kRpl; ++j) {
      const int k = lane + 32 * j;
      if (k < r) out[j] = fl.idx ? out[j] + x * row[k] : row[k];
    }
  }
}

__device__ __forceinline__ float dot(const float (&a)[kRpl],
                                     const float (&b)[kRpl]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kRpl; ++j) s += a[j] * b[j];
  return rsp::warp_sum(s);
}

__device__ __forceinline__ FeatList user_feats(const RankMFArgs& a) {
  return FeatList{a.uf_idx, a.uf_val, a.uf_mask, a.Fu};
}
__device__ __forceinline__ FeatList item_feats(const RankMFArgs& a) {
  return FeatList{a.if_idx, a.if_val, a.if_mask, a.Fi};
}
// Features per entity in the RMSprop snapshot: max(Fu, Fi, 1).
__host__ __device__ __forceinline__ int old_stride(const RankMFArgs& a) {
  const int F = a.Fu > a.Fi ? a.Fu : a.Fi;
  return F > 1 ? F : 1;
}

// Write one entity's update to scratch (slot q = 3 s + e) and start its
// accumulator step.  Every lane of the warp calls it.
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
      sq += grad[j] * grad[j];
    }
  }
  const bool flag = enabled && __any_sync(RSP_FULL_MASK, nz);
  const float g2 = rsp::warp_sum(sq) / (float)r;
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
  const bool user = q % 3 == 0;
  const FeatList fl = user ? user_feats(a) : item_feats(a);
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

// The counters of one sample, into the CTA's sums (lane 0).
__device__ __forceinline__ void count(int* cnt, bool auc_hit, bool valid,
                                      bool found, int first_k, int K) {
  atomicAdd(cnt, (int)auc_hit);
  atomicAdd(cnt + 1, (int)valid);
  atomicAdd(cnt + 2, (int)found);
  atomicAdd(cnt + 3, found ? first_k + 1 : K);
}

// The gradients of a sample whose first acceptable candidate is found at
// first_k (j, d_sel, hj_adj), in lanes over the rank, staged to scratch.
__device__ void finish_sample(const RankMFArgs& a, int s, int u, int i,
                              bool found, int first_k, int j, float d_sel,
                              float hi_adj, float hj_adj,
                              const float (&wu)[kRpl],
                              const float (&hi)[kRpl], float (&hj)[kRpl],
                              int lane) {
  float weight = 0.f;
  if (found) {
    weight = sigmoid(d_sel);
    if (a.loss == 1)
      weight = weight *
               log1pf((float)(a.n_item - 1) / (float)(first_k + 1) + 1.f) /
               a.norm;
  } else {
#pragma unroll
    for (int q = 0; q < kRpl; ++q) hj[q] = 0.f;
  }
  float gu[kRpl], gp[kRpl], gn[kRpl];
#pragma unroll
  for (int q = 0; q < kRpl; ++q) {
    gu[q] = weight * (hj_adj * hj[q] - hi_adj * hi[q]);
    gp[q] = -weight * hi_adj * wu[q];
    gn[q] = weight * hj_adj * wu[q];
  }
  stage_entity(a, 3 * s, u, gu, wu, found, lane);
  stage_entity(a, 3 * s + 1, i, gp, hi, found && a.update_items, lane);
  stage_entity(a, 3 * s + 2, j, gn, hj, found && a.update_items, lane);
}

// ---- candidates side by side (r <= RL <= 32) ---------------------------------

// out = the entity's combined embedding, all r values in this lane
// (float4 loads where rows are 16-byte aligned).
template <int RL>
__device__ __forceinline__ void combine_whole(const float* emb,
                                              const FeatList& fl, int id,
                                              int r, float (&out)[RL]) {
#pragma unroll
  for (int k = 0; k < RL; ++k) out[k] = 0.f;
  for (int l = 0; l < fl.count(); ++l) {
    int f;
    float x;
    if (!fl.at(id, l, &f, &x)) continue;
    const float* row = emb + (size_t)f * r;
    if ((r & 3) == 0) {
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
        if (k < r) out[k] = fl.idx ? out[k] + x * __ldg(row + k) : __ldg(row + k);
    }
  }
}

template <int RL>
__device__ __forceinline__ float dot_whole(const float (&u)[RL],
                                           const float (&v)[RL]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < RL; ++k) s += u[k] * v[k];
  return s;
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

template <int RL>
__global__ void rankmf_samples_lanes(RankMFArgs a) {
  __shared__ int cnt[4];
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
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
    const FeatList ufl = user_feats(a), ifl = item_feats(a);
    float wu[RL], hi[RL];
    combine_whole<RL>(a.W, ufl, u, r, wu);
    combine_whole<RL>(a.H, ifl, i, r, hi);
    const float r_ui = dot_whole<RL>(wu, hi);
    const bool sig = a.kernel == 1;
    const float rui_k = sig ? sigmoid(r_ui) : r_ui;
    const float hi_adj = sig ? rui_k * (1.f - rui_k) : 1.f;
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
          combine_whole<RL>(a.H, ifl, jc, r, hj);
          const float r_uj = dot_whole<RL>(wu, hj);
          const float ruj_k = sig ? sigmoid(r_uj) : r_uj;
          d = sig ? ruj_k - rui_k : r_uj - r_ui;
          hja = sig ? ruj_k * (1.f - ruj_k) : 1.f;
          ok = a.loss == 0 || d + a.margin >= 0.f;
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
    combine(a.W, ufl, u, r, lane, wl);
    combine(a.H, ifl, i, r, lane, hl);
    if (found) combine(a.H, ifl, j, r, lane, jl);
    finish_sample(a, s, u, i, found, first_k, j, d_sel, hi_adj, hj_adj, wl,
                  hl, jl, lane);
  }
  __syncthreads();
  if (threadIdx.x < 4 && cnt[threadIdx.x] != 0)
    atomicAdd(a.counters + threadIdx.x, (unsigned long long)cnt[threadIdx.x]);
}

// ---- candidates one after another (r > 32) -----------------------------------

// One sample with lanes over the rank: each candidate's bucket, then its
// row, in turn.
__device__ void sample_serial(const RankMFArgs& a, int s, int lane,
                              int* cnt) {
  const int r = a.r;
  const long long* bs = a.bits + (size_t)s * (a.K + 2);
  const int u = (int)((unsigned)bs[0] % (unsigned)a.n_user);
  const int nnz_u = a.row_nnz[u];
  const bool valid = nnz_u > 0;
  const unsigned pos_off = (unsigned)bs[1] % (unsigned)max(nnz_u, 1);
  long long pi = (long long)a.indptr[u] + pos_off;
  pi = pi < 0 ? 0 : (pi > a.flat_len - 1 ? a.flat_len - 1 : pi);
  const int i = a.flat_idx[pi];
  const FeatList ufl = user_feats(a), ifl = item_feats(a);
  float wu[kRpl], hi[kRpl], hj[kRpl];
  combine(a.W, ufl, u, r, lane, wu);
  combine(a.H, ifl, i, r, lane, hi);
  const float r_ui = dot(wu, hi);
  const bool sig = a.kernel == 1;
  const float rui_k = sig ? sigmoid(r_ui) : r_ui;
  const float hi_adj = sig ? rui_k * (1.f - rui_k) : 1.f;

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
    combine(a.H, ifl, jc, r, lane, hj);
    const float r_uj = dot(wu, hj);
    const float ruj_k = sig ? sigmoid(r_uj) : r_uj;
    const float d = sig ? ruj_k - rui_k : r_uj - r_ui;
    if (k == 0) auc_hit = valid && d < 0.f;
    if (a.loss == 0 || d + a.margin >= 0.f) {
      found = true;
      first_k = k;
      j = jc;
      d_sel = d;
      hj_adj = sig ? ruj_k * (1.f - ruj_k) : 1.f;
      break;
    }
  }
  found = found && valid;
  if (lane == 0) count(cnt, auc_hit, valid, found, first_k, a.K);
  finish_sample(a, s, u, i, found, first_k, j, d_sel, hi_adj, hj_adj, wu, hi,
                hj, lane);
}

__global__ void rankmf_samples(RankMFArgs a) {
  __shared__ int cnt[4];
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s < a.S) sample_serial(a, s, lane, cnt);  // s is warp-uniform
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
  const FeatList fl = user ? user_feats(a) : item_feats(a);
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
  const FeatList fl = e == 0 ? user_feats(a) : item_feats(a);
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

}  // namespace

// Scratch, counters and (RMSprop) the duplicate counts are allocated by
// the caller (_kernels.RankMFArgs), the duplicate counts zeroed; the
// counters are zeroed here.  `stages`: 2 runs the batch; 1 stops after
// launch A (the counters are left unclamped and the tables unchanged but
// AdaGrad's accumulators), so that chip_smoke.py times launch A apart.
extern "C" int rsp_rankmf_batch(const RankMFArgs* args, int stages,
                                void* stream) {
  const RankMFArgs a = *args;
  if (a.S <= 0) return 0;
  if (a.r < 1 || a.r > kMaxR || a.K < 1 || a.n_user < 1 || a.n_item < 1 ||
      a.flat_len < 1 || a.lanes < 1 || a.lanes > 32 ||
      (stages != 1 && stages != 2) ||
      (a.optimizer == 1 && (!a.cntW || (a.update_items && !a.cntH))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(a.counters, 0, 4 * sizeof(*a.counters), st);
  if (err != cudaSuccess) return (int)err;
  const int S3 = 3 * a.S;
  const dim3 grid((a.S + kWarps - 1) / kWarps), block(kWarps * 32);
  if (a.r <= 8) {
    rankmf_samples_lanes<8><<<grid, block, 0, st>>>(a);
  } else if (a.r <= 16) {
    rankmf_samples_lanes<16><<<grid, block, 0, st>>>(a);
  } else if (a.r <= 32) {
    rankmf_samples_lanes<32><<<grid, block, 0, st>>>(a);
  } else {
    rankmf_samples<<<grid, block, 0, st>>>(a);
  }
  err = cudaGetLastError();
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
