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
//   A  one warp per sample, lanes over the rank: decode the user, the
//      positive and the K candidates from the raw bits (%, as :226-237),
//      combine the embeddings, probe the user's hash bucket (one lane per
//      bucket lane, (h >> shift) & mask), score candidates in order until
//      the first acceptable one (BPR: not a positive; WARP: also
//      d + margin >= 0), the WARP rank weight log1p((n_item - 1)/(k + 1) +
//      1) / log1p(n_item + 1), the AUC counters, and the gradients of the
//      user, the positive and the negative; write them and the combined
//      embeddings to scratch; AdaGrad adds g^2 / r into the accumulators
//      with atomics; RMSprop instead counts duplicates and keeps each
//      feature's batch-start accumulator in scratch;
//   A2 (RMSprop) one thread per (entity, feature): add the EMA delta;
//   B  one warp per entity: step = grad / sqrt(acc + eps) + lambda comb,
//      added as -lr step into every feature row of the entity with atomics.
// A thread never reads an accumulator or a table that another thread of
// the same launch adds to.  The positive and negative item updates share
// launch B and its accumulators, as at :339-345.
//
// What bounds it on the H100: bytes and latency.  Per sample it reads up to
// K + 2 embedding rows (r floats each) and K hash buckets at random
// addresses, a chain of dependent loads (the hash row, then the next
// candidate), and does ~4 r (K + 3) flops.  What the design does about it:
// candidates stop at the first acceptable one (their scores are needed no
// further, as in the reference's rejection loop); one warp per sample
// keeps S = 8192 samples in flight at once; members of the positive set
// skip the score entirely.  The atomic sums over duplicate features add in
// an order that changes from run to run (f32 rounding).

#include "common.cuh"

namespace {

constexpr int kMaxR = 128;          // widest embedding (MAX_RANK)
constexpr int kRpl = kMaxR / 32;    // components a lane holds
constexpr int kWarps = 8;           // warps per CTA
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
  int* counters;                  // (4,) zeroed: auc_num, valid, found,
                                  // tried
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

__global__ void rankmf_samples(RankMFArgs a) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= a.S) return;  // s is the same on every lane of the warp
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
  if (lane == 0) {
    atomicAdd(a.counters, (int)auc_hit);
    atomicAdd(a.counters + 1, (int)valid);
    atomicAdd(a.counters + 2, (int)found);
    atomicAdd(a.counters + 3, found ? first_k + 1 : a.K);
  }
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

// Scratch, counters and (RMSprop) the duplicate counts are allocated and
// zeroed by the caller (_kernels.RankMFArgs).
extern "C" int rsp_rankmf_batch(const RankMFArgs* args, void* stream) {
  const RankMFArgs a = *args;
  if (a.S <= 0) return 0;
  if (a.r < 1 || a.r > kMaxR || a.K < 1 || a.n_user < 1 || a.n_item < 1 ||
      a.flat_len < 1 || a.lanes < 1 || a.lanes > 32 ||
      (a.optimizer == 1 && (!a.cntW || (a.update_items && !a.cntH))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int S3 = 3 * a.S;
  rankmf_samples<<<(a.S + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.optimizer == 1) {
    const long long n = (long long)S3 * old_stride(a);
    rankmf_rmsprop<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rankmf_apply<<<(S3 + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}
