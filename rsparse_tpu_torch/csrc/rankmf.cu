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
// leaves the accumulators alone and two launches replace A2 and B, with
// no host work between them.  Launch A writes each update's table row
// (-1 where it changes nothing) at its rank in the JAX scatter's update
// order, one list a table (W: sample, feature slot; H: the positives'
// updates, then the negatives'); launch G sorts each table's list stably
// by row on the device (one CTA a chunk of up to 16,384 pairs: a radix
// sort in shared memory over only the row bits the chunk needs) and
// compacts the starts of its runs; launch W walks the runs, a group of
// lanes a row (several rows a warp at r <= 16), its updates in that order:
// the accumulator first (AdaGrad: acc += g^2 / r per update; RMSprop: the
// duplicate count, then acc += (gamma - 1) old / count + (1 - gamma) g^2
// per update, old the batch-start value), then each component of the row,
// one rounded add an update.  A table of more than one chunk (item
// features) has each row walked by its first chunk's run, which looks up
// the row's runs in the later chunks.  No atomics: the bf16 batch gives
// the same tables every run.

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
  int* gscratch;                  // bf16: rsp_rankmf_group_ints ints
  int S, K, r, n_user, n_item, flat_len, lanes, Fu, Fi, loss, kernel,
      optimizer, update_items;
  int table_bf16;                 // W, H, accW, accH, feature values bf16
  int n_wrows, n_hrows;           // rows of W and H (bf16: the sort's keys)
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

// The bf16 instance's pair lists in gscratch (ints): each table's pairs
// in the reference's update order, W's S Fw (sample, feature slot), then
// H's 2 S Fh (the positives' (sample, slot), then the negatives'); launch
// A writes each pair's table row (-1: it updates nothing) into keys; the
// group launch sorts each chunk of up to kChunk pairs of a table by row
// into skey / sval (row, update rank) and lists where its runs of one row
// start (runs: kChunk + 1 a chunk, the last entry the chunk's valid pairs;
// nruns: the runs a chunk).
constexpr int kSortThreads = 1024;
constexpr int kChunk = 16 * kSortThreads;
struct GroupLayout {
  int nW, nH, chW, chH;
  long long keys, skey, sval, runs, nruns, total;
};
__host__ __device__ __forceinline__ GroupLayout group_layout(
    int S, int Fu, int Fi, int update_items) {
  GroupLayout L;
  L.nW = S * (Fu > 0 ? Fu : 1);
  L.nH = update_items ? 2 * S * (Fi > 0 ? Fi : 1) : 0;
  L.chW = (L.nW + kChunk - 1) / kChunk;
  L.chH = (L.nH + kChunk - 1) / kChunk;
  const long long n = (long long)L.nW + L.nH;
  L.keys = 0;
  L.skey = n;
  L.sval = 2 * n;
  L.runs = 3 * n;
  L.nruns = L.runs + (long long)(L.chW + L.chH) * (kChunk + 1);
  L.total = L.nruns + L.chW + L.chH;
  return L;
}
__host__ __device__ __forceinline__ GroupLayout group_layout(
    const RankMFArgs& a) {
  return group_layout(a.S, a.Fu, a.Fi, a.update_items);
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
  if constexpr (kIsBf16<T>) {
    // the entity's pairs: its table row at each feature slot, at its
    // update rank (the reference's scatter order)
    const int e = q % 3, s = q / 3;
    if (e == 0 || a.update_items) {
      const FeatList<T> fl = e == 0 ? user_feats<T>(a) : item_feats<T>(a);
      const int Fe = fl.count();
      const GroupLayout L = group_layout(a);
      int* keys = a.gscratch + L.keys +
                  (e == 0 ? 0 : L.nW + (size_t)(e - 1) * a.S * Fe) +
                  (size_t)s * Fe;
      for (int l = lane; l < Fe; l += 32) {
        int f;
        float x;
        keys[l] = flag && fl.at(id, l, &f, &x) ? f : -1;
      }
    }
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

// ---- the bf16 instance's ordered scatter -----------------------------------

// Launch G's radix sort: 8 bits a pass; a warp holds 512 consecutive
// pairs, lane l its pairs 32 j + l (j < 16), so (j, l) is their order.
constexpr int kItems = kChunk / kSortThreads;  // pairs a thread
constexpr int kWarpsG = kSortThreads / 32;
constexpr int kHistLd = kWarpsG + 1;           // hist[d * kHistLd + warp]
constexpr size_t kGroupSmem =
    (size_t)(2 * kChunk + 256 * kHistLd) * sizeof(unsigned);
static_assert(kGroupSmem <= 232448, "one CTA's shared memory");
static_assert(kWarpsG == 32, "block_scan and the warp offsets take 32 warps");

// Exclusive scan of v over the block (kSortThreads threads); *total gets
// the sum.  Two barriers; every thread calls it.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* wsum,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(RSP_FULL_MASK, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned w = wsum[lane], wi = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(RSP_FULL_MASK, wi, o);
    if (lane >= o) wi += t;
  }
  const unsigned before = __shfl_sync(RSP_FULL_MASK, wi - w, warp);
  *total = __shfl_sync(RSP_FULL_MASK, wi, 31);
  __syncthreads();  // wsum may be written by the next call
  return before + incl - v;
}

// Launch G: one CTA a chunk of up to kChunk pairs of one table (the
// chunks of W, then those of H).  A stable LSD radix sort of the chunk's
// table rows, 8 bits a pass over only the bits its largest row needs (a
// pair that updates nothing sorts last), in shared memory.  Per pass each
// warp ranks its pairs among its own by digit (the lanes with the same
// digit found by 8 ballots, in (j, lane) order), the warps' digit counts
// are scanned digit-major (digit, warp), and each pair goes to its
// digit's offset plus its rank, so equal rows keep their update order.
// Writes the sorted (row, update rank) and the starts of the chunk's runs
// in order.
__global__ void __launch_bounds__(kSortThreads, 1)
    rankmf_group(RankMFArgs a) {
  extern __shared__ unsigned gsm[];
  __shared__ unsigned wsum[32];
  const GroupLayout L = group_layout(a);
  const int cg = blockIdx.x;
  const bool hside = cg >= L.chW;
  const int c = hside ? cg - L.chW : cg;
  const int n_t = hside ? L.nH : L.nW;
  const long long off = (hside ? L.nW : 0) + (long long)c * kChunk;
  const int len = min(kChunk, n_t - c * kChunk);
  unsigned* skeys = gsm;
  unsigned* svals = gsm + kChunk;
  unsigned* hist = gsm + 2 * kChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int p0 = warp * 32 * kItems + lane;  // pair j at p0 + 32 j
  const int* keys = a.gscratch + L.keys + off;
  unsigned k[kItems], v[kItems];
  unsigned mx = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = p0 + 32 * j;
    const int key = i < len ? keys[i] : -1;
    k[j] = key < 0 ? 0xffffffffu : (unsigned)key;
    v[j] = (unsigned)(c * kChunk + i);
    if (key >= 0 && (unsigned)key > mx) mx = key;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = max(mx, __shfl_xor_sync(RSP_FULL_MASK, mx, o));
  if (lane == 0) wsum[warp] = mx;
  __syncthreads();
  mx = wsum[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = max(mx, __shfl_xor_sync(RSP_FULL_MASK, mx, o));
  __syncthreads();
  // rows < 2^bits - 1: the sentinel's low bits sort after every row's
  const int bits = 32 - __clz(mx + 1);
  for (int shift = 0; shift < bits; shift += 8) {
    for (int i = tid; i < 256 * kHistLd; i += kSortThreads) hist[i] = 0;
    __syncthreads();
    unsigned rk[kItems / 2];  // two 16-bit ranks a word
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned d = (k[j] >> shift) & 255u;
      unsigned peers = RSP_FULL_MASK;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const unsigned m = __ballot_sync(RSP_FULL_MASK, (d >> b) & 1u);
        peers &= (d >> b) & 1u ? m : ~m;
      }
      unsigned* h = hist + d * kHistLd + warp;
      const unsigned before = __popc(peers & lt);
      const unsigned rank = *h + before;
      __syncwarp();
      if (before == 0) *h = rank + __popc(peers);
      __syncwarp();
      if (j & 1)
        rk[j >> 1] |= rank << 16;
      else
        rk[j >> 1] = rank;
    }
    __syncthreads();
    // exclusive scan of the counts in (digit, warp) order: thread t takes
    // the 8 counts from 8 t
    unsigned sum = 0, total;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = 8 * tid + q;
      sum += hist[(i >> 5) * kHistLd + (i & 31)];
    }
    unsigned run = block_scan(sum, wsum, &total);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = 8 * tid + q;
      unsigned* h = hist + (i >> 5) * kHistLd + (i & 31);
      const unsigned cq = *h;
      *h = run;
      run += cq;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned d = (k[j] >> shift) & 255u;
      const unsigned p = hist[d * kHistLd + warp] +
                         ((rk[j >> 1] >> (16 * (j & 1))) & 0xffffu);
      skeys[p] = k[j];
      svals[p] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = skeys[p0 + 32 * j];
      v[j] = svals[p0 + 32 * j];
    }
    __syncthreads();
  }
  // the sorted pairs, and the runs' starts in position order: the warp's
  // positions run j-major, so a start's place is the starts before it in
  // earlier warps, in earlier j of this warp, and in lower lanes
  unsigned* gk = reinterpret_cast<unsigned*>(a.gscratch + L.skey + off);
  int* gv = a.gscratch + L.sval + off;
  unsigned hbits = 0, starts = 0, valid = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = p0 + 32 * j;
    const unsigned prev = i > 0 ? skeys[i - 1] : 0xffffffffu;
    const bool ok = i < len && k[j] != 0xffffffffu;
    const bool head = ok && k[j] != prev;
    hbits |= (unsigned)head << j;
    starts += __popc(__ballot_sync(RSP_FULL_MASK, head));
    valid += ok;
    if (i < len) {
      gk[i] = k[j];
      gv[i] = (int)v[j];
    }
  }
  unsigned n_runs, n_valid;
  // each warp's starts, one value a warp (its lane 0), scanned over warps
  unsigned at = block_scan(lane == 0 ? starts : 0u, wsum, &n_runs);
  at = __shfl_sync(RSP_FULL_MASK, at, 0);
  block_scan(valid, wsum, &n_valid);
  int* runs = a.gscratch + L.runs + (long long)cg * (kChunk + 1);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool head = (hbits >> j) & 1u;
    const unsigned b = __ballot_sync(RSP_FULL_MASK, head);
    if (head) runs[at + __popc(b & lt)] = p0 + 32 * j;
    at += __popc(b);
  }
  if (tid == 0) {
    runs[n_runs] = (int)n_valid;
    a.gscratch[L.nruns + cg] = (int)n_runs;
  }
}

// The first position in a sorted chunk of n rows whose row is >= f.
__device__ __forceinline__ int lower_bound(const unsigned* p, int n,
                                           unsigned f) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p[mid] < f)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Launch W: a group of G lanes a run of one row (G = 8 at r <= 8, 16 at r
// <= 16, else a warp), over the compacted run list of one chunk, a slice of
// kWalkRuns(G) runs a CTA.  A row whose pairs also lie in other chunks of
// its table is walked by its run in the first of them: the group's lanes
// look the row up in the other chunks side by side.  Its updates in
// order: the accumulator (one rounded add each), then every component
// (one rounded add each), as a bf16 scatter-add of bf16 updates.
constexpr int kWalkThreads = 256;
template <int G>
constexpr int kWalkRuns = 2 * kWalkThreads / G;

template <int G>
__global__ void __launch_bounds__(kWalkThreads)
    rankmf_walk(RankMFArgs a) {
  const GroupLayout L = group_layout(a);
  const int cg = blockIdx.x;
  if (cg == 0 && blockIdx.y == 0 && threadIdx.x == 0 && a.counters[1] == 0)
    a.counters[1] = 1;  // launch A's counters are complete
  const int n_runs = a.gscratch[L.nruns + cg];
  const int r0 = blockIdx.y * kWalkRuns<G>;
  if (r0 >= n_runs) return;  // the whole CTA
  const bool hside = cg >= L.chW;
  const int c = hside ? cg - L.chW : cg;
  const int nch = hside ? L.chH : L.chW, n_t = hside ? L.nH : L.nW;
  const long long tbase = hside ? L.nW : 0;
  const unsigned* skey =
      reinterpret_cast<const unsigned*>(a.gscratch + L.skey + tbase);
  const int* sval = a.gscratch + L.sval + tbase;
  const int* runs = a.gscratch + L.runs + (long long)cg * (kChunk + 1);
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int gbase = lane - gl;
  const unsigned gmask =
      G == 32 ? RSP_FULL_MASK : (((1u << G) - 1) << gbase);
  const int S = a.S, S3 = 3 * S, r = a.r;
  const int Fe = hside ? (a.Fi > 0 ? a.Fi : 1) : (a.Fu > 0 ? a.Fu : 1);
  const int half = S * Fe;
  bf16_t* emb = reinterpret_cast<bf16_t*>(hside ? a.H : a.W);
  bf16_t* accp = reinterpret_cast<bf16_t*>(hside ? a.accH : a.accW);
  const float* g2s = a.fscratch;
  const float* grads = g2s + S3;
  const float* combs = grads + (size_t)S3 * r;
  const int r1 = min(r0 + kWalkRuns<G>, n_runs);
  for (int ri = r0 + (int)threadIdx.x / G; ri < r1;
       ri += kWalkThreads / G) {
    const int start = runs[ri], end = runs[ri + 1];
    const unsigned f = skey[(long long)c * kChunk + start];
    // the row in the table's other chunks: lane gl looks in chunks gl,
    // gl + G, ...; it keeps where the row starts in chunk gl
    int lo_own = 0;
    if (nch > 1) {
      bool earlier = false;
      for (int c2 = gl; c2 < nch; c2 += G) {
        if (c2 == c) continue;
        const int n2 = min(kChunk, n_t - c2 * kChunk);
        const unsigned* k2 = skey + (long long)c2 * kChunk;
        const int lo = lower_bound(k2, n2, f);
        if (c2 == gl) lo_own = lo;
        earlier |= c2 < c && lo < n2 && k2[lo] == f;
      }
      if (__any_sync(gmask, earlier)) continue;
    }
    // every update of the row in order: this chunk's run, then the later
    // chunks' runs of the same row
    auto for_each = [&](auto&& fn) {
      for (int t = start; t < end; ++t) fn(sval[(long long)c * kChunk + t]);
      for (int c2 = c + 1; c2 < nch; ++c2) {
        const int n2 = min(kChunk, n_t - c2 * kChunk);
        const unsigned* k2 = skey + (long long)c2 * kChunk;
        int t = c2 < G ? __shfl_sync(gmask, lo_own, gbase + c2)
                       : lower_bound(k2, n2, f);
        for (; t < n2 && k2[t] == f; ++t)
          fn(sval[(long long)c2 * kChunk + t]);
      }
    };
    // the staged entity q = 3 s + e of update rank p
    auto entity = [&](int p) {
      if (!hside) return 3 * (p / Fe);
      const int e = p < half ? 1 : 2;
      return 3 * ((p - (e - 1) * half) / Fe) + e;
    };
    float acc = ld(accp + f);
    if (a.optimizer == 0) {
      for_each([&](int p) { acc = rsp::rbf(acc + g2s[entity(p)]); });
    } else {
      float cnt = 0.f;
      for_each([&](int) { cnt = rsp::rbf(cnt + 1.f); });
      const float n_dup = fmaxf(cnt, 1.f), old = acc;
      const float gm1 = rsp::rbf(a.gamma - 1.f), omg = rsp::rbf(1.f - a.gamma);
      const float od = rsp::rbf(rsp::rbf(gm1 * old) / n_dup);
      for_each([&](int p) {
        acc = rsp::rbf(acc + rsp::rbf(od + rsp::rbf(omg * g2s[entity(p)])));
      });
    }
    const float denom = rsp::rbf(sqrtf(rsp::rbf(acc + rsp::rbf(kEps))));
    if (gl == 0) accp[f] = __float2bfloat16_rn(acc);
    const float nlr = -a.lr;
    bf16_t* row = emb + (size_t)f * r;
    // (the group's lanes stay together: for_each may exchange among them)
    for (int k0 = 0; k0 < r; k0 += G) {
      const int k = k0 + gl;
      const bool on = k < r;
      float w = on ? ld(row + k) : 0.f;
      for_each([&](int p) {
        if (!on) return;
        const int q = entity(p), e = q % 3;
        const float lam = e == 0 ? a.lam_u : (e == 1 ? a.lam_ip : a.lam_in);
        const float step =
            rsp::rbf(rsp::rbf(grads[(size_t)q * r + k] / denom) +
                     rsp::rbf(lam * combs[(size_t)q * r + k]));
        w = rsp::rbf(w + rsp::rbf(nlr * step));
      });
      if (on) row[k] = __float2bfloat16_rn(w);
    }
  }
}

template <int G>
int launch_walk(const RankMFArgs& a, const GroupLayout& L, cudaStream_t st) {
  const dim3 grid(L.chW + L.chH, (kChunk + kWalkRuns<G> - 1) / kWalkRuns<G>);
  rankmf_walk<G><<<grid, kWalkThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Launches G and W of the bf16 instance, after launch A.
int launch_group_walk(const RankMFArgs& a, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rankmf_group, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kGroupSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const GroupLayout L = group_layout(a);
  rankmf_group<<<L.chW + L.chH, kSortThreads, kGroupSmem, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return a.r <= 8    ? launch_walk<8>(a, L, st)
         : a.r <= 16 ? launch_walk<16>(a, L, st)
                     : launch_walk<32>(a, L, st);
}

}  // namespace

// Scratch, counters and (RMSprop) the duplicate counts are allocated by
// the caller (_kernels.RankMFArgs), the duplicate counts zeroed; the
// counters are zeroed here.  `stages`: 2 runs the batch; 1 stops after
// launch A (the counters are left unclamped and the tables unchanged but
// the float32 instance's AdaGrad accumulators), so that chip_smoke.py
// times launch A apart.  The bf16 instance (table_bf16) runs launch A,
// the group launch and launch W: three launches and the counters' memset,
// no host work between them.
extern "C" int rsp_rankmf_batch(const RankMFArgs* args, int stages,
                                void* stream) {
  const RankMFArgs a = *args;
  if (a.S <= 0) return 0;
  if (a.r < 1 || a.r > kMaxR || a.K < 1 || a.n_user < 1 || a.n_item < 1 ||
      a.flat_len < 1 || a.lanes < 1 || a.lanes > 32 ||
      (stages != 1 && stages != 2) ||
      (!a.table_bf16 && a.optimizer == 1 &&
       (!a.cntW || (a.update_items && !a.cntH))) ||
      (a.table_bf16 && (!a.gscratch || a.n_wrows < 1 ||
                        (a.update_items && a.n_hrows < 1))) ||
      (!a.wmap != !a.hmap))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(a.counters, 0, 4 * sizeof(*a.counters), st);
  if (err != cudaSuccess) return (int)err;
  if (a.table_bf16) {
    err = (cudaError_t)launch_samples<bf16_t>(a, st);
    if (err != cudaSuccess || stages == 1) return (int)err;
    return launch_group_walk(a, st);
  }
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

// Ints of the bf16 instance's gscratch (its pair lists, sorted lists and
// runs) for S samples with Fu / Fi feature slots (0: identity).
extern "C" long long rsp_rankmf_group_ints(int S, int Fu, int Fi,
                                           int update_items) {
  return group_layout(S, Fu, Fi, update_items).total;
}
