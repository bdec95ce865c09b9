// K11: one GloVe dense head tile.
//
// Replaces the TPU program rsparse_tpu/models/glove.py:206
// _glove_dense_step_impl (one scan step: one tile).  Its plain PyTorch
// version is rsparse_tpu_torch/models/glove.py _glove_tile_plain.
//
// A tile is the counts X of n_r hot row ids by n_c hot column ids (0 =
// absent), exactly one shard of its present triplets: with S = w_i[rows]
// w_j[cols]' + b_i + b_j - log X clipped at +-100, weight (X / x_max)^alpha
// below x_max (0 where absent) and cost = weight * S, each side's
// accumulator-first AdaGrad step needs, per position, the row (column)
// sums of cost w_j (cost' w_i), cost^2 w_j^2 (cost^2' w_i^2), cost and
// cost^2: four products of the (n_r, n_c) cost grid with an (n, r) factor
// block beside S itself.  With the bf16 head (bf16 != 0) X is stored as
// bf16 and w_i, w_j, S, cost = bf16(bf16(weight) S_c), cost^2 and w^2 are
// rounded to bf16 where the reference rounds them
// (rsparse_tpu/models/glove.py:247-283); every product and sum accumulates
// in f32.
//
// Two launches, written by hand (no library product):
//   A  grid (own blocks, chunks, 2 sides).  A CTA owns kO positions of one
//      side (z = 0: rows, z = 1: columns) and walks one chunk of the other
//      side in steps of kN positions.  Per step it loads the kN factor rows
//      and the kO x kN counts into shared memory, computes its S block with
//      an FMA loop over r, turns it into the cost block on chip (never
//      written to device memory), and adds cost @ w_oth and cost^2 @ w_oth^2
//      into its own positions' sums, kept in registers across the steps.
//      S, and so the cost, is computed once by each side (6 products for
//      the tile's 5): no CTA has to add into another's sums, so there are
//      no atomics, and a chunk writes its partial sums once.  The loss sum
//      cost * S comes from the row side, one partial per CTA;
//   B  one thread per (side, position, component): the partials of all
//      chunks summed in a fixed order, then acc += sum cost^2 w^2, w +=
//      -lr sum cost w / sqrt(acc) (the same for the biases), for the
//      tile's own positions (distinct hot ids: no race); thread 0 sums the
//      loss partials.  Both launches are deterministic.
//
// What bounds it on the H100: operations.  At config #4 a tile is 3,063 x
// 3,063 x r = 128: 12.0 GFLOP for the five products against ~19 MB of
// bf16 counts, far above the card's ~295 flops a byte in bf16 and ~20 in
// f32.  This first version runs on the f32 FMA units (a 2 x 4 micro-tile a
// thread for S, 4 x 4 x 2 for the products, operands from shared memory);
// wgmma on bf16 operands is later work.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float kClip = 100.f;
constexpr int kMaxR = 128;          // widest embedding (models/glove.py MAX_RANK)
constexpr int kO = 32;              // own positions per CTA
constexpr int kN = 64;              // other positions per step
constexpr int kThreads = 256;
constexpr int kLd = kMaxR + 1;      // shared stride of a factor row (odd)
constexpr int kLdc = kN + 1;        // shared stride of a cost row

struct Smem {
  float own[kO * kLd];
  float oth[kN * kLd];
  float cost[kO * kLdc];            // counts, then bf16-rounded cost
  float c2[kO * kLdc];
  float b_own[kO];
  float b_oth[kN];
  float red[32];
};

__device__ __forceinline__ float to_c(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float load_count(const void* X, long long off,
                                            bool bf16) {
  if (bf16) {
    const unsigned h = static_cast<const unsigned short*>(X)[off];
    return __uint_as_float(h << 16);
  }
  return static_cast<const float*>(X)[off];
}

// Chunks of the other side per CTA row: enough CTAs for ~8 a multiprocessor
// over both sides, at most one step of kN positions per chunk.
int plan_chunks(int n_r, int n_c) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n_sm = 132;
  }
  const int n = n_r > n_c ? n_r : n_c;
  const int own_blocks = (n + kO - 1) / kO;
  const int steps = (n + kN - 1) / kN;
  int chunks = (8 * n_sm + 2 * own_blocks - 1) / (2 * own_blocks);
  if (chunks > steps) chunks = steps;
  return chunks < 1 ? 1 : chunks;
}

// part: side 0's (chunks, n_r, 2r + 2) then side 1's (chunks, n_c, 2r + 2)
// sums [cost w | cost^2 w^2 | cost | cost^2]; lpart: (ceil(n_r / kO),
// chunks) loss partials.
__global__ void __launch_bounds__(kThreads, 2)
    glove_tile_sums(const int* __restrict__ rows, const int* __restrict__ cols,
                    int n_r, int n_c, const void* __restrict__ X,
                    long long sr, long long sc, int bf16,
                    const float* __restrict__ w_i,
                    const float* __restrict__ w_j,
                    const float* __restrict__ b_i,
                    const float* __restrict__ b_j, int r, float x_max,
                    float alpha, int chunks, float* __restrict__ part,
                    float* __restrict__ lpart) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int side = blockIdx.z;
  const int n_own = side ? n_c : n_r, n_oth = side ? n_r : n_c;
  const int own0 = blockIdx.x * kO;
  if (own0 >= n_own) return;  // the same for the whole CTA
  const int chunk = blockIdx.y;
  const bool bf = bf16 != 0;
  const int* own_ids = side ? cols : rows;
  const int* oth_ids = side ? rows : cols;
  const float* W_own = side ? w_j : w_i;
  const float* W_oth = side ? w_i : w_j;
  const float* B_own = side ? b_j : b_i;
  const float* B_oth = side ? b_i : b_j;
  const int steps = (n_oth + kN - 1) / kN;
  const int s0 = (int)((long long)chunk * steps / chunks);
  const int s1 = (int)((long long)(chunk + 1) * steps / chunks);
  const int tid = threadIdx.x;

  for (int q = tid; q < kO * r; q += kThreads) {
    const int m = q / r, k = q % r, p = own0 + m;
    sm.own[m * kLd + k] =
        p < n_own ? to_c(W_own[(size_t)own_ids[p] * r + k], bf) : 0.f;
  }
  if (tid < kO) {
    const int p = own0 + tid;
    sm.b_own[tid] = p < n_own ? B_own[own_ids[p]] : 0.f;
  }

  // S and cost cells: own ty + 16 i (i < 2), other tx + 16 j (j < 4)
  const int ty = tid >> 4, tx = tid & 15;
  // products: own py + 8 i (i < 4), component px + 32 j (j < 4)
  const int py = tid >> 5, px = tid & 31;
  float g[4][4], a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = a[i][j] = 0.f;
  float rc[2] = {0.f, 0.f}, rc2[2] = {0.f, 0.f}, lsum = 0.f;
  // the count block of a step spans rows [a0, a0 + A) x cols [b0, b0 + Bn)
  const int A = side ? kN : kO, Bn = side ? kO : kN;
  const bool b_fast = sc == 1;  // columns are contiguous in X

  for (int step = s0; step < s1; ++step) {
    const int oth0 = step * kN;
    __syncthreads();  // the previous step's products are done with oth, cost
    for (int q = tid; q < kN * r; q += kThreads) {
      const int n = q / r, k = q % r, p = oth0 + n;
      sm.oth[n * kLd + k] =
          p < n_oth ? to_c(W_oth[(size_t)oth_ids[p] * r + k], bf) : 0.f;
    }
    if (tid < kN) {
      const int p = oth0 + tid;
      sm.b_oth[tid] = p < n_oth ? B_oth[oth_ids[p]] : 0.f;
    }
    const int a0 = side ? oth0 : own0, b0 = side ? own0 : oth0;
    for (int q = tid; q < A * Bn; q += kThreads) {
      const int al = b_fast ? q / Bn : q % A, bl = b_fast ? q % Bn : q / A;
      const int ra = a0 + al, cb = b0 + bl;
      const float x = (ra < n_r && cb < n_c)
                          ? load_count(X, ra * sr + cb * sc, bf)
                          : 0.f;
      const int ol = side ? bl : al, tl = side ? al : bl;
      sm.cost[ol * kLdc + tl] = x;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < r; ++k) {
      float av[2], bv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) av[i] = sm.own[(ty + 16 * i) * kLd + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.oth[(tx + 16 * j) * kLd + k];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = ty + 16 * i, n = tx + 16 * j;
        const float x = sm.cost[m * kLdc + n];
        // the reference adds the row's bias first: (S + b_i) + b_j
        const float b_row = side ? sm.b_oth[n] : sm.b_own[m];
        const float b_col = side ? sm.b_own[m] : sm.b_oth[n];
        const bool present = x > 0.f;
        const float lx = logf(present ? x : 1.f);
        const float w =
            present ? (x < x_max ? powf(x / x_max, alpha) : 1.f) : 0.f;
        const float sv =
            fminf(fmaxf(s[i][j] + b_row + b_col - lx, -kClip), kClip);
        const float cost = to_c(to_c(w, bf) * to_c(sv, bf), bf);
        const float c2 = to_c(cost * cost, bf);
        lsum += cost * sv;
        rc[i] += cost;
        rc2[i] += c2;
        sm.cost[m * kLdc + n] = cost;
        sm.c2[m * kLdc + n] = c2;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int n = 0; n < kN; ++n) {
      float o[4], o2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = px + 32 * j;
        o[j] = k < r ? sm.oth[n * kLd + k] : 0.f;
        o2[j] = to_c(o[j] * o[j], bf);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float cv = sm.cost[(py + 8 * i) * kLdc + n];
        const float c2v = sm.c2[(py + 8 * i) * kLdc + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[i][j] = fmaf(cv, o[j], g[i][j]);
          a[i][j] = fmaf(c2v, o2[j], a[i][j]);
        }
      }
    }
  }

  const int width = 2 * r + 2;
  float* P = part + (side ? (size_t)chunks * n_r * width : 0) +
             (size_t)chunk * n_own * width;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = own0 + py + 8 * i;
    if (p < n_own) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = px + 32 * j;
        if (k < r) {
          P[(size_t)p * width + k] = g[i][j];
          P[(size_t)p * width + r + k] = a[i][j];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {  // over the 16 lanes of one own row
      rc[i] += __shfl_xor_sync(RSP_FULL_MASK, rc[i], o);
      rc2[i] += __shfl_xor_sync(RSP_FULL_MASK, rc2[i], o);
    }
    const int p = own0 + ty + 16 * i;
    if (tx == 0 && p < n_own) {
      P[(size_t)p * width + 2 * r] = rc[i];
      P[(size_t)p * width + 2 * r + 1] = rc2[i];
    }
  }
  if (side == 0) {
    const float l = rsp::block_sum(lsum, sm.red);
    if (tid == 0) lpart[blockIdx.x * chunks + chunk] = l;
  }
}

// Threads [0, n_r (r + 1)) apply the row side, the rest the column side;
// within a side, thread p (r + 1) + k is component k of position p, k = r
// its bias.
__global__ void glove_tile_apply(const int* __restrict__ rows,
                                 const int* __restrict__ cols, int n_r,
                                 int n_c, int r, int chunks,
                                 const float* __restrict__ part,
                                 const float* __restrict__ lpart, int n_lpart,
                                 float* w_i, float* w_j, float* b_i, float* b_j,
                                 float* acc_w_i, float* acc_w_j,
                                 float* acc_b_i, float* acc_b_j, float lr,
                                 float* loss) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) {
    float l = 0.f;
    for (int t = 0; t < n_lpart; ++t) l += lpart[t];
    *loss = l;
  }
  const long long n0 = (long long)n_r * (r + 1);
  if (idx >= n0 + (long long)n_c * (r + 1)) return;
  const bool col = idx >= n0;
  if (col) idx -= n0;
  const int n_own = col ? n_c : n_r;
  const int width = 2 * r + 2;
  const size_t stride = (size_t)n_own * width;
  const float* P = part + (col ? (size_t)chunks * n_r * width : 0) +
                   (idx / (r + 1)) * width;
  const int p = (int)(idx / (r + 1)), k = (int)(idx % (r + 1));
  const int f = (col ? cols : rows)[p];
  const int k1 = k < r ? k : 2 * r;  // sum of cost w, or of cost
  const int k2 = k < r ? r + k : 2 * r + 1;
  float s1 = 0.f, s2 = 0.f;
  for (int c = 0; c < chunks; ++c) {
    s1 += P[c * stride + k1];
    s2 += P[c * stride + k2];
  }
  if (k < r) {
    float* w = col ? w_j : w_i;
    float* acc = col ? acc_w_j : acc_w_i;
    const size_t e = (size_t)f * r + k;
    const float av = acc[e] + s2;
    w[e] += -lr * s1 / sqrtf(av);
    acc[e] = av;
  } else {
    float* b = col ? b_j : b_i;
    float* acc = col ? acc_b_j : acc_b_i;
    const float av = acc[f] + s2;
    b[f] += -lr * s1 / sqrtf(av);
    acc[f] = av;
  }
}

}  // namespace

// Floats of scratch one tile needs (the wrapper allocates it uninitialised).
extern "C" long long rsp_glove_tile_scratch(int n_r, int n_c, int r) {
  const long long chunks = plan_chunks(n_r, n_c);
  return chunks * (n_r + n_c) * (2LL * r + 2) +
         chunks * ((n_r + kO - 1) / kO);
}

// rows (n_r,), cols (n_c,) int32: the tile's distinct hot ids; X the
// tile's counts, element (a, b) at X[a sr + b sc] (f32, or bf16 when bf16
// != 0, which also rounds the products' operands to bf16); the eight state
// tables f32, updated in place; scratch of rsp_glove_tile_scratch floats;
// loss (one float) receives the tile's sum(cost * S).
extern "C" int rsp_glove_tile(const int* rows, const int* cols, int n_r,
                              int n_c, const void* X, long long sr,
                              long long sc, int bf16, float* w_i, float* w_j,
                              float* b_i, float* b_j, float* acc_w_i,
                              float* acc_w_j, float* acc_b_i, float* acc_b_j,
                              int r, float x_max, float alpha, float lr,
                              float* scratch, float* loss, void* stream) {
  if (n_r <= 0 || n_c <= 0 || r < 1 || r > kMaxR || !scratch || !loss)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        glove_tile_sums, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = plan_chunks(n_r, n_c);
  const int own_blocks = ((n_r > n_c ? n_r : n_c) + kO - 1) / kO;
  float* lpart = scratch + (size_t)chunks * (n_r + n_c) * (2 * r + 2);
  glove_tile_sums<<<dim3(own_blocks, chunks, 2), kThreads, sizeof(Smem),
                    st>>>(rows, cols, n_r, n_c, X, sr, sc, bf16, w_i, w_j,
                          b_i, b_j, r, x_max, alpha, chunks, scratch, lpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)(n_r + n_c) * (r + 1);
  glove_tile_apply<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      rows, cols, n_r, n_c, r, chunks, scratch, lpart,
      chunks * ((n_r + kO - 1) / kO), w_i, w_j, b_i, b_j, acc_w_i, acc_w_j,
      acc_b_i, acc_b_j, lr, loss);
  return (int)cudaGetLastError();
}
