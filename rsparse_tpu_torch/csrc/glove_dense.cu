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
// Written by hand (no library product), in launches that keep it
// deterministic (no atomics; sums in a fixed order):
//   A  grid (own blocks, chunks, 2 sides).  A CTA owns positions of one
//      side (z = 0: rows, z = 1: columns) and walks one chunk of the other
//      side in steps.  Per step it forms its block of S, turns it into the
//      cost block on chip (never written to device memory), and adds cost
//      @ w_oth and cost^2 @ w_oth^2 and the row sums of cost and cost^2
//      into its own positions' sums, held across the steps.  S, and so the
//      cost, is computed once by each side (6 products for the tile's 5):
//      no CTA adds into another's sums, and a chunk writes its partial sums
//      once.  The loss sum cost * S comes from the row side, one partial per
//      CTA;
//   B  one thread per (side, position, component): the partials of all
//      chunks summed in a fixed order, then acc += sum cost^2 w^2, w +=
//      -lr sum cost w / sqrt(acc) (the same for the biases), for the
//      tile's own positions (distinct hot ids: no race); thread 0 sums the
//      loss partials.
//
// The bf16 head (bf16 != 0, the configuration that config #4 and
// compute_dtype="bfloat16" run) puts all six products on the tensor cores
// (glove_tile_sums_mma, mma.sync.m16n8k16, bf16 operands, f32 sums), after
// a gather launch that writes both sides' rows as bf16, bf16(w^2) (rounded
// once), the biases, the rows' norms, and a table of (bf16(weight), log x,
// log x in float64) for all 2^15 positive bf16 counts.  A CTA of four
// warps owns 64 positions, a warp 16; per step of 64 other positions (rows,
// squares, biases, norms and counts staged with cp.async, two buffers) a
// warp forms its 16 x 64 block of S into register fragments, turns them
// into cost and cost^2 in registers, and reuses them, packed to bf16, as
// the A fragments of the two products (the layout FlashAttention-2 uses
// for P V).  Count lines are staged along whichever side is contiguous in
// X, so both sides read X in rows.  Numerics: the tensor core truncates
// when it adds into a running sum, so each k16 slice of S and each step's
// products are summed into fresh fragments and added in float32, and the
// row sums of cost and cost^2 a step at a time; a cell whose float32
// clip(S + b_i + b_j - log x) lies within the sum's error bound of a bf16
// rounding midpoint (bound from |w_own| |w_oth|, by Cauchy-Schwarz) is
// summed again exactly in float64 by the warp (eight lanes a cell), so the
// bf16 costs are those of the exactly summed S.
//
// The f32 head (bf16 == 0, GloVe's default compute dtype) follows the
// tile's present cells: an absent cell's cost is exactly 0, so it adds
// nothing to any product or sum.  A CTA of 8 warps owns kO = 32 positions
// and walks its chunk in steps of kN = 64 other positions.  Per step it
// stages the 32 x 64 count block (cp.async, along X's unit stride) and
// compacts its present cells by ballots in own-major order, other
// positions rising, with a slot for each other position that a present
// cell needs; only those other rows (and biases) are staged, by cp.async
// into one of two buffers, and a step without a present cell stages and
// computes nothing.  The next step's counts load while this step's S is
// formed, and its rows while this step's products run.  S, the cost and
// the loss term are formed one present cell a thread, S summed over k in
// order on the FMA units at f32; then each warp adds cost w_oth and cost^2
// w_oth^2 for its own lines warp + 8 i, a lane 32-strided components, and
// the lines' sums of cost and cost^2.  The order is the dense walk's that
// the first version (a dense FMA walk) took for S and the four products,
// less its zero terms, so the factor tables and their accumulators come
// out bitwise that kernel's under the same chunks (by construction: an
// absent cell only added exact zeros); the bias sums and the loss add the
// same terms in another order.  No atomics.  Dynamic shared memory
// (sizeof(Smem<MR>)): 106 KB a CTA at r <= 128, 224 KB at 320; ptxas -v:
// 119 and 159 registers a thread; so two CTAs an SM at r <= 128, one at
// 320.
//
// What bounds it on the H100: at config #4 a tile is 3,063 x 3,063 cells,
// r = 128, of which ~0.7% (a tail tile) to 14% (the first) are present:
// the function needs the present cells' work and one read of the ~19 MB of
// bf16 counts, a few microseconds.  The dense formulation does 12 n_r n_c r
// = 13.5 GFLOP a tile on the tensor cores whatever the density; the steps'
// staging and latency (two warps a scheduler at ~250 registers a thread)
// and the exact re-sums of the densest rows hold it well below the bf16
// peak.  The f32 head's work follows the present cells (~2.5 GFLOP of FMA
// at the first tile, both sides); what remains is the staging of the other
// rows from L2 (each CTA row reads the needed other side once: ~300 MB at
// r = 128, ~750 MB at 320 on the first tile) and the shared-memory reads
// of S's dot products, one row pair a cell.
//
// Two widths are built and chosen by r: 128 and 320 (GloVe's published
// 300 dimensions pad to 320 with zero columns, which add nothing to S, the
// products, the rows' norms or the exact re-sums).  At 320 the f32 path
// holds 32 + 2 x 64 staged rows of 324 floats and 40 components a thread
// a line.  The bf16 path at 320 is its own kernel,
// glove_tile_sums_wg, written for the H100: a persistent grid of one CTA
// an SM over the tile's (side, own block, chunk) items; a producer warp
// keeps the other side's rows in two stages of 64 x 320 bf16 (TMA, 128-byte
// swizzle) and their squares in one, with their biases, norms and count
// lines (cp.async), each on a full / empty mbarrier pair; two consumer
// warpgroups (232 registers a thread by setmaxnreg) each form S for the 64
// own rows and half of a step's 64 other positions on wgmma (m64n32k16, so
// S is formed once a block), make cost and cost^2 in registers, hand their
// packed fragments to each other through shared memory, and each sums the
// products for 160 of the 320 components on wgmma with the cost fragments
// as the register A operand.  The numerics are the narrow path's: every
// k16 slice of S and every step's products into fresh accumulators added
// in float32; the midpoint test's bound grows with S's ceil(r / 16) k16
// slices (19 at r = 300), so a cell it flags is tested again with a
// tighter bound from the rows' k16 slices' norms (near_midpoint_slices,
// the norms made by the gather launch), which cut the cells summed again
// exactly in float64 from ~10% to ~3% of the present cells at config #4's
// first tile; the test is taken a fragment (4 cells a thread) at a time,
// so the queue of four exact sums never overflows.  What bounds it: 12 n_r n_c 320 operations a tile at the bf16
// peak (36 GFLOP at config #4's first tile, 0.04 ms) and one read of the
// counts; per step the CUDA cores' per-cell work (the midpoint test, the
// lookups, the packing) sits between the two wgmma phases of a warpgroup,
// and the other warpgroup's wgmma fills it.

// The bf16-state instance (state_bf16 != 0, GloVe(precision="bfloat16"),
// which runs the bf16 head) walks only the present cells at both widths
// (glove_tile_walk_bf16 below: the f32 head's steps and compaction, S and
// the products of each step's slots on mma.sync; it replaced the two
// dense routes' bf16-state instances, which it beat on config #4's
// densest, transposed and last tiles at r = 128 and 300, kernel_times.py
// k11-bf16).
// The eight tables are bf16 and read directly (the gather launch widens
// nothing), the weight table holds (bf16(pow(bf16(x / x_max), alpha)),
// bf16(log x)) as the reference forms them at bf16, and a cell's S is the
// bf16 rounding of the exact sum w_own . w_oth (a midpoint test on S with
// the sum's error bound, the flagged cells summed again in float64 and
// rounded once), then + b_i, + b_j and - log x each rounded before the
// clip, as the reference's bf16 ops are (rsparse_tpu/models/glove.py:
// 230-241); cost and cost^2 at bf16, the loss terms cost S rounded before
// their sum.  Launch B rounds each product and sum to bf16 and takes the
// step op by op (acc + s2, -lr s1, sqrt, the quotient, the add, each
// rounded).  The reference's two sums over a tile's cells with dtype=bf16
// (the biases' sum cost and sum cost^2) accumulate at bf16 in XLA's own
// order; K11 and its plain version round their f32 sums once (ROADMAP.md
// lists the difference).

#include <cuda.h>
#include <type_traits>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float kClip = 100.f;
// the two widths built (models/glove.py GLOVE_WIDTHS), chosen by r: each
// path is templated on it (MR below), so the r <= 128 route is as it was
constexpr int kMaxR = 128;
constexpr int kMaxRWide = 320;      // widest embedding (models/glove.py MAX_RANK)
constexpr int kO = 32;              // own positions per CTA
constexpr int kN = 64;              // other positions per step
constexpr int kThreads = 256;
constexpr int kLdc = kN + 1;        // shared stride of a staged count line
constexpr int kCells = kO * kN;     // cells of a step's count block

// Launch A of the f32 head at instance width MR.  A step's counts are
// staged (cp.async, zero past the tile) into the other-row buffer that no
// step is reading, then compacted into the step's present cells; the other
// rows that a present cell needs are staged into that buffer, so the next
// step's rows load while this step's products run.
template <int MR>
struct Smem {
  static constexpr int kLd = MR + 4;  // floats a staged factor row: float4
                                      // reads, and 16 bytes past a multiple
                                      // of 128, so 8 rows hit 8 bank groups
  float own[kO * kLd];
  float oth[2][kN * kLd];             // the needed other rows, by slot
  float val[2][kCells];               // present cells, own-major: x, then cost
  unsigned char slot[2][kCells];      // the cell's other row: its slot in oth
  unsigned char slot_pos[2][kN];      // slot -> other position in the step
  short row0[2][kO + 1];              // own line m's cells [row0[m], row0[m + 1])
  float b_own[kO];
  float b_oth[2][kN];
  int rowcnt[kO];
  unsigned need[kThreads / 32][2];    // other positions a warp's cells need
  float red[32];
};
static_assert(sizeof(Smem<kMaxR>) <= 232448 / 2 - 1024,
              "two CTAs of the f32 head an SM at r <= 128");

// Chunks of the other side per CTA row: enough CTAs for ~8 a multiprocessor
// over both sides, at most one step of kN positions per chunk.
int n_sms();

int plan_chunks(int n_r, int n_c) {
  const int n_sm = n_sms();
  const int n = n_r > n_c ? n_r : n_c;
  const int own_blocks = (n + kO - 1) / kO;
  const int steps = (n + kN - 1) / kN;
  int chunks = (8 * n_sm + 2 * own_blocks - 1) / (2 * own_blocks);
  if (chunks > steps) chunks = steps;
  return chunks < 1 ? 1 : chunks;
}

// 4 bytes global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// n factor rows (and their biases) into dst at stride kLd: row s is table
// row ids[p0 + (pos ? pos[s] : s)].  vec: r % 4 == 0 and the table 16-byte
// aligned, so rows go in 16-byte granules.
template <int kLd>
__device__ __forceinline__ void stage_rows(float* dst, float* bdst,
                                           const float* W, const float* B,
                                           const int* ids, int p0,
                                           const unsigned char* pos, int n,
                                           int r, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int g4 = r >> 2;
    for (int q = tid; q < n * g4; q += kThreads) {
      const int s = q / g4, g = q - s * g4;
      const int id = ids[p0 + (pos ? pos[s] : s)];
      rsp::cp_async16(dst + s * kLd + 4 * g, W + (size_t)id * r + 4 * g, 16);
    }
  } else {
    for (int q = tid; q < n * r; q += kThreads) {
      const int s = q / r, k = q - s * r;
      const int id = ids[p0 + (pos ? pos[s] : s)];
      cp_async4(dst + s * kLd + k, W + (size_t)id * r + k, 4);
    }
  }
  for (int s = tid; s < n; s += kThreads)
    cp_async4(bdst + s, B + ids[p0 + (pos ? pos[s] : s)], 4);
}

// part: side 0's (chunks, n_r, 2r + 2) then side 1's (chunks, n_c, 2r + 2)
// sums [cost w | cost^2 w^2 | cost | cost^2]; lpart: (ceil(n_r / kO),
// chunks) loss partials.  MR: the instance width (r <= MR); a warp's
// products cover own lines warp + 8 i (i < 4), a lane components lane +
// 32 j (j < MR / 32).
template <int MR>
__global__ void __launch_bounds__(kThreads, MR <= kMaxR ? 2 : 1)
    glove_tile_sums(const int* __restrict__ rows, const int* __restrict__ cols,
                    int n_r, int n_c, const float* __restrict__ X,
                    long long sr, long long sc,
                    const float* __restrict__ w_i,
                    const float* __restrict__ w_j,
                    const float* __restrict__ b_i,
                    const float* __restrict__ b_j, int r, int vec,
                    float x_max, float alpha, int chunks,
                    float* __restrict__ part, float* __restrict__ lpart) {
  extern __shared__ float smem_raw[];
  Smem<MR>& sm = *reinterpret_cast<Smem<MR>*>(smem_raw);
  constexpr int kLd = Smem<MR>::kLd, kJ = MR / 32;
  const int side = blockIdx.z;
  const int n_own = side ? n_c : n_r, n_oth = side ? n_r : n_c;
  const int own0 = blockIdx.x * kO;
  if (own0 >= n_own) return;  // the same for the whole CTA
  const int chunk = blockIdx.y;
  const int* own_ids = side ? cols : rows;
  const int* oth_ids = side ? rows : cols;
  const float* W_own = side ? w_j : w_i;
  const float* W_oth = side ? w_i : w_j;
  const float* B_own = side ? b_j : b_i;
  const float* B_oth = side ? b_i : b_j;
  const int steps = (n_oth + kN - 1) / kN;
  const int s0 = (int)((long long)chunk * steps / chunks);
  const int s1 = (int)((long long)(chunk + 1) * steps / chunks);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_own_blk = n_own - own0 < kO ? n_own - own0 : kO;

  // the count block of a step spans rows [a0, a0 + A) x cols [b0, b0 + Bn);
  // staged own-major (line ol, other position tl) along X's unit stride
  const int A = side ? kN : kO, Bn = side ? kO : kN;
  const bool b_fast = sc == 1;  // columns are contiguous in X
  auto load_counts = [&](int step, float* cnt) {
    const int oth0 = step * kN;
    const int a0 = side ? oth0 : own0, b0 = side ? own0 : oth0;
    for (int q = tid; q < kCells; q += kThreads) {
      const int al = b_fast ? q / Bn : q % A, bl = b_fast ? q % Bn : q / A;
      const int ra = a0 + al, cb = b0 + bl;
      const bool in = ra < n_r && cb < n_c;
      const int ol = side ? bl : al, tl = side ? al : bl;
      cp_async4(cnt + ol * kLdc + tl, in ? X + ra * sr + cb * sc : X,
                in ? 4 : 0);
    }
  };
  // The step's present cells in own-major order, other positions rising
  // (the order the dense walk summed them in), by ballots: warp w compacts
  // own lines 4 w .. 4 w + 3; each needed other position gets a slot.
  // Returns the slots.  One barrier inside; the caller synchronises before
  // and after.
  auto compact = [&](const float* cnt, int bb) {
    unsigned lo[4], hi[4], nlo = 0, nhi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * warp + i;
      lo[i] = __ballot_sync(RSP_FULL_MASK, cnt[m * kLdc + lane] > 0.f);
      hi[i] = __ballot_sync(RSP_FULL_MASK, cnt[m * kLdc + lane + 32] > 0.f);
      nlo |= lo[i];
      nhi |= hi[i];
      if (lane == 0) sm.rowcnt[m] = __popc(lo[i]) + __popc(hi[i]);
    }
    if (lane == 0) {
      sm.need[warp][0] = nlo;
      sm.need[warp][1] = nhi;
    }
    __syncthreads();
    nlo = nhi = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      nlo |= sm.need[w][0];
      nhi |= sm.need[w][1];
    }
    const int c = sm.rowcnt[lane];  // kO == 32 lines: one a lane
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(RSP_FULL_MASK, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned lt = (1u << lane) - 1;
    if (warp == 0) {
      sm.row0[bb][lane + 1] = (short)incl;
      if (lane == 0) sm.row0[bb][0] = 0;
      if ((nlo >> lane) & 1)
        sm.slot_pos[bb][__popc(nlo & lt)] = (unsigned char)lane;
      if ((nhi >> lane) & 1)
        sm.slot_pos[bb][__popc(nlo) + __popc(nhi & lt)] =
            (unsigned char)(lane + 32);
    }
    const int slot_lo = __popc(nlo & lt);
    const int slot_hi = __popc(nlo) + __popc(nhi & lt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * warp + i;
      const int base = __shfl_sync(RSP_FULL_MASK, incl - c, m);
      if ((lo[i] >> lane) & 1) {
        const int e = base + __popc(lo[i] & lt);
        sm.val[bb][e] = cnt[m * kLdc + lane];
        sm.slot[bb][e] = (unsigned char)slot_lo;
      }
      if ((hi[i] >> lane) & 1) {
        const int e = base + __popc(lo[i]) + __popc(hi[i] & lt);
        sm.val[bb][e] = cnt[m * kLdc + lane + 32];
        sm.slot[bb][e] = (unsigned char)slot_hi;
      }
    }
    return __popc(nlo) + __popc(nhi);
  };

  float g[4][kJ], a[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) g[i][j] = a[i][j] = 0.f;
  float rc[4] = {0.f, 0.f, 0.f, 0.f}, rc2[4] = {0.f, 0.f, 0.f, 0.f};
  float lsum = 0.f;

  stage_rows<kLd>(sm.own, sm.b_own, W_own, B_own, own_ids, own0, nullptr,
                  n_own_blk, r, vec);
  if (s0 < s1) {
    load_counts(s0, sm.oth[1]);
    rsp::cp_async_commit();
    rsp::cp_async_wait<0>();
    __syncthreads();
    const int n_need = compact(sm.oth[1], 0);
    __syncthreads();
    stage_rows<kLd>(sm.oth[0], sm.b_oth[0], W_oth, B_oth, oth_ids, s0 * kN,
                    sm.slot_pos[0], n_need, r, vec);
    rsp::cp_async_commit();
  }
  for (int step = s0; step < s1; ++step) {
    const int bb = (step - s0) & 1, nb = bb ^ 1;
    const bool next = step + 1 < s1;
    rsp::cp_async_wait<0>();  // this step's rows (and the own rows)
    __syncthreads();          // ... and the step before is done with nb
    if (next) {
      load_counts(step + 1, sm.oth[nb]);
      rsp::cp_async_commit();
    }
    // S, the cost and the loss term of each present cell, one a thread: S
    // summed over k in order, as the dense walk summed it
    const float* oth = sm.oth[bb];
    const int n_cells = sm.row0[bb][kO];
    for (int e = tid; e < n_cells; e += kThreads) {
      int m = 0;  // the last own line whose cells start at or before e
#pragma unroll
      for (int h = 16; h > 0; h >>= 1)
        if (sm.row0[bb][m + h] <= e) m += h;
      const int s = sm.slot[bb][e];
      const float* ow = sm.own + m * kLd;
      const float* ot = oth + s * kLd;
      float acc = 0.f;
      int k = 0;
#pragma unroll 4
      for (; k + 4 <= r; k += 4) {
        const float4 u = *reinterpret_cast<const float4*>(ow + k);
        const float4 v = *reinterpret_cast<const float4*>(ot + k);
        acc = fmaf(u.x, v.x, acc);
        acc = fmaf(u.y, v.y, acc);
        acc = fmaf(u.z, v.z, acc);
        acc = fmaf(u.w, v.w, acc);
      }
      for (; k < r; ++k) acc = fmaf(ow[k], ot[k], acc);
      const float x = sm.val[bb][e];
      // the reference adds the row's bias first: (S + b_i) + b_j
      const float b_row = side ? sm.b_oth[bb][s] : sm.b_own[m];
      const float b_col = side ? sm.b_own[m] : sm.b_oth[bb][s];
      const float lx = logf(x);
      const float w = x < x_max ? powf(x / x_max, alpha) : 1.f;
      const float sv = fminf(fmaxf(acc + b_row + b_col - lx, -kClip), kClip);
      const float cost = w * sv;
      lsum += cost * sv;
      sm.val[bb][e] = cost;
    }
    rsp::cp_async_wait<0>();  // the next step's counts
    __syncthreads();
    if (next) {
      const int n_need = compact(sm.oth[nb], nb);
      __syncthreads();
      stage_rows<kLd>(sm.oth[nb], sm.b_oth[nb], W_oth, B_oth, oth_ids,
                      (step + 1) * kN, sm.slot_pos[nb], n_need, r, vec);
      rsp::cp_async_commit();
    }
    // the products over the present cells of the warp's own lines, other
    // positions rising (the dense walk's order without its zero terms)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = warp + 8 * i;
      const int e1 = sm.row0[bb][m + 1];
      for (int e = sm.row0[bb][m]; e < e1; ++e) {
        const float cv = sm.val[bb][e];
        const float c2v = cv * cv;
        const float* ot = oth + sm.slot[bb][e] * kLd;
        rc[i] += cv;
        rc2[i] += c2v;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int k = lane + 32 * j;
          const float o = k < r ? ot[k] : 0.f;
          g[i][j] = fmaf(cv, o, g[i][j]);
          a[i][j] = fmaf(c2v, o * o, a[i][j]);
        }
      }
    }
  }

  const int width = 2 * r + 2;
  float* P = part + (side ? (size_t)chunks * n_r * width : 0) +
             (size_t)chunk * n_own * width;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = own0 + warp + 8 * i;
    if (p < n_own) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int k = lane + 32 * j;
        if (k < r) {
          P[(size_t)p * width + k] = g[i][j];
          P[(size_t)p * width + r + k] = a[i][j];
        }
      }
      if (lane == 0) {
        P[(size_t)p * width + 2 * r] = rc[i];
        P[(size_t)p * width + 2 * r + 1] = rc2[i];
      }
    }
  }
  if (side == 0) {
    const float l = rsp::block_sum(lsum, sm.red);
    if (tid == 0) lpart[blockIdx.x * chunks + chunk] = l;
  }
}

// ---- the bf16 head on tensor cores ------------------------------------------

constexpr int kMO = 64;             // own positions per CTA (16 a warp)
constexpr int kMN = 64;             // other positions per step
constexpr int kCntLine = 144;       // bytes a staged count line: 9 granules

// The mma.sync path at width MR <= 128 (the r = 320 instance runs on
// wgmma, glove_tile_sums_wg below).  A warp holds its 16 own rows' sums of
// MR components (G and A2: MR / 2 floats a thread each).
template <int MR>
struct MmaShape {
  static_assert(MR <= kMaxR, "the wide head runs glove_tile_sums_wg");
  static constexpr int kThreads = 128;
  static constexpr int kWRow = MR + 8;  // bf16 a staged factor row: 16 bytes
                                        // past a multiple of 128 (272 bytes
                                        // at 128), so ldmatrix's 8 rows hit
                                        // 8 bank groups
  static constexpr int kGran = MR / 8;  // 16-byte granules a row
  static constexpr int kNT = MR / 8;    // n8 tiles a warp sums
};

template <int MR>
struct MmaSmem {
  static constexpr int kWRow = MmaShape<MR>::kWRow;
  __nv_bfloat16 own[kMO * kWRow];
  __nv_bfloat16 oth[2][kMN * kWRow];
  __nv_bfloat16 oth2[2][kMN * kWRow];  // bf16(w^2)
  unsigned char cnt[2][64 * kCntLine];
  int coff[2][64];                     // offset of each line in its first granule
  float b_own[kMO];
  float b_oth[2][kMN];
  float n_own[kMO];                    // |bf16(w)|_2 of each staged row
  float n_oth[2][kMN];
  float red[32];
};
static_assert(sizeof(Smem<kMaxRWide>) <= 232448, "one CTA's shared memory");

// bf16 counts: 2^15 bit patterns of positive (or zero) values
constexpr int kLut = 1 << 15;

// The tile's factor rows at bf16 for the tensor cores, both sides: rows
// side then columns side, MR columns each (0 past r), w and bf16(w^2),
// one warp a position; the biases and the rows' norms |bf16(w)|_2 f32, the
// columns side's from offset round4(n_r).  (gw2, gsn and lut64 may be
// null: the bf16-state walk reads none of them.)  Threads below kLut also fill
// the weight table of the bf16 counts: for the count with bits b << 16,
// (bf16(weight), log x) as the plain version computes them (logf, powf),
// so that the sums kernel reads them instead of evaluating both in every
// cell.
__device__ __forceinline__ float ldt(const float* p) { return *p; }
__device__ __forceinline__ float ldt(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int MR, typename T>
__global__ void glove_tile_gather(const int* __restrict__ rows,
                                  const int* __restrict__ cols, int n_r,
                                  int n_c, const T* __restrict__ w_i,
                                  const T* __restrict__ w_j,
                                  const T* __restrict__ b_i,
                                  const T* __restrict__ b_j, int r,
                                  float x_max, float alpha,
                                  __nv_bfloat16* gw, __nv_bfloat16* gw2,
                                  float* gb, float* gn,
                                  __nv_bfloat16* gsn, float2* lut,
                                  double* lut64) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < kLut && lut != nullptr) {
    const float x = __uint_as_float((unsigned)idx << 16);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // at bf16 state every op of the weight and the log rounds
      const float w =
          x > 0.f ? (x < x_max ? rsp::rbf(powf(rsp::rbf(x / x_max), alpha))
                               : 1.f)
                  : 0.f;
      lut[idx] = make_float2(w, rsp::rbf(logf(x > 0.f ? x : 1.f)));
    } else {
      const float w =
          x > 0.f ? (x < x_max ? powf(x / x_max, alpha) : 1.f) : 0.f;
      lut[idx] = make_float2(rsp::rbf(w), logf(x > 0.f ? x : 1.f));
    }
    if (lut64 != nullptr) lut64[idx] = log(x > 0.f ? (double)x : 1.0);
  }
  const int p = (int)(idx >> 5), lane = threadIdx.x & 31;
  if (p >= n_r + n_c) return;  // the same for the whole warp
  const bool col = p >= n_r;
  const int pos = col ? p - n_r : p;
  const int id = (col ? cols : rows)[pos];
  const T* W = (col ? w_j : w_i) + (size_t)id * r;
  const int o = col ? ((n_r + 3) & ~3) + pos : pos;
  float ss = 0.f;
#pragma unroll
  for (int m = 0; m < MR / 32; ++m) {
    const int k = lane + 32 * m;
    const float v = k < r ? rsp::rbf(ldt(W + k)) : 0.f;
    gw[(size_t)p * MR + k] = __float2bfloat16_rn(v);
    if (gw2 != nullptr) gw2[(size_t)p * MR + k] = __float2bfloat16_rn(v * v);
    ss += v * v;
    if constexpr (MR > kMaxR) {
      // the norms of the row's k16 slices 2m (lanes 0-15) and 2m + 1,
      // rounded up (the wide kernel's midpoint bound)
      float q = v * v;
#pragma unroll
      for (int h = 8; h > 0; h >>= 1) q += __shfl_xor_sync(RSP_FULL_MASK, q, h);
      if ((lane & 15) == 0 && gsn != nullptr)
        gsn[(size_t)o * (MR / 16) + 2 * m + (lane >> 4)] =
            __float2bfloat16_ru(sqrtf(q) * (1.f + 0x1p-18f));
    }
  }
  ss = rsp::warp_sum(ss);
  if (lane == 0) {
    gb[o] = ldt((col ? b_j : b_i) + id);
    gn[o] = sqrtf(ss);
  }
}

// Whether sv lies within `bound` of a bf16 rounding midpoint.
__device__ __forceinline__ bool within_of_midpoint(float sv, float bound) {
  const unsigned u = __float_as_uint(sv);
  const float ulp = __uint_as_float(u & 0x7f800000u) * 0x1p-23f;
  const int dist = abs((int)(u & 0xffffu) - 0x8000);
  return (float)dist * ulp <= bound;
}
// Whether clip(S + b_row + b_col - log x) computed in float32 from K11's
// tensor-core S (s) may sit on the other side of a bf16 rounding midpoint
// than the exact value: its distance from the nearest midpoint is within
// the error bound of the sum.  S is `slices` k16 slices (8 at r <= 128,
// taken whatever r is; ceil(r / 16) in the wide instance), each summed by
// the tensor core (at most ~2 ulp of its partial sums) and added in
// float32; every partial is bounded by sum |a_k b_k| <= |a|_2 |b|_2
// (Cauchy-Schwarz), so the bound is 2^-21 slices |a| |b| (2^-18 at 8)
// plus the three float32 roundings of the biases and the log, and the
// error of the __logf the test is made with.
__device__ __forceinline__ bool near_midpoint(float sv, float s, float b_row,
                                              float b_col, float lx,
                                              float na, float nb,
                                              float slices) {
  const float bound = 0x1p-21f * slices * na * nb +
                      0x1p-22f * (fabsf(s) + fabsf(b_row) + fabsf(b_col) +
                                  fabsf(lx)) +
                      0x1p-21f * (1.f + fabsf(lx));
  return within_of_midpoint(sv, bound);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Launch A of the bf16 head on the tensor cores: as glove_tile_sums, with
// kMO own positions a CTA (16 a warp) and kMN other positions a step.
// Per step a warp computes its 16 x 64 block of S = w_own w_oth' with
// mma.m16n8k16 (bf16 operands from the gathered rows, f32 sums), turns
// the S fragments into cost and cost^2 in registers, and reuses them, packed
// to bf16, as the A fragments of cost @ w_oth and cost^2 @ w_oth^2 (the
// accumulator layout of m16n8 equals the A layout of m16n8k16 over two
// adjacent n tiles), summing into 16 x 128 f32 fragments held across the
// steps.  The other side's rows, squares, biases and counts are staged with
// cp.async into two buffers; counts are staged as lines along whichever
// side is contiguous in X (the row side's lines are X's rows; the column
// side reads the same rows and indexes them transposed).
template <int MR>
__global__ void __launch_bounds__(MmaShape<MR>::kThreads, 2)
    glove_tile_sums_mma(int n_r, int n_c, const void* __restrict__ X,
                        long long sr, long long sc,
                        const __nv_bfloat16* __restrict__ gw,
                        const __nv_bfloat16* __restrict__ gw2,
                        const float* __restrict__ gb,
                        const float* __restrict__ gn,
                        const float2* __restrict__ lut,
                        const double* __restrict__ lut64, int r, int chunks,
                        float* __restrict__ part, float* __restrict__ lpart,
                        float* s_dump) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  MmaSmem<MR>& sm = *reinterpret_cast<MmaSmem<MR>*>(smem_mma);
  using Sh = MmaShape<MR>;
  constexpr int kMThreads = Sh::kThreads, kWRow = Sh::kWRow,
                kGran = Sh::kGran, kNT = Sh::kNT;
  const int side = blockIdx.z;
  const int n_own = side ? n_c : n_r, n_oth = side ? n_r : n_c;
  const int own0 = blockIdx.x * kMO;
  if (own0 >= n_own) return;  // the same for the whole CTA
  const int chunk = blockIdx.y;
  const int steps = (n_oth + kMN - 1) / kMN;
  const int s0 = (int)((long long)chunk * steps / chunks);
  const int s1 = (int)((long long)(chunk + 1) * steps / chunks);
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;  // the warp's 16 own rows
  const int g = lane >> 2, tig = lane & 3;
  const int rb = (n_r + 3) & ~3;
  const __nv_bfloat16* W_own = gw + (size_t)(side ? n_r : 0) * MR;
  const __nv_bfloat16* W_oth = gw + (size_t)(side ? 0 : n_r) * MR;
  const __nv_bfloat16* W2_oth = gw2 + (size_t)(side ? 0 : n_r) * MR;
  const float* B_own = gb + (side ? rb : 0);
  const float* B_oth = gb + (side ? 0 : rb);
  const float* N_own = gn + (side ? rb : 0);
  const float* N_oth = gn + (side ? 0 : rb);
  const long long s_own = side ? sc : sr, s_oth = side ? sr : sc;
  const bool lines_own = s_oth == 1;  // count lines run along the other side
  const long long s_line = lines_own ? s_own : s_oth;
  const int kr = (r + 15) / 16;       // k16 slices of the factor rows
  // the midpoint test's slices (near_midpoint) and the S fragments a pass
  // of the test takes (a queue of four exact sums a thread a pass)
  const float slices = 8.f;
  constexpr int kQN = 2;

  for (int e = tid; e < kMO * kGran; e += kMThreads) {
    const int m = e / kGran, q = e % kGran, p = own0 + m;
    rsp::cp_async16(&sm.own[m * kWRow + 8 * q],
                    W_own + (size_t)(p < n_own ? p : 0) * MR + 8 * q,
                    p < n_own ? 16 : 0);
  }
  if (tid < kMO / 4) {
    const int p = own0 + 4 * tid;
    rsp::cp_async16(&sm.b_own[4 * tid], B_own + (p < n_own ? p : 0),
                    p < n_own ? 16 : 0);
    rsp::cp_async16(&sm.n_own[4 * tid], N_own + (p < n_own ? p : 0),
                    p < n_own ? 16 : 0);
  }
  auto issue = [&](int step) {
    const int buf = step & 1, q0 = step * kMN;
    for (int e = tid; e < kMN * kGran; e += kMThreads) {
      const int m = e / kGran, q = e % kGran, p = q0 + m;
      const size_t o = (size_t)(p < n_oth ? p : 0) * MR + 8 * q;
      rsp::cp_async16(&sm.oth[buf][m * kWRow + 8 * q], W_oth + o,
                      p < n_oth ? 16 : 0);
      rsp::cp_async16(&sm.oth2[buf][m * kWRow + 8 * q], W2_oth + o,
                      p < n_oth ? 16 : 0);
    }
    if (tid < kMN / 4) {
      const int p = q0 + 4 * tid;
      rsp::cp_async16(&sm.b_oth[buf][4 * tid], B_oth + (p < n_oth ? p : 0),
                      p < n_oth ? 16 : 0);
      rsp::cp_async16(&sm.n_oth[buf][4 * tid], N_oth + (p < n_oth ? p : 0),
                      p < n_oth ? 16 : 0);
    }
    // count lines: along the other side (lines = own positions) or along
    // the own side (lines = other positions); only the granules that hold
    // the line's positions inside the tile are read
    const int n_lines = lines_own ? n_own - own0 : n_oth - q0;
    const int first = lines_own ? q0 : own0;
    const int n_along = (lines_own ? n_oth : n_own) - first;
    const int len = n_along < 64 ? n_along : 64;
    for (int e = tid; e < 64 * 9; e += kMThreads) {
      const int line = e / 9, q = e - line * 9;
      if (line >= n_lines) continue;
      const long long el =
          (long long)((lines_own ? own0 : q0) + line) * s_line + first;
      const size_t a = reinterpret_cast<size_t>(X) + 2 * (size_t)el;
      const int off = (int)(a & 15);
      if (q == 0) sm.coff[buf][line] = off;
      if (q < ((off + 2 * len + 15) >> 4))
        rsp::cp_async16(&sm.cnt[buf][line * kCntLine + 16 * q],
                        reinterpret_cast<const void*>((a & ~(size_t)15) + 16 * q),
                        16);
    }
  };

  float G[kNT][4], A2[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) G[n][q] = A2[n][q] = 0.f;
  float rc[2] = {0.f, 0.f}, rc2[2] = {0.f, 0.f}, lsum = 0.f;
  const int prow = 16 * warp;  // the warp's first own row in the block

  if (s0 < s1) issue(s0);
  rsp::cp_async_commit();
  for (int step = s0; step < s1; ++step) {
    const int buf = step & 1, q0 = step * kMN;
    if (step + 1 < s1) {
      issue(step + 1);
      rsp::cp_async_commit();
      rsp::cp_async_wait<1>();
    } else {
      rsp::cp_async_wait<0>();
    }
    __syncthreads();

    // S for the warp's 16 own rows x 64 other positions.  Each k16 slice
    // is summed by the tensor core into a fresh fragment and the slices are
    // added in float32: the tensor core truncates when it adds into a
    // running sum, which would send more cells of S across a bf16 rounding
    // boundary than a float32 sum does.
    float s[8][4];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s[2 * np][q] = s[2 * np + 1][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MR / 16; ++ks) {
        if (ks < kr) {
          unsigned a[4], bq[4];
          rsp::ldsm_x4(a, &sm.own[(prow + (lane & 15)) * kWRow + 16 * ks +
                                  (lane >> 4) * 8]);
          rsp::ldsm_x4(bq, &sm.oth[buf][(16 * np + (lane & 7) +
                                         ((lane >> 4) << 3)) * kWRow +
                                        16 * ks + ((lane >> 3) & 1) * 8]);
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          rsp::mma_bf16(t0, a, bq[0], bq[1]);
          rsp::mma_bf16(t1, a, bq[2], bq[3]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            s[2 * np][q] += t0[q];
            s[2 * np + 1][q] += t1[q];
          }
        }
      }
    }

    // cost and cost^2 in registers, packed as the products' A fragments.
    // Cell 4 n + q of a thread is S fragment s[n][q]: own row pr, other
    // position qr.  Three passes keep every array index a constant (a
    // runtime index would put the fragments in local memory): (1) flag the
    // cells whose float32 clip(S + b_i + b_j - log x) may round to the
    // other bf16 neighbour than the exact S does; (2) the warp sums the
    // flagged cells' S exactly in float64, four cells a round, eight lanes
    // and 16 of the 128 exact products a lane each, and each cell's thread
    // queues its S (the first four of a thread's eight cells in a quarter of
    // the step; a fifth keeps its float32 value); (3) the costs, their sums
    // and the packed fragments, a flagged cell's clip(S + b_i + b_j - log
    // x) formed in float64 from the queue and rounded once to bf16, as the
    // float64 sum does.
    const unsigned char* cb = sm.cnt[buf];
    auto cell = [&](int n, int q, int& pr, int& qr, unsigned& xb, float& b_row,
                    float& b_col) {
      pr = prow + g + 8 * (q >> 1);
      qr = 8 * n + 2 * tig + (q & 1);
      const int line = lines_own ? pr : qr, el = lines_own ? qr : pr;
      const bool in = own0 + pr < n_own && q0 + qr < n_oth;
      xb = in ? *reinterpret_cast<const unsigned short*>(
                    cb + line * kCntLine + sm.coff[buf][line] + 2 * el)
              : 0u;
      // the reference adds the row's bias first: (S + b_i) + b_j
      b_row = side ? sm.b_oth[buf][qr] : sm.b_own[pr];
      b_col = side ? sm.b_own[pr] : sm.b_oth[buf][qr];
    };
    unsigned ca[4][4], c2a[4][4];
    // this step's row sums, added to the running sums after the step (two
    // levels: a long float32 sum of cancelling terms in one chain would
    // sit further from the exact sum than the plain version's)
    float sc[2] = {0.f, 0.f}, sc2[2] = {0.f, 0.f}, sl = 0.f;
    // by quarters of the step's cells (two S fragments, 8 cells a thread),
    // so that the queue of four rarely overflows
#pragma unroll
    for (int qt = 0; qt < 8 / kQN; ++qt) {
      unsigned near_mask = 0;
#pragma unroll
      for (int n = kQN * qt; n < kQN * qt + kQN; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pr = prow + g + 8 * (q >> 1);
          const int qr = 8 * n + 2 * tig + (q & 1);
          const int line = lines_own ? pr : qr, el = lines_own ? qr : pr;
          const float x =
              own0 + pr < n_own && q0 + qr < n_oth
                  ? __uint_as_float(
                        (unsigned)*reinterpret_cast<const unsigned short*>(
                            cb + line * kCntLine + sm.coff[buf][line] + 2 * el)
                        << 16)
                  : 0.f;
          if (x > 0.f) {  // (absent cells, most of a sparse tile, skip)
            const float b_row = side ? sm.b_oth[buf][qr] : sm.b_own[pr];
            const float b_col = side ? sm.b_own[pr] : sm.b_oth[buf][qr];
            // log x by the fast intrinsic, its error (at most 2^-21 (1 +
            // |log x|)) added to the test's bound: no global memory here
            const float lx = __logf(x);
            const float sv =
                fminf(fmaxf(s[n][q] + b_row + b_col - lx, -kClip), kClip);
            if (near_midpoint(sv, s[n][q], b_row, b_col, lx, sm.n_own[pr],
                              sm.n_oth[buf][qr], slices))
              near_mask |= 1u << (4 * n + q);
          }
        }
      }
      // the first four flagged cells of the thread, in cell order
      unsigned fixed = 0;
      for (int i = 0; i < 4 && near_mask != 0; ++i) {
        fixed |= near_mask & (0u - near_mask);
        near_mask &= near_mask - 1;
      }
      near_mask = fixed;
      // the queue of exact S, in cell order
      double fs0 = 0.0, fs1 = 0.0, fs2 = 0.0, fs3 = 0.0;
      int fn = 0;
      for (unsigned any = __ballot_sync(RSP_FULL_MASK, near_mask != 0); any;
           any = __ballot_sync(RSP_FULL_MASK, near_mask != 0)) {
        // four cells a round, eight lanes each: group j takes the lowest
        // flagged cell of the j-th lowest lane that has one
        const int grp = lane >> 3, gl = lane & 7;
        unsigned a = any;
        for (int j = 0; j < grp && a; ++j) a &= a - 1;
        const int L = a ? __ffs(a) - 1 : -1;
        const int t = __shfl_sync(RSP_FULL_MASK, __ffs(near_mask) - 1,
                                  L < 0 ? 0 : L);
        double part = 0.0;
        if (L >= 0) {
          const int n = t >> 2, q = t & 3;
          const int pr = prow + (L >> 2) + 8 * (q >> 1);
          const int qr = 8 * n + 2 * (L & 3) + (q & 1);
#pragma unroll
          for (int e = 0; e < MR / 8; e += 2) {
            const int k = (MR / 8) * gl + e;
            const __nv_bfloat162 x =
                *reinterpret_cast<const __nv_bfloat162*>(&sm.own[pr * kWRow + k]);
            const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(
                &sm.oth[buf][qr * kWRow + k]);
            part += (double)(__low2float(x) * __low2float(y)) +
                    (double)(__high2float(x) * __high2float(y));
          }
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          part += __shfl_xor_sync(RSP_FULL_MASK, part, o);
        // the owners (the four lowest lanes with a flagged cell) take their
        // group's sum
        const int rank = __popc(any & ((1u << lane) - 1u));
        const double res = __shfl_sync(RSP_FULL_MASK, part, 8 * (rank & 3));
        if (near_mask != 0 && rank < 4) {
          near_mask &= near_mask - 1;
          fs0 = fn == 0 ? res : fs0;
          fs1 = fn == 1 ? res : fs1;
          fs2 = fn == 2 ? res : fs2;
          fs3 = fn == 3 ? res : fs3;
          ++fn;
        }
      }
#pragma unroll
      for (int n = kQN * qt; n < kQN * qt + kQN; ++n) {
        int pr[4], qr[4];
        unsigned xb[4];
        float b_row[4], b_col[4];
        float2 wl[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cell(n, q, pr[q], qr[q], xb[q], b_row[q], b_col[q]);
        double lx64[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // bf16(weight) and log x of the count
          const bool present = __uint_as_float(xb[q] << 16) > 0.f;
          wl[q] = present ? __ldg(&lut[xb[q]]) : make_float2(0.f, 0.f);
          lx64[q] = (fixed >> (4 * n + q)) & 1u ? __ldg(&lut64[xb[q]]) : 0.0;
        }
        float cv[4], c2v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool present = __uint_as_float(xb[q] << 16) > 0.f;
          float sv = fminf(fmaxf(s[n][q] + b_row[q] + b_col[q] - wl[q].y,
                                 -kClip),
                           kClip);
          float svb = rsp::rbf(sv);
          if ((fixed >> (4 * n + q)) & 1u) {  // the next queued exact S
            const double v = fmin(
                fmax(fs0 + (double)b_row[q] + (double)b_col[q] - lx64[q],
                     -(double)kClip),
                (double)kClip);
            svb = __bfloat162float(__double2bfloat16(v));  // rounded once
            sv = (float)v;
            fs0 = fs1;
            fs1 = fs2;
            fs2 = fs3;
          }
          const float cost = present ? rsp::rbf(wl[q].x * svb) : 0.f;
          const float c2 = rsp::rbf(cost * cost);
          sl += cost * sv;
          if (s_dump != nullptr && present) {
            const int i = side ? q0 + qr[q] : own0 + pr[q];
            const int j = side ? own0 + pr[q] : q0 + qr[q];
            s_dump[((size_t)side * n_r + i) * n_c + j] = svb;
          }
          sc[q >> 1] += cost;
          sc2[q >> 1] += c2;
          cv[q] = cost;
          c2v[q] = c2;
        }
        ca[n >> 1][2 * (n & 1)] = pack_bf16(cv[0], cv[1]);
        ca[n >> 1][2 * (n & 1) + 1] = pack_bf16(cv[2], cv[3]);
        c2a[n >> 1][2 * (n & 1)] = pack_bf16(c2v[0], c2v[1]);
        c2a[n >> 1][2 * (n & 1) + 1] = pack_bf16(c2v[2], c2v[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rc[h] += sc[h];
      rc2[h] += sc2[h];
    }
    lsum += sl;

    // cost @ w_oth and cost^2 @ w_oth^2: each step's four k16 slices into
    // fresh fragments, added to the warp's 16 x MR sums in float32
#pragma unroll
    for (int cl = 0; cl < kNT / 2; ++cl) {
      const int cp = cl;
      if (cp < kr) {
        float tg[2][4] = {}, ta[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int o = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kWRow +
                        16 * cp + (lane >> 4) * 8;
          unsigned bq[4];
          rsp::ldsm_x4_trans(bq, &sm.oth[buf][o]);
          rsp::mma_bf16(tg[0], ca[kk], bq[0], bq[1]);
          rsp::mma_bf16(tg[1], ca[kk], bq[2], bq[3]);
          rsp::ldsm_x4_trans(bq, &sm.oth2[buf][o]);
          rsp::mma_bf16(ta[0], c2a[kk], bq[0], bq[1]);
          rsp::mma_bf16(ta[1], c2a[kk], bq[2], bq[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          G[2 * cl][q] += tg[0][q];
          G[2 * cl + 1][q] += tg[1][q];
          A2[2 * cl][q] += ta[0][q];
          A2[2 * cl + 1][q] += ta[1][q];
        }
      }
    }
    __syncthreads();  // buffers of this step are free for step + 2
  }
  rsp::cp_async_wait<0>();

  const int width = 2 * r + 2;
  float* P = part + (side ? (size_t)chunks * n_r * width : 0) +
             (size_t)chunk * n_own * width;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = own0 + prow + g + 8 * h;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * n + 2 * tig + e;
        if (p < n_own && k < r) {
          P[(size_t)p * width + k] = G[n][2 * h + e];
          P[(size_t)p * width + r + k] = A2[n][2 * h + e];
        }
      }
    }
    float a1 = rc[h], a2 = rc2[h];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {  // over the 4 lanes of one own row
      a1 += __shfl_xor_sync(RSP_FULL_MASK, a1, o);
      a2 += __shfl_xor_sync(RSP_FULL_MASK, a2, o);
    }
    if (tig == 0 && p < n_own) {
      P[(size_t)p * width + 2 * r] = a1;
      P[(size_t)p * width + 2 * r + 1] = a2;
    }
  }
  if (side == 0) {
    const float l = rsp::block_sum(lsum, sm.red);
    if (tid == 0) lpart[blockIdx.x * chunks + chunk] = l;
  }
}

// ---- the bf16-state head over the present cells ----------------------------

// Launch A of the bf16-state head (state_bf16 != 0) at instance width MR
// (both widths): the f32 walk's steps over the tile's present cells
// (glove_tile_sums above) on the gather launch's bf16 rows.  Per step the
// 32 x 64 count block is staged as count lines along X's unit stride (16-
// byte granules from the aligned address below each line, as the mma path
// stages them) and compacted by ballots own-major, other positions rising;
// only the other rows (MR bf16, zero past r), biases and norms that a
// present cell needs are staged by cp.async into one of two buffers, and a
// step without a present cell stages and computes nothing.  S for the
// step's 32 own lines x its slots on the tensor cores (mma.m16n8k16, each
// k16 slice into fresh fragments added in float32, the mma path's S), then
// the present cells a warp 32 at a time: a cell whose float32 S lies
// within the sum's error bound ((2^-21 + ceil(r / 16) 2^-24) |w_own|
// |w_oth|) of a bf16 rounding midpoint is summed again in float64 by the
// whole warp, so S is the exactly rounded bf16 of w_own . w_oth; then + b_i,
// + b_j and - log x each rounded, the clip, cost = bf16(bf16(weight) sv)
// and the loss term bf16(cost sv) from the gather's table of (bf16(weight),
// bf16(log x)).  The step's costs and bf16(cost^2) are then scattered into
// a 32 x 64 block over the step's slots (zero where absent; the lines'
// sums of cost and cost^2 taken on the way), the needed rows' bf16(w^2)
// formed once, and the products cost w_oth and cost^2 w_oth^2 run on the
// tensor cores over the slots alone (the mma path's fragments: a warp 16
// own lines x MR / 4 components, a step's k16 slices into fresh fragments
// added in float32); a chunk writes its partials once, for launch B
// (unchanged).  No atomics: a fixed order everywhere.  So a step's work
// follows its slots and present cells, not the 32 x 64 block.  Shared
// memory 105 KB a CTA at r <= 128 (two an SM), 191 KB at 320 (one).
template <int MR>
struct WalkSmem {
  static constexpr int kLd = MR + 8;  // bf16 a staged row: 16 bytes past a
                                      // multiple of 128 bytes
  static constexpr int kLdC = kN + 8;  // bf16 a row of the step's cost block
  __nv_bfloat16 own[kO * kLd];
  __nv_bfloat16 oth[2][kN * kLd];     // the needed other rows, by slot; the
                                      // free one takes a step's count lines
  __nv_bfloat16 oth2[kN * kLd];       // the step's bf16(w_oth^2), by slot
  __nv_bfloat16 cst[2][kO * kLdC];    // the step's cost and bf16(cost^2),
                                      // own line x slot (0 where absent)
  float sblk[kO * (kN + 4)];          // the step's S, own line x slot
  float val[2][kCells];               // present cells, own-major: x, then cost
  unsigned char slot[2][kCells];
  unsigned char line[2][kCells];      // a cell's own line
  unsigned char slot_pos[2][kN];
  short row0[2][kO + 1];
  float b_own[kO], n_own[kO];
  float b_oth[2][kN], n_oth[2][kN];
  int coff[kN];                       // a count line's offset in its granule
  int rowcnt[kO];
  unsigned need[kThreads / 32][2];
  float red[32];
};
static_assert((size_t)kN * WalkSmem<kMaxR>::kLd * 2 >= (size_t)kN * kCntLine,
              "a step's count lines fit a row buffer");
static_assert(sizeof(WalkSmem<kMaxR>) <= 232448 / 2 - 1024,
              "two CTAs of the bf16-state walk an SM at r <= 128");
static_assert(sizeof(WalkSmem<kMaxRWide>) <= 232448,
              "one CTA's shared memory");

__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// RSP_K11_WALK_CLOCKS (a timing build, kernel_times.py k11-walk): thread
// 0 of CTA (0, 0, 0) sums the clock cycles of each phase of its steps,
// and the CTA counts its present cells and those it summed again in
// float64; they overwrite part[0..9].
#ifdef RSP_K11_WALK_CLOCKS
#define RSP_WALK_CLK(i)                                                 \
  do {                                                                  \
    if (clk_on) {                                                       \
      const long long c_ = clock64();                                   \
      wclk[i] += c_ - wclk_t;                                           \
      wclk_t = c_;                                                      \
    }                                                                   \
  } while (0)
#else
#define RSP_WALK_CLK(i) \
  do {                  \
  } while (0)
#endif

template <int MR>
__global__ void __launch_bounds__(kThreads, MR <= kMaxR ? 2 : 1)
    glove_tile_walk_bf16(int n_r, int n_c, const __nv_bfloat16* __restrict__ X,
                         long long sr, long long sc,
                         const __nv_bfloat16* __restrict__ gw,
                         const float* __restrict__ gb,
                         const float* __restrict__ gn,
                         const float2* __restrict__ lut, int r, int chunks,
                         float* __restrict__ part, float* __restrict__ lpart) {
  extern __shared__ __align__(16) unsigned char smem_walk[];
  WalkSmem<MR>& sm = *reinterpret_cast<WalkSmem<MR>*>(smem_walk);
  constexpr int kLd = WalkSmem<MR>::kLd, kLdC = WalkSmem<MR>::kLdC,
                kGran = MR / 8;
  const int side = blockIdx.z;
  const int n_own = side ? n_c : n_r, n_oth = side ? n_r : n_c;
  const int own0 = blockIdx.x * kO;
  if (own0 >= n_own) return;  // the same for the whole CTA
  const int chunk = blockIdx.y;
  const int steps = (n_oth + kN - 1) / kN;
  const int s0 = (int)((long long)chunk * steps / chunks);
  const int s1 = (int)((long long)(chunk + 1) * steps / chunks);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_own_blk = n_own - own0 < kO ? n_own - own0 : kO;
  const int rb = (n_r + 3) & ~3;
  const __nv_bfloat16* W_own = gw + (size_t)(side ? n_r : 0) * MR;
  const __nv_bfloat16* W_oth = gw + (size_t)(side ? 0 : n_r) * MR;
  const float* B_own = gb + (side ? rb : 0);
  const float* B_oth = gb + (side ? 0 : rb);
  const float* N_own = gn + (side ? rb : 0);
  const float* N_oth = gn + (side ? 0 : rb);
  const long long s_own = side ? sc : sr, s_oth = side ? sr : sc;
  const bool lines_own = s_oth == 1;  // count lines run along the other side
  const int n8 = (r + 7) / 8;         // 8-component granules of a row
  const int kr = (r + 15) / 16;       // k16 slices of S
  // S's error bound over |w_own| |w_oth|: the tensor core's error on a k16
  // slice is at most 2^-21 of its sum of |products| and the kr slices'
  // float32 adds at most kr 2^-24 of theirs, both under the rows' norms
  // by Cauchy-Schwarz (near_midpoint_slices' argument); 0.1% for the
  // norms' own rounding
  const float bound_k = (0x1p-21f + (float)kr * 0x1p-24f) * 1.001f;

  // A step's count lines into buf: own lines along the other side, or
  // other lines along the own side.
  auto load_counts = [&](int step, unsigned char* buf) {
    const int oth0 = step * kN;
    const int n_oth_blk = n_oth - oth0 < kN ? n_oth - oth0 : kN;
    const int n_lines = lines_own ? n_own_blk : n_oth_blk;
    const int len = lines_own ? n_oth_blk : n_own_blk;
    for (int e = tid; e < kN * 9; e += kThreads) {
      const int line = e / 9, q = e - line * 9;
      if (line >= n_lines) continue;
      const long long el = lines_own
                               ? (long long)(own0 + line) * s_own + oth0
                               : (long long)(oth0 + line) * s_oth + own0;
      const size_t a = reinterpret_cast<size_t>(X) + 2 * (size_t)el;
      const int off = (int)(a & 15);
      if (q == 0) sm.coff[line] = off;
      if (q < ((off + 2 * len + 15) >> 4))
        rsp::cp_async16(buf + line * kCntLine + 16 * q,
                        reinterpret_cast<const void*>((a & ~(size_t)15) +
                                                      16 * q),
                        16);
    }
  };
  // the count's bits at own line m, other position n of the step (0
  // outside the tile)
  auto bits_at = [&](const unsigned char* buf, int m, int n, int oth0) {
    if (m >= n_own_blk || oth0 + n >= n_oth) return 0u;
    const int line = lines_own ? m : n, el = lines_own ? n : m;
    return (unsigned)*reinterpret_cast<const unsigned short*>(
        buf + line * kCntLine + sm.coff[line] + 2 * el);
  };
  // the f32 walk's compact(): the step's present cells own-major, other
  // positions rising, a slot for each needed other position; returns the
  // slots.  One barrier inside; the caller synchronises before and after.
  auto compact = [&](const unsigned char* buf, int bb, int oth0) {
    unsigned lo[4], hi[4], xl[4], xh[4], nlo = 0, nhi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * warp + i;
      xl[i] = bits_at(buf, m, lane, oth0);
      xh[i] = bits_at(buf, m, lane + 32, oth0);
      lo[i] = __ballot_sync(RSP_FULL_MASK, bf_lo(xl[i]) > 0.f);
      hi[i] = __ballot_sync(RSP_FULL_MASK, bf_lo(xh[i]) > 0.f);
      nlo |= lo[i];
      nhi |= hi[i];
      if (lane == 0) sm.rowcnt[m] = __popc(lo[i]) + __popc(hi[i]);
    }
    if (lane == 0) {
      sm.need[warp][0] = nlo;
      sm.need[warp][1] = nhi;
    }
    __syncthreads();
    nlo = nhi = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      nlo |= sm.need[w][0];
      nhi |= sm.need[w][1];
    }
    const int c = sm.rowcnt[lane];  // kO == 32 lines: one a lane
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(RSP_FULL_MASK, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned lt = (1u << lane) - 1;
    if (warp == 0) {
      sm.row0[bb][lane + 1] = (short)incl;
      if (lane == 0) sm.row0[bb][0] = 0;
      if ((nlo >> lane) & 1)
        sm.slot_pos[bb][__popc(nlo & lt)] = (unsigned char)lane;
      if ((nhi >> lane) & 1)
        sm.slot_pos[bb][__popc(nlo) + __popc(nhi & lt)] =
            (unsigned char)(lane + 32);
    }
    const int slot_lo = __popc(nlo & lt);
    const int slot_hi = __popc(nlo) + __popc(nhi & lt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * warp + i;
      const int base = __shfl_sync(RSP_FULL_MASK, incl - c, m);
      if ((lo[i] >> lane) & 1) {
        const int e = base + __popc(lo[i] & lt);
        sm.val[bb][e] = bf_lo(xl[i]);
        sm.slot[bb][e] = (unsigned char)slot_lo;
        sm.line[bb][e] = (unsigned char)m;
      }
      if ((hi[i] >> lane) & 1) {
        const int e = base + __popc(lo[i]) + __popc(hi[i] & lt);
        sm.val[bb][e] = bf_lo(xh[i]);
        sm.slot[bb][e] = (unsigned char)slot_hi;
        sm.line[bb][e] = (unsigned char)m;
      }
    }
    return __popc(nlo) + __popc(nhi);
  };
  // the needed other rows (their positions oth0 + slot_pos), biases and
  // norms into buffer bb
  auto stage_rows = [&](int bb, int oth0, int n_need) {
    for (int q = tid; q < n_need * kGran; q += kThreads) {
      const int s = q / kGran, g = q - s * kGran;
      const int p = oth0 + sm.slot_pos[bb][s];
      rsp::cp_async16(&sm.oth[bb][s * kLd + 8 * g],
                      W_oth + (size_t)p * MR + 8 * g, 16);
    }
    for (int s = tid; s < n_need; s += kThreads) {
      const int p = oth0 + sm.slot_pos[bb][s];
      cp_async4(&sm.b_oth[bb][s], B_oth + p, 4);
      cp_async4(&sm.n_oth[bb][s], N_oth + p, 4);
    }
  };

  // the warp's products: own lines [16 mt, 16 mt + 16) x components
  // [kNW c0, kNW c0 + kNW), kNW / 8 n8 tiles of fragments each
  constexpr int kNW = MR / 4, kNT8 = kNW / 8;
  const int mt = warp & 1, c0 = (warp >> 1) * kNW;
  const int gq = lane >> 2, tig = lane & 3;
  float G[kNT8][4], A2[kNT8][4];
#pragma unroll
  for (int n = 0; n < kNT8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) G[n][q] = A2[n][q] = 0.f;
  float rc[4] = {0.f, 0.f, 0.f, 0.f}, rc2[4] = {0.f, 0.f, 0.f, 0.f};
  float lsum = 0.f;

  for (int e = tid; e < kO * kGran; e += kThreads) {
    const int m = e / kGran, q = e - m * kGran, p = own0 + m;
    rsp::cp_async16(&sm.own[m * kLd + 8 * q],
                    W_own + (size_t)(p < n_own ? p : 0) * MR + 8 * q,
                    p < n_own ? 16 : 0);
  }
  if (tid < kO) {
    const int p = own0 + tid;
    cp_async4(&sm.b_own[tid], B_own + (p < n_own ? p : 0), p < n_own ? 4 : 0);
    cp_async4(&sm.n_own[tid], N_own + (p < n_own ? p : 0), p < n_own ? 4 : 0);
  }
  auto cbuf = [&](int b) {
    return reinterpret_cast<unsigned char*>(sm.oth[b]);
  };
  __shared__ int n_need_of[2];  // the slots staged in each buffer
  if (s0 < s1) {
    load_counts(s0, cbuf(1));
    rsp::cp_async_commit();
    rsp::cp_async_wait<0>();
    __syncthreads();
    const int n_need = compact(cbuf(1), 0, s0 * kN);
    if (tid == 0) n_need_of[0] = n_need;
    __syncthreads();
    stage_rows(0, s0 * kN, n_need);
    rsp::cp_async_commit();
  }
#ifdef RSP_K11_WALK_CLOCKS
  const bool clk_on = tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                      blockIdx.z == 0;
  long long wclk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, wclk_t = clock64();
  float n_flag = 0.f, n_cell = 0.f;
#endif
  for (int step = s0; step < s1; ++step) {
    const int bb = (step - s0) & 1, nb = bb ^ 1;
    const bool next = step + 1 < s1;
    rsp::cp_async_wait<0>();  // this step's rows (and the own rows)
    __syncthreads();          // ... and the step before is done with nb
    if (next) {
      load_counts(step + 1, cbuf(nb));
      rsp::cp_async_commit();
    }
    RSP_WALK_CLK(0);
    // S, the cost and the loss term of each present cell, one a thread
    const __nv_bfloat16* oth = sm.oth[bb];
    const int n_cells = sm.row0[bb][kO];
    const int n_slot = n_need_of[bb];
    const int n16 = (n_slot + 15) & ~15;
    // the step's S block on mma.m16n8k16: warp (mt, ng) 16 own lines x the
    // slots [16 ng, 16 ng + 16), each k16 slice into fresh fragments added
    // in float32 (the mma path's S)
    const int ng = warp >> 1;
    if (n_cells > 0 && 16 * ng < n16) {
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < kr; ++ks) {
        unsigned a[4], bq[4];
        rsp::ldsm_x4(a, &sm.own[(16 * mt + (lane & 15)) * kLd + 16 * ks +
                                (lane >> 4) * 8]);
        rsp::ldsm_x4(bq, &oth[(16 * ng + (lane & 7) + ((lane >> 4) << 3)) *
                                  kLd +
                              16 * ks + ((lane >> 3) & 1) * 8]);
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        rsp::mma_bf16(t0, a, bq[0], bq[1]);
        rsp::mma_bf16(t1, a, bq[2], bq[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s0[q] += t0[q];
          s1[q] += t1[q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = 16 * mt + gq + 8 * (q >> 1);
        const int c = 16 * ng + 2 * tig + (q & 1);
        sm.sblk[m * (kN + 4) + c] = s0[q];
        sm.sblk[m * (kN + 4) + c + 8] = s1[q];
      }
    }
    __syncthreads();
    RSP_WALK_CLK(1);
    // the present cells, a warp 2 x 32 at a time (two cells a lane, for
    // their loads' latency)
    for (int base = 32 * warp; base < n_cells; base += 2 * kThreads) {
      int e[2], m[2], s[2];
      bool on[2];
      float dot[2], sd[2];
      float2 wl[2];
      unsigned fl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        e[h] = base + h * kThreads + lane;
        on[h] = e[h] < n_cells;
        m[h] = on[h] ? sm.line[bb][e[h]] : 0;
        s[h] = on[h] ? sm.slot[bb][e[h]] : 0;
        wl[h] = on[h] ? __ldg(&lut[__float_as_uint(sm.val[bb][e[h]]) >> 16])
                      : make_float2(0.f, 0.f);
        dot[h] = on[h] ? sm.sblk[m[h] * (kN + 4) + s[h]] : 0.f;
        sd[h] = rsp::rbf(dot[h]);
        // a cell whose float32 S may round to the other bf16 neighbour
        // than the exact sum
        fl[h] = __ballot_sync(
            RSP_FULL_MASK,
            on[h] && within_of_midpoint(dot[h], bound_k * sm.n_own[m[h]] *
                                                    sm.n_oth[bb][s[h]]));
#ifdef RSP_K11_WALK_CLOCKS
        if (on[h]) n_cell += 1.f;
        if (lane == 0) n_flag += (float)__popc(fl[h]);
#endif
      }
      // the flagged cells summed again in float64, four a round: group g
      // of eight lanes takes the g-th flagged cell, a lane the component
      // pairs gl + 8 j in two sums, then a fixed tree over the group
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        while (fl[h] != 0u) {
          const int grp = lane >> 3, gl = lane & 7;
          unsigned f = fl[h];
          for (int j = 0; j < grp && f != 0u; ++j) f &= f - 1;
          const int L = f != 0u ? __ffs(f) - 1 : -1;
          const int mL = __shfl_sync(RSP_FULL_MASK, m[h], L < 0 ? 0 : L);
          const int sL = __shfl_sync(RSP_FULL_MASK, s[h], L < 0 ? 0 : L);
          double x0 = 0.0, x1 = 0.0;
          if (L >= 0) {
            const unsigned* ow =
                reinterpret_cast<const unsigned*>(sm.own + mL * kLd);
            const unsigned* ot =
                reinterpret_cast<const unsigned*>(oth + sL * kLd);
            for (int j = gl; j < 4 * n8; j += 8) {
              const unsigned u = ow[j], v = ot[j];
              x0 += (double)(bf_lo(u) * bf_lo(v));
              x1 += (double)(bf_hi(u) * bf_hi(v));
            }
          }
          double x = x0 + x1;
#pragma unroll
          for (int o = 4; o > 0; o >>= 1)
            x += __shfl_xor_sync(RSP_FULL_MASK, x, o);
          // lane L takes its group's sum; the round's cells leave the mask
          unsigned done = 0u;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int Lg = __shfl_sync(RSP_FULL_MASK, L, 8 * g);
            const double xg = __shfl_sync(RSP_FULL_MASK, x, 8 * g);
            if (Lg >= 0) {
              done |= 1u << Lg;
              if (lane == Lg) sd[h] = __bfloat162float(__double2bfloat16(xg));
            }
          }
          fl[h] &= ~done;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (on[h]) {
          // the reference adds the row's bias first: (S + b_i) + b_j
          const float bo = sm.b_own[m[h]], bt = sm.b_oth[bb][s[h]];
          const float b_row = side ? bt : bo, b_col = side ? bo : bt;
          const float sv = fminf(
              fmaxf(rsp::rbf(rsp::rbf(rsp::rbf(sd[h] + b_row) + b_col) -
                             wl[h].y),
                    -kClip),
              kClip);
          const float cost = rsp::rbf(wl[h].x * sv);
          lsum += rsp::rbf(cost * sv);
          sm.val[bb][e[h]] = cost;
        }
      }
    }
    RSP_WALK_CLK(2);
    rsp::cp_async_wait<0>();  // the next step's counts
    __syncthreads();
    RSP_WALK_CLK(3);
    if (next) {
      const int n_need = compact(cbuf(nb), nb, (step + 1) * kN);
      if (tid == 0) n_need_of[nb] = n_need;
      __syncthreads();
      stage_rows(nb, (step + 1) * kN, n_need);
      rsp::cp_async_commit();
    }
    RSP_WALK_CLK(4);
    // the cost block: each warp its lines warp + 8 i (zero, then the
    // present cells' cost and bf16(cost^2) at their slots, the lines' sums
    // of both on the way); the needed rows' bf16(w^2), and zero rows past
    // the slots up to the k16 slice
    __nv_bfloat16* C = sm.cst[0];
    __nv_bfloat16* C2 = sm.cst[1];
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = warp + 8 * i;
      C[m * kLdC + lane] = C[m * kLdC + lane + 32] = zero;
      C2[m * kLdC + lane] = C2[m * kLdC + lane + 32] = zero;
      __syncwarp();
      float s1 = 0.f, s2 = 0.f;
      const int e1 = sm.row0[bb][m + 1];
      for (int e = sm.row0[bb][m] + lane; e < e1; e += 32) {
        const float cv = sm.val[bb][e];
        const float c2v = rsp::rbf(cv * cv);
        C[m * kLdC + sm.slot[bb][e]] = __float2bfloat16_rn(cv);
        C2[m * kLdC + sm.slot[bb][e]] = __float2bfloat16_rn(c2v);
        s1 += cv;
        s2 += c2v;
      }
      rc[i] += s1;  // a lane's share; the warp's tree at the end
      rc2[i] += s2;
    }
    __nv_bfloat16* ob = sm.oth[bb];
    for (int q = tid; q < n16 * kGran; q += kThreads) {
      const int sl = q / kGran, gr = q - sl * kGran;
      uint4* o = reinterpret_cast<uint4*>(ob + sl * kLd + 8 * gr);
      uint4* o2 = reinterpret_cast<uint4*>(sm.oth2 + sl * kLd + 8 * gr);
      if (sl < n_slot) {
        const uint4 v = *o;
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
        unsigned sq[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float lo = bf_lo(w[h]), hi = bf_hi(w[h]);
          const __nv_bfloat162 t = __floats2bfloat162_rn(lo * lo, hi * hi);
          sq[h] = *reinterpret_cast<const unsigned*>(&t);
        }
        *o2 = make_uint4(sq[0], sq[1], sq[2], sq[3]);
      } else {
        *o = *o2 = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    RSP_WALK_CLK(5);
    __syncthreads();
    RSP_WALK_CLK(6);
    // cost @ w_oth and cost^2 @ w_oth^2 over the step's slots: each step's
    // k16 slices into fresh fragments, added to the sums in float32
#pragma unroll
    for (int cl = 0; cl < kNT8 / 2; ++cl) {
      const int cp = c0 / 16 + cl;
      if (16 * cp < r) {
        float tg[2][4] = {}, ta[2][4] = {};
        for (int kk = 0; kk < n16 / 16; ++kk) {
          unsigned ca[4], c2a[4], bq[4];
          const int ao = (16 * mt + (lane & 15)) * kLdC + 16 * kk +
                         (lane >> 4) * 8;
          rsp::ldsm_x4(ca, &C[ao]);
          rsp::ldsm_x4(c2a, &C2[ao]);
          const int o = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                        16 * cp + (lane >> 4) * 8;
          rsp::ldsm_x4_trans(bq, &ob[o]);
          rsp::mma_bf16(tg[0], ca, bq[0], bq[1]);
          rsp::mma_bf16(tg[1], ca, bq[2], bq[3]);
          rsp::ldsm_x4_trans(bq, &sm.oth2[o]);
          rsp::mma_bf16(ta[0], c2a, bq[0], bq[1]);
          rsp::mma_bf16(ta[1], c2a, bq[2], bq[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          G[2 * cl][q] += tg[0][q];
          G[2 * cl + 1][q] += tg[1][q];
          A2[2 * cl][q] += ta[0][q];
          A2[2 * cl + 1][q] += ta[1][q];
        }
      }
    }
    RSP_WALK_CLK(7);
  }
  rsp::cp_async_wait<0>();

  const int width = 2 * r + 2;
  float* P = part + (side ? (size_t)chunks * n_r * width : 0) +
             (size_t)chunk * n_own * width;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = own0 + 16 * mt + gq + 8 * h;
#pragma unroll
    for (int n = 0; n < kNT8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = c0 + 8 * n + 2 * tig + e;
        if (p < n_own && k < r) {
          P[(size_t)p * width + k] = G[n][2 * h + e];
          P[(size_t)p * width + r + k] = A2[n][2 * h + e];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = own0 + warp + 8 * i;
    const float a1 = rsp::warp_sum(rc[i]), a2 = rsp::warp_sum(rc2[i]);
    if (p < n_own && lane == 0) {
      P[(size_t)p * width + 2 * r] = a1;
      P[(size_t)p * width + 2 * r + 1] = a2;
    }
  }
  if (side == 0) {
    const float l = rsp::block_sum(lsum, sm.red);
    if (tid == 0) lpart[blockIdx.x * chunks + chunk] = l;
  }
#ifdef RSP_K11_WALK_CLOCKS
  const float nf = rsp::block_sum(n_flag, sm.red);
  const float nc = rsp::block_sum(n_cell, sm.red);
  if (clk_on) {
    for (int q = 0; q < 8; ++q) part[q] = (float)wclk[q];
    part[8] = nf;
    part[9] = nc;
  }
#endif
}

// ---- the r = 320 head on wgmma -----------------------------------------------

// RSP_K11_CLOCKS (a timing build, kernel_times.py k11-wide): thread 0 of
// CTA 0 sums the clock cycles of each phase of its consumer loop and the
// CTA counts the cells it sums again exactly; a launch with s_dump writes
// them to s_dump[0..7] and s_dump[8] (and no cells).
#ifdef RSP_K11_CLOCKS
#define RSP_K11_CLK(i)                         \
  do {                                         \
    if (tid == 0 && blockIdx.x == 0) {          \
      const long long c_ = clock64();           \
      k11_clk[i] += c_ - k11_t;                 \
      k11_t = c_;                               \
    }                                          \
  } while (0)
#else
#define RSP_K11_CLK(i) \
  do {                 \
  } while (0)
#endif

namespace wgk {

constexpr int kR = kMaxRWide;            // components, zero past r
constexpr int kBoxes = kR / 64;          // 64-component boxes of a row
constexpr int kBox = 64 * 128;           // bytes of a box of 64 rows
constexpr int kTile = kBoxes * kBox;     // bytes of 64 rows: 40,960
constexpr int kSlices = kR / 16;         // k16 slices of S
constexpr int kNC = 32;                  // components a product chunk
constexpr int kChunks = kR / 2 / kNC;    // chunks a warpgroup: 160 components
constexpr int kThreads = 384;            // two consumer warpgroups, a producer one
constexpr int kX = 16;                   // registers a thread hands over a step

// One CTA: the own rows, two stages of the other side's rows (TMA, 128-byte
// swizzle, 64 x 64 bf16 boxes), one stage of their squares, two stages of
// count lines, biases and norms (cp.async), the warpgroups' exchange of
// cost fragments, and the pipeline's mbarriers.
struct WgSmem {
  unsigned char own[kTile];
  unsigned char oth[2][kTile];
  unsigned char oth2[kTile];
  unsigned char cnt[2][64 * kCntLine];
  // the k16 slices' norms of the own rows and of a stage's rows (bf16,
  // rounded up): the midpoint test's tighter bound
  __nv_bfloat16 sn_own[64 * kSlices];
  __nv_bfloat16 sn_oth[2][64 * kSlices];
  unsigned xch[2][2][kX][128];  // [step parity][warpgroup][register][thread]
  int coff[2][64];
  float b_own[64], n_own[64];
  float b_oth[2][64], n_oth[2][64];
  float rsum[2][64];  // warpgroup 1's row sums of cost and cost^2
  float red[8];
  unsigned long long full[2], empty[2], full2, empty2, own_full, own_empty;
  unsigned flagged[8];  // RSP_K11_CLOCKS: the cells each warp summed again
};
constexpr int kSmemBytes = (int)sizeof(WgSmem) + 1024;  // + the alignment
static_assert(kSmemBytes <= 232448, "one CTA's shared memory");

__device__ __forceinline__ unsigned su32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(unsigned long long* b, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(b)),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(su32(b))
               : "memory");
}
__device__ __forceinline__ void bar_expect(unsigned long long* b,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(su32(b)),
               "r"(bytes)
               : "memory");
}
// the calling thread's cp.async copies so far arrive on b when they land
__device__ __forceinline__ void bar_cp_async(unsigned long long* b) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   su32(b))
               : "memory");
}
// Waits for the phase of parity `parity` to complete.
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
// rows [c1, c1 + 64) x components [c0, c0 + 64) of a tensor map into dst
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1,
                                        unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(su32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(su32(b))
      : "memory");
}
__device__ __forceinline__ void named_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Shared-memory operand descriptor, 128-byte swizzle: the 8-row groups 1024
// bytes apart (the K groups of an MN-major operand too; an operand here never
// spans two 64-element swizzle atoms along MN).
__device__ __forceinline__ unsigned long long desc(const void* p) {
  return (unsigned long long)((su32(p) & 0x3FFFF) >> 4) | (64ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading an accumulator before the wait
__device__ __forceinline__ void reg_fence(float (&d)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

// d (= or +=) a b', 64 x 32 x 16: a from shared memory (K-major), b the 32
// rows at db (K-major)
__device__ __forceinline__ void mma_ss(float (&d)[16], unsigned long long da,
                                       unsigned long long db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
// d (= or +=) a b, 64 x 32 x 16: a from registers (the mma.m16n8k16 A
// layout a warp), b 16 rows x 32 components at db (MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[16], const unsigned (&a)[4],
                                       unsigned long long db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// near_midpoint with the slices' own magnitudes: the tensor core's error
// on k16 slice s is at most 2^-21 sum_k |a_k b_k| <= 2^-21 |a_s| |b_s|
// (Cauchy-Schwarz a slice), and adding the kSlices slices in float32 at
// most kSlices 2^-24 sum_s |a_s| |b_s|; together under 2^-19 sum_s |a_s|
// |b_s|, which is at most 4 / kSlices of near_midpoint's 2^-21 kSlices
// |a| |b|.  an, bn: the rows' slice norms, rounded up.
__device__ __forceinline__ bool near_midpoint_slices(
    float sv, float s, float b_row, float b_col, float lx,
    const __nv_bfloat16* an, const __nv_bfloat16* bn) {
  float sigma = 0.f;
#pragma unroll
  for (int k = 0; k < kSlices; k += 2) {
    const __nv_bfloat162 a2 = *reinterpret_cast<const __nv_bfloat162*>(an + k);
    const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bn + k);
    sigma = fmaf(__low2float(a2), __low2float(b2), sigma);
    sigma = fmaf(__high2float(a2), __high2float(b2), sigma);
  }
  const float bound = 0x1p-19f * sigma * (1.f + 0x1p-18f) +
                      0x1p-22f * (fabsf(s) + fabsf(b_row) + fabsf(b_col) +
                                  fabsf(lx)) +
                      0x1p-21f * (1.f + fabsf(lx));
  return within_of_midpoint(sv, bound);
}

// Byte offset of the 16-byte chunk c (8 components) of row `row` in a
// swizzled tile of 64-row boxes.
__device__ __forceinline__ int chunk_at(int row, int c) {
  return (c >> 3) * kBox + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

// The work items of a tile: (side, own block of 64, chunk of the other
// side), side-major.
struct Item {
  int side, ob, chunk;
  __device__ __forceinline__ Item(int i, int own_blocks, int chunks) {
    chunk = i % chunks;
    ob = (i / chunks) % own_blocks;
    side = i / (chunks * own_blocks);
  }
};

}  // namespace wgk

// Launch A of the bf16 head at r <= 320 (one CTA an SM, a persistent grid
// over the work items).  Warp 8 is the producer: per item the own rows
// (TMA), biases and norms; per step of 64 other positions their rows (TMA
// into two stages), their squares (one stage), biases, norms and count
// lines (cp.async), each stage on a full / empty mbarrier pair.  The two
// consumer warpgroups each form S = w_own w_oth' for the 64 own rows and
// half of the step's other positions with wgmma (m64n32k16, both operands
// from shared memory, every k16 slice into fresh accumulators added in
// float32), turn their cells into cost and cost^2 in registers (the
// midpoint test and the exact float64 re-sums of glove_tile_sums_mma, the
// flagged cells of a fragment at a time), and hand their packed cost
// fragments to the other warpgroup through shared memory; then each sums
// cost @ w_oth and cost^2 @ w_oth^2 over the step's 64 other positions for
// its 160 components with wgmma (m64n32k16, A the cost fragments from
// registers, B the staged rows read MN-major), a step into fresh
// accumulators added in float32.  No atomics: a chunk writes its partial
// sums once, launch B adds them in order.
__global__ void __launch_bounds__(wgk::kThreads, 1)
    glove_tile_sums_wg(const __grid_constant__ CUtensorMap tw_r,
                       const __grid_constant__ CUtensorMap tw_c,
                       const __grid_constant__ CUtensorMap tw2_r,
                       const __grid_constant__ CUtensorMap tw2_c, int n_r,
                       int n_c, const void* __restrict__ X, long long sr,
                       long long sc, const float* __restrict__ gb,
                       const float* __restrict__ gn,
                       const __nv_bfloat16* __restrict__ gsn,
                       const float2* __restrict__ lut,
                       const double* __restrict__ lut64, int r, int chunks,
                       float* __restrict__ part, float* __restrict__ lpart,
                       float* s_dump) {
  using namespace wgk;
  // the tiles start on a 1024-byte swizzle atom; the offset is added to the
  // shared array itself, so that the compiler keeps every access in the
  // shared window (LDS / STS, not generic loads)
  extern __shared__ __align__(16) unsigned char smem_wg[];
  WgSmem& sm = *reinterpret_cast<WgSmem*>(
      smem_wg + ((1024u - (su32(smem_wg) & 1023u)) & 1023u));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int own_blocks = ((n_r > n_c ? n_r : n_c) + kMO - 1) / kMO;
  const int n_items = 2 * own_blocks * chunks;
  const int rb = (n_r + 3) & ~3;
  if (tid == 0) {
    bar_init(&sm.full[0], 1);
    bar_init(&sm.full[1], 1);
    bar_init(&sm.empty[0], 256);
    bar_init(&sm.empty[1], 256);
    bar_init(&sm.full2, 1);
    bar_init(&sm.empty2, 256);
    bar_init(&sm.own_full, 1);
    bar_init(&sm.own_empty, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer warpgroup: warp 8 loads, 9 to 11 wait out ----------
    // (registers are handed over by warpgroups: 128 x 128 of the launch's
    // 168 a thread go to the consumers' 232)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      int gs = 0, it = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item itm(i, own_blocks, chunks);
        const int side = itm.side;
        const int n_own = side ? n_c : n_r, n_oth = side ? n_r : n_c;
        const int own0 = itm.ob * kMO;
        if (own0 >= n_own) continue;  // the same for every warp
        const int steps = (n_oth + kMN - 1) / kMN;
        const int s0 = (int)((long long)itm.chunk * steps / chunks);
        const int s1 = (int)((long long)(itm.chunk + 1) * steps / chunks);
        const CUtensorMap* t_own = side ? &tw_c : &tw_r;
        const CUtensorMap* t_oth = side ? &tw_r : &tw_c;
        const CUtensorMap* t_oth2 = side ? &tw2_r : &tw2_c;
        const float* B_own = gb + (side ? rb : 0);
        const float* B_oth = gb + (side ? 0 : rb);
        const float* N_own = gn + (side ? rb : 0);
        const float* N_oth = gn + (side ? 0 : rb);
        const __nv_bfloat16* SN_own = gsn + (size_t)(side ? rb : 0) * kSlices;
        const __nv_bfloat16* SN_oth = gsn + (size_t)(side ? 0 : rb) * kSlices;
        const long long s_own = side ? sc : sr, s_oth = side ? sr : sc;
        const bool lines_own = s_oth == 1;
        const long long s_line = lines_own ? s_own : s_oth;

        bar_wait(&sm.own_empty, (it & 1) ^ 1);
        {
          const int q = lane & 15, p = own0 + 4 * q;
          float* dst = lane < 16 ? &sm.b_own[4 * q] : &sm.n_own[4 * q];
          const float* src = (lane < 16 ? B_own : N_own) + (p < n_own ? p : 0);
          rsp::cp_async16(dst, src, p < n_own ? 16 : 0);
        }
        for (int e = lane; e < 64 * kSlices * 2 / 16; e += 32)
          rsp::cp_async16(reinterpret_cast<unsigned char*>(sm.sn_own) + 16 * e,
                          reinterpret_cast<const unsigned char*>(
                              SN_own + (size_t)own0 * kSlices) + 16 * e, 16);
        bar_cp_async(&sm.own_full);
        __syncwarp();
        if (lane == 0) {
          bar_expect(&sm.own_full, kTile);
          for (int b = 0; b < kBoxes; ++b)
            tma_box(sm.own + b * kBox, t_own, 64 * b, own0, &sm.own_full);
        }
        for (int step = s0; step < s1; ++step, ++gs) {
          const int slot = gs & 1, q0 = step * kMN;
          bar_wait(&sm.empty[slot], ((gs >> 1) & 1) ^ 1);
          {
            const int q = lane & 15, p = q0 + 4 * q;
            float* dst =
                lane < 16 ? &sm.b_oth[slot][4 * q] : &sm.n_oth[slot][4 * q];
            const float* src =
                (lane < 16 ? B_oth : N_oth) + (p < n_oth ? p : 0);
            rsp::cp_async16(dst, src, p < n_oth ? 16 : 0);
          }
          for (int e = lane; e < 64 * kSlices * 2 / 16; e += 32)
            rsp::cp_async16(
                reinterpret_cast<unsigned char*>(sm.sn_oth[slot]) + 16 * e,
                reinterpret_cast<const unsigned char*>(
                    SN_oth + (size_t)q0 * kSlices) + 16 * e, 16);
          // count lines, as glove_tile_sums_mma stages them
          const int n_lines = lines_own ? n_own - own0 : n_oth - q0;
          const int first = lines_own ? q0 : own0;
          const int n_along = (lines_own ? n_oth : n_own) - first;
          const int len = n_along < 64 ? n_along : 64;
          for (int e = lane; e < 64 * 9; e += 32) {
            const int line = e / 9, q = e - line * 9;
            if (line >= n_lines) continue;
            const long long el =
                (long long)((lines_own ? own0 : q0) + line) * s_line + first;
            const size_t a = reinterpret_cast<size_t>(X) + 2 * (size_t)el;
            const int off = (int)(a & 15);
            if (q == 0) sm.coff[slot][line] = off;
            if (q < ((off + 2 * len + 15) >> 4))
              rsp::cp_async16(
                  &sm.cnt[slot][line * kCntLine + 16 * q],
                  reinterpret_cast<const void*>((a & ~(size_t)15) + 16 * q), 16);
          }
          bar_cp_async(&sm.full[slot]);
          __syncwarp();
          if (lane == 0) {
            bar_expect(&sm.full[slot], kTile);
            for (int b = 0; b < kBoxes; ++b)
              tma_box(sm.oth[slot] + b * kBox, t_oth, 64 * b, q0,
                      &sm.full[slot]);
          }
          bar_wait(&sm.empty2, (gs & 1) ^ 1);
          if (lane == 0) {
            bar_expect(&sm.full2, kTile);
            for (int b = 0; b < kBoxes; ++b)
              tma_box(sm.oth2 + b * kBox, t_oth2, 64 * b, q0, &sm.full2);
          }
        }
        ++it;
      }
    }
  } else {
    // ---- the consumers --------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  #ifdef RSP_K11_CLOCKS
    long long k11_clk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, k11_t = clock64();
    if (lane == 0) sm.flagged[warp] = 0;
    named_sync();
  #endif
    const int wg = tid >> 7, t = tid & 127, w = t >> 5;
    const int g = lane >> 2, tig = lane & 3;
    const int prow = 16 * w;  // the warp's first own row
    const int kr = (r + 15) / 16;
    const float slices = (float)kr;  // the midpoint test's k16 slices
    int gs = 0, it = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item itm(i, own_blocks, chunks);
      const int side = itm.side;
      const int n_own = side ? n_c : n_r, n_oth = side ? n_r : n_c;
      const int own0 = itm.ob * kMO;
      if (own0 >= n_own) continue;
      const int steps = (n_oth + kMN - 1) / kMN;
      const int s0 = (int)((long long)itm.chunk * steps / chunks);
      const int s1 = (int)((long long)(itm.chunk + 1) * steps / chunks);
      const long long s_oth = side ? sr : sc;
      const bool lines_own = s_oth == 1;

      float G[kChunks][16], A2[kChunks][16];
  #pragma unroll
      for (int c = 0; c < kChunks; ++c)
  #pragma unroll
        for (int q = 0; q < 16; ++q) G[c][q] = A2[c][q] = 0.f;
      float rc[2] = {0.f, 0.f}, rc2[2] = {0.f, 0.f}, lsum = 0.f;
      float tf[16];  // the products' fresh accumulators
  #pragma unroll
      for (int q = 0; q < 16; ++q) tf[q] = 0.f;
      bar_wait(&sm.own_full, it & 1);

      for (int step = s0; step < s1; ++step, ++gs) {
        const int slot = gs & 1, q0 = step * kMN;
        bar_wait(&sm.full[slot], (gs >> 1) & 1);
        RSP_K11_CLK(0);  // the stage's rows and counts
        const unsigned char* oth = sm.oth[slot];

        // S for the 64 own rows x this warpgroup's 32 other positions: every
        // k16 slice into fresh accumulators (two, so that one is added while
        // the next is summed), added in float32
        float s[16], f0[16], f1[16];
  #pragma unroll
        for (int q = 0; q < 16; ++q) s[q] = f0[q] = f1[q] = 0.f;
        {
          const unsigned char* bo = oth + wg * 32 * 128;
          wg_fence();
          mma_ss(f0, desc(sm.own), desc(bo), 0);
          wg_commit();
  #pragma unroll
          for (int ks = 1; ks < kSlices; ++ks) {
            const int o = (ks >> 2) * kBox + (ks & 3) * 32;
            if (ks & 1)
              mma_ss(f1, desc(sm.own + o), desc(bo + o), 0);
            else
              mma_ss(f0, desc(sm.own + o), desc(bo + o), 0);
            wg_commit();
            wg_wait<1>();
            if (ks & 1) {
              reg_fence(f0);
  #pragma unroll
              for (int q = 0; q < 16; ++q) s[q] += f0[q];
            } else {
              reg_fence(f1);
  #pragma unroll
              for (int q = 0; q < 16; ++q) s[q] += f1[q];
            }
            wg_fence();
          }
          wg_wait<0>();
          // the last slice (kSlices - 1, odd) landed in f1
          reg_fence(f1);
  #pragma unroll
          for (int q = 0; q < 16; ++q) s[q] += f1[q];
        }
        RSP_K11_CLK(1);  // S

        // cost and cost^2 in registers, a fragment (4 cells) at a time: (1)
        // flag the cells whose float32 clip(S + b_i + b_j - log x) may round to
        // the other bf16 neighbour than the exact S does; (2) the warp sums
        // the flagged cells' S exactly in float64, four cells a round, eight
        // lanes and 40 of the 320 exact products a lane each; (3) the costs,
        // their sums and the packed fragments.
        const unsigned char* cb = sm.cnt[slot];
        unsigned ca[2][4], c2a[2][4];
        float sc_[2] = {0.f, 0.f}, sc2_[2] = {0.f, 0.f}, sl = 0.f;
        // a fragment n (a compile-time constant: s, ca and c2a stay in
        // registers)
        auto fragment = [&](auto nc) {
          constexpr int n = decltype(nc)::value;
          unsigned near_mask = 0;
  #pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int pr = prow + g + 8 * (q >> 1);
            const int qr = 32 * wg + 8 * n + 2 * tig + (q & 1);
            const int line = lines_own ? pr : qr, el = lines_own ? qr : pr;
            const float x =
                own0 + pr < n_own && q0 + qr < n_oth
                    ? __uint_as_float(
                          (unsigned)*reinterpret_cast<const unsigned short*>(
                              cb + line * kCntLine + sm.coff[slot][line] + 2 * el)
                          << 16)
                    : 0.f;
            if (x > 0.f) {
              const float b_row = side ? sm.b_oth[slot][qr] : sm.b_own[pr];
              const float b_col = side ? sm.b_own[pr] : sm.b_oth[slot][qr];
              const float lx = __logf(x);
              const float sv = fminf(
                  fmaxf(s[4 * n + q] + b_row + b_col - lx, -kClip), kClip);
              if (near_midpoint(sv, s[4 * n + q], b_row, b_col, lx,
                                sm.n_own[pr], sm.n_oth[slot][qr], slices) &&
                  near_midpoint_slices(sv, s[4 * n + q], b_row, b_col, lx,
                                       sm.sn_own + pr * kSlices,
                                       sm.sn_oth[slot] + qr * kSlices))
                near_mask |= 1u << q;
            }
          }
          const unsigned fixed = near_mask;
  #ifdef RSP_K11_CLOCKS
          if (blockIdx.x == 0) {  // the warp's flagged cells, by lane 0
            const unsigned nf = __reduce_add_sync(RSP_FULL_MASK, __popc(fixed));
            if (lane == 0) sm.flagged[warp] += nf;
          }
  #endif
          // the queue of exact S, in cell order (at most four: a fragment)
          double fs0 = 0.0, fs1 = 0.0, fs2 = 0.0, fs3 = 0.0;
          int fn = 0;
          for (unsigned any = __ballot_sync(RSP_FULL_MASK, near_mask != 0); any;
               any = __ballot_sync(RSP_FULL_MASK, near_mask != 0)) {
            // four cells a round, eight lanes each: group j takes the lowest
            // flagged cell of the j-th lowest lane that has one
            const int grp = lane >> 3, gl = lane & 7;
            unsigned a = any;
            for (int j = 0; j < grp && a; ++j) a &= a - 1;
            const int L = a ? __ffs(a) - 1 : -1;
            const int qq = __shfl_sync(RSP_FULL_MASK, __ffs(near_mask) - 1,
                                       L < 0 ? 0 : L);
            double part_s = 0.0;
            if (L >= 0) {
              const int pr = prow + (L >> 2) + 8 * (qq >> 1);
              const int qr = 32 * wg + 8 * n + 2 * (L & 3) + (qq & 1);
  #pragma unroll
              for (int b = 0; b < kBoxes; ++b) {
                const uint4 xa = *reinterpret_cast<const uint4*>(
                    sm.own + chunk_at(pr, 8 * b + gl));
                const uint4 ya = *reinterpret_cast<const uint4*>(
                    oth + chunk_at(qr, 8 * b + gl));
                const unsigned xs4[4] = {xa.x, xa.y, xa.z, xa.w};
                const unsigned ys4[4] = {ya.x, ya.y, ya.z, ya.w};
  #pragma unroll
                for (int e = 0; e < 4; ++e)
                  part_s += (double)(__uint_as_float(xs4[e] << 16) *
                                     __uint_as_float(ys4[e] << 16)) +
                            (double)(__uint_as_float(xs4[e] & 0xffff0000u) *
                                     __uint_as_float(ys4[e] & 0xffff0000u));
              }
            }
  #pragma unroll
            for (int o = 4; o > 0; o >>= 1)
              part_s += __shfl_xor_sync(RSP_FULL_MASK, part_s, o);
            // the owners (the four lowest lanes with a flagged cell) take
            // their group's sum
            const int rank = __popc(any & ((1u << lane) - 1u));
            const double res = __shfl_sync(RSP_FULL_MASK, part_s, 8 * (rank & 3));
            if (near_mask != 0 && rank < 4) {
              near_mask &= near_mask - 1;
              fs0 = fn == 0 ? res : fs0;
              fs1 = fn == 1 ? res : fs1;
              fs2 = fn == 2 ? res : fs2;
              fs3 = fn == 3 ? res : fs3;
              ++fn;
            }
          }
          float cv[4], c2v[4];
  #pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int pr = prow + g + 8 * (q >> 1);
            const int qr = 32 * wg + 8 * n + 2 * tig + (q & 1);
            const int line = lines_own ? pr : qr, el = lines_own ? qr : pr;
            const bool in = own0 + pr < n_own && q0 + qr < n_oth;
            const unsigned xb =
                in ? *reinterpret_cast<const unsigned short*>(
                         cb + line * kCntLine + sm.coff[slot][line] + 2 * el)
                   : 0u;
            const bool present = __uint_as_float(xb << 16) > 0.f;
            float cost = 0.f;
            if (present) {
              // the reference adds the row's bias first: (S + b_i) + b_j
              const float b_row = side ? sm.b_oth[slot][qr] : sm.b_own[pr];
              const float b_col = side ? sm.b_own[pr] : sm.b_oth[slot][qr];
              const float2 wl = __ldg(&lut[xb]);
              float sv = fminf(
                  fmaxf(s[4 * n + q] + b_row + b_col - wl.y, -kClip), kClip);
              float svb = rsp::rbf(sv);
              if ((fixed >> q) & 1u) {  // the next queued exact S
                const double v =
                    fmin(fmax(fs0 + (double)b_row + (double)b_col -
                                  __ldg(&lut64[xb]),
                              -(double)kClip),
                         (double)kClip);
                svb = __bfloat162float(__double2bfloat16(v));  // rounded once
                sv = (float)v;
                fs0 = fs1;
                fs1 = fs2;
                fs2 = fs3;
              }
              cost = rsp::rbf(wl.x * svb);
              sl += cost * sv;
  #ifndef RSP_K11_CLOCKS
              if (s_dump != nullptr) {
                const int ii = side ? q0 + qr : own0 + pr;
                const int jj = side ? own0 + pr : q0 + qr;
                s_dump[((size_t)side * n_r + ii) * n_c + jj] = svb;
              }
  #endif
            }
            const float c2 = rsp::rbf(cost * cost);
            sc_[q >> 1] += cost;
            sc2_[q >> 1] += c2;
            cv[q] = cost;
            c2v[q] = c2;
          }
          ca[n >> 1][2 * (n & 1)] = pack_bf16(cv[0], cv[1]);
          ca[n >> 1][2 * (n & 1) + 1] = pack_bf16(cv[2], cv[3]);
          c2a[n >> 1][2 * (n & 1)] = pack_bf16(c2v[0], c2v[1]);
          c2a[n >> 1][2 * (n & 1) + 1] = pack_bf16(c2v[2], c2v[3]);
        };
        fragment(std::integral_constant<int, 0>{});
        fragment(std::integral_constant<int, 1>{});
        fragment(std::integral_constant<int, 2>{});
        fragment(std::integral_constant<int, 3>{});
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          rc[h] += sc_[h];
          rc2[h] += sc2_[h];
        }
        lsum += sl;
        RSP_K11_CLK(2);  // cost and cost^2

        // the other warpgroup's cost fragments (the same positions of its
        // threads), through shared memory
        unsigned* mine = &sm.xch[gs & 1][wg][0][t];
        const unsigned* theirs = &sm.xch[gs & 1][wg ^ 1][0][t];
  #pragma unroll
        for (int k = 0; k < 2; ++k)
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[128 * (4 * k + e)] = ca[k][e];
            mine[128 * (8 + 4 * k + e)] = c2a[k][e];
          }
        named_sync();
        unsigned A[4][4], A2f[4][4];  // k16 slices of the step's 64 positions
  #pragma unroll
        for (int k = 0; k < 2; ++k)
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned oc = theirs[128 * (4 * k + e)];
            const unsigned oc2 = theirs[128 * (8 + 4 * k + e)];
            A[k][e] = wg ? oc : ca[k][e];
            A[2 + k][e] = wg ? ca[k][e] : oc;
            A2f[k][e] = wg ? oc2 : c2a[k][e];
            A2f[2 + k][e] = wg ? c2a[k][e] : oc2;
          }

        RSP_K11_CLK(3);  // the exchange
        // cost @ w_oth and cost^2 @ w_oth^2 for this warpgroup's components,
        // a chunk of 32 and a product at a time into fresh accumulators
        bar_wait(&sm.full2, gs & 1);
        RSP_K11_CLK(4);  // the squares' stage
  #pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int comp0 = 160 * wg + kNC * c;
          if (comp0 < r) {
            const int o = (comp0 >> 6) * kBox + (comp0 & 63) * 2;
            wg_fence();
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              mma_rs(tf, A[kk], desc(oth + o + kk * 2048), kk);
            wg_commit();
            wg_wait<0>();
            reg_fence(tf);
  #pragma unroll
            for (int q = 0; q < 16; ++q) G[c][q] += tf[q];
            wg_fence();
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              mma_rs(tf, A2f[kk], desc(sm.oth2 + o + kk * 2048), kk);
            wg_commit();
            wg_wait<0>();
            reg_fence(tf);
  #pragma unroll
            for (int q = 0; q < 16; ++q) A2[c][q] += tf[q];
          }
        }
        bar_arrive(&sm.empty[slot]);
        bar_arrive(&sm.empty2);
        RSP_K11_CLK(5);  // the products
      }
      bar_arrive(&sm.own_empty);

      // the item's partial sums: [cost w | cost^2 w^2 | cost | cost^2] of
      // each own position, this warpgroup's components
      const int width = 2 * r + 2;
      float* P = part + (side ? (size_t)chunks * n_r * width : 0) +
                 (size_t)itm.chunk * n_own * width;
  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = own0 + prow + g + 8 * h;
  #pragma unroll
        for (int c = 0; c < kChunks; ++c) {
  #pragma unroll
          for (int j = 0; j < 4; ++j) {
  #pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 160 * wg + kNC * c + 8 * j + 2 * tig + e;
              if (p < n_own && k < r) {
                P[(size_t)p * width + k] = G[c][4 * j + 2 * h + e];
                P[(size_t)p * width + r + k] = A2[c][4 * j + 2 * h + e];
              }
            }
          }
        }
      }
      // the row sums: warpgroup 0's half of the positions, then 1's
      float a1[2], a2[2];
  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        a1[h] = rc[h];
        a2[h] = rc2[h];
  #pragma unroll
        for (int o = 1; o < 4; o <<= 1) {  // over the 4 lanes of one own row
          a1[h] += __shfl_xor_sync(RSP_FULL_MASK, a1[h], o);
          a2[h] += __shfl_xor_sync(RSP_FULL_MASK, a2[h], o);
        }
        if (wg == 1 && tig == 0) {
          sm.rsum[0][prow + g + 8 * h] = a1[h];
          sm.rsum[1][prow + g + 8 * h] = a2[h];
        }
      }
      float l = side == 0 ? rsp::warp_sum(lsum) : 0.f;
      if (lane == 0) sm.red[warp] = l;
      named_sync();
      if (wg == 0) {
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = own0 + prow + g + 8 * h;
          if (tig == 0 && p < n_own) {
            P[(size_t)p * width + 2 * r] = a1[h] + sm.rsum[0][prow + g + 8 * h];
            P[(size_t)p * width + 2 * r + 1] =
                a2[h] + sm.rsum[1][prow + g + 8 * h];
          }
        }
        if (side == 0 && t == 0) {
          float tot = 0.f;
          for (int k = 0; k < 8; ++k) tot += sm.red[k];
          lpart[itm.ob * chunks + itm.chunk] = tot;
        }
      }
      ++it;
      RSP_K11_CLK(6);  // the item's own rows and its partial sums
    }
#ifdef RSP_K11_CLOCKS
    named_sync();
    if (tid == 0 && blockIdx.x == 0 && s_dump != nullptr) {
      for (int q = 0; q < 8; ++q) s_dump[q] = (float)k11_clk[q];
      unsigned nf = 0;
      for (int w8 = 0; w8 < 8; ++w8) nf += sm.flagged[w8];
      s_dump[8] = (float)nf;
    }
#endif
  }
}

// Threads [0, n_r (r + 1)) apply the row side, the rest the column side;
// within a side, thread p (r + 1) + k is component k of position p, k = r
// its bias.
// (T = bf16: the sums rounded to bf16, then the step op by op at bf16.)
__device__ __forceinline__ void stt(float* p, float v) { *p = v; }
__device__ __forceinline__ void stt(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__global__ void glove_tile_apply(const int* __restrict__ rows,
                                 const int* __restrict__ cols, int n_r,
                                 int n_c, int r, int chunks,
                                 const float* __restrict__ part,
                                 const float* __restrict__ lpart, int n_lpart,
                                 T* w_i, T* w_j, T* b_i, T* b_j,
                                 T* acc_w_i, T* acc_w_j,
                                 T* acc_b_i, T* acc_b_j, float lr,
                                 float* loss) {
  constexpr bool kB = std::is_same<T, __nv_bfloat16>::value;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) {
    float l = 0.f;
    for (int t = 0; t < n_lpart; ++t) l += lpart[t];
    *loss = kB ? rsp::rbf(l) : l;
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
  T* w = k < r ? (col ? w_j : w_i) : (col ? b_j : b_i);
  T* acc = k < r ? (col ? acc_w_j : acc_w_i) : (col ? acc_b_j : acc_b_i);
  const size_t e = k < r ? (size_t)f * r + k : (size_t)f;
  if constexpr (kB) {
    s1 = rsp::rbf(s1);
    s2 = rsp::rbf(s2);
    const float av = rsp::rbf(ldt(acc + e) + s2);
    stt(w + e, ldt(w + e) + rsp::rbf(rsp::rbf(-lr * s1) /
                                     rsp::rbf(sqrtf(av))));
    stt(acc + e, av);
  } else {
    const float av = acc[e] + s2;
    w[e] += -lr * s1 / sqrtf(av);
    acc[e] = av;
  }
}

int n_sms() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n_sm = 132;
  }
  return n_sm;
}

// Chunks of the other side per CTA row of the tensor-core path (own
// blocks of kMO positions) and of the bf16-state walk (kO): the count (at
// most 4: each adds a tile's worth of partial sums) with the fewest waves
// x steps a chunk, at two CTAs an SM at r <= 128 and one at 320.
int plan_chunks_mma(int n_r, int n_c, int r, int own = kMO) {
  const int n = n_r > n_c ? n_r : n_c;
  const int own_blocks = (n + own - 1) / own, steps = (n + kMN - 1) / kMN;
  const int slots = (r <= kMaxR ? 2 : 1) * n_sms();
  int best = 1;
  long long best_t = -1;
  for (int c = 1; c <= 4 && c <= steps; ++c) {
    const long long waves = (2LL * own_blocks * c + slots - 1) / slots;
    const long long t = waves * ((steps + c - 1) / c);
    if (best_t < 0 || t < best_t) {
      best_t = t;
      best = c;
    }
  }
  return best;
}

// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of n_rows rows of 320 bf16 at base, read in 64 x 64 boxes
// with the 128-byte swizzle (rows past n_rows read as zero).
int row_map(CUtensorMap* m, const void* base, int n_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)wgk::kR, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)wgk::kR * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Scratch floats of the tensor-core path: partials, loss partials, then
// (16-byte aligned) the gathered bf16 rows and squares, the biases, the
// rows' norms and the weight table.
struct MmaScratch {
  long long part, lpart, gw, gw2, gb, gn, gsn, lut, lut64, total;
};
// The instance width that takes rank r (128 or 320), 0 above the widest.
int width_of(int r) {
  return r < 1 ? 0 : r <= kMaxR ? kMaxR : r <= kMaxRWide ? kMaxRWide : 0;
}

MmaScratch mma_scratch(int n_r, int n_c, int r) {
  const long long chunks = plan_chunks_mma(n_r, n_c, r);
  const long long mr = width_of(r);
  MmaScratch m;
  m.part = 0;
  m.lpart = chunks * (n_r + n_c) * (2LL * r + 2);
  m.gw = (m.lpart + chunks * ((n_r + kMO - 1) / kMO) + 3) & ~3LL;
  m.gw2 = m.gw + (long long)(n_r + n_c) * mr / 2;
  m.gb = m.gw2 + (long long)(n_r + n_c) * mr / 2;
  m.gn = m.gb + ((n_r + 3) & ~3) + ((n_c + 3) & ~3) + 4;
  m.gsn = m.gn + ((n_r + 3) & ~3) + ((n_c + 3) & ~3) + 4;
  // the wide kernel's slice norms: 20 bf16 a row, each side from a multiple
  // of 4 rows, and 64 rows past the end (a last block's stage reads them)
  const long long sn_rows =
      mr > kMaxR ? ((n_r + 3) & ~3) + ((n_c + 3) & ~3) + 64 : 0;
  m.lut = m.gsn + sn_rows * (wgk::kR / 16) / 2;
  m.lut64 = m.lut + 2LL * kLut;
  m.total = m.lut64 + 2LL * kLut;
  return m;
}

// Scratch floats of the bf16-state walk: partials, loss partials, then
// (16-byte aligned) the gathered bf16 rows, the biases, the rows' norms
// and the weight table.
struct WalkScratch {
  long long part, lpart, gw, gb, gn, lut, total;
};
WalkScratch walk_scratch(int n_r, int n_c, int r) {
  const long long chunks = plan_chunks_mma(n_r, n_c, r, kO);
  const long long mr = width_of(r);
  WalkScratch m;
  m.part = 0;
  m.lpart = chunks * (n_r + n_c) * (2LL * r + 2);
  m.gw = (m.lpart + chunks * ((n_r + kO - 1) / kO) + 3) & ~3LL;
  m.gb = m.gw + (long long)(n_r + n_c) * mr / 2;
  m.gn = m.gb + ((n_r + 3) & ~3) + ((n_c + 3) & ~3) + 4;
  m.lut = m.gn + ((n_r + 3) & ~3) + ((n_c + 3) & ~3) + 4;
  m.total = m.lut + 2LL * kLut;
  return m;
}

// Launch A (and the gather of the bf16 path) of a tile at instance width
// MR: sets chunks, n_lpart and lpart for launch B.
// T: the state's table type (bf16: the bf16-state instance, BS below,
// which takes the bf16 head only and runs the present-cell walk).
template <int MR, typename T>
int tile_sums(const int* rows, const int* cols, int n_r, int n_c,
              const void* X, long long sr, long long sc, int bf16,
              const T* w_i, const T* w_j, const T* b_i,
              const T* b_j, int r, float x_max, float alpha,
              float* scratch, float* s_dump, cudaStream_t st, int& chunks,
              int& n_lpart, float*& lpart) {
  constexpr bool BS = std::is_same<T, __nv_bfloat16>::value;
  // above 48 KB a kernel's dynamic shared memory must be opted into
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        glove_tile_sums<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem<MR>));
    if constexpr (BS) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(glove_tile_walk_bf16<MR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(WalkSmem<MR>));
    } else if constexpr (MR <= kMaxR) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(glove_tile_sums_mma<MR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(MmaSmem<MR>));
    } else {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(glove_tile_sums_wg,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 wgk::kSmemBytes);
    }
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if constexpr (BS) {
    const WalkScratch m = walk_scratch(n_r, n_c, r);
    chunks = plan_chunks_mma(n_r, n_c, r, kO);
    const int own_blocks = ((n_r > n_c ? n_r : n_c) + kO - 1) / kO;
    n_lpart = chunks * ((n_r + kO - 1) / kO);
    lpart = scratch + m.lpart;
    auto* gw = reinterpret_cast<__nv_bfloat16*>(scratch + m.gw);
    float* gb = scratch + m.gb;
    float* gn = scratch + m.gn;
    auto* lut = reinterpret_cast<float2*>(scratch + m.lut);
    long long ng = 32LL * (n_r + n_c);
    if (ng < kLut) ng = kLut;
    glove_tile_gather<MR, T><<<(unsigned)((ng + 255) / 256), 256, 0, st>>>(
        rows, cols, n_r, n_c, w_i, w_j, b_i, b_j, r, x_max, alpha, gw,
        nullptr, gb, gn, nullptr, lut, nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    glove_tile_walk_bf16<MR><<<dim3(own_blocks, chunks, 2), kThreads,
                               sizeof(WalkSmem<MR>), st>>>(
        n_r, n_c, static_cast<const __nv_bfloat16*>(X), sr, sc, gw, gb, gn,
        lut, r, chunks, scratch, lpart);
    (void)s_dump;
  } else if (bf16) {
    const MmaScratch m = mma_scratch(n_r, n_c, r);
    chunks = plan_chunks_mma(n_r, n_c, r);
    const int own_blocks = ((n_r > n_c ? n_r : n_c) + kMO - 1) / kMO;
    n_lpart = chunks * ((n_r + kMO - 1) / kMO);
    lpart = scratch + m.lpart;
    auto* gw = reinterpret_cast<__nv_bfloat16*>(scratch + m.gw);
    auto* gw2 = reinterpret_cast<__nv_bfloat16*>(scratch + m.gw2);
    float* gb = scratch + m.gb;
    float* gn = scratch + m.gn;
    auto* gsn = reinterpret_cast<__nv_bfloat16*>(scratch + m.gsn);
    auto* lut = reinterpret_cast<float2*>(scratch + m.lut);
    auto* lut64 = reinterpret_cast<double*>(scratch + m.lut64);
    long long ng = 32LL * (n_r + n_c);
    if (ng < kLut) ng = kLut;
    glove_tile_gather<MR, T><<<(unsigned)((ng + 255) / 256), 256, 0, st>>>(
        rows, cols, n_r, n_c, w_i, w_j, b_i, b_j, r, x_max, alpha, gw, gw2,
        gb, gn, gsn, lut, lut64);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if constexpr (MR <= kMaxR) {
      glove_tile_sums_mma<MR><<<dim3(own_blocks, chunks, 2),
                                MmaShape<MR>::kThreads, sizeof(MmaSmem<MR>),
                                st>>>(n_r, n_c, X, sr, sc, gw, gw2, gb, gn,
                                      lut, lut64, r, chunks, scratch, lpart,
                                      s_dump);
    } else {
      // the four row maps: w and bf16(w^2) of each side
      CUtensorMap maps[4];
      const __nv_bfloat16* bases[4] = {gw, gw + (size_t)n_r * MR, gw2,
                                       gw2 + (size_t)n_r * MR};
      for (int q = 0; q < 4; ++q)
        if (int e = row_map(&maps[q], bases[q], q & 1 ? n_c : n_r)) return e;
      const int items = 2 * own_blocks * chunks;
      glove_tile_sums_wg<<<items < n_sms() ? items : n_sms(),
                               wgk::kThreads,
                           wgk::kSmemBytes, st>>>(
          maps[0], maps[1], maps[2], maps[3], n_r, n_c, X, sr, sc, gb, gn,
          gsn, lut, lut64, r, chunks, scratch, lpart, s_dump);
    }
  } else {
    chunks = plan_chunks(n_r, n_c);
    const int own_blocks = ((n_r > n_c ? n_r : n_c) + kO - 1) / kO;
    n_lpart = chunks * ((n_r + kO - 1) / kO);
    lpart = scratch + (size_t)chunks * (n_r + n_c) * (2 * r + 2);
    const int vec = (r & 3) == 0 && (reinterpret_cast<size_t>(w_i) & 15) == 0 &&
                    (reinterpret_cast<size_t>(w_j) & 15) == 0;
    glove_tile_sums<MR><<<dim3(own_blocks, chunks, 2), kThreads,
                          sizeof(Smem<MR>), st>>>(
        rows, cols, n_r, n_c, static_cast<const float*>(X), sr, sc, w_i, w_j,
        b_i, b_j, r, vec, x_max, alpha, chunks, scratch, lpart);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int tile(const int* rows, const int* cols, int n_r, int n_c, const void* X,
         long long sr, long long sc, int bf16, void* const* tabs, int r,
         float x_max, float alpha, float lr, float* scratch, float* loss,
         float* s_dump, cudaStream_t st) {
  // tabs: w_i, w_j, b_i, b_j, acc_w_i, acc_w_j, acc_b_i, acc_b_j
  T* const* t = reinterpret_cast<T* const*>(tabs);
  int chunks = 0, n_lpart = 0;
  float* lpart = nullptr;
  const int rc = r <= kMaxR
                     ? tile_sums<kMaxR, T>(rows, cols, n_r, n_c, X, sr, sc,
                                           bf16, t[0], t[1], t[2], t[3], r,
                                           x_max, alpha, scratch, s_dump, st,
                                           chunks, n_lpart, lpart)
                     : tile_sums<kMaxRWide, T>(rows, cols, n_r, n_c, X, sr,
                                               sc, bf16, t[0], t[1], t[2],
                                               t[3], r, x_max, alpha, scratch,
                                               s_dump, st, chunks, n_lpart,
                                               lpart);
  if (rc != 0 || s_dump != nullptr) return rc;
  const long long n = (long long)(n_r + n_c) * (r + 1);
  glove_tile_apply<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      rows, cols, n_r, n_c, r, chunks, scratch, lpart, n_lpart, t[0], t[1],
      t[2], t[3], t[4], t[5], t[6], t[7], lr, loss);
  return (int)cudaGetLastError();
}

}  // namespace

// The instance width that takes rank r (128 or 320), 0 above the widest.
extern "C" int rsp_glove_tile_width(int r) { return width_of(r); }

// Floats of scratch one tile needs (the wrapper allocates it uninitialised).
extern "C" long long rsp_glove_tile_scratch(int n_r, int n_c, int r,
                                            int bf16, int state_bf16) {
  if (state_bf16) return walk_scratch(n_r, n_c, r).total;
  if (bf16) return mma_scratch(n_r, n_c, r).total;
  const long long chunks = plan_chunks(n_r, n_c);
  return chunks * (n_r + n_c) * (2LL * r + 2) +
         chunks * ((n_r + kO - 1) / kO);
}

// rows (n_r,), cols (n_c,) int32: the tile's distinct hot ids; X the
// tile's counts, element (a, b) at X[a sr + b sc] (f32, or bf16 when bf16
// != 0, which also rounds the products' operands to bf16 and runs them on
// the tensor cores; then sr or sc must be 1); the eight state tables f32,
// or bf16 when state_bf16 != 0 (the bf16-state instance, the present-cell
// walk: bf16 != 0, and x_max, alpha and lr bf16 values), updated in place;
// scratch of rsp_glove_tile_scratch floats; loss (one float) receives the
// tile's sum(cost * S).  s_dump, for checks only, is null or (2, n_r, n_c)
// floats that receive, at the present cells, the bf16 value of clip(S +
// b_i + b_j - log x) that each side of the bf16 head over float32 state
// formed (the row side's [i, j], the column side's [j, i]); then the
// state is left as it was.  The bf16-state walk takes none.
extern "C" int rsp_glove_tile(const int* rows, const int* cols, int n_r,
                              int n_c, const void* X, long long sr,
                              long long sc, int bf16, int state_bf16,
                              void* w_i, void* w_j, void* b_i, void* b_j,
                              void* acc_w_i, void* acc_w_j, void* acc_b_i,
                              void* acc_b_j, int r, float x_max, float alpha,
                              float lr, float* scratch, float* loss,
                              float* s_dump, void* stream) {
  if (n_r <= 0 || n_c <= 0 || width_of(r) == 0 || !scratch || !loss)
    return (int)cudaErrorInvalidValue;
  if (bf16 && sr != 1 && sc != 1) return (int)cudaErrorInvalidValue;
  if (s_dump != nullptr && !bf16) return (int)cudaErrorInvalidValue;
  if (state_bf16 && !bf16) return (int)cudaErrorInvalidValue;
  if (s_dump != nullptr && state_bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  void* const tabs[8] = {w_i, w_j, b_i, b_j, acc_w_i, acc_w_j, acc_b_i,
                         acc_b_j};
  return state_bf16
             ? tile<__nv_bfloat16>(rows, cols, n_r, n_c, X, sr, sc, bf16,
                                   tabs, r, x_max, alpha, lr, scratch, loss,
                                   s_dump, st)
             : tile<float>(rows, cols, n_r, n_c, X, sr, sc, bf16, tabs, r,
                           x_max, alpha, lr, scratch, loss, s_dump, st);
}
