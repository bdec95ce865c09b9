// K4: one bucket of non-negative ALS solves (NNLS by sequential coordinate
// descent), implicit or explicit feedback, with an optional dense zipf head.
//
// Replaces the TPU program rsparse_tpu/ops/solvers.py:254 batched_nnls as
// rsparse_tpu/ops/als.py reaches it (:243-245 implicit, :358-360
// explicit), with the lhs of those branches.  Its plain PyTorch version is
// rsparse_tpu_torch/ops/solvers.py batched_nnls behind ops/als.py
// _solve_bucket_implicit / _explicit; tests/test_torch_k4_split.py runs
// this kernel's split (the packed G, the sweeps from it) in plain torch.
//
// For each target row b:
//   lhs, rhs  as K2 builds them (rsp::build_normal_equations, common.cuh);
//   G  = lhs' lhs + eps I (lhs is symmetric, so G = lhs lhs);
//   mu = G x0 - lhs' rhs;
//   sweeps over the coordinates k = 0 .. d-1 in order (reference
//   inst/include/nnls.hpp:11-34): x_k' = max(x_k - mu_k / G_kk, 0),
//   mu += (x_k' - x_k) G[:, k]; a system stops after the first sweep whose
//   largest |x_k' - x_k| / (|x_k| + eps) is at most rel_tol, or after
//   max_iter sweeps.  The stop is per system, as in nnls.hpp; the TPU
//   program stops the whole batch at once (ROADMAP queue 3).
//   Then the loss as in K1.
//
// Built for d <= 128 and d <= 160, each for float and bf16 source tables
// (the rounding points of compute_dtype="bfloat16" are those of the shared
// normal-equation build and of K1's loss; the sweeps are f32 either way).
// At 160 < d <= 514 rsp_als_nnls runs als_nnls_wide.cu's kernels.
//
// What bounds it on the H100: the coordinate sweeps, a chain of d
// dependent steps per sweep, times the sweeps a system needs (G squares the
// condition number of the lhs: thousands at config #2 (c), up to the
// budget of 10,000).  A step is a shuffle of mu_k from the lane that holds
// it, the clamp, and d / 32 FMAs per lane into mu that the next step's
// shuffle waits for.  A kernel that runs the build and the sweeps in one CTA
// of eight warps (this kernel's first form) holds lhs and G, 2 d^2 floats
// of shared memory (133 KB at d = 129): one CTA runs per SM, and while one
// warp sweeps the other seven wait.  132 warps sweep on the whole card, and
// a bucket waits for its slowest system on every SM.
//
// What the design does about it: three launches.
// (1) Build: one CTA of eight warps per system, as before, writes G as its
//     packed lower triangle (G[i, k] = P[i (i + 1) / 2 + k] for i >= k:
//     d (d + 1) / 2 floats, 33 KB at d = 128) and mu to a scratch buffer in
//     device memory (the wrapper's; a bucket too large for it runs in
//     slices of systems, each built and swept in turn).
// (2) Sweeps: one warp per system, kSweepWarps warps a block, as many
//     blocks an SM as shared memory allows (six systems at d = 128 or 129,
//     against one); a persistent grid whose warps take the next
//     system from an atomic counter, so a warp that finishes a short system
//     starts another at once and a bucket's tail is its hardest system
//     alone.  A warp copies its system's packed G into its slice of shared
//     memory with 16-byte cp.async, holds x and mu in registers (lane l:
//     coordinates l, l + 32, ...), and reads G[i, k] as row k of P for
//     i < k and column k for i >= k.  A step's chain is the shuffle of
//     mu_k, the quotient, the clamp and the FMAs into mu: the loads of the
//     next step's column are issued during the step, G_kk and its
//     correctly rounded reciprocal are taken once per system (the quotient
//     mu_k / G_kk is then one multiply and one correction, still correctly
//     rounded, as the plain version divides), and the stop test runs once
//     per sweep, each lane over its own coordinates, then a vote.  The
//     sweeps are thereby the plain version's arithmetic (its mu update
//     rounds twice where the FMA here rounds once, as the first form's
//     did).  G and mu are summed in f64 and rounded once: summed in f32,
//     K4's fitted solutions on rows of thousands of entries sat several
//     times further from float64 than the plain version's (PERF.md,
//     section 6), near K4's limit.
// (3) Loss: one CTA per system from the solved x, as in K1 (rsp::row_loss).

#include <math.h>

#include "common.cuh"

namespace {

constexpr float kEps = 1e-16f;  // NNLS_EPS of ops/solvers.py
constexpr int kSweepWarps = 2;  // systems (warps) a block of the sweep stage

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// floats of one system in the scratch: packed G, then mu, each padded to a
// multiple of 4 floats (16 bytes)
__host__ __device__ constexpr int g_floats(int d) { return round4(tri(d)); }
__host__ __device__ constexpr int sys_floats(int d) {
  return g_floats(d) + round4(d);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// (1) the normal equations, G and mu of system s0 + blockIdx.x into
// scratch + blockIdx.x * sys_floats(d); block 0 also zeroes the sweep
// stage's work counter.
template <int KMAXD, class T, bool EXPLICIT>
__global__ void __launch_bounds__(rsp::kGramThreads)
nnls_build_kernel(rsp::BucketArgs a, int s0, float* __restrict__ scratch,
                  int* __restrict__ counter) {
  constexpr int KT = KMAXD / 16;
  extern __shared__ float smem[];
  const int d = a.d, b = s0 + blockIdx.x, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int gw = max(d * d, rsp::gram_smem_floats(d));
  float* A = smem;                  // d x d lhs
  float* G = A + d * d;             // workspace of the build, then G
  float* rhs = G + gw;              // d
  float* x = rhs + d;               // d
  if (blockIdx.x == 0 && tid == 0) *counter = 0;

  rsp::build_normal_equations<KMAXD, EXPLICIT, T>(
      a, b, rsp::row_lambda(a, b), A, rhs, rsp::gram_smem(G, d));

  // ---- G = lhs' lhs + eps I, summed in f64 and rounded once ----------------
  // (the build's workspace in G is read no more: the build ends in a
  // barrier); half of this thread's rows at a time, for the registers
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    constexpr int KH = KT / 2;
    double acc[KH][KT];
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) acc[i][j] = 0.0;
    for (int k = 0; k < d; ++k) {
      const float* row = A + k * d;
      double av[KH], bv[KT];
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int ri = ty + 16 * (h * KH + i);
        av[i] = ri < d ? row[ri] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int ci = tx + 16 * j;
        bv[j] = ci < d ? row[ci] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < KH; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int ri = ty + 16 * (h * KH + i), ci = tx + 16 * j;
        if (ri < d && ci < d)
          G[ri * d + ci] = (float)acc[i][j] + (ri == ci ? kEps : 0.f);
      }
  }
  for (int t = tid; t < d; t += rsp::kGramThreads)
    x[t] = a.x0 != nullptr ? a.x0[(size_t)b * d + t] : 0.f;
  __syncthreads();

  // ---- packed G and mu = G x0 - lhs' rhs (summed in f64) to the scratch ---
  float* dst = scratch + (size_t)blockIdx.x * sys_floats(d);
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < d; i += rsp::kGramThreads / 32)
    for (int j = lane; j <= i; j += 32) dst[tri(i) + j] = G[i * d + j];
  for (int t = tid; t < d; t += rsp::kGramThreads) {
    double gx = 0.0, ar = 0.0;
    for (int i = 0; i < d; ++i) {
      gx = fma((double)G[t * d + i], (double)x[i], gx);
      ar = fma((double)A[i * d + t], (double)rhs[i], ar);
    }
    dst[g_floats(d) + t] = (float)(gx - ar);
  }
}

// (2) the sweeps of systems s0 .. s0 + n_sys - 1, one warp each, taken from
// *counter; writes y and the sweeps each system ran.
template <int PL>
__global__ void __launch_bounds__(32 * kSweepWarps)
nnls_sweep_kernel(const float* __restrict__ scratch, int s0, int n_sys, int d,
                  const float* __restrict__ x0, float* __restrict__ y,
                  int max_iter, float rel_tol, int* __restrict__ sweeps,
                  int* __restrict__ counter) {
  // kSweepWarps slices of sys_floats(d): a packed G, then d floats that a
  // step past the last one may read
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int gf = g_floats(d);
  float* P = smem + (threadIdx.x >> 5) * sys_floats(d);
  // this lane's coordinates i = lane + 32 m: tri(i), or 0 past d (such a
  // lane reads G[0, k], in the slice, and its x and mu are never read)
  int ti[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) {
    const int i = lane + 32 * m;
    ti[m] = i < d ? tri(i) : 0;
  }

  for (;;) {
    int s = 0;
    if (lane == 0) s = atomicAdd(counter, 1);
    s = __shfl_sync(RSP_FULL_MASK, s, 0);
    if (s >= n_sys) break;
    const int b = s0 + s;
    const float* src = scratch + (size_t)s * sys_floats(d);
    for (int c = 4 * lane; c < gf; c += 128) cp_async16(P + c, src + c);
    asm volatile("cp.async.commit_group;\n" ::);
    float xr[PL], mr[PL];
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int k = lane + 32 * m;
      xr[m] = k < d && x0 != nullptr ? x0[(size_t)b * d + k] : 0.f;
      mr[m] = k < d ? src[gf + k] : 0.f;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
    // this lane's G_kk and 1 / G_kk (correctly rounded), for its k
    float gd[PL], rd[PL];
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int i = lane + 32 * m;
      gd[m] = i < d ? P[ti[m] + i] : 1.f;
      rd[m] = __frcp_rn(gd[m]);
    }

    int t = 0;
    bool go = true;
    while (t < max_iter && go) {
      float xs[PL];  // x at the sweep's start
#pragma unroll
      for (int m = 0; m < PL; ++m) xs[m] = xr[m];
      // ga: where this lane's G[i, k] lies in P, column k (tri(i) + k) for
      // i >= k, row k (tri(k) + i) once k > i; each step moves it to the
      // next step's (by 1, or by k + 1 in the row) and loads that
      int ga[PL];
      float gc[PL];
#pragma unroll
      for (int mm = 0; mm < PL; ++mm) {
        ga[mm] = ti[mm];
        gc[mm] = P[ga[mm]];
      }
#pragma unroll
      for (int m = 0; m < PL; ++m) {
        const int jn = min(32, d - 32 * m);
#pragma unroll 2
        for (int j = 0; j < jn; ++j) {
          const int kn = 32 * m + j + 1;
          float gn[PL];
#pragma unroll
          for (int mm = 0; mm < PL; ++mm) {
            ga[mm] += kn > lane + 32 * mm ? kn : 1;
            gn[mm] = P[ga[mm]];
          }
          const float old = __shfl_sync(RSP_FULL_MASK, xr[m], j);
          const float g = __shfl_sync(RSP_FULL_MASK, gd[m], j);
          const float r = __shfl_sync(RSP_FULL_MASK, rd[m], j);
          const float mk = __shfl_sync(RSP_FULL_MASK, mr[m], j);
          // mk / g correctly rounded, as the plain version divides: one
          // correction of mk * r, with r = RN(1 / g)
          const float q0 = mk * r;
          const float q = fmaf(fmaf(-g, q0, mk), r, q0);
          const float nw = fmaxf(old - q, 0.f);
          const float diff = nw - old;
#pragma unroll
          for (int mm = 0; mm < PL; ++mm) mr[mm] += diff * gc[mm];
          if (lane == j) xr[m] = nw;
#pragma unroll
          for (int mm = 0; mm < PL; ++mm) gc[mm] = gn[mm];
        }
      }
      // the stop test of the sweep, as the plain version takes it: the
      // largest |x_k - start_k| / (|start_k| + eps) against rel_tol
      bool moved = false;
#pragma unroll
      for (int m = 0; m < PL; ++m)
        moved |= lane + 32 * m < d &&
                 fabsf(xr[m] - xs[m]) / (fabsf(xs[m]) + kEps) > rel_tol;
      go = __any_sync(RSP_FULL_MASK, moved);
      ++t;
    }
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int k = lane + 32 * m;
      if (k < d) y[(size_t)b * d + k] = xr[m];
    }
    if (lane == 0 && sweeps != nullptr) sweeps[b] = t;
    __syncwarp();  // every lane is done with P before the next copy
  }
}

// (3) the loss of row blockIdx.x from its solution y.
template <int KMAXD, class T, bool EXPLICIT>
__global__ void __launch_bounds__(rsp::kGramThreads)
nnls_loss_kernel(rsp::BucketArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, b = blockIdx.x;
  float* x = smem;                  // d
  float* buf = x + d;               // d
  float* scratch = buf + d;         // 32
  for (int t = threadIdx.x; t < d; t += rsp::kGramThreads)
    x[t] = a.y[(size_t)b * d + t];
  __syncthreads();
  const float total = rsp::row_loss<KMAXD / 32, EXPLICIT>(
      rsp::row_entries<T>(a, b), a, x,
      rsp::dot_operand(x, buf, d, a.round_bf16 != 0), rsp::row_lambda(a, b),
      scratch);
  if (threadIdx.x == 0) a.loss[b] = total;
}

using Build = void (*)(rsp::BucketArgs, int, float*, int*);
using Sweep = void (*)(const float*, int, int, int, const float*, float*, int,
                       float, int*, int*);
using Loss = void (*)(rsp::BucketArgs);

Sweep sweep_kernel(int d) {
  return d > 128 ? nnls_sweep_kernel<5> : nnls_sweep_kernel<4>;
}

// Blocks of the sweep stage an SM holds at width d (shared memory bound),
// with the kernel's attributes set for that width.
int sweep_blocks_per_sm(int d, size_t* smem_out) {
  const Sweep kern = sweep_kernel(d);
  const size_t smem = sizeof(float) * (size_t)kSweepWarps * sys_floats(d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, 32 * kSweepWarps, smem);
  if (smem_out != nullptr) *smem_out = smem;
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// The wide widths, 160 < d <= 514 (als_nnls_wide.cu).
extern "C" long long rsp_als_nnls_wide_stride(int d);
extern "C" int rsp_als_nnls_wide_inflight(int d);
extern "C" int rsp_als_nnls_wide(const rsp::BucketArgs* args, int max_iter,
                                 float rel_tol, int* sweeps, float* scratch,
                                 int slice, int* counter, void* stream);

extern "C" long long rsp_als_nnls_wide_extra(int d, int B);

// Floats of scratch one system of a slice takes (packed G and mu; at d >
// 160 G and mu whole), or minus a CUDA error past d = 514.
extern "C" int rsp_als_nnls_stride(int d) {
  return d > 160 ? (int)rsp_als_nnls_wide_stride(d) : sys_floats(d);
}

// Floats of scratch past a bucket of B systems' slice: none at d <= 160;
// above, the lhs and rhs of a sub-slice of systems (als_nnls_wide.cu).
extern "C" long long rsp_als_nnls_extra(int d, int B) {
  return d > 160 ? rsp_als_nnls_wide_extra(d, B) : 0;
}

// Systems sweeping at once on one SM at width d (warps of the sweep stage
// an SM holds), or minus a CUDA error.
extern "C" int rsp_als_nnls_inflight(int d) {
  if (d > 160) return rsp_als_nnls_wide_inflight(d);
  if (d <= 0) return -(int)cudaErrorInvalidValue;
  const int n = sweep_blocks_per_sm(d, nullptr);
  return n < 0 ? n : n * kSweepWarps;
}

// args: the bucket (rsp::BucketArgs; y and loss are written); sweeps (B,)
// int32 or null; scratch: slice * rsp_als_nnls_stride(d) +
// rsp_als_nnls_extra(d, B) floats; slice: the systems built and swept at
// a time; counter: one int32 of device memory.
extern "C" int rsp_als_nnls(const rsp::BucketArgs* args, int max_iter,
                            float rel_tol, int* sweeps, float* scratch,
                            int slice, int* counter, void* stream) {
  const rsp::BucketArgs a = *args;
  if (a.d > 160)
    return rsp_als_nnls_wide(args, max_iter, rel_tol, sweeps, scratch, slice,
                             counter, stream);
  if (a.B <= 0) return 0;
  if (a.d <= 0 || slice <= 0) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  // [d <= 128 ? 0 : 1][bf16 table][explicit]
  static const Build builds[2][2][2] = {
      {{nnls_build_kernel<128, float, false>, nnls_build_kernel<128, float, true>},
       {nnls_build_kernel<128, bf16, false>, nnls_build_kernel<128, bf16, true>}},
      {{nnls_build_kernel<160, float, false>, nnls_build_kernel<160, float, true>},
       {nnls_build_kernel<160, bf16, false>, nnls_build_kernel<160, bf16, true>}}};
  static const Loss losses[2][2][2] = {
      {{nnls_loss_kernel<128, float, false>, nnls_loss_kernel<128, float, true>},
       {nnls_loss_kernel<128, bf16, false>, nnls_loss_kernel<128, bf16, true>}},
      {{nnls_loss_kernel<160, float, false>, nnls_loss_kernel<160, float, true>},
       {nnls_loss_kernel<160, bf16, false>, nnls_loss_kernel<160, bf16, true>}}};
  const int wide = a.d > 128, tb = a.table_bf16 != 0, ex = a.explicit_fb != 0;
  const Build build = builds[wide][tb][ex];
  const Loss loss = losses[wide][tb][ex];
  const cudaStream_t st = (cudaStream_t)stream;
  const int d = a.d;

  const size_t build_smem =
      sizeof(float) * ((size_t)d * d +
                       (size_t)(d * d > rsp::gram_smem_floats(d)
                                    ? d * d : rsp::gram_smem_floats(d)) +
                       2 * (size_t)d);
  cudaError_t err = cudaFuncSetAttribute(
      build, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)build_smem);
  if (err != cudaSuccess) return (int)err;
  size_t sweep_smem = 0;
  const int per_sm = sweep_blocks_per_sm(d, &sweep_smem);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const Sweep sweep = sweep_kernel(d);

  for (int s0 = 0; s0 < a.B; s0 += slice) {
    const int n = a.B - s0 < slice ? a.B - s0 : slice;
    build<<<n, rsp::kGramThreads, build_smem, st>>>(a, s0, scratch, counter);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int want = (n + kSweepWarps - 1) / kSweepWarps;
    const int grid = want < per_sm * n_sm ? want : per_sm * n_sm;
    sweep<<<grid, 32 * kSweepWarps, sweep_smem, st>>>(
        scratch, s0, n, d, a.x0, a.y, max_iter, rel_tol, sweeps, counter);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  loss<<<a.B, rsp::kGramThreads, sizeof(float) * (2 * (size_t)d + 32), st>>>(a);
  return (int)cudaGetLastError();
}
