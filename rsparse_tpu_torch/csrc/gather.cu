// K12: row gather out[i, :] = table[idx[i], :] for a float or bf16 table of
// d <= 512 columns and int32 indices, in the two layouts the probes use.
//
// Replaces the Pallas probes scripts/exp_gather.py:72 mk (pallas_call :74;
// kern_take :87, kern_tala :91, kern_dslice_loop :99: 2,097,152 rows of a
// 32,768 x 128 bf16 table held whole in VMEM) and scripts/exp_gather2.py:41
// b1, :56 b2 and :74 b3 (pallas_call :45, :63, :79: take_along_axis over
// the whole table, a 2048-row tile, and a lane gather out[:, j] =
// tabT[:, idx[j]] on the transposed table, which is this kernel on the
// strided views tabT.T -> out.T).  Its plain PyTorch version is
// rsparse_tpu_torch/ops/gather.py _gather_rows_plain (table[idx]).
//
// Two layouts:
//   vector: unit column strides and 16-byte aligned rows: lpr lanes of a
//           warp copy one row in 16-byte loads and stores (a power of two
//           up to 32, so a 256-byte bf16 row of d = 128 takes 16 lanes and
//           a warp moves two rows at a time);
//   lanes:  unit ROW strides (a transposed table tabT (d, N) and output
//           outT (d, n)), in two cases that ops/gather.py lane_plan picks:
//     staged:      a block copies rt whole rows of tabT (N elements each)
//                  into shared memory with 16-byte cp.async, then walks a
//                  span of j: each thread reads 16 bytes of indices, looks
//                  each one up in the staged rows and writes 16 bytes of
//                  each of its rt output rows, so every store coalesces and
//                  no load is a random 2-byte read from L2.  Grid (d / rt)
//                  x (n / span); idx is read d / rt times (from L2);
//     elementwise: a table row too long for shared memory: consecutive
//                  threads take consecutive j for one row, so the stores
//                  coalesce and each load is one random element.
// Any other layout is refused (ops/gather.py raises before the call).
//
// What bounds it on the H100: bytes.  Each gathered row is read once (from
// L2 when the table fits the 50 MB L2, else from HBM at random rows) and
// written once; there is no arithmetic.  It is the probe of the card's
// random row-read rate that bounds K5-K8 and K10.  The staged lane case
// adds the random shared-memory reads (about 3-4 bank passes a warp-wide
// 2- or 4-byte lookup) and the d / rt re-reads of idx from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCols = 16;  // columns per thread in the lanes layout

template <class T>
__global__ void __launch_bounds__(kThreads)
gather_vec_kernel(const T* __restrict__ table, long long t_rs,
                  const int* __restrict__ idx, int n, int chunks, int lpr,
                  T* __restrict__ out, long long o_rs) {
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lpr;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long i = warp * rows_per_warp + lane / lpr;
  if (i >= n) return;
  const long long r = idx[i];
  const uint4* src = reinterpret_cast<const uint4*>(table + r * t_rs);
  uint4* dst = reinterpret_cast<uint4*>(out + i * o_rs);
  for (int c = lane % lpr; c < chunks; c += lpr) dst[c] = __ldg(src + c);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const T* __restrict__ table, long long t_cs,
                    const int* __restrict__ idx, int n, int d,
                    T* __restrict__ out, long long o_cs) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = idx[i];
  const int k0 = blockIdx.y * kLaneCols;
  const int k1 = min(d, k0 + kLaneCols);
  for (int k = k0; k < k1; ++k) out[i + k * o_cs] = table[r + k * t_cs];
}

constexpr int kStagedThreads = 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 16 bytes of output: V = 16 / sizeof(T) values of one staged row at the
// indices ii, packed as one uint4.
template <class T>
__device__ __forceinline__ uint4 pack16(const T* srow, const int* ii);

template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(
    const __nv_bfloat16* srow, const int* ii) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(srow);
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = static_cast<unsigned>(s[ii[2 * q]]) |
           (static_cast<unsigned>(s[ii[2 * q + 1]]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <>
__device__ __forceinline__ uint4 pack16<float>(const float* srow,
                                               const int* ii) {
  const unsigned* s = reinterpret_cast<const unsigned*>(srow);
  return make_uint4(s[ii[0]], s[ii[1]], s[ii[2]], s[ii[3]]);
}

// out[:, j] = tabT[:, idx[j]] for rows [blockIdx.x * rt, + rt) of tabT (rows
// t_cs elements apart, n_tab each) and j in span blockIdx.y.  copy16: rows
// start 16-byte aligned and are a multiple of 16 bytes long; vec16: idx and
// the output rows are 16-byte aligned and span is a multiple of V.
template <class T>
__global__ void __launch_bounds__(kStagedThreads)
gather_lanes_staged_kernel(const T* __restrict__ table, long long t_cs,
                           int n_tab, const int* __restrict__ idx, int n,
                           int d, int rt, int span, int copy16, int vec16,
                           T* __restrict__ out, long long o_cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);
  constexpr int V = 16 / sizeof(T);
  const int k0 = blockIdx.x * rt;
  const int nr = min(rt, d - k0);
  if (copy16) {
    const int chunks = (int)((long long)n_tab * sizeof(T) / 16);
    for (int r = 0; r < nr; ++r) {
      const char* src =
          reinterpret_cast<const char*>(table + (long long)(k0 + r) * t_cs);
      char* dst = reinterpret_cast<char*>(rows + (long long)r * n_tab);
      for (int c = threadIdx.x; c < chunks; c += blockDim.x)
        cp_async16(dst + 16 * c, src + 16 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (int r = 0; r < nr; ++r)
      for (int i = threadIdx.x; i < n_tab; i += blockDim.x)
        rows[(long long)r * n_tab + i] =
            table[(long long)(k0 + r) * t_cs + i];
  }
  __syncthreads();
  const long long j0 = (long long)blockIdx.y * span;
  const long long j1 = min((long long)n, j0 + span);
  long long jt = j0;  // first j of the scalar tail
  if (vec16) {
    jt = j0 + (j1 - j0) / V * V;
    for (long long j = j0 + (long long)threadIdx.x * V; j < jt;
         j += (long long)blockDim.x * V) {
      int ii[V];
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(idx + j) + q);
        ii[4 * q] = v.x;
        ii[4 * q + 1] = v.y;
        ii[4 * q + 2] = v.z;
        ii[4 * q + 3] = v.w;
      }
      for (int r = 0; r < nr; ++r)
        *reinterpret_cast<uint4*>(out + (long long)(k0 + r) * o_cs + j) =
            pack16<T>(rows + (long long)r * n_tab, ii);
    }
  }
  for (long long j = jt + threadIdx.x; j < j1; j += blockDim.x) {
    const int i = __ldg(idx + j);
    for (int r = 0; r < nr; ++r)
      out[(long long)(k0 + r) * o_cs + j] = rows[(long long)r * n_tab + i];
  }
}

template <class T>
int launch(const void* table, long long t_rs, long long t_cs, const int* idx,
           int n, int d, void* out, long long o_rs, long long o_cs,
           int n_tab, int rt, int span, cudaStream_t stream) {
  const T* tab = static_cast<const T*>(table);
  T* dst = static_cast<T*>(out);
  const size_t es = sizeof(T);
  const bool aligned =
      t_cs == 1 && o_cs == 1 && (d * es) % 16 == 0 && (t_rs * es) % 16 == 0 &&
      (o_rs * es) % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    const int chunks = (int)(d * es / 16);
    int lpr = 1;
    while (lpr < chunks && lpr < 32) lpr <<= 1;
    const long long rows_per_block = (long long)kWarps * (32 / lpr);
    const long long grid = (n + rows_per_block - 1) / rows_per_block;
    gather_vec_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
        tab, t_rs, idx, n, chunks, lpr, dst, o_rs);
  } else if (t_rs == 1 && o_rs == 1 && rt > 0) {
    if (span <= 0 || n_tab <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)rt * n_tab * es;
    const cudaError_t e = cudaFuncSetAttribute(
        gather_lanes_staged_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const bool copy16 = (t_cs * es) % 16 == 0 && (n_tab * es) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(table) % 16 == 0;
    const bool vec16 = (o_cs * es) % 16 == 0 && (span * es) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(idx) % 16 == 0;
    const dim3 grid((unsigned)((d + rt - 1) / rt),
                    (unsigned)((n + (long long)span - 1) / span));
    gather_lanes_staged_kernel<T><<<grid, kStagedThreads, smem, stream>>>(
        tab, t_cs, n_tab, idx, n, d, rt, span, copy16, vec16, dst, o_cs);
  } else if (t_rs == 1 && o_rs == 1) {
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads),
                    (unsigned)((d + kLaneCols - 1) / kLaneCols));
    gather_lanes_kernel<T><<<grid, kThreads, 0, stream>>>(
        tab, t_cs, idx, n, d, dst, o_cs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// n_tab: rows of the table (columns of tabT in the lanes layout); rt > 0
// takes the staged lanes case with rt rows of tabT per block and span
// indices per block (ops/gather.py lane_plan), rt = 0 the elementwise one.
extern "C" int rsp_gather_rows(const void* table, long long t_rs,
                               long long t_cs, int bf16, const int* idx,
                               int n, int d, void* out, long long o_rs,
                               long long o_cs, int n_tab, int rt, int span,
                               void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || d > 512 || rt < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(table, t_rs, t_cs, idx, n, d, out, o_rs,
                                      o_cs, n_tab, rt, span, s)
              : launch<float>(table, t_rs, t_cs, idx, n, d, out, o_rs, o_cs,
                              n_tab, rt, span, s);
}
