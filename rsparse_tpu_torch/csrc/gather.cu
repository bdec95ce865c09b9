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
//   lanes:  unit ROW strides (a transposed table and output): consecutive
//           threads take consecutive i for one column, so the stores
//           coalesce and each load is one random element.
// Any other layout is refused (ops/gather.py raises before the call).
//
// What bounds it on the H100: bytes.  Each gathered row is read once (from
// L2 when the table fits the 50 MB L2, else from HBM at random rows) and
// written once; there is no arithmetic.  It is the probe of the card's
// random row-read rate that bounds K5-K8 and K10.

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

template <class T>
int launch(const void* table, long long t_rs, long long t_cs, const int* idx,
           int n, int d, void* out, long long o_rs, long long o_cs,
           cudaStream_t stream) {
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

extern "C" int rsp_gather_rows(const void* table, long long t_rs,
                               long long t_cs, int bf16, const int* idx,
                               int n, int d, void* out, long long o_rs,
                               long long o_cs, void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || d > 512) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(table, t_rs, t_cs, idx, n, d, out, o_rs,
                                      o_cs, s)
              : launch<float>(table, t_rs, t_cs, idx, n, d, out, o_rs, o_cs,
                              s);
}
