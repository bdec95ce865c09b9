// K1 at d <= 128 on a bf16 table (als_cg.cuh), and the head term alone.

#include "als_cg.cuh"

namespace rsp_cg {

cudaError_t run_128_bf16(const rsp::BucketArgs& a, const Plan& pl,
                        int cg_steps, float tol, cudaStream_t st) {
  return run<128, __nv_bfloat16>(a, pl, cg_steps, tol, st);
}

cudaError_t info_128_bf16(const rsp::BucketArgs& a, int rows, int* out) {
  return info<128, __nv_bfloat16>(a, rows, out);
}

cudaError_t hot_chain_run(const rsp::BucketArgs& a, const Plan& pl, int mode,
                          cudaStream_t st) {
  const int tiles = (a.B + pl.rows - 1) / pl.rows;
  const int smem = smem_bytes(a, 1, pl.rows);
  return mode != 0
             ? launch(hot_chain_kernel<1>, pl, tiles, smem, kThreads, st, a, pl)
             : launch(hot_chain_kernel<0>, pl, tiles, smem, kThreads, st, a,
                      pl);
}

}  // namespace rsp_cg
