// K1 at d <= 160 on a bf16 table (als_cg.cuh).

#include "als_cg.cuh"

namespace rsp_cg {

cudaError_t run_160_bf16(const rsp::BucketArgs& a, const Plan& pl,
                        int cg_steps, float tol, cudaStream_t st) {
  return run<160, __nv_bfloat16>(a, pl, cg_steps, tol, st);
}

cudaError_t info_160_bf16(const rsp::BucketArgs& a, int rows, int* out) {
  return info<160, __nv_bfloat16>(a, rows, out);
}

}  // namespace rsp_cg
