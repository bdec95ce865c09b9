// K1 at d <= 128 on a float32 table (als_cg.cuh).

#include "als_cg.cuh"

namespace rsp_cg {

cudaError_t run_128_f32(const rsp::BucketArgs& a, const Plan& pl,
                        int cg_steps, float tol, cudaStream_t st) {
  return run<128, float>(a, pl, cg_steps, tol, st);
}

cudaError_t info_128_f32(const rsp::BucketArgs& a, int* out) {
  return info<128, float>(a, out);
}

}  // namespace rsp_cg
