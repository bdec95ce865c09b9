// K1 at d <= 160 on a float32 table (als_cg.cuh).

#include "als_cg.cuh"

namespace rsp_cg {

cudaError_t run_160_f32(const rsp::BucketArgs& a, const Plan& pl,
                        int cg_steps, float tol, cudaStream_t st) {
  return run<160, float>(a, pl, cg_steps, tol, st);
}

cudaError_t info_160_f32(const rsp::BucketArgs& a, int* out) {
  return info<160, float>(a, out);
}

}  // namespace rsp_cg
