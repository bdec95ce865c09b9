// K1 (the bucketed CG solve) and the head term alone: the C entry points.
// The kernels and their design are in als_cg.cuh; each width and table
// type is compiled in its own translation unit (als_cg_128_f32.cu,
// als_cg_128_bf16.cu, als_cg_160_f32.cu, als_cg_160_bf16.cu), in parallel.

#include "als_cg.cuh"

using rsp_cg::Plan;

extern "C" int rsp_als_cg(const rsp::BucketArgs* args, const Plan* plan,
                          int cg_steps, float tol, void* stream) {
  const rsp::BucketArgs a = *args;
  const Plan pl = *plan;
  if (a.B <= 0) return 0;
  if (a.d <= 0 || a.d > 160 || !rsp_cg::plan_ok(pl) ||
      (a.round_bf16 && !a.table_bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool wide = a.d > 128, bf16 = a.table_bf16 != 0;
  return (int)(wide ? (bf16 ? rsp_cg::run_160_bf16(a, pl, cg_steps, tol, st)
                            : rsp_cg::run_160_f32(a, pl, cg_steps, tol, st))
                    : (bf16 ? rsp_cg::run_128_bf16(a, pl, cg_steps, tol, st)
                            : rsp_cg::run_128_f32(a, pl, cg_steps, tol, st)));
}

// info: 7 int32 (see rsp_cg::occupancy).
extern "C" int rsp_als_cg_info(const rsp::BucketArgs* args, int* info) {
  const rsp::BucketArgs a = *args;
  if (a.d <= 0 || a.d > 160) return (int)cudaErrorInvalidValue;
  const bool wide = a.d > 128, bf16 = a.table_bf16 != 0;
  return (int)(wide ? (bf16 ? rsp_cg::info_160_bf16(a, info)
                            : rsp_cg::info_160_f32(a, info))
                    : (bf16 ? rsp_cg::info_128_bf16(a, info)
                            : rsp_cg::info_128_f32(a, info)));
}

extern "C" int rsp_hot_chain(const rsp::BucketArgs* args, const Plan* plan,
                             int mode, void* stream) {
  const rsp::BucketArgs a = *args;
  const Plan pl = *plan;
  if (a.B <= 0) return 0;
  // built for what the probe runs: a bf16 Vh of d <= 128, one CTA a tile
  if (a.d <= 0 || a.d > 128 || a.W == nullptr || a.table_bf16 == 0 ||
      !rsp_cg::plan_ok(pl) || pl.cluster != 1)
    return (int)cudaErrorInvalidValue;
  return (int)rsp_cg::hot_chain_run(a, pl, mode, (cudaStream_t)stream);
}
