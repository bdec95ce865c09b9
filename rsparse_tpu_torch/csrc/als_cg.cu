// K1 (the bucketed CG solve) and the head term alone: the C entry points.
// The kernels and their design are in als_cg.cuh; each width and table
// type is compiled in its own translation unit (als_cg_{128,160,288,544}_
// {f32,bf16}.cu), in parallel.

#include "als_cg.cuh"

using rsp_cg::Plan;

// The widest d K1 takes (rank 512 with both biases; ops/als.py
// CG_MAX_D): the widest instance holds 544 values a row.
constexpr int kMaxD = 514;

// The instance a width runs on: 0 (d <= 128), 1 (<= 160), 2 (<= 288),
// 3 (<= kMaxD); -1 outside.
static int instance(int d) {
  return d <= 0 ? -1 : d <= 128 ? 0 : d <= 160 ? 1 : d <= 288 ? 2
                     : d <= kMaxD ? 3 : -1;
}

extern "C" int rsp_als_cg(const rsp::BucketArgs* args, const Plan* plan,
                          int cg_steps, float tol, void* stream) {
  const rsp::BucketArgs a = *args;
  const Plan pl = *plan;
  if (a.B <= 0) return 0;
  const int w = instance(a.d);
  if (w < 0 || !rsp_cg::plan_ok(pl) || (a.round_bf16 && !a.table_bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool bf16 = a.table_bf16 != 0;
  using namespace rsp_cg;
  switch (w) {
    case 0: return (int)(bf16 ? run_128_bf16(a, pl, cg_steps, tol, st)
                              : run_128_f32(a, pl, cg_steps, tol, st));
    case 1: return (int)(bf16 ? run_160_bf16(a, pl, cg_steps, tol, st)
                              : run_160_f32(a, pl, cg_steps, tol, st));
    case 2: return (int)(bf16 ? run_288_bf16(a, pl, cg_steps, tol, st)
                              : run_288_f32(a, pl, cg_steps, tol, st));
    default: return (int)(bf16 ? run_544_bf16(a, pl, cg_steps, tol, st)
                               : run_544_f32(a, pl, cg_steps, tol, st));
  }
}

// info: 7 int32 (see rsp_cg::occupancy) at `rows` target rows a CTA (the
// wide instances' layout depends on it; the narrow ones' does not).
extern "C" int rsp_als_cg_info(const rsp::BucketArgs* args, int rows,
                               int* info) {
  const rsp::BucketArgs a = *args;
  const int w = instance(a.d);
  if (w < 0 || rows < 1 || rows > rsp_cg::kTile)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = a.table_bf16 != 0;
  using namespace rsp_cg;
  switch (w) {
    case 0: return (int)(bf16 ? info_128_bf16(a, rows, info)
                              : info_128_f32(a, rows, info));
    case 1: return (int)(bf16 ? info_160_bf16(a, rows, info)
                              : info_160_f32(a, rows, info));
    case 2: return (int)(bf16 ? info_288_bf16(a, rows, info)
                              : info_288_f32(a, rows, info));
    default: return (int)(bf16 ? info_544_bf16(a, rows, info)
                               : info_544_f32(a, rows, info));
  }
}

// Shared bytes of one K1 CTA (make_layout; ops/als.py cg_layout mirrors
// it), and the sparse head cells a warp keeps into *cache.
extern "C" int rsp_als_cg_layout(int d, int H, int tbytes, int cluster,
                                 int rows, int* cache) {
  const rsp_cg::Layout L = rsp_cg::make_layout(d, H, tbytes, cluster, rows);
  *cache = L.cache;
  return L.bytes;
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
