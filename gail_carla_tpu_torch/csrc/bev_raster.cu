// BEV capsule rasterizer for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: gail_carla_tpu/ops/bev_pallas.py::_kernel (entry
// render_bev_pallas_batch), the 3-channel (road, route, lane) policy
// observation. The plain PyTorch version is
// gail_carla_tpu_torch/ops/bev.py::render_bev_plain; the two agree bit for
// bit on the same inputs.
//
// What it computes, per env and pixel (W x W pixels, pose [x, y, cos, sin]):
//   road  = sign of the length-normalised cross of the nearest oriented
//           boundary edge, "nearest" by the key d2 - 1e-3*|cross| with the
//           first of equal keys winning, and only where key <= dmax^2;
//   route = min capsule d2 over the K route-window segments <= half^2;
//   lane  = max marking value over the lane capsules within their own half
//           width, times the float32 reciprocal of 255.
// The boundary and lane loops run over the cell's live counts only: the
// tables are padded with far-away sentinels that never win a min or hit a
// capsule, so skipping them changes no pixel.
//
// Bound: FP32 CUDA-core arithmetic. Each pixel does about 12 flops per
// segment, so an env costs about W^2 * (n_bnd + n_lane + K) * 12 flops;
// tensor cores do not apply. The only large memory traffic is the
// 3 * W^2 * 4 B output write; the tables (~2.4 KB per env) are read once
// per block into shared memory.
//
// Design: one thread block per (pixel tile of 256, env), one thread per
// pixel, three register accumulators. Each block stages its env's tables
// in shared memory with the per-edge coefficients hoisted (tx, ty, tc, nx,
// ny and the reciprocal of |ab|^2, as bev_pallas.py:126-137 hoists them to
// scalars), so the per-pixel loop is multiplies, adds and selects; the
// staging and the per-pixel loops are in bev_raster_common.cuh, shared
// with bev6_raster.cu. Any W works: the ragged last tile is masked. It is
// deliberately simple: no TMA, no wgmma, no fusion of the spatial-hash
// fetch (the wrapper gathers the tables); speed is for later work.
//
// Exactness: build with --fmad=false (no a*b+c contraction into FMA) and
// without fast math, so every operation rounds as the plain version's
// separate float32 tensor ops do. Divisions and square roots are the IEEE
// ones. The per-pixel expressions keep the plain version's op order.
#include "bev_raster_common.cuh"

using namespace bev_raster;

namespace {

__global__ void __launch_bounds__(kThreads) bev_raster_kernel(
    const int* __restrict__ counts,     // (N, 2) live [n_bnd, n_lane]
    const float* __restrict__ pose,     // (N, 4) x, y, cos yaw, sin yaw
    const float* __restrict__ bnd,      // (N, Mb, 4)
    const float* __restrict__ lane,     // (N, Ml, 4)
    const float* __restrict__ lane_val, // (N, Ml)
    const float* __restrict__ lane_w,   // (N, Ml)
    const float* __restrict__ route,    // (N, K, 4)
    float* __restrict__ out,            // (N, 3, W, W)
    int mb, int ml, int k, int w,
    float fwd_off, float right_off, float scale,
    float dmax2, float route_half2) {
  extern __shared__ float smem[];
  float* s_bnd = smem;                       // mb * kBndCoef
  float* s_lane = s_bnd + mb * kBndCoef;     // ml * kLaneCoef
  float* s_route = s_lane + ml * kLaneCoef;  // k * kRouteCoef

  const int env = blockIdx.y;
  const int nb = min(max(counts[2 * env], 0), mb);
  const int nl = min(max(counts[2 * env + 1], 0), ml);
  stage_segments(env, nb, nl, mb, ml, k, bnd, lane, lane_val, lane_w, route,
                 s_bnd, s_lane, s_route);
  __syncthreads();

  const int npix = w * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  float pxx, pxy;
  pixel_world(pose, env, p, w, fwd_off, right_off, scale, &pxx, &pxy);
  road_route_lane(pxx, pxy, nb, nl, k, s_bnd, s_lane, s_route, dmax2,
                  route_half2, out + (size_t)env * 3 * npix + p, npix);
}

}  // namespace

extern "C" int bev_raster_launch(
    const void* counts, const void* pose, const void* bnd, const void* lane,
    const void* lane_val, const void* lane_w, const void* route, void* out,
    int n, int mb, int ml, int k, int w, float fwd_off, float right_off,
    float scale, float dmax2, float route_half2, void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  const size_t smem =
      sizeof(float) * ((size_t)mb * kBndCoef + (size_t)ml * kLaneCoef +
                       (size_t)k * kRouteCoef);
  const dim3 grid((w * w + kThreads - 1) / kThreads, n);
  bev_raster_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)counts, (const float*)pose, (const float*)bnd,
      (const float*)lane, (const float*)lane_val, (const float*)lane_w,
      (const float*)route, (float*)out, mb, ml, k, w, fwd_off, right_off,
      scale, dmax2, route_half2);
  return (int)cudaGetLastError();
}
