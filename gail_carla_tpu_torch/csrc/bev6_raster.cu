// 6-channel BEV rasterizer (bev6) for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: gail_carla_tpu/ops/bev6_pallas.py::_kernel (entry
// render_bev6_pallas_batch), the signal- and traffic-aware policy
// observation. The plain PyTorch version is
// gail_carla_tpu_torch/ops/bev6.py::render_bev6_plain; the two agree bit for
// bit on the same inputs.
//
// What it computes, per env and pixel (W x W pixels, pose [x, y, cos, sin]):
//   0 road    = sign of the length-normalised cross of the nearest oriented
//               boundary edge, "nearest" by the key d2 - 1e-3*|cross| with
//               the first of equal keys winning, where key <= dmax^2;
//   1 route   = min capsule d2 over the K route-window segments <= half^2;
//   2 lane    = max marking value over the lane capsules within their own
//               half width, times the float32 reciprocal of 255;
//   3 signals = max of the phase values (80/170/255) of the cell's culled
//               stop lines within the stroke half width, and 255 inside the
//               active stop-sign box, times the reciprocal of 255;
//   4 vehicles, 5 walkers = 1 inside any of that channel's oriented boxes.
// The boxes come as one table, each row [x, y, cos, sin, half_len,
// half_wid, channel, pad] (channel 0 signals, 1 vehicles, 2 walkers); a
// negative half extent draws nothing. The boundary, lane and light loops
// run over the cell's live counts only: the tables are padded with
// far-away sentinels that never win a min or hit a capsule.
//
// Bound: FP32 CUDA-core arithmetic. A pixel does about 12 flops per
// segment, and 10 per box (2 subtractions, 4 multiplies, 2 adds and 2
// compares; |.| is an operand modifier of the compare). Only a box whose
// bounding circle meets the view can draw a pixel, so an env needs about
// W^2 * (12 * (n_bnd + n_lane + K + n_tl) + 10 * n_boxes_in_view) flops,
// plus a cull test of each box; tensor cores do not apply. The only large
// memory traffic is the 6 * W^2 * 4 B output write; the tables (about
// 5.0 KB per env at Mb=88, Ml=32, K=20, Mt=8, B=71) are read once per
// block into 6.9 KB of shared memory.
//
// Design: as bev_raster.cu, one thread block per (pixel tile of 256, env),
// one thread per pixel, six register accumulators. Each block stages its
// env's boundary, lane, route and light segments with the per-segment
// coefficients hoisted, and its box table, in shared memory, so the
// per-pixel loops are multiplies, adds, compares and selects. The staging
// of the boundary, lane and route segments, the pixel transform and the
// road, route and lane loops are bev_raster.cu's, from
// bev_raster_common.cuh. The light values are a per-line column of the
// staged table (the TPU kernel's one-hot einsum is a plain gather in the
// wrapper). Any W works: the ragged last tile is masked. No TMA, no wgmma,
// no fused table fetch yet.
//
// Exactness: build with --fmad=false and without fast math, so every
// operation rounds as the plain version's separate float32 tensor ops do;
// the expressions keep the plain version's op order, including the box
// transform lx = dx*c + dy*s, ly = -dx*s + dy*c.
#include "bev_raster_common.cuh"

using namespace bev_raster;

namespace {

constexpr int kTlCoef = 7;     // ax ay abx aby inv_denom aab val
constexpr int kBoxCoef = 7;    // x y cos sin half_len half_wid channel
constexpr int kBoxCols = 8;    // row width of the box table

__global__ void __launch_bounds__(kThreads) bev6_raster_kernel(
    const int* __restrict__ counts,     // (N, 3) live [n_bnd, n_lane, n_tl]
    const float* __restrict__ pose,     // (N, 4) x, y, cos yaw, sin yaw
    const float* __restrict__ bnd,      // (N, Mb, 4)
    const float* __restrict__ lane,     // (N, Ml, 4)
    const float* __restrict__ lane_val, // (N, Ml)
    const float* __restrict__ lane_w,   // (N, Ml)
    const float* __restrict__ route,    // (N, K, 4)
    const float* __restrict__ tl,       // (N, Mt, 4)
    const float* __restrict__ tl_val,   // (N, Mt)
    const float* __restrict__ boxes,    // (N, B, 8)
    float* __restrict__ out,            // (N, 6, W, W)
    int mb, int ml, int k, int mt, int nbox, int w,
    float fwd_off, float right_off, float scale,
    float dmax2, float route_half2, float tl_half2) {
  extern __shared__ float smem[];
  float* s_bnd = smem;                       // mb * kBndCoef
  float* s_lane = s_bnd + mb * kBndCoef;     // ml * kLaneCoef
  float* s_route = s_lane + ml * kLaneCoef;  // k * kRouteCoef
  float* s_tl = s_route + k * kRouteCoef;    // mt * kTlCoef
  float* s_box = s_tl + mt * kTlCoef;        // nbox * kBoxCoef

  const int env = blockIdx.y;
  const int nb = min(max(counts[3 * env], 0), mb);
  const int nl = min(max(counts[3 * env + 1], 0), ml);
  const int nt = min(max(counts[3 * env + 2], 0), mt);
  stage_segments(env, nb, nl, mb, ml, k, bnd, lane, lane_val, lane_w, route,
                 s_bnd, s_lane, s_route);
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const size_t j = (size_t)env * mt + i;
    float* c = s_tl + i * kTlCoef;
    capsule_coef(tl + j * 4, c);
    c[6] = tl_val[j];
  }
  for (int i = threadIdx.x; i < nbox; i += blockDim.x) {
    const float* b = boxes + ((size_t)env * nbox + i) * kBoxCols;
    float* c = s_box + i * kBoxCoef;
    for (int j = 0; j < kBoxCoef; ++j) c[j] = b[j];
  }
  __syncthreads();

  const int npix = w * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  float pxx, pxy;
  pixel_world(pose, env, p, w, fwd_off, right_off, scale, &pxx, &pxy);
  float* o = out + (size_t)env * 6 * npix + p;
  road_route_lane(pxx, pxy, nb, nl, k, s_bnd, s_lane, s_route, dmax2,
                  route_half2, o, npix);

  // signals: max phase value over the stop lines within the stroke
  float sig = 0.0f;
  for (int i = 0; i < nt; ++i) {
    const float* e = s_tl + i * kTlCoef;
    if (capsule_d2(e, pxx, pxy) <= tl_half2) sig = fmaxf(sig, e[6]);
  }

  // boxes: point in oriented box, drawn into the row's channel
  float veh = 0.0f;
  float wk = 0.0f;
  for (int i = 0; i < nbox; ++i) {
    const float* b = s_box + i * kBoxCoef;
    const float dx = pxx - b[0];
    const float dy = pxy - b[1];
    const float lx = dx * b[2] + dy * b[3];
    const float ly = -dx * b[3] + dy * b[2];
    if (fabsf(lx) <= b[4] && fabsf(ly) <= b[5]) {
      const float ch = b[6];
      if (ch == 0.0f) {
        sig = fmaxf(sig, 255.0f);
      } else if (ch == 1.0f) {
        veh = 1.0f;
      } else if (ch == 2.0f) {
        wk = 1.0f;
      }
    }
  }

  const float inv_255 = 1.0f / 255.0f;
  o[3 * npix] = sig * inv_255;
  o[4 * npix] = veh;
  o[5 * npix] = wk;
}

}  // namespace

extern "C" int bev6_raster_launch(
    const void* counts, const void* pose, const void* bnd, const void* lane,
    const void* lane_val, const void* lane_w, const void* route,
    const void* tl, const void* tl_val, const void* boxes, void* out,
    int n, int mb, int ml, int k, int mt, int nbox, int w, float fwd_off,
    float right_off, float scale, float dmax2, float route_half2,
    float tl_half2, void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  const size_t smem =
      sizeof(float) * ((size_t)mb * kBndCoef + (size_t)ml * kLaneCoef +
                       (size_t)k * kRouteCoef + (size_t)mt * kTlCoef +
                       (size_t)nbox * kBoxCoef);
  const dim3 grid((w * w + kThreads - 1) / kThreads, n);
  bev6_raster_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)counts, (const float*)pose, (const float*)bnd,
      (const float*)lane, (const float*)lane_val, (const float*)lane_w,
      (const float*)route, (const float*)tl, (const float*)tl_val,
      (const float*)boxes, (float*)out, mb, ml, k, mt, nbox, w, fwd_off,
      right_off, scale, dmax2, route_half2, tl_half2);
  return (int)cudaGetLastError();
}
