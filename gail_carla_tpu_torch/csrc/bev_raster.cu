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
// scalars), so the per-pixel loop is multiplies, adds and selects. Any W
// works: the ragged last tile is masked. It is deliberately simple: no TMA,
// no wgmma, no fusion of the spatial-hash fetch (the wrapper gathers the
// tables); speed is for later work.
//
// Exactness: build with --fmad=false (no a*b+c contraction into FMA) and
// without fast math, so every operation rounds as the plain version's
// separate float32 tensor ops do. Divisions and square roots are the IEEE
// ones. The per-pixel expressions keep the plain version's op order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBndCoef = 9;    // ax ay abx aby tx ty tc nx ny
constexpr int kLaneCoef = 8;   // ax ay abx aby inv_denom aab lw2 val
constexpr int kRouteCoef = 6;  // ax ay abx aby inv_denom aab

__device__ inline float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ inline void capsule_coef(const float* seg, float* c) {
  const float ax = seg[0];
  const float ay = seg[1];
  const float abx = seg[2] - ax;
  const float aby = seg[3] - ay;
  c[0] = ax;
  c[1] = ay;
  c[2] = abx;
  c[3] = aby;
  c[4] = 1.0f / ((abx * abx + aby * aby) + 1e-9f);
  c[5] = ax * abx + ay * aby;
}

__device__ inline float capsule_d2(const float* c, float pxx, float pxy) {
  const float t = clip01(((pxx * c[2] + pxy * c[3]) - c[5]) * c[4]);
  const float dx = (pxx - c[0]) - t * c[2];
  const float dy = (pxy - c[1]) - t * c[3];
  return dx * dx + dy * dy;
}

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

  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const float* seg = bnd + ((size_t)env * mb + i) * 4;
    float* c = s_bnd + i * kBndCoef;
    const float ax = seg[0];
    const float ay = seg[1];
    const float abx = seg[2] - ax;
    const float aby = seg[3] - ay;
    const float inv_denom = 1.0f / ((abx * abx + aby * aby) + 1e-9f);
    const float inv_len = sqrtf(inv_denom);
    c[0] = ax;
    c[1] = ay;
    c[2] = abx;
    c[3] = aby;
    c[4] = abx * inv_denom;
    c[5] = aby * inv_denom;
    c[6] = (ax * abx + ay * aby) * inv_denom;
    c[7] = abx * inv_len;
    c[8] = aby * inv_len;
  }
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const size_t j = (size_t)env * ml + i;
    float* c = s_lane + i * kLaneCoef;
    capsule_coef(lane + j * 4, c);
    const float lw = lane_w[j];
    c[6] = lw * lw;
    c[7] = lane_val[j];
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    capsule_coef(route + ((size_t)env * k + i) * 4, s_route + i * kRouteCoef);
  }
  __syncthreads();

  const int npix = w * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const float row = (float)(p / w);
  const float col = (float)(p % w);

  // pixel world coordinates, ops/bev.py::pixel_world_coords op order
  const float x = pose[4 * env];
  const float y = pose[4 * env + 1];
  const float c = pose[4 * env + 2];
  const float s = pose[4 * env + 3];
  const float tl_x = (x + fwd_off * c) - right_off * (-s);
  const float tl_y = (y + fwd_off * s) - right_off * c;
  const float srx = scale * (-s);
  const float sry = scale * c;
  const float sfx = scale * c;
  const float sfy = scale * s;
  const float pxx = (tl_x + col * srx) - row * sfx;
  const float pxy = (tl_y + col * sry) - row * sfy;

  // road: nearest oriented boundary edge by the tie key, first one wins
  float keymin = 1.0e12f;
  float cr_best = 0.0f;
  for (int i = 0; i < nb; ++i) {
    const float* e = s_bnd + i * kBndCoef;
    const float t = clip01((pxx * e[4] + pxy * e[5]) - e[6]);
    const float dx = (pxx - e[0]) - t * e[2];
    const float dy = (pxy - e[1]) - t * e[3];
    const float d2 = dx * dx + dy * dy;
    const float crn = e[7] * dy - e[8] * dx;
    const float key = d2 - 1e-3f * fabsf(crn);
    if (key < keymin) {
      keymin = key;
      cr_best = crn;
    }
  }

  // route: min capsule distance over the route window
  float route_d2 = 1.0e12f;
  for (int i = 0; i < k; ++i) {
    route_d2 = fminf(route_d2, capsule_d2(s_route + i * kRouteCoef, pxx, pxy));
  }

  // lane: max marking value within each capsule's own half width
  float lane_v = 0.0f;
  for (int i = 0; i < nl; ++i) {
    const float* e = s_lane + i * kLaneCoef;
    if (capsule_d2(e, pxx, pxy) <= e[6]) lane_v = fmaxf(lane_v, e[7]);
  }

  const float inv_255 = 1.0f / 255.0f;
  float* o = out + (size_t)env * 3 * npix + p;
  o[0] = (cr_best > 0.0f && keymin <= dmax2) ? 1.0f : 0.0f;
  o[npix] = (route_d2 <= route_half2) ? 1.0f : 0.0f;
  o[2 * npix] = lane_v * inv_255;
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
