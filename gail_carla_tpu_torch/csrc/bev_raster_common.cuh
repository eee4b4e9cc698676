// Device code shared by bev_raster.cu (3-channel BEV) and bev6_raster.cu
// (6-channel BEV): the staging of an env's boundary, lane and route
// segments in shared memory with their coefficients hoisted, the pixel's
// world coordinates, and the road, route and lane channels of one pixel.
// Each expression keeps the plain PyTorch version's op order (see the
// headers of the two kernels for what is computed and why it is exact).
#pragma once

#include <cuda_runtime.h>

namespace bev_raster {

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

// The env's nb live boundary edges (of mb rows), nl live lane capsules (of
// ml) and k route segments, staged by the whole block.
__device__ inline void stage_segments(
    int env, int nb, int nl, int mb, int ml, int k,
    const float* __restrict__ bnd, const float* __restrict__ lane,
    const float* __restrict__ lane_val, const float* __restrict__ lane_w,
    const float* __restrict__ route, float* s_bnd, float* s_lane,
    float* s_route) {
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
}

// World coordinates of pixel p (row-major in a W x W view) of the env at
// pose [x, y, cos yaw, sin yaw], ops/bev.py::pixel_world_coords op order.
__device__ inline void pixel_world(const float* __restrict__ pose, int env,
                                   int p, int w, float fwd_off,
                                   float right_off, float scale, float* pxx,
                                   float* pxy) {
  const float row = (float)(p / w);
  const float col = (float)(p % w);
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
  *pxx = (tl_x + col * srx) - row * sfx;
  *pxy = (tl_y + col * sry) - row * sfy;
}

// Road, route and lane channels of the pixel at (pxx, pxy), written to
// o[0], o[npix] and o[2 * npix].
__device__ inline void road_route_lane(
    float pxx, float pxy, int nb, int nl, int k, const float* s_bnd,
    const float* s_lane, const float* s_route, float dmax2,
    float route_half2, float* o, int npix) {
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
  o[0] = (cr_best > 0.0f && keymin <= dmax2) ? 1.0f : 0.0f;
  o[npix] = (route_d2 <= route_half2) ? 1.0f : 0.0f;
  o[2 * npix] = lane_v * inv_255;
}

}  // namespace bev_raster
