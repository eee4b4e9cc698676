// BEV capsule rasterizer for Hopper (sm_90a), plain CUDA C++: kernel B1.
//
// Replaces: gail_carla_tpu/ops/bev_pallas.py::_kernel (entry
// render_bev_pallas_batch), the 3-channel (road, route, lane) policy
// observation. The plain PyTorch version is
// gail_carla_tpu_torch/ops/bev.py::render_bev_plain on the tables of
// ops/bev.py::bev_inputs; the two agree bit for bit on the same render
// state.
//
// What it computes, per env and pixel (W x W pixels, ego pose x, y, yaw):
//   road  = sign of the length-normalised cross of the nearest oriented
//           boundary edge, "nearest" by the key d2 - 1e-3*|cross| with the
//           first of equal keys winning, and only where key <= dmax^2;
//   route = min capsule d2 over the K route-window segments <= half^2;
//   lane  = max marking value over the lane capsules within their own half
//           width, times the float32 reciprocal of 255.
// The boundary and lane tables are the ego cell's, read over its live
// counts only: the tables are padded with far-away sentinels that never
// win a min or hit a capsule, so skipping them changes no pixel.
//
// The kernel, its fetch, tiling, culling and exactness rules are in
// bev_raster_common.cuh (raster_kernel<false>), shared with bev6_raster.cu.
//
// Bound: at 256 envs x 192 px the 113 MB output write (3 channels of
// float32); a pixel meets a few boundary edges, route segments and lane
// capsules within their reach, about 20 flops each.
#include "bev_raster_common.cuh"

extern "C" int bev_raster_launch(
    const void* xy, const void* cos_yaw, const void* sin_yaw,
    const void* route_id, const void* head, const void* grid_lo,
    const void* cell_bnd, const void* cell_bnd_n, const void* cell_lane,
    const void* cell_lane_val, const void* cell_lane_w,
    const void* cell_lane_n, const void* route_xy, void* out, int n, int gx,
    int gy, int mb, int ml, int n_routes, int route_len, int window,
    int stride, int k, int w, int tile_rows, float inv_cell, float fwd_off,
    float right_off, float scale, float dmax2, float route_half2,
    float road_reach, float route_reach, float pad, void* stream) {
  bev_raster::Params p = {};
  p.xy = (const float*)xy;
  p.cosv = (const float*)cos_yaw;
  p.sinv = (const float*)sin_yaw;
  p.route_id = (const int*)route_id;
  p.head = (const int*)head;
  p.grid_lo = (const float*)grid_lo;
  p.cell_bnd = (const float*)cell_bnd;
  p.cell_bnd_n = (const int*)cell_bnd_n;
  p.cell_lane = (const float*)cell_lane;
  p.cell_lane_val = (const float*)cell_lane_val;
  p.cell_lane_w = (const float*)cell_lane_w;
  p.cell_lane_n = (const int*)cell_lane_n;
  p.route_xy = (const float*)route_xy;
  p.out = (float*)out;
  p.n = n;
  p.gx = gx;
  p.gy = gy;
  p.mb = mb;
  p.ml = ml;
  p.n_routes = n_routes;
  p.route_len = route_len;
  p.window = window;
  p.stride = stride;
  p.k = k;
  p.w = w;
  p.tile_rows = tile_rows;
  p.inv_cell = inv_cell;
  p.fwd_off = fwd_off;
  p.right_off = right_off;
  p.scale = scale;
  p.dmax2 = dmax2;
  p.route_half2 = route_half2;
  p.road_reach = road_reach;
  p.route_reach = route_reach;
  p.pad = pad;
  return bev_raster::launch<false>(p, stream);
}
