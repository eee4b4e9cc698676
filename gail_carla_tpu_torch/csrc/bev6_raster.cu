// 6-channel BEV rasterizer (bev6) for Hopper (sm_90a), plain CUDA C++:
// kernel B2.
//
// Replaces: gail_carla_tpu/ops/bev6_pallas.py::_kernel (entry
// render_bev6_pallas_batch), the signal- and traffic-aware policy
// observation. The plain PyTorch version is
// gail_carla_tpu_torch/ops/bev6.py::render_bev6_plain on the tables of
// ops/bev6.py::bev6_inputs; the two agree bit for bit on the same render
// state.
//
// What it computes, per env and pixel (W x W pixels, ego pose x, y, yaw):
//   0 road    = sign of the length-normalised cross of the nearest oriented
//               boundary edge, "nearest" by the key d2 - 1e-3*|cross| with
//               the first of equal keys winning, where key <= dmax^2;
//   1 route   = min capsule d2 over the K route-window segments <= half^2;
//   2 lane    = max marking value over the lane capsules within their own
//               half width, times the float32 reciprocal of 255;
//   3 signals = max of the phase values (80/170/255) of the cell's culled
//               stop lines within the stroke half width, and 255 inside the
//               active stop-sign box (a square of its larger half extent),
//               times the reciprocal of 255;
//   4 vehicles, 5 walkers = 1 inside any of that channel's oriented boxes.
// The plain version draws every light of the town and every stop sign
// (inactive ones with a negative half extent); the kernel reads the ego
// cell's culled light table and the one active stop sign. They agree
// because the cell tables keep every light a pixel of the cell's view can
// touch (scene/segments.py::build_tl_cells).
//
// The kernel, its fetch, tiling, culling and exactness rules are in
// bev_raster_common.cuh (raster_kernel<true>), shared with bev_raster.cu.
//
// Bound: at 256 envs x 192 px the 226.5 MB output write (6 channels of
// float32); a pixel meets a few segments within their reach, and of the
// 71 boxes per env about 2.7 reach the view at all.
#include "bev_raster_common.cuh"

// The arguments are bev_raster_launch's, in its order, with the bev6
// tables, counts and extents after each group of the same kind.
extern "C" int bev6_raster_launch(
    const void* xy, const void* cos_yaw, const void* sin_yaw,
    const void* route_id, const void* head, const void* grid_lo,
    const void* cell_bnd, const void* cell_bnd_n, const void* cell_lane,
    const void* cell_lane_val, const void* cell_lane_w,
    const void* cell_lane_n, const void* route_xy, const void* cell_tl,
    const void* cell_tl_idx, const void* cell_tl_n, const void* light,
    const void* stop_idx, const void* ss_center, const void* ss_extent,
    const void* npc, const void* walker, void* out, int n, int gx, int gy,
    int mb, int ml, int n_routes, int route_len, int window, int stride,
    int k, int w, int tile_rows, int mt, int n_lights, int n_stop,
    int n_veh, int n_walk, float inv_cell, float fwd_off, float right_off,
    float scale, float dmax2, float route_half2, float road_reach,
    float route_reach, float pad, float tl_half2, float tl_reach,
    float veh_half_len, float veh_half_wid, float walker_half_len,
    float walker_half_wid, void* stream) {
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
  p.cell_tl = (const float*)cell_tl;
  p.cell_tl_idx = (const int*)cell_tl_idx;
  p.cell_tl_n = (const int*)cell_tl_n;
  p.light = (const float*)light;
  p.stop_idx = (const int*)stop_idx;
  p.ss_center = (const float*)ss_center;
  p.ss_extent = (const float*)ss_extent;
  p.npc = (const float*)npc;
  p.walker = (const float*)walker;
  p.out = (float*)out;
  p.n = n;
  p.gx = gx;
  p.gy = gy;
  p.mb = mb;
  p.ml = ml;
  p.mt = mt;
  p.n_routes = n_routes;
  p.route_len = route_len;
  p.window = window;
  p.stride = stride;
  p.k = k;
  p.n_lights = n_lights;
  p.n_stop = n_stop;
  p.n_veh = n_veh;
  p.n_walk = n_walk;
  p.w = w;
  p.tile_rows = tile_rows;
  p.inv_cell = inv_cell;
  p.fwd_off = fwd_off;
  p.right_off = right_off;
  p.scale = scale;
  p.dmax2 = dmax2;
  p.route_half2 = route_half2;
  p.tl_half2 = tl_half2;
  p.road_reach = road_reach;
  p.route_reach = route_reach;
  p.tl_reach = tl_reach;
  p.pad = pad;
  p.veh_half_len = veh_half_len;
  p.veh_half_wid = veh_half_wid;
  p.walker_half_len = walker_half_len;
  p.walker_half_wid = walker_half_wid;
  return bev_raster::launch<true>(p, stream);
}
