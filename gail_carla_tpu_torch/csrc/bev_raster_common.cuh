// The BEV rasterizer kernel that bev_raster.cu (3 channels, kernel B1) and
// bev6_raster.cu (6 channels, kernel B2) instantiate: raster_kernel<false>
// draws road, route and lane; raster_kernel<true> adds signals, vehicles
// and walkers. The headers of the two .cu files say what each channel is.
//
// Design, for Hopper (sm_90a):
// - Table fetch inside the kernel. A block reads its env's rows straight
//   from the scene: the spatial-hash cell of the ego pose (cell_bnd,
//   cell_lane, cell_lane_val, cell_lane_w and, for bev6, cell_tl and
//   cell_tl_idx, with their live counts), the route window at the route
//   cursor (start clamped as sim/cursor.py::take_window clamps it, every
//   `stride`-th point), and for bev6 the light values of the cell's stop
//   lines, the active stop sign's row (stop_idx) and the NPC and walker
//   poses. The cos and sin of every yaw come in from one PyTorch prologue,
//   and the light values from ops/bev6.py::light_values, so that both are
//   the very ops the plain version runs. The rows are scattered, 2-7 KB per
//   env, and each feeds a coefficient computation at once, so every thread
//   loads one item with plain loads and writes its hoisted coefficients to
//   shared memory: TMA or cp.async would add a copy pass and no overlap.
// - 2-D tiles. A warp draws one tile of 32 columns (one per lane) by
//   tile_rows rows; a block of kWarps warps draws kWarps tiles of one env
//   and stages that env's tables once. Row and column come from the tile
//   and lane indices (one divide per warp, none per pixel); the ragged
//   edge of any W is masked at the store. Each store of a channel row is
//   32 consecutive floats, 128 bytes.
// - Per-tile culling. After staging, each warp tests every boundary edge,
//   route segment, lane capsule, stop line and box against its tile's
//   bounding circle, and keeps, in table order, the items within their
//   reach plus the circle's radius plus a margin (ops/bev_tiles.py defines
//   the tile, the pad and the reaches, and the wrapper passes them in). A
//   __ballot_sync with a __popc prefix writes the survivors' indices to the
//   warp's list in shared memory. Culling is exact: a culled item lies
//   beyond its reach from every pixel of the tile, so it can change no min
//   or max that decides a pixel. For the road, a culled edge's key
//   d2 - 1e-3*|cross| exceeds dmax^2 at every pixel of the tile: it cannot
//   displace (or, the test being a strict <, tie with) a winner whose key
//   is <= dmax^2, and a pixel whose winner's key exceeds dmax^2 is 0 with
//   or without it; the survivors keep their order, so the first of equal
//   keys still wins. The same holds for the route, lane and stop-line
//   thresholds and for the boxes.
// - Several pixels per thread. A thread draws kPass rows of its column per
//   pass over a list (8 for bev, 4 for bev6: pass_rows), so each
//   coefficient read from shared memory feeds kPass pixels.
// - Boxes by channel. The active stop-sign box, the vehicles and the
//   walkers are culled into lists of their own, so the per-pixel loops
//   have no channel branch.
// - No tensor cores: the work is float32 compare, min and max logic that
//   must round as the plain version's separate tensor ops do.
//
// Bound: the (N, C, W, W) float32 output write. At 256 envs x 192 px the
// pixel-item pairs within reach are a few per pixel; the tables are KB.
//
// Exactness: built with --fmad=false (no a*b+c contraction into FMA) and
// without fast math, so every operation rounds as the plain version's
// separate float32 ops do; divisions and square roots are the IEEE ones.
// Every per-pixel expression keeps the plain version's op order: the
// pixel frame of ops/bev.py::pixel_world_coords, the hoisted per-segment
// coefficients, the box transform lx = dx*c + dy*s, ly = -dx*s + dy*c,
// the strict < on the road's tie key, and the max of the light values and
// the stop box before the multiply by the float32 reciprocal of 255.
#pragma once

#include <cuda_runtime.h>

namespace bev_raster {

constexpr int kWarps = 8;        // tiles per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCols = 32;    // one column per lane
constexpr int kBndCoef = 9;      // ax ay abx aby tx ty tc nx ny
constexpr int kCapCoef = 8;      // ax ay abx aby inv_denom aab half2 value
constexpr int kBoxCoef = 6;      // x y cos sin half_len half_wid

struct Params {
  // render state, one row per env
  const float* xy;            // (N, 2)
  const float* cosv;          // cos of the yaws: ego (N), then for bev6
  const float* sinv;          //   stop signs (S), vehicles (N*K), walkers
  const int* route_id;        // (N,)
  const int* head;            // (N,) route cursor
  // scene tables
  const float* grid_lo;       // (2,) cell grid origin
  const float* cell_bnd;      // (G, Mb, 4) oriented boundary edges
  const int* cell_bnd_n;      // (G,) live edges
  const float* cell_lane;     // (G, Ml, 4) lane-marking capsules
  const float* cell_lane_val; // (G, Ml)
  const float* cell_lane_w;   // (G, Ml) half widths
  const int* cell_lane_n;     // (G,)
  const float* route_xy;      // (R, L, 2) dense routes
  // bev6 only
  const float* cell_tl;       // (G, Mt, 4) the cell's culled stop lines
  const int* cell_tl_idx;     // (G, Mt) their light indices
  const int* cell_tl_n;       // (G,)
  const float* light;         // (N, T) each light's value at the env's time
  const int* stop_idx;        // (N,) active stop sign, -1 for none
  const float* ss_center;     // (S, 2)
  const float* ss_extent;     // (S, 2)
  const float* npc;           // (N, K, 3) x, y, yaw
  const float* walker;        // (N, Wk, 3)
  float* out;                 // (N, C, W, W)
  int n, gx, gy, mb, ml, mt, n_routes, route_len, window, stride, k;
  int n_lights, n_stop, n_veh, n_walk, w, tile_rows, tiles_x, tiles;
  float inv_cell, fwd_off, right_off, scale, dmax2, route_half2, tl_half2;
  float road_reach, route_reach, tl_reach, pad;
  float veh_half_len, veh_half_wid, walker_half_len, walker_half_wid;
};

// Staged items of one env, and the shared memory they take: the hoisted
// coefficients as floats, then each warp's list of survivors.
__host__ __device__ inline int n_boxes(const Params& p, bool six) {
  return six ? 1 + p.n_veh + p.n_walk : 0;
}
__host__ __device__ inline int n_floats(const Params& p, bool six) {
  return p.mb * kBndCoef + (p.ml + p.k) * kCapCoef +
         (six ? p.mt * kCapCoef + n_boxes(p, six) * kBoxCoef : 0);
}
__host__ __device__ inline int list_cap(const Params& p, bool six) {
  return p.mb + p.ml + p.k + (six ? p.mt + n_boxes(p, six) : 0);
}
inline size_t smem_bytes(const Params& p, bool six) {
  return sizeof(float) * (size_t)n_floats(p, six) +
         sizeof(unsigned short) * (size_t)kWarps * list_cap(p, six);
}

__device__ inline float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ inline int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// ops/bev.py::_cell_of along one axis: floor((x - lo) / cell_size),
// clamped into [0, g). inv_cell is the exact reciprocal of a power-of-two
// cell size, so the multiply is the division.
__device__ inline int cell_index(float d, float inv_cell, int g) {
  const float f = floorf(d * inv_cell);
  return (int)fminf(fmaxf(f, 0.0f), (float)(g - 1));
}

// ops/bev.py::capsule_dist2_all's per-segment coefficients.
__device__ inline void capsule_coef(float ax, float ay, float bx, float by,
                                    float* c) {
  const float abx = bx - ax;
  const float aby = by - ay;
  c[0] = ax;
  c[1] = ay;
  c[2] = abx;
  c[3] = aby;
  c[4] = 1.0f / ((abx * abx + aby * aby) + 1e-9f);
  c[5] = ax * abx + ay * aby;
}

// ops/bev.py::boundary_dist_cross's per-edge coefficients.
__device__ inline void edge_coef(const float* seg, float* c) {
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

__device__ inline void box_row(float x, float y, float c, float s, float hl,
                               float hw, float* b) {
  b[0] = x;
  b[1] = y;
  b[2] = c;
  b[3] = s;
  b[4] = hl;
  b[5] = hw;
}

// Squared distance from (cx, cy) to the segment a + [0, 1] * ab
// (ops/bev_tiles.py::seg_dist2); a zero-length segment is its point a.
__device__ inline float seg_dist2(float cx, float cy, const float* c) {
  const float qx = cx - c[0];
  const float qy = cy - c[1];
  const float l2 = c[2] * c[2] + c[3] * c[3];
  const float t =
      l2 > 0.0f ? clip01((qx * c[2] + qy * c[3]) / l2) : 0.0f;
  const float dx = qx - t * c[2];
  const float dy = qy - t * c[3];
  return dx * dx + dy * dy;
}

__device__ inline bool within(float d2, float reach, float pad) {
  const float lim = reach + pad;
  return d2 <= lim * lim;
}

// Appends, in order, the indices i < n for which keep(i) holds to a
// warp's list; returns how many (the same in every lane).
template <typename Keep>
__device__ inline int compact(int n, unsigned short* list, int lane,
                              Keep keep) {
  int kept = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool k = i < n && keep(i);
    const unsigned m = __ballot_sync(0xffffffffu, k);
    if (k) list[kept + __popc(m & ((1u << lane) - 1u))] = (unsigned short)i;
    kept += __popc(m);
  }
  __syncwarp();
  return kept;
}

template <int P>
__device__ inline void store(float* o, int r0, int w, bool col_ok,
                             const float* v) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (col_ok && r0 + j < w) o[(size_t)(r0 + j) * w] = v[j];
  }
}

__device__ inline float capsule_d2(const float* c, float pxx, float pxy) {
  const float t = clip01(((pxx * c[2] + pxy * c[3]) - c[5]) * c[4]);
  const float dx = (pxx - c[0]) - t * c[2];
  const float dy = (pxy - c[1]) - t * c[3];
  return dx * dx + dy * dy;
}

// Max of each kept capsule's value over the capsules whose half width
// (squared in c[6], or `half2` when negative) covers the pixel.
template <int P>
__device__ inline void capsule_max(const float* s, const unsigned short* l,
                                   int n, float half2, const float* pxx,
                                   const float* pxy, float* v) {
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = 0.0f;
  for (int q = 0; q < n; ++q) {
    const float* e = s + l[q] * kCapCoef;
    const float h2 = half2 < 0.0f ? e[6] : half2;
    const float val = e[7];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (capsule_d2(e, pxx[j], pxy[j]) <= h2) v[j] = fmaxf(v[j], val);
    }
  }
}

// 1 where a pixel is inside any kept box.
template <int P>
__device__ inline void boxes_hit(const float* s, const unsigned short* l,
                                 int n, const float* pxx, const float* pxy,
                                 float* v) {
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = 0.0f;
  for (int q = 0; q < n; ++q) {
    const float* b = s + l[q] * kBoxCoef;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float dx = pxx[j] - b[0];
      const float dy = pxy[j] - b[1];
      const float lx = dx * b[2] + dy * b[3];
      const float ly = -dx * b[3] + dy * b[2];
      if (fabsf(lx) <= b[4] && fabsf(ly) <= b[5]) v[j] = 1.0f;
    }
  }
}

// Rows a thread draws per pass over a list: each coefficient read from
// shared memory feeds kPass pixels. bev6's six channels keep more values
// live, and at 4 rows it holds 63 registers instead of 77, which lets a
// fourth block onto each SM.
template <bool kSix>
__host__ __device__ constexpr int pass_rows() {
  return kSix ? 4 : 8;
}

template <bool kSix>
__global__ void __launch_bounds__(kThreads) raster_kernel(const Params p) {
  constexpr int kPass = pass_rows<kSix>();
  extern __shared__ float smem[];
  float* s_bnd = smem;
  float* s_lane = s_bnd + p.mb * kBndCoef;
  float* s_route = s_lane + p.ml * kCapCoef;
  float* s_tl = s_route + p.k * kCapCoef;
  float* s_box = s_tl + (kSix ? p.mt * kCapCoef : 0);
  unsigned short* s_list =
      reinterpret_cast<unsigned short*>(smem + n_floats(p, kSix));

  // --- the env's rows, fetched from the scene ---
  const int env = blockIdx.y;
  const float x = p.xy[2 * env];
  const float y = p.xy[2 * env + 1];
  const float c = p.cosv[env];
  const float s = p.sinv[env];
  const int cell = cell_index(y - p.grid_lo[1], p.inv_cell, p.gy) * p.gx +
                   cell_index(x - p.grid_lo[0], p.inv_cell, p.gx);
  const int nb = clampi(p.cell_bnd_n[cell], 0, p.mb);
  const int nl = clampi(p.cell_lane_n[cell], 0, p.ml);
  const int nt = kSix ? clampi(p.cell_tl_n[cell], 0, p.mt) : 0;
  const int nbox = n_boxes(p, kSix);
  const int rid = clampi(p.route_id[env], 0, p.n_routes - 1);
  const int start = min(max(p.head[env], 0), p.route_len - p.window);
  const float* route = p.route_xy + ((size_t)rid * p.route_len + start) * 2;

  // one item per thread: hoisted coefficients into shared memory
  const int total = nb + nl + p.k + nt + nbox;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    int j = i;
    if (j < nb) {
      edge_coef(p.cell_bnd + ((size_t)cell * p.mb + j) * 4,
                s_bnd + j * kBndCoef);
      continue;
    }
    j -= nb;
    if (j < nl) {
      const size_t r = (size_t)cell * p.ml + j;
      const float* seg = p.cell_lane + r * 4;
      float* e = s_lane + j * kCapCoef;
      capsule_coef(seg[0], seg[1], seg[2], seg[3], e);
      const float lw = p.cell_lane_w[r];
      e[6] = lw * lw;
      e[7] = p.cell_lane_val[r];
      continue;
    }
    j -= nl;
    if (j < p.k) {
      const float* a = route + (size_t)j * p.stride * 2;
      const float* b = a + (size_t)p.stride * 2;
      capsule_coef(a[0], a[1], b[0], b[1], s_route + j * kCapCoef);
      continue;
    }
    j -= p.k;
    if (!kSix) continue;
    if (j < nt) {
      const size_t r = (size_t)cell * p.mt + j;
      const float* seg = p.cell_tl + r * 4;
      float* e = s_tl + j * kCapCoef;
      capsule_coef(seg[0], seg[1], seg[2], seg[3], e);
      const int li = clampi(p.cell_tl_idx[r], 0, p.n_lights - 1);
      e[7] = p.light[(size_t)env * p.n_lights + li];
      continue;
    }
    j -= nt;
    float* b = s_box + j * kBoxCoef;
    if (j == 0) {
      // the active stop sign, a square of its larger half extent; none
      // (a negative half extent: never kept, never drawn) without one
      const int si = p.stop_idx[env];
      if (si >= 0 && si < p.n_stop) {
        const float half = fmaxf(p.ss_extent[2 * si], p.ss_extent[2 * si + 1]);
        box_row(p.ss_center[2 * si], p.ss_center[2 * si + 1],
                p.cosv[p.n + si], p.sinv[p.n + si], half, half, b);
      } else {
        box_row(0.0f, 0.0f, 1.0f, 0.0f, -1.0f, -1.0f, b);
      }
    } else if (j <= p.n_veh) {
      const size_t a = (size_t)env * p.n_veh + (j - 1);
      const size_t t = (size_t)p.n + p.n_stop + a;
      box_row(p.npc[3 * a], p.npc[3 * a + 1], p.cosv[t], p.sinv[t],
              p.veh_half_len, p.veh_half_wid, b);
    } else {
      const size_t a = (size_t)env * p.n_walk + (j - 1 - p.n_veh);
      const size_t t =
          (size_t)p.n + p.n_stop + (size_t)p.n * p.n_veh + a;
      box_row(p.walker[3 * a], p.walker[3 * a + 1], p.cosv[t], p.sinv[t],
              p.walker_half_len, p.walker_half_wid, b);
    }
  }
  __syncthreads();

  // --- this warp's tile and its bounding circle ---
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= p.tiles) return;
  const int ty = tile / p.tiles_x;
  const int tx = tile - ty * p.tiles_x;
  const int col = tx * kTileCols + lane;
  const int row0 = ty * p.tile_rows;
  // the pixel frame, ops/bev.py::pixel_world_coords op order
  const float tl_x = (x + p.fwd_off * c) - p.right_off * (-s);
  const float tl_y = (y + p.fwd_off * s) - p.right_off * c;
  const float srx = p.scale * (-s);
  const float sry = p.scale * c;
  const float sfx = p.scale * c;
  const float sfy = p.scale * s;
  // ops/bev_tiles.py::tile_centres
  const float colc = (float)(tx * kTileCols) + 0.5f * (float)(kTileCols - 1);
  const float rowc = (float)row0 + 0.5f * (float)(p.tile_rows - 1);
  const float ccx = (tl_x + colc * srx) - rowc * sfx;
  const float ccy = (tl_y + colc * sry) - rowc * sfy;

  // --- cull: each table's items within reach of the tile, in order ---
  // (the lambdas capture local copies, not the parameter block)
  const float pad = p.pad;
  const float road_reach = p.road_reach;
  const float route_reach = p.route_reach;
  const float tl_reach = p.tl_reach;
  const int n_veh_all = p.n_veh;
  unsigned short* l_road = s_list + warp * list_cap(p, kSix);
  const int n_road = compact(nb, l_road, lane, [=](int i) {
    return within(seg_dist2(ccx, ccy, s_bnd + i * kBndCoef), road_reach,
                  pad);
  });
  unsigned short* l_route = l_road + n_road;
  const int n_route = compact(p.k, l_route, lane, [=](int i) {
    return within(seg_dist2(ccx, ccy, s_route + i * kCapCoef), route_reach,
                  pad);
  });
  unsigned short* l_lane = l_route + n_route;
  const int n_lane = compact(nl, l_lane, lane, [=](int i) {
    const float* e = s_lane + i * kCapCoef;
    return within(seg_dist2(ccx, ccy, e), sqrtf(e[6]), pad);
  });
  unsigned short* l_tl = l_lane + n_lane;
  int n_tl = 0, n_stop = 0, n_veh = 0, n_walk = 0;
  unsigned short *l_stop = l_tl, *l_veh = l_tl, *l_walk = l_tl;
  if (kSix) {
    n_tl = compact(nt, l_tl, lane, [=](int i) {
      return within(seg_dist2(ccx, ccy, s_tl + i * kCapCoef), tl_reach, pad);
    });
    // a box's reach is its half diagonal; none with a negative extent
    auto box_keep = [=](int i) {
      const float* b = s_box + i * kBoxCoef;
      if (!(b[4] >= 0.0f && b[5] >= 0.0f)) return false;
      const float dx = ccx - b[0];
      const float dy = ccy - b[1];
      return within(dx * dx + dy * dy, sqrtf(b[4] * b[4] + b[5] * b[5]),
                    pad);
    };
    l_stop = l_tl + n_tl;
    n_stop = compact(1, l_stop, lane, box_keep);
    l_veh = l_stop + n_stop;
    n_veh = compact(n_veh_all, l_veh, lane,
                    [=](int i) { return box_keep(1 + i); });
    l_walk = l_veh + n_veh;
    n_walk = compact(p.n_walk, l_walk, lane,
                     [=](int i) { return box_keep(1 + n_veh_all + i); });
  }

  // --- draw the tile, kPass rows of this lane's column at a time ---
  const int w = p.w;
  const size_t npix = (size_t)w * w;
  float* o = p.out + (size_t)env * (kSix ? 6 : 3) * npix + col;
  const bool col_ok = col < w;
  const float colf = (float)col;
  const float bx = tl_x + colf * srx;
  const float by = tl_y + colf * sry;
  const int row_end = min(row0 + p.tile_rows, w);
  const float inv_255 = 1.0f / 255.0f;
  for (int r0 = row0; r0 < row_end; r0 += kPass) {
    float pxx[kPass], pxy[kPass], v[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const float rf = (float)(r0 + j);
      pxx[j] = bx - rf * sfx;
      pxy[j] = by - rf * sfy;
    }

    // road: nearest oriented boundary edge by the tie key, first one wins
    {
      float keymin[kPass], cr[kPass];
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        keymin[j] = 1.0e12f;
        cr[j] = 0.0f;
      }
      for (int q = 0; q < n_road; ++q) {
        const float* e = s_bnd + l_road[q] * kBndCoef;
        const float e0 = e[0], e1 = e[1], e2 = e[2], e3 = e[3], e4 = e[4];
        const float e5 = e[5], e6 = e[6], e7 = e[7], e8 = e[8];
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          const float t = clip01((pxx[j] * e4 + pxy[j] * e5) - e6);
          const float dx = (pxx[j] - e0) - t * e2;
          const float dy = (pxy[j] - e1) - t * e3;
          const float d2 = dx * dx + dy * dy;
          const float crn = e7 * dy - e8 * dx;
          const float key = d2 - 1e-3f * fabsf(crn);
          if (key < keymin[j]) {
            keymin[j] = key;
            cr[j] = crn;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        v[j] = (cr[j] > 0.0f && keymin[j] <= p.dmax2) ? 1.0f : 0.0f;
      }
      store<kPass>(o, r0, w, col_ok, v);
    }

    // route: min capsule distance over the route window
    {
#pragma unroll
      for (int j = 0; j < kPass; ++j) v[j] = 1.0e12f;
      for (int q = 0; q < n_route; ++q) {
        const float* e = s_route + l_route[q] * kCapCoef;
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          v[j] = fminf(v[j], capsule_d2(e, pxx[j], pxy[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        v[j] = (v[j] <= p.route_half2) ? 1.0f : 0.0f;
      }
      store<kPass>(o + npix, r0, w, col_ok, v);
    }

    // lane: max marking value within each capsule's own half width
    capsule_max<kPass>(s_lane, l_lane, n_lane, -1.0f, pxx, pxy, v);
#pragma unroll
    for (int j = 0; j < kPass; ++j) v[j] = v[j] * inv_255;
    store<kPass>(o + 2 * npix, r0, w, col_ok, v);

    if (kSix) {
      // signals: max phase value of the stop lines within the stroke,
      // and 255 inside the active stop-sign box
      float stop[kPass];
      capsule_max<kPass>(s_tl, l_tl, n_tl, p.tl_half2, pxx, pxy, v);
      boxes_hit<kPass>(s_box, l_stop, n_stop, pxx, pxy, stop);
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        if (stop[j] != 0.0f) v[j] = fmaxf(v[j], 255.0f);
        v[j] = v[j] * inv_255;
      }
      store<kPass>(o + 3 * npix, r0, w, col_ok, v);
      boxes_hit<kPass>(s_box + kBoxCoef, l_veh, n_veh, pxx, pxy, v);
      store<kPass>(o + 4 * npix, r0, w, col_ok, v);
      boxes_hit<kPass>(s_box + (1 + n_veh_all) * kBoxCoef, l_walk, n_walk,
                       pxx, pxy, v);
      store<kPass>(o + 5 * npix, r0, w, col_ok, v);
    }
  }
}

// A block may use 48 KB of dynamic shared memory without asking; past
// that the kernel must opt in (cudaFuncAttributeMaxDynamicSharedMemorySize)
// up to the card's opt-in limit per block (227 KB on H100).
constexpr size_t kDefaultShared = 48 * 1024;
// Returned by launch() when one env's staged tables need more shared
// memory than the card's opt-in limit; the wrapper names the table maxima.
constexpr int kErrSharedMemory = 1 << 20;

// Raises raster_kernel<kSix>'s dynamic shared-memory limit to `bytes` when
// they are past the 48 KB default; returns a cudaError, or
// kErrSharedMemory when `bytes` is past the card's opt-in limit.
template <bool kSix>
inline int allow_shared(size_t bytes) {
  if (bytes <= kDefaultShared) return (int)cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)optin) return kErrSharedMemory;
  return (int)cudaFuncSetAttribute(raster_kernel<kSix>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Launches raster_kernel<kSix> on `stream` for p.n envs; returns the
// cudaError of the launch (or kErrSharedMemory).
template <bool kSix>
inline int launch(Params p, void* stream) {
  if (p.n <= 0 || p.w <= 0) return (int)cudaSuccess;
  if (p.tile_rows <= 0 || p.tile_rows % pass_rows<kSix>() != 0 || p.k < 0 ||
      p.window < 1 || p.route_len < p.window ||
      (size_t)p.stride * p.k >= (size_t)p.window) {
    return (int)cudaErrorInvalidValue;
  }
  p.tiles_x = (p.w + kTileCols - 1) / kTileCols;
  p.tiles = p.tiles_x * ((p.w + p.tile_rows - 1) / p.tile_rows);
  const dim3 grid((p.tiles + kWarps - 1) / kWarps, p.n);
  const size_t smem = smem_bytes(p, kSix);
  const int err = allow_shared<kSix>(smem);
  if (err != (int)cudaSuccess) return err;
  raster_kernel<kSix><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace bev_raster
