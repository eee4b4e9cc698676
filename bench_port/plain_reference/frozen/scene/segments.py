# Frozen copy of gail_carla_tpu_torch/scene/segments.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Segment-soup + spatial-hash compilation for the on-device renderer.

Why this exists (TPU-first design note): the obvious port of the reference's
BEV pipeline — pre-rendered town textures warped per step (``chauffeurnet.py:
142-153`` via cv2) — needs a 192x192 random gather per env per step. On this
TPU stack XLA lowers such gathers catastrophically (measured: 269 s compile,
1.7 s/run for ONE env). What IS fast: contiguous ``dynamic_slice`` windows
and brute-force vector math on the VPU (10M+ capsule-distance tests per ms).

So the map compiles to *capsule segments* (road corridors, lane-marking
lines) bucketed into a coarse spatial grid. At render time each env fetches
its cell's fixed-size segment table with one dynamic_slice and rasterises by
computing per-pixel distances. Empty slots hold a far-away sentinel segment,
so there are no masks or dynamic shapes anywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from bench_port.plain_reference.frozen.scene.town import LaneGraph

FAR = 1.0e7  # sentinel coordinate for empty slots


def _chordify(pts: np.ndarray, max_err: float = 0.35) -> np.ndarray:
    """Reduce a ~1 m polyline to few chords with bounded sagitta error.
    Greedy: extend each chord while all skipped points stay within max_err."""
    if len(pts) <= 2:
        return pts
    keep = [0]
    i = 0
    while i < len(pts) - 1:
        j = len(pts) - 1
        while j > i + 1:
            a, b = pts[i], pts[j]
            ab = b - a
            denom = float(ab @ ab) + 1e-12
            seg = pts[i + 1:j]
            t = np.clip(((seg - a) @ ab) / denom, 0.0, 1.0)
            d = np.linalg.norm(seg - (a + t[:, None] * ab), axis=1)
            if d.max() <= max_err:
                break
            j -= 1
        keep.append(j)
        i = j
    return pts[keep]


LANE_HALF_W_DEFAULT = 0.25  # m; ~2 px marking stroke (graph-derived towns)


@dataclasses.dataclass
class SegmentSoup:
    road_ab: np.ndarray    # (Sr, 4) x0 y0 x1 y1 — lane-corridor centrelines
    road_junction: np.ndarray  # (Sr,) 1.0 = junction connector segment
    lane_ab: np.ndarray    # (Sl, 4) — lane-marking lines
    lane_val: np.ndarray   # (Sl,) 255 solid / 120 broken (chauffeurnet
                           # mask values, chauffeurnet.py:188-189)
    lane_hw: np.ndarray = None  # (Sl,) capsule half width, metres


def extract_segments(graph: LaneGraph, max_err: float = 0.35) -> SegmentSoup:
    road: List[np.ndarray] = []
    road_junction: List[float] = []
    lane: List[np.ndarray] = []
    lane_val: List[float] = []
    half = graph.lane_width / 2.0
    from bench_port.plain_reference.frozen.scene.road_option import RoadOption

    change_opts = (RoadOption.CHANGELANELEFT, RoadOption.CHANGELANERIGHT)
    for e in graph.edges:
        ch = _chordify(e.pts, max_err)
        ab = np.concatenate([ch[:-1], ch[1:]], axis=1)  # (M, 4)
        road.append(ab)
        road_junction.extend([1.0 if e.is_junction else 0.0] * len(ab))
        if not e.is_junction and e.option not in change_opts:
            d = ch[1:] - ch[:-1]
            n = d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-9)
            right = np.stack([-n[:, 1], n[:, 0]], axis=1)
            # marking values per edge: default broken centre at -half
            # (road centre), solid at +half (outer boundary); multi-lane
            # roads override via mark_vals — see scene/raster.py
            for off, val in ((-half, e.mark_vals[0]),
                             (half, e.mark_vals[1])):
                a = ch[:-1] + right * off
                b = ch[1:] + right * off
                lane.append(np.concatenate([a, b], axis=1))
                lane_val.extend([val] * len(a))
    lane_ab_arr = np.concatenate(lane, axis=0).astype(np.float32)
    return SegmentSoup(
        road_ab=np.concatenate(road, axis=0).astype(np.float32),
        road_junction=np.asarray(road_junction, np.float32),
        lane_ab=lane_ab_arr,
        lane_val=np.asarray(lane_val, np.float32),
        lane_hw=np.full(len(lane_ab_arr), LANE_HALF_W_DEFAULT, np.float32),
    )


def _seg_rect_dist(ab: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Min distance between segments (S, 4) and an axis-aligned rect,
    conservatively via sampled segment points (cheap, host-side). The
    9-point sampling overestimates by at most len/16, so callers must
    subdivide long segments first (``_subdivide``)."""
    if len(ab) == 0:
        return np.zeros((0,))
    t = np.linspace(0.0, 1.0, 9)[None, :, None]
    pts = ab[:, None, :2] * (1 - t) + ab[:, None, 2:] * t  # (S, 9, 2)
    dx = np.maximum(np.maximum(lo[0] - pts[..., 0], pts[..., 0] - hi[0]), 0)
    dy = np.maximum(np.maximum(lo[1] - pts[..., 1], pts[..., 1] - hi[1]), 0)
    return np.sqrt(dx * dx + dy * dy).min(axis=1)


def _subdivide(ab: np.ndarray, max_len: float = 6.0):
    """Split segments into <= max_len pieces for the bucketing distance
    test (9-sample error <= max_len/16 ~ 0.4 m, inside the margin slack).
    Returns (pieces (P, 4), parent (P,) int)."""
    if len(ab) == 0:
        return ab, np.zeros((0,), np.int64)
    a = ab[:, :2]
    b = ab[:, 2:]
    n = np.maximum(
        np.ceil(np.linalg.norm(b - a, axis=1) / max_len).astype(np.int64), 1
    )
    parent = np.repeat(np.arange(len(ab)), n)
    # fractional positions within each parent
    idx_in = np.arange(len(parent)) - np.repeat(
        np.concatenate([[0], np.cumsum(n)[:-1]]), n
    )
    t0 = idx_in / n[parent]
    t1 = (idx_in + 1) / n[parent]
    pa = a[parent] + (b - a)[parent] * t0[:, None]
    pb = a[parent] + (b - a)[parent] * t1[:, None]
    return np.concatenate([pa, pb], axis=1), parent


def _bucket_ids(ab, grid_lo, gy, gx, cell_size, margin):
    """Per-cell lists of segment indices within ``margin`` of each cell
    rect (long segments handled via subdivision)."""
    per_cell = [[] for _ in range(gy * gx)]
    if len(ab) == 0:
        return per_cell
    pieces, parent = _subdivide(np.asarray(ab, np.float64))
    for cy in range(gy):
        for cx in range(gx):
            c_lo = grid_lo + np.array([cx, cy]) * cell_size
            c_hi = c_lo + cell_size
            d = _seg_rect_dist(pieces, c_lo - margin, c_hi + margin)
            hit = np.unique(parent[d <= 1e-6])
            per_cell[cy * gx + cx] = list(hit)
    return per_cell


@dataclasses.dataclass
class CellTable:
    """Per-cell fixed-size segment tables (padded with FAR sentinels)."""

    grid_lo: np.ndarray      # (2,)
    cell_size: float
    road: np.ndarray         # (Gy, Gx, Mr, 4)
    road_flag: np.ndarray    # (Gy, Gx, Mr) 1.0 = junction connector
    road_n: np.ndarray       # (Gy, Gx) i32 live (non-sentinel) road segs
    lane: np.ndarray         # (Gy, Gx, Ml, 4)
    lane_val: np.ndarray     # (Gy, Gx, Ml)
    lane_w: np.ndarray       # (Gy, Gx, Ml) capsule half width, metres
    lane_n: np.ndarray       # (Gy, Gx) i32 live lane segs


def build_cell_table(
    soup: SegmentSoup,
    bounds_lo: np.ndarray,
    bounds_hi: np.ndarray,
    cell_size: float = 32.0,
    margin: float = 42.0,
    pad_mult: int = 8,
) -> CellTable:
    """margin must cover the farthest BEV pixel from the ego
    (sqrt((w-ptb)^2 + (w/2)^2)/ppm ≈ 36 m for 192 px @5 px/m, +capsule
    half-width), so that a cell's table contains every segment any ego in
    that cell can see."""
    lo = bounds_lo - cell_size
    gx = int(math.ceil((bounds_hi[0] - lo[0]) / cell_size)) + 1
    gy = int(math.ceil((bounds_hi[1] - lo[1]) / cell_size)) + 1

    def bucket(ab):
        per_cell = _bucket_ids(ab, lo, gy, gx, cell_size, margin)
        m = max(max(len(c) for c in per_cell), 1)
        m = ((m + pad_mult - 1) // pad_mult) * pad_mult
        return per_cell, m

    road_cells, mr = bucket(soup.road_ab)
    lane_cells, ml = bucket(soup.lane_ab)

    road = np.full((gy, gx, mr, 4), FAR, np.float32)
    road_flag = np.zeros((gy, gx, mr), np.float32)
    road_n = np.zeros((gy, gx), np.int32)
    lane = np.full((gy, gx, ml, 4), FAR, np.float32)
    lane_val = np.zeros((gy, gx, ml), np.float32)
    lane_w = np.full((gy, gx, ml), LANE_HALF_W_DEFAULT, np.float32)
    lane_n = np.zeros((gy, gx), np.int32)
    soup_hw = (
        soup.lane_hw
        if soup.lane_hw is not None
        else np.full(len(soup.lane_ab), LANE_HALF_W_DEFAULT, np.float32)
    )
    for cy in range(gy):
        for cx in range(gx):
            ids = road_cells[cy * gx + cx]
            road[cy, cx, : len(ids)] = soup.road_ab[ids]
            road_flag[cy, cx, : len(ids)] = soup.road_junction[ids]
            road_n[cy, cx] = len(ids)
            ids = lane_cells[cy * gx + cx]
            lane[cy, cx, : len(ids)] = soup.lane_ab[ids]
            lane_val[cy, cx, : len(ids)] = soup.lane_val[ids]
            lane_w[cy, cx, : len(ids)] = soup_hw[ids]
            lane_n[cy, cx] = len(ids)

    return CellTable(
        grid_lo=lo.astype(np.float32), cell_size=float(cell_size),
        road=road, road_flag=road_flag, road_n=road_n,
        lane=lane, lane_val=lane_val, lane_w=lane_w, lane_n=lane_n,
    )


def build_bnd_cells(
    bnd_ab: np.ndarray,
    grid_lo: np.ndarray,
    gy: int,
    gx: int,
    cell_size: float,
    dmax: float,
    pixel_reach: float = 37.0,
    pad_mult: int = 8,
):
    """Per-cell oriented road-boundary edge tables (scene/mask_geo.py).

    Margin rule for EXACTNESS of the nearest-edge sign test (ops/bev.py::
    boundary_inside): a pixel within ``pixel_reach`` of its cell whose true
    nearest boundary edge is within ``dmax`` must find that edge in its
    cell's table, so margin = pixel_reach + dmax. Points farther than dmax
    from every edge are provably outside (dmax = the mask's deepest interior
    point), which the renderer enforces with its ``d2 <= dmax^2`` guard.

    Returns (cell_bnd (Gy,Gx,Mb,4), cell_bnd_n (Gy,Gx) i32).
    """
    margin = pixel_reach + dmax + 1.0
    per_cell = _bucket_ids(bnd_ab, grid_lo, gy, gx, cell_size, margin)
    mb = max(max(len(c) for c in per_cell), 1)
    mb = ((mb + pad_mult - 1) // pad_mult) * pad_mult
    cell_bnd = np.full((gy, gx, mb, 4), FAR, np.float32)
    cell_bnd_n = np.zeros((gy, gx), np.int32)
    for cy in range(gy):
        for cx in range(gx):
            ids = per_cell[cy * gx + cx]
            cell_bnd[cy, cx, : len(ids)] = bnd_ab[ids]
            cell_bnd_n[cy, cx] = len(ids)
    return cell_bnd, cell_bnd_n


def build_tl_cells(tl_stop, grid_lo, gy: int, gx: int,
                   cell_size: float, margin: float = 42.0,
                   pad_mult: int = 4):
    """Per-cell traffic-light stop-line tables for the bev6 kernel.

    Same margin rule as build_cell_table (any light a cell's ego could see
    is in the cell's table), so culling the per-env light loop to this
    table is bit-exact vs streaming every light in the town.

    Returns (cell_tl (Gy,Gx,Mt,4) f32, cell_tl_idx (Gy,Gx,Mt) i32 source
    light index for phase lookup, cell_tl_n (Gy,Gx) i32 live counts).
    """
    T = tl_stop.shape[0]
    ab = tl_stop.reshape(T, 4).astype(np.float32)
    per_cell = _bucket_ids(ab, grid_lo, gy, gx, cell_size, margin)
    mt = max(max(len(c) for c in per_cell), 1)
    mt = ((mt + pad_mult - 1) // pad_mult) * pad_mult
    cell_tl = np.full((gy, gx, mt, 4), FAR, np.float32)
    cell_tl_idx = np.zeros((gy, gx, mt), np.int32)
    cell_tl_n = np.zeros((gy, gx), np.int32)
    for cy in range(gy):
        for cx in range(gx):
            ids = per_cell[cy * gx + cx]
            cell_tl[cy, cx, : len(ids)] = ab[ids]
            cell_tl_idx[cy, cx, : len(ids)] = ids
            cell_tl_n[cy, cx] = len(ids)
    return cell_tl, cell_tl_idx, cell_tl_n
