"""Host-side texture baking: town -> (road, lane) rasters.

Copy of ``gail_carla_tpu/scene/raster.py::rasterize_town`` (the procedural
scene's road boundary is traced from this raster); the route arc-length
texture is not ported.

Counterpart of the reference's offline map renderer
(``carla_gym/utils/birdview_map.py`` writes ``maps/TownXX.h5`` with ``road``,
``lane_marking_all``, ``lane_marking_white_broken`` layers at 5 px/m, consumed
by ``chauffeurnet.py:72-85``), in pure numpy: masks are built by
segment-distance stamping.
"""
from __future__ import annotations

import dataclasses
import math
import numpy as np

from gail_carla_tpu_torch.scene.town import LaneGraph

PIXELS_PER_METER = 5.0  # chauffeurnet obs config, carla_env.py:53


@dataclasses.dataclass
class TownRaster:
    road: np.ndarray           # (H, W) u8, 255 = road
    lane: np.ndarray           # (H, W) u8, 255 = solid marking, 120 = broken
    world_offset: np.ndarray   # (2,) metres of pixel (0, 0)
    ppm: float


def _stamp_polyline(
    img: np.ndarray,
    pts_px: np.ndarray,
    half_width_px: float,
    value,
    s_px: np.ndarray = None,
):
    """Write ``value`` (or per-point ``s_px`` + 1) into all pixels within
    ``half_width_px`` of the polyline. Windowed per segment; offline-only."""
    H, W = img.shape
    r = half_width_px
    for i in range(len(pts_px) - 1):
        a, b = pts_px[i], pts_px[i + 1]
        x0 = max(int(math.floor(min(a[0], b[0]) - r)), 0)
        x1 = min(int(math.ceil(max(a[0], b[0]) + r)) + 1, W)
        y0 = max(int(math.floor(min(a[1], b[1]) - r)), 0)
        y1 = min(int(math.ceil(max(a[1], b[1]) + r)) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = np.arange(x0, x1, dtype=np.float64)
        ys = np.arange(y0, y1, dtype=np.float64)
        gx, gy = np.meshgrid(xs, ys)
        ab = b - a
        denom = float(ab @ ab) + 1e-12
        t = ((gx - a[0]) * ab[0] + (gy - a[1]) * ab[1]) / denom
        t = np.clip(t, 0.0, 1.0)
        dx = gx - (a[0] + t * ab[0])
        dy = gy - (a[1] + t * ab[1])
        m = dx * dx + dy * dy <= r * r
        win = img[y0:y1, x0:x1]
        if s_px is None:
            win[m] = value
        else:
            sval = (s_px[i] + t * (s_px[i + 1] - s_px[i]) + 1.0).astype(
                img.dtype
            )
            np.maximum(win, np.where(m, sval, 0), out=win)


def _bounds(graph: LaneGraph, margin: float = 40.0):
    pts = np.concatenate([e.pts for e in graph.edges], axis=0)
    lo = pts.min(axis=0) - margin
    hi = pts.max(axis=0) + margin
    return lo, hi


def rasterize_town(
    graph: LaneGraph, ppm: float = PIXELS_PER_METER, margin: float = 40.0
) -> TownRaster:
    lo, hi = _bounds(graph, margin)
    W = int(math.ceil((hi[0] - lo[0]) * ppm))
    H = int(math.ceil((hi[1] - lo[1]) * ppm))
    road = np.zeros((H, W), dtype=np.uint8)
    lane = np.zeros((H, W), dtype=np.uint8)
    half_lane_px = graph.lane_width / 2.0 * ppm

    def to_px(pts):
        return (pts - lo[None, :]) * ppm

    # Road = union of lane corridors (junction connectors included).
    for e in graph.edges:
        _stamp_polyline(road, to_px(e.pts), half_lane_px, 255)

    # Lane markings on straight roads only (junction interiors unpainted,
    # like real towns): centre line broken (120), outer edges solid (255).
    half = graph.lane_width / 2.0
    for e in graph.edges:
        if e.is_junction:
            continue
        d = np.diff(e.pts, axis=0)
        d = np.concatenate([d, d[-1:]], axis=0)
        n = d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-9)
        right = np.stack([-n[:, 1], n[:, 0]], axis=1)
        # lane centreline is offset +half to the right of the road axis;
        # road centre (broken marking) is at -half, outer edge at +half.
        _stamp_polyline(lane, to_px(e.pts - right * half), 1.0, 120)
        _stamp_polyline(lane, to_px(e.pts + right * half), 1.0, 255)

    return TownRaster(
        road=road, lane=lane, world_offset=lo.astype(np.float32), ppm=ppm
    )
