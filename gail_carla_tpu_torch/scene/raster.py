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


# segments stamped per vectorised pass (over their joint pixel window)
SEG_GROUP = 32


def _stamp_polyline(img: np.ndarray, pts_px: np.ndarray,
                    half_width_px: float, value):
    """Write ``value`` into all pixels within ``half_width_px`` of the
    polyline, ``SEG_GROUP`` segments at a time over their joint window.
    Each pixel-segment distance is the float64 expression of the JAX
    package's per-segment loop, so the mask is the same; a pixel outside
    a segment's own window is more than the half width from it."""
    H, W = img.shape
    r = half_width_px
    pts = np.asarray(pts_px, np.float64)
    for lo in range(0, len(pts) - 1, SEG_GROUP):
        a = pts[lo:lo + SEG_GROUP]
        b = pts[lo + 1:lo + SEG_GROUP + 1]
        a = a[:len(b)]
        ends = np.concatenate([a, b])
        x0 = max(int(math.floor(ends[:, 0].min() - r)), 0)
        x1 = min(int(math.ceil(ends[:, 0].max() + r)) + 1, W)
        y0 = max(int(math.floor(ends[:, 1].min() - r)), 0)
        y1 = min(int(math.ceil(ends[:, 1].max() + r)) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        gx = np.arange(x0, x1, dtype=np.float64)[None, None, :]
        gy = np.arange(y0, y1, dtype=np.float64)[None, :, None]
        ab = b - a
        denom = np.array([float(v @ v) for v in ab]) + 1e-12
        ax, ay = a[:, 0, None, None], a[:, 1, None, None]
        abx, aby = ab[:, 0, None, None], ab[:, 1, None, None]
        t = ((gx - ax) * abx + (gy - ay) * aby) / denom[:, None, None]
        t = np.clip(t, 0.0, 1.0)
        dx = gx - (ax + t * abx)
        dy = gy - (ay + t * aby)
        m = (dx * dx + dy * dy <= r * r).any(axis=0)
        img[y0:y1, x0:x1][m] = value


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
