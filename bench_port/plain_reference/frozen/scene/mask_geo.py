# Frozen copy of gail_carla_tpu_torch/scene/mask_geo.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Binary mask -> analytic geometry: oriented contours and skeleton paths
(numpy, host side).

Copy of ``gail_carla_tpu/scene/mask_geo.py``. The town importers compile
the reference's mask packs (scene/h5_maps.py) into two analytic forms the
BEV renderers consume:

- **oriented boundary edges** (marching squares at the 0.5 iso-level,
  interior on the cross-positive side): a pixel is inside the mask iff the
  cross product of its *nearest* boundary edge with the offset to the
  pixel is positive. With the cell-table margin extended by the mask's
  maximum interior depth, and the extra guard ``d2 <= depth_max^2``, the
  test is exact for every pixel (ops/bev.py::boundary_inside). The
  procedural scene traces its rasterized road corridors the same way.
- **skeleton polylines** (Zhang-Suen thinning + path tracing, carrying the
  distance-transform half-width): thin strokes (lane markings) and
  walkable ribbons (sidewalks) become capsule segments / navigation
  paths; ``plan_on_mask`` and ``refine_polyline_inside`` plan and repair
  route spans against a mask.

Pixel convention (chauffeurnet.py:291-299): world = offset + (x_px, y_px)
/ ppm; mask indexed [y_px, x_px].
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import ndimage


def _chordify_fast(pts: np.ndarray, max_err: float = 0.35) -> np.ndarray:
    """Greedy polyline chordification with bounded sagitta error, like
    scene/segments.py::_chordify but with doubling + binary search for the
    chord end (the decrement scan is O(n^2) on town-perimeter loops)."""
    n = len(pts)
    if n <= 2:
        return pts

    def ok(i, j):
        a, b = pts[i], pts[j]
        ab = b - a
        denom = float(ab @ ab) + 1e-12
        seg = pts[i + 1:j]
        t = np.clip(((seg - a) @ ab) / denom, 0.0, 1.0)
        d2 = np.sum((seg - (a + t[:, None] * ab)) ** 2, axis=1)
        return d2.max(initial=0.0) <= max_err * max_err

    keep = [0]
    i = 0
    while i < n - 1:
        # exponential growth
        step = 1
        j = i + 1
        while j < n - 1:
            nj = min(j + step, n - 1)
            if ok(i, nj):
                j = nj
                step *= 2
            else:
                break
        # binary search in (j, j+step)
        lo, hi = j, min(j + step, n - 1)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if ok(i, mid):
                lo = mid
            else:
                hi = mid - 1
        keep.append(lo)
        i = lo
    return pts[keep]


# ---------------------------------------------------------------------------
# Marching squares: oriented 0.5-level contours
# ---------------------------------------------------------------------------

# For each 2x2 cell code (TL + 2*TR + 4*BR + 8*BL) the emitted directed
# segments, as (start, end) picked from the cell-edge midpoints
#   T=(x+.5, y)  B=(x+.5, y+1)  L=(x, y+.5)  R=(x+1, y+.5)
# oriented so that cross(b-a, p-a) > 0 for interior points p (mask = 1).
_T, _B, _L, _R = 0, 1, 2, 3
_MS_CASES: Dict[int, List[Tuple[int, int]]] = {
    0: [], 15: [],
    1: [(_T, _L)],            # TL set
    2: [(_R, _T)],            # TR
    4: [(_B, _R)],            # BR
    8: [(_L, _B)],            # BL
    3: [(_R, _L)],            # top row
    12: [(_L, _R)],           # bottom row
    9: [(_T, _B)],            # left col
    6: [(_B, _T)],            # right col
    14: [(_L, _T)],           # all but TL
    13: [(_T, _R)],           # all but TR
    11: [(_R, _B)],           # all but BR
    7: [(_B, _L)],            # all but BL
    5: [(_T, _L), (_B, _R)],  # TL+BR diagonal: keep corners separate
    10: [(_R, _T), (_L, _B)],  # TR+BL diagonal
}


def _midpoints(ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """(4, n, 2) midpoint coordinates (x, y) of T/B/L/R for cells at
    (ys, xs), in half-pixel integer units (x2 to stay exact)."""
    x2 = xs.astype(np.int64) * 2
    y2 = ys.astype(np.int64) * 2
    t = np.stack([x2 + 1, y2], axis=1)
    b = np.stack([x2 + 1, y2 + 2], axis=1)
    left = np.stack([x2, y2 + 1], axis=1)
    r = np.stack([x2 + 2, y2 + 1], axis=1)
    return np.stack([t, b, left, r], axis=0)


def mask_contour_loops(mask: np.ndarray) -> List[np.ndarray]:
    """Closed oriented contour loops of a binary mask at the 0.5 level.

    Returns a list of (K, 2) float arrays in pixel coordinates (x, y),
    each a closed loop (last point != first; closure implied), oriented so
    interior is on the cross-positive side. Holes come out with opposite
    winding automatically, so one sign test serves both."""
    m = np.pad(mask.astype(bool), 1).astype(np.int8)
    code = (
        m[:-1, :-1] + 2 * m[:-1, 1:] + 4 * m[1:, 1:] + 8 * m[1:, :-1]
    )
    starts: List[np.ndarray] = []
    ends: List[np.ndarray] = []
    for c, segs in _MS_CASES.items():
        if not segs:
            continue
        ys, xs = np.nonzero(code == c)
        if len(ys) == 0:
            continue
        mid = _midpoints(ys, xs)
        for a, b in segs:
            starts.append(mid[a])
            ends.append(mid[b])
    if not starts:
        return []
    s = np.concatenate(starts, axis=0)
    e = np.concatenate(ends, axis=0)
    # link: each start key maps to its segment (orientations are consistent,
    # so every midpoint has exactly one outgoing segment)
    nxt = {}
    for i in range(len(s)):
        nxt[(int(s[i, 0]), int(s[i, 1]))] = i
    used = np.zeros(len(s), bool)
    loops: List[np.ndarray] = []
    for i0 in range(len(s)):
        if used[i0]:
            continue
        pts = []
        i = i0
        while not used[i]:
            used[i] = True
            pts.append(s[i])
            i = nxt[(int(e[i, 0]), int(e[i, 1]))]
        loop = np.asarray(pts, np.float64) * 0.5 - 1.0  # un-pad, un-x2
        loops.append(loop)
    return loops


def loops_to_edges(
    loops: List[np.ndarray],
    offset: np.ndarray,
    ppm: float,
    max_err_px: float = 0.35,
    min_loop_px: int = 4,
) -> np.ndarray:
    """Chordify contour loops and convert to world-space directed edges.

    Returns (B, 4) float32 [ax, ay, bx, by] with interior on the
    cross-positive side (cross(b-a, p-a) > 0)."""
    out = []
    for loop in loops:
        if len(loop) < min_loop_px:
            continue
        closed = np.concatenate([loop, loop[:1]], axis=0)
        ch = _chordify_fast(closed, max_err=max_err_px)
        w = ch / ppm + np.asarray(offset, np.float64)[None, :]
        out.append(
            np.concatenate([w[:-1], w[1:]], axis=1)
        )
    if not out:
        return np.zeros((0, 4), np.float32)
    ab = np.concatenate(out, axis=0)
    keep = np.linalg.norm(ab[:, 2:] - ab[:, :2], axis=1) > 1e-9
    return ab[keep].astype(np.float32)


def mask_boundary_edges(
    mask: np.ndarray,
    offset: np.ndarray,
    ppm: float,
    max_err_px: float = 0.35,
) -> Tuple[np.ndarray, float]:
    """(edges (B, 4) world-space oriented boundary, depth_max metres).

    depth_max is the maximum interior depth (distance transform peak):
    any point farther than depth_max from every boundary edge is outside
    the mask — the guard that makes the nearest-edge sign test exact with
    cell-local edge tables."""
    edges = loops_to_edges(mask_contour_loops(mask), offset, ppm, max_err_px)
    if mask.any():
        # +0.5 px: the contour sits on edge midpoints, up to half a pixel
        # outside the center-sampled distance transform
        dmax = float(ndimage.distance_transform_edt(mask).max() + 0.75) / ppm
    else:
        dmax = 0.0
    return edges, dmax


def _nearest_edge_robust(edges, p, a, ab, inv):
    """Shared inner loop of the point-vs-oriented-boundary tests: squared
    distances, the ROBUSTLY chosen nearest edge per point, and its cross.

    At a shared vertex of two edges, both are exactly equidistant and a
    plain argmin tie-breaks on floating-point noise — every point whose
    nearest boundary *feature* is that vertex (a 2D cone reaching up to
    dmax into the interior) then gets an essentially random inside sign.
    This printed phantom multi-metre "violations" onto plain-road spans of
    the Town03 routes. The robust rule (the angle-weighted pseudo-normal
    collapsed to two candidates): among edges within a relative tie window
    of the minimum distance, trust the one whose LENGTH-NORMALIZED cross
    is largest — the edge most perpendicular to the point's offset vector,
    whose sign is unambiguous."""
    t = np.clip(np.sum((p - a) * ab, -1) * inv, 0.0, 1.0)
    d = (p - a) - t[..., None] * ab
    d2 = np.sum(d * d, -1)
    cr = ab[..., 0] * d[..., 1] - ab[..., 1] * d[..., 0]
    crn = cr * np.sqrt(inv)
    d2min = d2.min(axis=1)
    near = d2 <= d2min[:, None] * (1.0 + 1e-3) + 1e-9
    score = np.where(near, np.abs(crn), -np.inf)
    j = np.argmax(score, axis=1)
    return d2, d2min, j, crn


def points_inside(edges: np.ndarray, dmax: float, pts: np.ndarray,
                  chunk: int = 4096) -> np.ndarray:
    """Host-side reference of the on-device test (ops/bev.py::
    boundary_inside): inside iff the nearest edge's cross is positive and
    the distance is within dmax, with vertex ties resolved by the largest
    normalized cross (``_nearest_edge_robust``). Used by tests and
    fidelity reports."""
    if len(edges) == 0:
        return np.zeros(len(pts), bool)
    a = edges[None, :, :2].astype(np.float64)
    ab = (edges[:, 2:] - edges[:, :2])[None].astype(np.float64)
    inv = 1.0 / (np.sum(ab * ab, -1) + 1e-12)
    out = np.zeros(len(pts), bool)
    for i in range(0, len(pts), chunk):
        p = pts[i:i + chunk, None, :].astype(np.float64)
        _, d2min, j, crn = _nearest_edge_robust(edges, p, a, ab, inv)
        rows = np.arange(len(j))
        out[i:i + chunk] = (crn[rows, j] > 0.0) & (d2min <= dmax * dmax)
    return out


def boundary_project(edges: np.ndarray, pts: np.ndarray,
                     chunk: int = 4096):
    """(closest (N,2), signed_d (N,), inward_n (N,2)): nearest boundary
    point, signed distance (positive inside) and the nearest edge's inward
    unit normal. Host-side; used to repair reconstructed lane graphs that
    stray off the ground-truth road mask."""
    a = edges[None, :, :2].astype(np.float64)
    ab = (edges[:, 2:] - edges[:, :2])[None].astype(np.float64)
    inv = 1.0 / (np.sum(ab * ab, -1) + 1e-12)
    closest = np.zeros((len(pts), 2))
    sd = np.zeros(len(pts))
    inward = np.zeros((len(pts), 2))
    for i in range(0, len(pts), chunk):
        p = pts[i:i + chunk, None, :].astype(np.float64)
        _, d2min, j, crn = _nearest_edge_robust(edges, p, a, ab, inv)
        rows = np.arange(len(j))
        t = np.clip(
            np.sum((p[:, 0] - a[0, j]) * ab[0, j], -1) * inv[0, j], 0.0, 1.0
        )
        cp = a[0, j] + t[:, None] * ab[0, j]
        e = ab[0, j]
        n = np.stack([-e[:, 1], e[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
        closest[i:i + chunk] = cp
        sd[i:i + chunk] = np.where(
            crn[rows, j] > 0, 1.0, -1.0
        ) * np.sqrt(d2min)
        inward[i:i + chunk] = n
    return closest, sd, inward


def boundary_signed_distance(edges: np.ndarray, pts: np.ndarray,
                             chunk: int = 4096) -> np.ndarray:
    """Signed distance to the oriented boundary: positive inside the mask,
    negative outside (host-side; used for lane-graph validation/repair and
    multi-lane width probing)."""
    if len(edges) == 0:
        return np.full(len(pts), -1e9)
    a = edges[None, :, :2].astype(np.float64)
    ab = (edges[:, 2:] - edges[:, :2])[None].astype(np.float64)
    inv = 1.0 / (np.sum(ab * ab, -1) + 1e-12)
    out = np.zeros(len(pts))
    for i in range(0, len(pts), chunk):
        p = pts[i:i + chunk, None, :].astype(np.float64)
        _, d2min, j, crn = _nearest_edge_robust(edges, p, a, ab, inv)
        rows = np.arange(len(j))
        out[i:i + chunk] = np.where(
            crn[rows, j] > 0.0, 1.0, -1.0
        ) * np.sqrt(d2min)
    return out


# ---------------------------------------------------------------------------
# Zhang-Suen thinning + skeleton path tracing
# ---------------------------------------------------------------------------

def thin_mask(mask: np.ndarray, max_iter: int = 200) -> np.ndarray:
    """Zhang-Suen thinning to a 1-px-wide 8-connected skeleton."""
    img = np.pad(mask.astype(bool), 1)

    def neighbours(a):
        # p2..p9 clockwise from north (standard Zhang-Suen ordering)
        return [
            np.roll(a, (1, 0), (0, 1)),    # p2 N
            np.roll(a, (1, -1), (0, 1)),   # p3 NE
            np.roll(a, (0, -1), (0, 1)),   # p4 E
            np.roll(a, (-1, -1), (0, 1)),  # p5 SE
            np.roll(a, (-1, 0), (0, 1)),   # p6 S
            np.roll(a, (-1, 1), (0, 1)),   # p7 SW
            np.roll(a, (0, 1), (0, 1)),    # p8 W
            np.roll(a, (1, 1), (0, 1)),    # p9 NW
        ]

    for _ in range(max_iter):
        changed = False
        for phase in (0, 1):
            p = neighbours(img)
            b = sum(x.astype(np.int8) for x in p)
            ring = p + [p[0]]
            a = sum(
                ((~ring[k]) & ring[k + 1]).astype(np.int8)
                for k in range(8)
            )
            if phase == 0:
                c1 = ~(p[0] & p[2] & p[4])
                c2 = ~(p[2] & p[4] & p[6])
            else:
                c1 = ~(p[0] & p[2] & p[6])
                c2 = ~(p[0] & p[4] & p[6])
            kill = img & (b >= 2) & (b <= 6) & (a == 1) & c1 & c2
            if kill.any():
                img &= ~kill
                changed = True
        if not changed:
            break
    return img[1:-1, 1:-1]


_NBR8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1)]


def skeleton_paths(skel: np.ndarray, min_len: int = 3) -> List[np.ndarray]:
    """Trace an 8-connected skeleton into maximal paths between
    endpoints/branch nodes (plus isolated loops). Returns (K, 2) pixel
    (x, y) arrays."""
    ys, xs = np.nonzero(skel)
    on = set(zip(ys.tolist(), xs.tolist()))
    deg = {}
    for p in on:
        deg[p] = sum(
            ((p[0] + dy, p[1] + dx) in on) for dy, dx in _NBR8
        )
    nodes = {p for p, d in deg.items() if d != 2}
    visited = set()   # directed half-edges (p, q)
    paths: List[np.ndarray] = []

    def walk(start, first):
        pts = [start, first]
        visited.add((start, first))
        prev, cur = start, first
        while cur not in nodes:
            outs = [
                (cur[0] + dy, cur[1] + dx)
                for dy, dx in _NBR8
                if (cur[0] + dy, cur[1] + dx) in on
                and (cur[0] + dy, cur[1] + dx) != prev
            ]
            if len(outs) != 1:
                break
            nxt = outs[0]
            if (cur, nxt) in visited:
                break
            visited.add((cur, nxt))
            pts.append(nxt)
            prev, cur = cur, nxt
        visited.add((cur, prev))
        return pts

    for p in sorted(nodes):
        for dy, dx in _NBR8:
            q = (p[0] + dy, p[1] + dx)
            if q in on and (p, q) not in visited:
                pts = walk(p, q)
                if len(pts) >= min_len:
                    paths.append(
                        np.array([(x, y) for y, x in pts], np.float64)
                    )
    # pure loops (no nodes on them)
    for p in sorted(on):
        if p in nodes:
            continue
        touched = any(
            ((p, (p[0] + dy, p[1] + dx)) in visited) for dy, dx in _NBR8
        )
        if touched:
            continue
        q = next(
            (p[0] + dy, p[1] + dx)
            for dy, dx in _NBR8
            if (p[0] + dy, p[1] + dx) in on
        )
        pts = walk(p, q)
        if len(pts) >= min_len:
            paths.append(np.array([(x, y) for y, x in pts], np.float64))
    return paths


def mask_stroke_capsules(
    mask: np.ndarray,
    offset: np.ndarray,
    ppm: float,
    value: float,
    max_err_px: float = 0.5,
    min_len_px: int = 3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Thin-stroke mask (lane markings) -> valued capsule segments.

    Returns (ab (S, 4) world, val (S,), half_w (S,) metres). Half-width per
    segment = mean distance-transform value along it (the stroke's true
    half thickness), so broad double lines and thin singles both
    reproduce."""
    if not mask.any():
        z = np.zeros((0,), np.float32)
        return np.zeros((0, 4), np.float32), z, z
    dist = ndimage.distance_transform_edt(mask)
    skel = thin_mask(mask)
    ab_out, hw_out = [], []
    for path in skeleton_paths(skel, min_len=min_len_px):
        ch = _chordify_fast(path, max_err=max_err_px)
        w = ch / ppm + np.asarray(offset, np.float64)[None, :]
        seg = np.concatenate([w[:-1], w[1:]], axis=1)
        # per-chord half width from the distance transform at the chord's
        # sample points (skeleton sits mid-stroke: D ~ half width + 0.5 px)
        mid = 0.5 * (ch[:-1] + ch[1:])
        xi = np.clip(mid[:, 0].round().astype(int), 0, mask.shape[1] - 1)
        yi = np.clip(mid[:, 1].round().astype(int), 0, mask.shape[0] - 1)
        hw = np.maximum(dist[yi, xi] - 0.5, 0.5) / ppm
        ab_out.append(seg)
        hw_out.append(hw)
    if not ab_out:
        z = np.zeros((0,), np.float32)
        return np.zeros((0, 4), np.float32), z, z
    ab = np.concatenate(ab_out, axis=0).astype(np.float32)
    hw = np.concatenate(hw_out, axis=0).astype(np.float32)
    val = np.full(len(ab), value, np.float32)
    return ab, val, hw


def mask_ribbon_paths(
    mask: np.ndarray,
    offset: np.ndarray,
    ppm: float,
    min_len_m: float = 8.0,
    step_m: float = 1.0,
) -> List[np.ndarray]:
    """Walkable-ribbon mask (sidewalks) -> centreline polylines in world
    metres, resampled at ~step_m (walker navigation paths — the stand-in
    for CARLA's nav-mesh, zombie_walker_handler.py:7-98)."""
    if not mask.any():
        return []
    skel = thin_mask(mask)
    out = []
    for path in skeleton_paths(skel):
        w = path / ppm + np.asarray(offset, np.float64)[None, :]
        d = np.linalg.norm(np.diff(w, axis=0), axis=1)
        s = np.concatenate([[0.0], np.cumsum(d)])
        if s[-1] < min_len_m:
            continue
        n = max(int(round(s[-1] / step_m)), 2)
        s_new = np.linspace(0.0, s[-1], n + 1)
        out.append(np.stack(
            [np.interp(s_new, s, w[:, 0]), np.interp(s_new, s, w[:, 1])],
            axis=1,
        ))
    return out


def plan_on_mask(
    mask: np.ndarray,
    offset: np.ndarray,
    ppm: float,
    a: np.ndarray,
    b: np.ndarray,
    margin_m: float = 80.0,
    cell_m: float = 1.0,
    center_bias: float = 4.0,
    step_m: float = 1.0,
):
    """Shortest on-mask path between world points ``a`` and ``b`` as a
    smoothed world polyline, or None if the mask does not connect them.

    The fallback route planner for legs the evidence lane graph cannot
    connect (the reference recovers these from the OpenDRIVE map via
    ``GlobalRoutePlanner.trace_route``, ``global_route_planner.py:26-63``;
    without the map, the shipped H5 ``road`` mask is the only ground truth
    covering roads no evidence route traverses). A* runs on a coarse grid
    (``cell_m`` metres/cell, majority-road cells passable) cropped to the
    leg's bbox + ``margin_m``; a distance-transform cost bias pulls the
    path toward the road centre so the smoothed polyline stays drivable.
    """
    import heapq

    off = np.asarray(offset, np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    coarse = max(int(round(cell_m * ppm)), 1)

    # crop bbox in fine pixels, aligned to the coarse grid
    lo = (np.minimum(a, b) - off) * ppm - margin_m * ppm
    hi = (np.maximum(a, b) - off) * ppm + margin_m * ppm
    x0 = max(int(lo[0]) // coarse * coarse, 0)
    y0 = max(int(lo[1]) // coarse * coarse, 0)
    x1 = min(int(hi[0]) + coarse, mask.shape[1])
    y1 = min(int(hi[1]) + coarse, mask.shape[0])
    crop = mask[y0:y1, x0:x1]
    if crop.size == 0:
        return None
    gh = crop.shape[0] // coarse
    gw = crop.shape[1] // coarse
    if gh < 2 or gw < 2:
        return None
    pooled = crop[: gh * coarse, : gw * coarse].reshape(
        gh, coarse, gw, coarse
    ).mean(axis=(1, 3))
    grid = pooled > 0.5

    # centre bias: cells far from the road edge are cheaper
    dt = ndimage.distance_transform_edt(grid)
    cost = 1.0 + center_bias / (1.0 + dt)

    def to_cell(p):
        g = ((p - off) * ppm - np.array([x0, y0])) / coarse
        return np.array([g[1], g[0]])  # (row, col)

    def snap(c):
        ci = np.clip(np.round(c).astype(int), 0, [gh - 1, gw - 1])
        if grid[ci[0], ci[1]]:
            return tuple(ci)
        ys, xs = np.nonzero(grid)
        if len(ys) == 0:
            return None
        k = np.argmin((ys - c[0]) ** 2 + (xs - c[1]) ** 2)
        if (ys[k] - c[0]) ** 2 + (xs[k] - c[1]) ** 2 > (8.0 / cell_m) ** 2:
            return None
        return (int(ys[k]), int(xs[k]))

    start = snap(to_cell(a))
    goal = snap(to_cell(b))
    if start is None or goal is None:
        return None

    nbrs = [(-1, -1, math.sqrt(2)), (-1, 0, 1.0), (-1, 1, math.sqrt(2)),
            (0, -1, 1.0), (0, 1, 1.0),
            (1, -1, math.sqrt(2)), (1, 0, 1.0), (1, 1, math.sqrt(2))]
    best = np.full((gh, gw), np.inf)
    best[start] = 0.0
    prev = {}
    # heap entries carry their own g: comparing a recomputed f-h against
    # best[] is 1-ulp fragile and can prune fresh entries
    heap = [(0.0, 0.0, start)]
    while heap:
        f, g, cur = heapq.heappop(heap)
        if cur == goal:
            break
        cy, cx = cur
        if g > best[cy, cx]:
            continue  # stale entry
        for dy, dx, w in nbrs:
            ny, nx = cy + dy, cx + dx
            if not (0 <= ny < gh and 0 <= nx < gw) or not grid[ny, nx]:
                continue
            ng = g + w * 0.5 * (cost[cy, cx] + cost[ny, nx])
            if ng < best[ny, nx]:
                best[ny, nx] = ng
                prev[(ny, nx)] = cur
                heapq.heappush(
                    heap,
                    (ng + math.hypot(goal[0] - ny, goal[1] - nx), ng,
                     (ny, nx)),
                )
    if not np.isfinite(best[goal]):
        return None
    cells = [goal]
    while cells[-1] != start:
        cells.append(prev[cells[-1]])
    cells.reverse()
    rc = np.asarray(cells, np.float64)
    # cell centres -> world; pin the exact endpoints
    w = np.empty_like(rc)
    w[:, 0] = (x0 + (rc[:, 1] + 0.5) * coarse) / ppm + off[0]
    w[:, 1] = (y0 + (rc[:, 0] + 0.5) * coarse) / ppm + off[1]
    w[0], w[-1] = a, b

    def snap(pts, r=6):
        """Pull every point to the nearest on-mask pixel within r px.
        Majority-pooled cell centres can sit ~0.7 m off the fine mask and
        blind Laplacian smoothing cut corners up to ~1.5 m off it — the
        planner's whole contract is that its output LIES ON the planning
        mask (callers erode the mask by their clearance), and unsnapped
        output measured up to 1.3 m outside."""
        out = pts.copy()
        for idx in range(1, len(pts) - 1):
            px = int((pts[idx, 0] - off[0]) * ppm)
            py = int((pts[idx, 1] - off[1]) * ppm)
            if (0 <= py < mask.shape[0] and 0 <= px < mask.shape[1]
                    and mask[py, px]):
                continue
            yy0, yy1 = max(0, py - r), min(mask.shape[0], py + r + 1)
            xx0, xx1 = max(0, px - r), min(mask.shape[1], px + r + 1)
            ys, xs = np.nonzero(mask[yy0:yy1, xx0:xx1])
            if len(ys) == 0:
                continue
            k = np.argmin((ys + yy0 - py) ** 2 + (xs + xx0 - px) ** 2)
            out[idx, 0] = (xs[k] + xx0 + 0.5) / ppm + off[0]
            out[idx, 1] = (ys[k] + yy0 + 0.5) / ppm + off[1]
        return out

    # smooth the staircase (keep endpoints) with a mask re-snap after
    # every pass, then resample at step_m and snap once more
    w = snap(w)
    for _ in range(3):
        if len(w) > 4:
            w[1:-1] = 0.25 * w[:-2] + 0.5 * w[1:-1] + 0.25 * w[2:]
            w = snap(w)
    d = np.linalg.norm(np.diff(w, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    if s[-1] < 1e-6:
        return None
    n = max(int(round(s[-1] / step_m)), 2)
    s_new = np.linspace(0.0, s[-1], n + 1)
    return snap(np.stack(
        [np.interp(s_new, s, w[:, 0]), np.interp(s_new, s, w[:, 1])],
        axis=1,
    ))


def _resample_span(out: np.ndarray, freeze: int) -> np.ndarray:
    """Uniform arc-length resample of a span's interior, keeping the first
    and last ``freeze`` points exactly (splice anchors). Removes the
    duplicate points and multi-metre index jumps a hard projection step
    leaves behind; point count is preserved."""
    n = len(out)
    lo, hi = freeze - 1, n - freeze     # resample out[lo..hi] inclusive
    mid = out[lo:hi + 1]
    d = np.linalg.norm(np.diff(mid, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    if s[-1] < 1e-9:
        return out
    s_new = np.linspace(0.0, s[-1], hi - lo + 1)
    res = out.copy()
    res[lo:hi + 1, 0] = np.interp(s_new, s, mid[:, 0])
    res[lo:hi + 1, 1] = np.interp(s_new, s, mid[:, 1])
    return res


def refine_polyline_inside(
    edges: np.ndarray,
    xy: np.ndarray,
    clearance: float = 0.75,
    freeze: int = 3,
    lam: float = 0.4,
    iters: int = 250,
    max_step: float = 0.3,
    contain_edges: Optional[np.ndarray] = None,
    contain_slack: float = 2.0,
) -> np.ndarray:
    """Elastic-band refinement: the smoothest deformation of ``xy`` whose
    interior stays ``clearance`` m inside the oriented boundary ``edges``
    (and, when ``contain_edges`` is given, within ``contain_slack`` m of
    that secondary boundary — the H5 ROAD mask, so a hard-surface repair
    cannot drift legally-but-unboundedly onto sidewalks/parking).

    Each iteration composes three displacement fields — Laplacian
    smoothing, a pull of clearance-violating points to the clearance line,
    and a pull of containment-violating points back toward the road — then
    SMOOTHES the combined field along the polyline and clamps each point's
    move to ``max_step`` m. The round-3 version instead teleported every
    violating point straight onto the clearance line of its *nearest*
    edge; mid-corridor, the nearest lobe flips between opposite walls from
    one point to the next, which printed zigzags (89-178 deg kinks),
    collapsed duplicates and 14 m index jumps into the Town03 routes.
    Coherent small steps cannot leapfrog a wall, and a periodic uniform
    arc-length resample (``_resample_span``) keeps spacing sane. The
    first/last ``freeze`` points are pinned so the refined span splices
    seamlessly; point count is preserved (companion per-point arrays —
    commands — stay aligned).
    """
    out = np.asarray(xy, np.float64).copy()
    n = len(out)
    if n < 2 * freeze + 3 or len(edges) == 0:
        return out
    # crop both boundaries to the span's bbox: the band's total motion is
    # bounded well under this margin, and nearest-edge queries only need
    # edges within it — a ~100x edge-count cut on town-scale boundaries
    margin = 25.0
    lo = out.min(axis=0) - margin
    hi = out.max(axis=0) + margin

    def crop(e):
        if e is None or not len(e):
            return e
        exlo = np.minimum(e[:, 0], e[:, 2])
        exhi = np.maximum(e[:, 0], e[:, 2])
        eylo = np.minimum(e[:, 1], e[:, 3])
        eyhi = np.maximum(e[:, 1], e[:, 3])
        sel = ((exhi >= lo[0]) & (exlo <= hi[0])
               & (eyhi >= lo[1]) & (eylo <= hi[1]))
        return e[sel] if sel.any() else e

    edges = crop(edges)
    contain_edges = crop(contain_edges)
    pinned = np.zeros(n, bool)
    pinned[:freeze] = True
    pinned[n - freeze:] = True
    for it in range(iters):
        disp = np.zeros_like(out)
        sm = 0.5 * (out[:-2] + out[2:])
        disp[1:-1] = lam * (sm - out[1:-1])
        closest, sd, inward = boundary_project(edges, out)
        viol = sd < clearance
        if viol.any():
            disp[viol] += (closest[viol] + inward[viol] * clearance
                           - out[viol])
        if contain_edges is not None and len(contain_edges):
            cc, sc, ic = boundary_project(contain_edges, out)
            violc = sc < -contain_slack
            if violc.any():
                # target: the point at signed distance -contain_slack
                disp[violc] += 0.5 * (
                    cc[violc] - ic[violc] * contain_slack - out[violc]
                )
        disp[pinned] = 0.0
        # coherent motion: smooth the displacement field so neighbours
        # move together even when their nearest-edge lobes disagree
        disp[1:-1] = 0.25 * disp[:-2] + 0.5 * disp[1:-1] + 0.25 * disp[2:]
        disp[pinned] = 0.0
        nrm = np.linalg.norm(disp, axis=1, keepdims=True)
        scale = np.minimum(1.0, max_step / np.maximum(nrm, 1e-12))
        out += disp * scale
        if it % 25 == 24:
            out = _resample_span(out, freeze)
    return _resample_span(out, freeze)
