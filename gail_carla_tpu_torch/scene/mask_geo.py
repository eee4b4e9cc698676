"""Binary mask -> oriented boundary edges (numpy, host side).

Copy of the part of ``gail_carla_tpu/scene/mask_geo.py`` that the
procedural scene needs (``mask_boundary_edges`` and its helpers); the
skeleton and path tools of the town importers are not ported.

Marching squares at the 0.5 iso-level gives closed contours oriented with
the interior on the cross-positive side: a pixel is inside the mask iff
the cross product of its *nearest* boundary edge with the offset to the
pixel is positive. With the cell-table margin extended by the mask's
maximum interior depth, and the extra guard ``d2 <= depth_max^2``, the
test is exact for every pixel (ops/bev.py::boundary_inside).

Pixel convention (chauffeurnet.py:291-299): world = offset + (x_px, y_px)
/ ppm; mask indexed [y_px, x_px].
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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
