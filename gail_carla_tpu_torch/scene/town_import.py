"""Reference-town reconstruction: Town01-06 from route XMLs + H5 packs.

Port of ``gail_carla_tpu/scene/town_import.py``: the same numpy code, so
the graph, the dense routes and the scene's host tables equal the JAX
package's; ``make_town_scene`` returns a ``TorchScene`` on ``device``.

Two ground-truth sources ship with the reference:

1. **Route waypoint data** — ``data/routes_{training,testing,devtest}.xml``
   and the scenario-description packs
   (``carla_gym/envs/scenario_descriptions/**``): lane-centerline poses
   (x, y, yaw) in real town coordinates (``config_utils.py:73-100``).
   These carry the lane TOPOLOGY evidence (where lanes run, which turns
   connect them).
2. **The pre-rendered mask packs** —
   ``carla_gym/core/obs_manager/birdview/maps/Town0{1..6}.h5`` (10 uint8
   layers at 5 px/m; loaded by ``chauffeurnet.py:72-85``, checked by
   ``config_utils.py:11-48``): the exact road / sidewalk / lane-marking
   PIXELS the reference policy observes. These carry the surface GEOMETRY
   ground truth (road polygons, real widths, marking lines). The
   ``stopline`` layer is empty in every town (verified), so traffic-light
   stop lines still have to be synthesized.

This module builds the lane graph from (1): every consecutive-waypoint leg
of every known route is densified into straight runs + junction arcs,
collinear runs are merged, junctions detected where turn corners cluster,
and lights synthesized at signalized-junction entries (phases/stop-lines
follow ``sim/signals.py`` semantics). The graph and each task's dense route
are then VALIDATED AND REPAIRED against (2): any polyline point that strays
outside (or within ``clearance`` of) the H5 road mask is pulled back inside
via the oriented-boundary projection (``repair_graph_to_mask``,
``scene/mask_geo.py::boundary_project``) — the invented junction-arc radii
are thereby corrected to the true junction polygons. The mask geometry
itself (boundary edges, marking capsules, sidewalk paths —
``scene/h5_maps.py``) is handed to ``build_scene`` so the BEV road/lane
channels render the reference's actual town pixels.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.scene import h5_maps
from gail_carla_tpu_torch.scene.road_option import RoadOption
from gail_carla_tpu_torch.scene.routes import RouteDef, parse_routes_xml
from gail_carla_tpu_torch.scene.town import (
    LANE_WIDTH,
    LaneEdge,
    LaneGraph,
    TrafficLightFixture,
    _sample_arc,
    _sample_line,
    _sample_uturn,
    _turn_option,
)
from gail_carla_tpu_torch.scene.trace import DenseRoute, _downsample

TOWNS = ("Town01", "Town02", "Town03", "Town04", "Town05", "Town06")


def _wrap(a: float) -> float:
    return (a + math.pi) % (2 * math.pi) - math.pi


# ---------------------------------------------------------------------------
# Leg densification: one consecutive-waypoint pair -> geometry pieces
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Piece:
    pts: np.ndarray          # (M, 2)
    option: RoadOption
    is_junction: bool
    corner: Optional[np.ndarray] = None   # junction corner (turn pieces)
    yaw_in: float = 0.0
    yaw_out: float = 0.0


def densify_leg(
    p0: np.ndarray, yaw0: float, p1: np.ndarray, yaw1: float,
    step: float = 1.0,
) -> List[_Piece]:
    """Geometry between two consecutive route waypoints.

    CARLA route files put waypoints at decision points, so a leg is one of:
    straight road (equal yaws), a gentle road curve (small yaw delta), or a
    junction turn (straight approach + corner arc + straight exit). The
    reference recovers the true geometry from the OpenDRIVE map via
    ``GlobalRoutePlanner.trace_route``; without the map we reconstruct it
    from the endpoint poses."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    d = p1 - p0
    dist = float(np.linalg.norm(d))
    if dist < 0.5:
        return []
    f0 = np.array([math.cos(yaw0), math.sin(yaw0)])
    f1 = np.array([math.cos(yaw1), math.sin(yaw1)])
    dyaw = _wrap(yaw1 - yaw0)
    chord_yaw = math.atan2(d[1], d[0])

    if abs(dyaw) < 0.06 and abs(_wrap(chord_yaw - yaw0)) < 0.06:
        # straight road
        return [_Piece(_sample_line(p0, p1, step), RoadOption.LANEFOLLOW,
                       False, yaw_in=yaw0, yaw_out=yaw1)]
    lon = float(d @ f0)
    lat = float(f0[0] * d[1] - f0[1] * d[0])  # + = CARLA right (y-down)
    if (abs(dyaw) < 0.09 and 1.8 <= abs(lat) <= 8.5
            and lon > 2.0 * abs(lat)):
        # Lane change: parallel headings one or two lane widths apart.
        # The reference's GlobalRoutePlanner emits CHANGELANELEFT/RIGHT
        # for its lane-change edges (global_route_planner.py:148-184);
        # route-file legs of this shape are exactly those edges plus
        # lane-follow slack, so reconstruct as straight approach + a
        # bounded diagonal blend (the CHANGELANE piece) + straight exit.
        opt = (RoadOption.CHANGELANERIGHT if lat > 0
               else RoadOption.CHANGELANELEFT)
        blend = min(lon - 2.0, max(6.0 * abs(lat), 12.0))
        s_pre = (lon - blend) * 0.5
        E = p0 + f0 * s_pre
        X = p1 - f1 * s_pre
        pieces: List[_Piece] = []
        if s_pre > 1.0:
            pieces.append(_Piece(_sample_line(p0, E, step),
                                 RoadOption.LANEFOLLOW, False,
                                 yaw_in=yaw0, yaw_out=yaw0))
        pieces.append(_Piece(_sample_arc(E, yaw0, X, yaw1, step), opt,
                             False, yaw_in=yaw0, yaw_out=yaw1))
        if s_pre > 1.0:
            pieces.append(_Piece(_sample_line(X, p1, step),
                                 RoadOption.LANEFOLLOW, False,
                                 yaw_in=yaw1, yaw_out=yaw1))
        return pieces
    if abs(dyaw) < 0.35:
        # gentle curve within one road — smooth blend, still lane-follow
        return [_Piece(_sample_arc(p0, yaw0, p1, yaw1, step),
                       RoadOption.LANEFOLLOW, False,
                       yaw_in=yaw0, yaw_out=yaw1)]
    if abs(dyaw) > 2.6 and dist < 15.0:
        # median U-turn (anti-parallel waypoints a few metres apart):
        # a posed blend degenerates into a sub-metre hairpin the vehicle
        # cannot steer (min turning radius ~4.2 m) — build the Dubins
        # teardrop through the junction opening instead
        return [_Piece(_sample_uturn(p0, yaw0, p1, yaw1, step=step),
                       _turn_option(yaw0, yaw1), True,
                       corner=0.5 * (p0 + p1), yaw_in=yaw0, yaw_out=yaw1)]

    # A turn. Find the corner C where the entry and exit headings cross:
    # p0 + t*f0 == p1 - u*f1.
    det = f0[0] * f1[1] - f0[1] * f1[0]
    if abs(det) < 1e-6:
        # U-turn / parallel headings: no unique corner
        return [_Piece(_sample_arc(p0, yaw0, p1, yaw1, step),
                       _turn_option(yaw0, yaw1), True,
                       corner=0.5 * (p0 + p1), yaw_in=yaw0, yaw_out=yaw1)]
    t = (d[0] * f1[1] - d[1] * f1[0]) / det
    u = (f0[0] * d[1] - f0[1] * d[0]) / det
    if t > 2.0 * dist or u > 2.0 * dist or min(t, u) > 60.0:
        # no credible corner inside the leg (shallow crossing of nearly
        # parallel headings puts the intersection far away — Town03+ has
        # winding roads): treat as a road bend, not a junction turn
        return [_Piece(_sample_arc(p0, yaw0, p1, yaw1, step),
                       RoadOption.LANEFOLLOW, False,
                       yaw_in=yaw0, yaw_out=yaw1)]
    if t < 1.0 or u < 1.0:
        # corner at/behind an endpoint — the whole leg is the connector
        return [_Piece(_sample_arc(p0, yaw0, p1, yaw1, step),
                       _turn_option(yaw0, yaw1), True,
                       corner=0.5 * (p0 + p1), yaw_in=yaw0, yaw_out=yaw1)]
    C = p0 + t * f0
    r = float(np.clip(min(t, u) * 0.67, 2.0, 10.0))
    E = C - f0 * r
    X = C + f1 * r
    pieces: List[_Piece] = []
    if t - r > 1.0:
        pieces.append(_Piece(_sample_line(p0, E, step),
                             RoadOption.LANEFOLLOW, False,
                             yaw_in=yaw0, yaw_out=yaw0))
    pieces.append(_Piece(_sample_arc(E, yaw0, X, yaw1, step),
                         _turn_option(yaw0, yaw1), True, corner=C,
                         yaw_in=yaw0, yaw_out=yaw1))
    if u - r > 1.0:
        pieces.append(_Piece(_sample_line(X, p1, step),
                             RoadOption.LANEFOLLOW, False,
                             yaw_in=yaw1, yaw_out=yaw1))
    return pieces


def _leg_doubles_back(p0, yaw0, p1, yaw1) -> bool:
    """True when a leg cannot be reconstructed from its endpoints: the
    chord opposes the entry or exit heading (>100 deg), i.e. the true
    CARLA route between these waypoints loops through the road network
    (turnaround at a junction, winding Town03+ connectors) — geometry a
    two-pose arc can only fake with an undrivable hairpin."""
    d = np.asarray(p1, np.float64) - np.asarray(p0, np.float64)
    dist = float(np.linalg.norm(d))
    if dist < 0.5:
        return False
    chord = math.atan2(d[1], d[0])
    return (abs(_wrap(chord - yaw0)) > 1.75
            or abs(_wrap(yaw1 - chord)) > 1.75)


def _pieces_hairpin(pieces: List[_Piece], step: float = 1.0) -> bool:
    """True when densified leg geometry bends more than ~40 deg between
    consecutive ~1 m samples (turn radius under ~1.4 m — tighter than any
    real lane connector; legitimate r>=2 m junction arcs stay under 30)."""
    return _polyline_hairpin(np.concatenate([p.pts for p in pieces],
                                            axis=0))


def _polyline_hairpin(xy: np.ndarray) -> bool:
    if len(xy) < 3:
        return False
    seg = np.diff(xy, axis=0)
    good = np.linalg.norm(seg, axis=-1) > 1e-6
    hdg = np.arctan2(seg[good][:, 1], seg[good][:, 0])
    turn = np.abs(np.vectorize(_wrap)(np.diff(hdg)))
    return bool((turn > 0.7).any())


def densify_route_hybrid(
    waypoints: np.ndarray, graph: "LaneGraph", geometry=None,
    step: float = 1.0,
) -> DenseRoute:
    """densify_route, but legs the endpoint reconstruction cannot express
    (doubling-back chords, hairpin arcs) are PLANNED through the evidence
    lane graph instead — per-leg GlobalRoutePlanner semantics
    (``global_route_planner.py`` trace between consecutive keypoints,
    ``task_vehicle.py:84-93``). Feasible legs keep the route's own geometry
    as the source of truth, and a graph plan is accepted only when it is
    actually better than the geometric leg: no hairpin of its own, and not
    deeper off the H5 road mask (``geometry.bnd_ab``)."""
    from gail_carla_tpu_torch.scene.trace import (
        _collapse_lane_changes, _edge_slices,
    )

    def offroad_depth(xy: np.ndarray) -> float:
        if geometry is None:
            return 0.0
        from gail_carla_tpu_torch.scene import mask_geo

        sd = mask_geo.boundary_signed_distance(geometry.bnd_ab, xy)
        return max(0.0, -float(sd.min()))

    pts: List[np.ndarray] = []
    cmds: List[np.ndarray] = []

    def push(p_list, c_list):
        for p, c in zip(p_list, c_list):
            if len(p) == 0:
                continue
            if pts and len(p) > 1:
                p, c = p[1:], c[1:]
            pts.append(p)
            cmds.append(np.asarray(c, np.int32))

    for i in range(len(waypoints) - 1):
        p0, yaw0 = waypoints[i, :2], waypoints[i, 2]
        p1, yaw1 = waypoints[i + 1, :2], waypoints[i + 1, 2]
        pieces = densify_leg(p0, yaw0, p1, yaw1, step)
        if not pieces:
            continue
        geo_xy = np.concatenate([pc.pts for pc in pieces], axis=0)
        if graph is not None and (
            _leg_doubles_back(p0, yaw0, p1, yaw1)
            or _pieces_hairpin(pieces, step)
        ):
            try:
                gp, gc = _edge_slices(
                    graph, np.asarray(p0), np.asarray(p1),
                    a_yaw=float(yaw0), b_yaw=float(yaw1),
                )
                g_xy = np.concatenate(gp, axis=0)
                # depth-only gate: graph kinks/turnaround reversals are
                # repaired downstream by smooth_dense_route, but a plan
                # that strays further off the road mask than the
                # geometric leg is a worse starting point
                if (offroad_depth(g_xy)
                        <= max(offroad_depth(geo_xy), 2.0) + 0.5):
                    push(gp, gc)
                    continue
            except RuntimeError:
                pass  # no graph path — keep the geometric fallback
        push([pc.pts for pc in pieces],
             [np.full(len(pc.pts), int(pc.option), np.int32)
              for pc in pieces])

    xy = np.concatenate(pts, axis=0)
    cmd = np.concatenate(cmds, axis=0)
    keep = np.ones(len(xy), dtype=bool)
    keep[1:] = np.linalg.norm(np.diff(xy, axis=0), axis=1) > 1e-6
    xy, cmd = xy[keep], cmd[keep]
    d = np.diff(xy, axis=0)
    yaw_seg = np.arctan2(d[:, 1], d[:, 0])
    yaw = np.concatenate([yaw_seg, yaw_seg[-1:]])
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
    cmd = _collapse_lane_changes(cmd)
    plan_idx = _downsample(xy, cmd, sample_factor=50.0)
    return DenseRoute(
        xy=xy, yaw=yaw, cmd=cmd, s=s,
        plan_xy=xy[plan_idx], plan_cmd=cmd[plan_idx],
    )


def densify_route(waypoints: np.ndarray, step: float = 1.0) -> DenseRoute:
    """Sparse (K, 3) route keypoints -> DenseRoute, bypassing graph A*
    (the route's own geometry IS the reconstruction source of truth)."""
    pts: List[np.ndarray] = []
    cmds: List[np.ndarray] = []
    for i in range(len(waypoints) - 1):
        for piece in densify_leg(
            waypoints[i, :2], waypoints[i, 2],
            waypoints[i + 1, :2], waypoints[i + 1, 2], step,
        ):
            p = piece.pts
            if pts and len(p) > 1:
                p = p[1:]   # drop duplicated seam point
            pts.append(p)
            cmds.append(np.full(len(p), int(piece.option), np.int32))
    xy = np.concatenate(pts, axis=0)
    cmd = np.concatenate(cmds, axis=0)
    keep = np.ones(len(xy), dtype=bool)
    keep[1:] = np.linalg.norm(np.diff(xy, axis=0), axis=1) > 1e-6
    xy, cmd = xy[keep], cmd[keep]
    d = np.diff(xy, axis=0)
    yaw_seg = np.arctan2(d[:, 1], d[:, 0])
    yaw = np.concatenate([yaw_seg, yaw_seg[-1:]])
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
    plan_idx = _downsample(xy, cmd, sample_factor=50.0)
    return DenseRoute(
        xy=xy, yaw=yaw, cmd=cmd, s=s,
        plan_xy=xy[plan_idx], plan_cmd=cmd[plan_idx],
    )


# ---------------------------------------------------------------------------
# Route collection
# ---------------------------------------------------------------------------

def _root(root: Optional[str]) -> str:
    """``root``, or the reference checkout ``h5_maps.REFERENCE_DATA`` at
    call time (the JAX package binds its path as the default)."""
    return h5_maps.REFERENCE_DATA if root is None else root


def _route_files(root: str) -> List[str]:
    out = []
    for name in ("routes_training.xml", "routes_testing.xml",
                 "routes_devtest.xml", "route_00.xml", "route_01.xml"):
        p = os.path.join(root, "data", name)
        if os.path.exists(p):
            out.append(p)
    return out


def collect_town_routes(
    town: str, root: Optional[str] = None, min_waypoints: int = 4,
) -> List[RouteDef]:
    """All multi-waypoint routes of ``town`` across the shipped data files
    (used as geometry evidence for the reconstruction)."""
    root = _root(root)
    routes: List[RouteDef] = []
    for path in _route_files(root):
        for r in parse_routes_xml(path):
            if r.town == town and len(r.waypoints) >= min_waypoints:
                routes.append(r)
    # LeaderBoard scenario-description packs (same towns; Town04 also has
    # _train/_test splits whose dir name starts with the town name)
    sd = os.path.join(root, "carla_gym", "envs", "scenario_descriptions",
                      "LeaderBoard")
    if os.path.isdir(sd):
        for d in sorted(os.listdir(sd)):
            if not d.startswith(town):
                continue
            p = os.path.join(sd, d, "routes.xml")
            if os.path.exists(p):
                for r in parse_routes_xml(p):
                    if len(r.waypoints) >= min_waypoints:
                        routes.append(dataclasses.replace(r, town=town))
    return routes


def benchmark_routes(
    town: str = "Town01", route_file: str = "routes_training.xml",
    root: Optional[str] = None,
) -> List[RouteDef]:
    """The benchmark task pack: routes of ``town`` from one file, in file
    order with re-numbered ids (training routes 0-9 are exactly the Town01
    block of routes_training.xml, ``params_variable.json:13``).
    ``route_file`` may also be a path to a scenario-description pack's
    routes.xml, whose routes carry no town attribute."""
    root = _root(root)
    if os.sep in route_file and os.path.exists(route_file):
        path = route_file
        picked = list(parse_routes_xml(path))
    else:
        path = os.path.join(root, "data", route_file)
        picked = [r for r in parse_routes_xml(path) if r.town == town]
    return [
        dataclasses.replace(r, route_id=i, town=town)
        for i, r in enumerate(picked)
    ]


# ---------------------------------------------------------------------------
# Graph reconstruction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Run:
    """A maximal straight lane line: anchor o, unit direction d, plus
    coverage intervals along it (merged with bounded gaps)."""

    o: np.ndarray
    d: np.ndarray
    intervals: List[List[float]]
    cuts: List[float] = dataclasses.field(default_factory=list)
    junction_spans: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list
    )

    def proj(self, p: np.ndarray) -> float:
        return float((p - self.o) @ self.d)

    def lateral(self, p: np.ndarray) -> float:
        v = p - self.o
        return float(abs(v[0] * self.d[1] - v[1] * self.d[0]))

    def point(self, s: float) -> np.ndarray:
        return self.o + s * self.d

    def add_interval(self, lo: float, hi: float, max_gap: float = 30.0):
        self.intervals.append([lo, hi])
        self.intervals.sort()
        merged = [self.intervals[0]]
        for a, b in self.intervals[1:]:
            if a <= merged[-1][1] + max_gap:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.intervals = merged


class _NodeSnap:
    """Node registry with distance snapping (two poses within ``tol`` m are
    the same graph node)."""

    def __init__(self, tol: float = 0.9):
        self.tol = tol
        self.nodes: List[np.ndarray] = []
        self._grid: Dict[Tuple[int, int], List[int]] = {}

    def get(self, p: np.ndarray) -> int:
        cx, cy = int(p[0] // self.tol), int(p[1] // self.tol)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for idx in self._grid.get((cx + dx, cy + dy), ()):
                    if np.linalg.norm(self.nodes[idx] - p) <= self.tol:
                        return idx
        self.nodes.append(np.asarray(p, np.float64))
        idx = len(self.nodes) - 1
        self._grid.setdefault((cx, cy), []).append(idx)
        return idx


def build_town_graph(
    route_defs: Sequence[RouteDef],
    lane_width: float = LANE_WIDTH,
    dir_tol: float = 0.07,
    lat_tol: float = 1.2,
    geometry=None,
    crossing_junctions: bool = False,
) -> LaneGraph:
    """Union of all route legs -> merged directed lane graph + synthesized
    signals. See module docstring for the method.

    With ``geometry`` (the town's H5-derived mask geometry) the graph is
    COMPLETED beyond the raw route evidence: every lane line gets its
    opposite-direction twin when the mask proves a two-way road there
    (``sd`` of the offset lane centre consistent with a 2-lane road), and
    with ``crossing_junctions`` near-perpendicular lane-line crossings
    spawn junction clusters even where no turning evidence exists —
    together these make arbitrary start->goal pairs plannable (the
    NoCrash/CoRL2017 packs are bare endpoint pairs,
    ``nocrash_env.py:57-59``)."""
    runs: List[_Run] = []
    curves: Dict[Tuple, _Piece] = {}
    arcs: Dict[Tuple, _Piece] = {}
    lane_change_pieces: Dict[Tuple, _Piece] = {}

    def endpoint_key(a, b):
        return (round(a[0] / 2.0), round(a[1] / 2.0),
                round(b[0] / 2.0), round(b[1] / 2.0))

    def match_run(p: np.ndarray, yaw: float) -> Optional[_Run]:
        f = np.array([math.cos(yaw), math.sin(yaw)])
        best, best_lat = None, lat_tol
        for run in runs:
            if float(run.d @ f) < math.cos(dir_tol):
                continue
            lat = run.lateral(p)
            if lat < best_lat:
                best, best_lat = run, lat
        return best

    # 1. densify every leg of every route; bucket pieces
    for r in route_defs:
        w = r.waypoints
        for i in range(len(w) - 1):
            for piece in densify_leg(w[i, :2], w[i, 2],
                                     w[i + 1, :2], w[i + 1, 2]):
                a, b = piece.pts[0], piece.pts[-1]
                if piece.is_junction:
                    arcs.setdefault(endpoint_key(a, b), piece)
                elif piece.option in (RoadOption.CHANGELANELEFT,
                                      RoadOption.CHANGELANERIGHT):
                    # evidence lane-change blends connect adjacent lanes;
                    # they must NOT seed runs (their chord is diagonal)
                    lane_change_pieces.setdefault(
                        endpoint_key(a, b), piece
                    )
                elif abs(_wrap(piece.yaw_out - piece.yaw_in)) < 0.06:
                    yaw = math.atan2(b[1] - a[1], b[0] - a[0])
                    run = match_run(a, yaw)
                    if run is None or run.lateral(b) > lat_tol:
                        run = _Run(
                            o=a.copy(),
                            d=np.array([math.cos(yaw), math.sin(yaw)]),
                            intervals=[],
                        )
                        runs.append(run)
                    lo, hi = run.proj(a), run.proj(b)
                    run.add_interval(min(lo, hi), max(lo, hi))
                else:
                    curves.setdefault(endpoint_key(a, b), piece)

    # 1b. mask-guided interval extension: evidence intervals end wherever
    # a route happened to stop, leaving dead-end stubs mid-road. Extend
    # each interval end along its lane line for as long as the line stays
    # inside the H5 road mask (the junction pass later cuts and links the
    # extended coverage).
    if geometry is not None:
        from gail_carla_tpu_torch.scene import mask_geo as _mg

        step_e = 4.0
        for run in runs:
            for lo, hi in list(run.intervals):
                for sgn, s0 in ((1.0, hi), (-1.0, lo)):
                    ss = s0 + sgn * step_e * np.arange(1, 101)
                    pts = run.o[None, :] + ss[:, None] * run.d[None, :]
                    _, sd, _ = _mg.boundary_project(geometry.bnd_ab, pts)
                    inside = sd > 0.9
                    n_ok = (
                        int(np.argmax(~inside)) if (~inside).any()
                        else len(ss)
                    )
                    if n_ok > 0:
                        s_end = float(ss[n_ok - 1])
                        run.add_interval(min(s0, s_end), max(s0, s_end))

    # 1c. twin-lane completion: evidence often drives a road in only one
    # direction. Where the H5 road mask proves a standard two-way two-lane
    # road (the offset lane centre sits inside the mask AND within
    # ~0.8 lane widths of the far edge — wider carriageways are rejected
    # so one-way multi-lane roads never get a ghost oncoming lane), add
    # the opposite lane as a run of its own.
    def covered(p: np.ndarray, yaw: float) -> bool:
        f = np.array([math.cos(yaw), math.sin(yaw)])
        for r2 in runs:
            if float(r2.d @ f) < math.cos(3.0 * dir_tol):
                continue
            if r2.lateral(p) > 1.5 * lat_tol:
                continue
            s = r2.proj(p)
            if any(lo - 5.0 <= s <= hi + 5.0 for lo, hi in r2.intervals):
                return True
        return False

    if geometry is not None:
        from gail_carla_tpu_torch.scene import mask_geo

        twins: List[_Run] = []
        for run in runs:
            left = np.array([-run.d[1], run.d[0]])
            yaw_t = math.atan2(-run.d[1], -run.d[0])
            for lo, hi in run.intervals:
                if hi - lo < 25.0:
                    continue
                ss = np.arange(lo + 2.0, hi - 2.0, 8.0)
                if len(ss) < 3:
                    continue
                pts = (
                    run.o[None, :] + ss[:, None] * run.d[None, :]
                    + left[None, :] * lane_width
                )
                _, sd, _ = mask_geo.boundary_project(geometry.bnd_ab, pts)
                if float((sd > 0.9).mean()) < 0.92:
                    continue  # offset lane leaves the road mask
                if float(np.median(sd)) > 0.8 * lane_width:
                    continue  # road wider than 2 lanes: direction unknown
                n_cov = sum(
                    covered(p, yaw_t) for p in pts[:: max(len(pts) // 6, 1)]
                )
                if n_cov > 0.2 * len(pts[:: max(len(pts) // 6, 1)]):
                    continue  # opposite lane (partially) evidenced already
                t = _Run(
                    o=run.o + left * lane_width, d=-run.d, intervals=[]
                )
                t.add_interval(-hi, -lo)
                twins.append(t)
        runs.extend(twins)

    # 2. junction clusters from arc corners
    corners = [p.corner for p in arcs.values() if p.corner is not None]
    clusters: List[dict] = []   # {center, members(list of _Piece)}
    for c, piece in zip(corners,
                        [p for p in arcs.values() if p.corner is not None]):
        hit = None
        for cl in clusters:
            if np.linalg.norm(cl["center"] - c) < 15.0:
                hit = cl
                break
        if hit is None:
            clusters.append({"center": c.copy(), "members": [piece],
                             "n": 1})
        else:
            hit["members"].append(piece)
            hit["n"] += 1
            hit["center"] = (
                hit["center"] * (hit["n"] - 1) + c
            ) / hit["n"]

    # 2b. crossing-derived junctions: two near-perpendicular lane lines
    # whose covered intervals cross MUST meet at a junction even if no
    # route evidence ever turned there (Town01/02 are flat grids — no
    # overpasses — so a 2D crossing is a real junction; towns with
    # grade separation keep this off).
    if crossing_junctions:
        for i, r1 in enumerate(runs):
            for r2 in runs[i + 1:]:
                det = r1.d[0] * r2.d[1] - r1.d[1] * r2.d[0]
                if abs(det) < 0.5:
                    continue
                rhs = r2.o - r1.o
                s = (rhs[0] * r2.d[1] - rhs[1] * r2.d[0]) / det
                t = (r1.d[0] * rhs[1] - r1.d[1] * rhs[0]) / det
                # corner junctions: at an L-corner both roads END short of
                # the geometric line crossing by about the corner radius,
                # so the tolerance must cover it
                m = 14.0
                if not any(
                    lo - m <= s <= hi + m for lo, hi in r1.intervals
                ):
                    continue
                if not any(
                    lo - m <= t <= hi + m for lo, hi in r2.intervals
                ):
                    continue
                c = r1.point(s)
                hit = None
                for cl in clusters:
                    if np.linalg.norm(cl["center"] - c) < 15.0:
                        hit = cl
                        break
                if hit is None:
                    clusters.append({
                        "center": c.copy(), "members": [], "n": 0,
                        "force_signalized": True,
                    })

    for cl in clusters:
        headings = set()
        radius = 8.0
        for p in cl["members"]:
            headings.add(round(p.yaw_in / (math.pi / 4)) % 8)
            for q in (p.pts[0], p.pts[-1]):
                radius = max(radius, float(
                    np.linalg.norm(q - cl["center"])
                ) + 1.0)
        if not cl["members"]:
            radius = 10.0
        cl["radius"] = min(radius, 20.0)
        cl["signalized"] = len(headings) >= 2 or cl.get(
            "force_signalized", False
        )

    # 3. snap arc endpoints onto runs, record cut points
    def snap_to_run(p: np.ndarray, yaw: float) -> np.ndarray:
        for flip in (1.0,):
            del flip
            run = match_run(p, yaw)
            if run is not None:
                s = run.proj(p)
                for lo, hi in run.intervals:
                    if lo - 3.0 <= s <= hi + 3.0:
                        run.cuts.append(float(np.clip(s, lo, hi)))
                        return run.point(run.cuts[-1])
        return p

    snapped_arcs: List[_Piece] = []
    for piece in arcs.values():
        e = snap_to_run(piece.pts[0], piece.yaw_in)
        x = snap_to_run(piece.pts[-1], piece.yaw_out)
        pts = _sample_arc(e, piece.yaw_in, x, piece.yaw_out)
        snapped_arcs.append(dataclasses.replace(piece, pts=pts))

    # 4. signalized-junction crossings on runs + light synthesis
    lights: List[TrafficLightFixture] = []
    half = lane_width / 2.0

    def add_light(p: np.ndarray, yaw: float, junction_id: int,
                  principal: float):
        rgt = np.array([-math.sin(yaw), math.cos(yaw)])
        rel = abs(math.cos(yaw - principal))
        group = 0 if rel > math.cos(math.pi / 4) else 1
        for t in lights:
            if t.junction == junction_id and np.linalg.norm(
                0.5 * (t.stop_a + t.stop_b) - p
            ) < 4.0 and abs(_wrap(t.yaw - yaw)) < 0.6:
                return
        lights.append(TrafficLightFixture(
            stop_a=p - rgt * half * 1.2, stop_b=p + rgt * half * 1.2,
            yaw=yaw, junction=junction_id, group=group,
        ))

    for jid, cl in enumerate(clusters):
        principal = (
            cl["members"][0].yaw_in if cl["members"] else None
        )
        if cl["signalized"]:
            # lights at every turning-arc entry
            for piece in snapped_arcs:
                if piece.corner is None:
                    continue
                if np.linalg.norm(
                    piece.corner - cl["center"]
                ) < cl["radius"]:
                    if principal is None:
                        principal = piece.yaw_in
                    add_light(piece.pts[0], piece.yaw_in, jid, principal)
        # straight-through crossings cut the runs for EVERY cluster
        # (connectivity); lights only at signalized ones
        for run in runs:
            lat = run.lateral(cl["center"])
            if lat >= cl["radius"]:
                continue
            s_c = run.proj(cl["center"])
            halfspan = math.sqrt(cl["radius"] ** 2 - lat ** 2)
            s_in, s_out = s_c - halfspan, s_c + halfspan
            for lo, hi in run.intervals:
                if s_in > lo + 2.0 and s_out < hi - 2.0:
                    run.cuts.extend([s_in, s_out])
                    run.junction_spans.append((s_in, s_out))
                    if cl["signalized"]:
                        yaw = math.atan2(run.d[1], run.d[0])
                        if principal is None:
                            principal = yaw
                        add_light(run.point(s_in), yaw, jid, principal)

    # 4b. junction completion: the evidence routes only exercise SOME of
    # each junction's legal (entry, exit) pairs, which leaves the directed
    # graph unable to plan arbitrary start->goal pairs (NoCrash/CoRL2017
    # routes are bare endpoint pairs — nocrash_env.py:57-59 plans them on
    # the OpenDRIVE map). Synthesize the missing connectors between every
    # observed entry and exit of each junction (no U-turns); the mask
    # repair pass afterwards pulls each synthesized arc into the true
    # junction polygon, so invented geometry cannot leave the road.
    extra_arcs: List[_Piece] = []
    for cl in clusters:
        entries: List[Tuple[np.ndarray, float, object]] = []
        exits: List[Tuple[np.ndarray, float, object]] = []
        for ai, piece in enumerate(snapped_arcs):
            if piece.corner is None or np.linalg.norm(
                piece.corner - cl["center"]
            ) >= cl["radius"]:
                continue
            entries.append((piece.pts[0], piece.yaw_in, ("arc", ai)))
            exits.append((piece.pts[-1], piece.yaw_out, ("arc", ai)))
        for ri, run in enumerate(runs):
            yaw = math.atan2(run.d[1], run.d[0])
            for si, (s_in, s_out) in enumerate(run.junction_spans):
                mid = run.point(0.5 * (s_in + s_out))
                if np.linalg.norm(mid - cl["center"]) < cl["radius"]:
                    entries.append((run.point(s_in), yaw, ("run", ri, si)))
                    exits.append((run.point(s_out), yaw, ("run", ri, si)))
            # dangling interval ends at this junction: a run that STOPS
            # at the junction is an approach (entry); one that STARTS
            # just past it is a departure (exit) — this is what stitches
            # one-way evidence stubs back into the network
            lat = run.lateral(cl["center"])
            if lat < cl["radius"] + 6.0:
                s_c = run.proj(cl["center"])
                halfspan = math.sqrt(
                    max(cl["radius"] ** 2 - lat ** 2, 0.0)
                )
                w_in = cl["radius"] + 14.0
                for li, (lo, hi) in enumerate(run.intervals):
                    # run STOPS at/inside the junction: entry where it
                    # crosses the junction circle (cut the lane there so
                    # the connector lands on a graph node)
                    if s_c - w_in <= hi <= s_c + cl["radius"]:
                        s_e = min(hi, s_c - halfspan)
                        if s_e >= lo:
                            run.cuts.append(float(s_e))
                            entries.append(
                                (run.point(s_e), yaw, ("rend", ri, li))
                            )
                    # run STARTS at/inside the junction: exit where it
                    # leaves the circle — NOT at its raw tip, which can
                    # sit behind every entry heading (mask-extended lane
                    # tips reach past the junction centre)
                    if s_c - cl["radius"] <= lo <= s_c + w_in:
                        s_x = max(lo, s_c + halfspan)
                        if s_x <= hi:
                            run.cuts.append(float(s_x))
                            exits.append(
                                (run.point(s_x), yaw, ("rstart", ri, li))
                            )

        def connected(pe, px):
            return any(
                np.linalg.norm(p.pts[0] - pe) < 2.0
                and np.linalg.norm(p.pts[-1] - px) < 2.0
                for p in snapped_arcs + extra_arcs
            )

        for pe, ye, tag_e in entries:
            fe = np.array([math.cos(ye), math.sin(ye)])
            for px_, yx, tag_x in exits:
                if tag_e == tag_x:
                    continue  # an arc/crossing already connects itself
                dyaw = _wrap(yx - ye)
                if abs(dyaw) > 2.2:
                    continue  # no U-turn connectors
                d = px_ - pe
                dist = float(np.linalg.norm(d))
                if dist < 1.0 or dist > 3.0 * cl["radius"]:
                    continue
                fx = np.array([math.cos(yx), math.sin(yx)])
                if d @ fe <= 0.2 * dist or d @ fx <= 0.2 * dist:
                    continue  # exit must lie ahead of the entry heading
                if connected(pe, px_):
                    continue
                opt = (
                    _turn_option(ye, yx) if abs(dyaw) > 0.35
                    else RoadOption.LANEFOLLOW
                )
                extra_arcs.append(_Piece(
                    _sample_arc(pe, ye, px_, yx), opt, True,
                    corner=cl["center"].copy(), yaw_in=ye, yaw_out=yx,
                ))
    snapped_arcs.extend(extra_arcs)

    # 4c. CHANGELANE edges (``global_route_planner.py:148-184`` adds a
    # lane-change edge at every waypoint whose lane marking permits one).
    # Two sources: (a) evidence blends from the route files
    # (lane_change_pieces) — cut their source/target runs so the blend
    # endpoints land on graph nodes; (b) synthesized connectors wherever
    # two same-direction runs sit about one lane width apart with
    # overlapping non-junction coverage — one connector pair per
    # ~anchor_gap m gives A* the same lane-change freedom at graph scale.
    lane_change_edges: List[_Piece] = list(lane_change_pieces.values())

    def cut_run_at(p: np.ndarray, yaw: float) -> Optional[np.ndarray]:
        """Cut the matching run at p's projection; returns the ON-RUN
        point (the graph node the caller should attach to)."""
        f = np.array([math.cos(yaw), math.sin(yaw)])
        for run in runs:
            if float(run.d @ f) < math.cos(3.0 * dir_tol):
                continue
            if run.lateral(p) > lat_tol:
                continue
            s = run.proj(p)
            if any(lo - 1.0 <= s <= hi + 1.0 for lo, hi in run.intervals):
                run.cuts.append(float(s))
                return run.point(s)
        return None

    for k, piece in enumerate(lane_change_edges):
        pa = cut_run_at(piece.pts[0], piece.yaw_in)
        pb = cut_run_at(piece.pts[-1], piece.yaw_out)
        if pa is not None and pb is not None:
            # rebuild the blend between the ON-RUN endpoints so the edge
            # lands exactly on the cut nodes
            lane_change_edges[k] = dataclasses.replace(
                piece, pts=_sample_arc(pa, piece.yaw_in, pb, piece.yaw_out)
            )

    def clear_of_junctions(run: _Run, a: float, b: float) -> bool:
        return not any(
            s - 4.0 <= b and e + 4.0 >= a
            for s, e in run.junction_spans
        )

    if geometry is not None:
        from gail_carla_tpu_torch.scene import mask_geo as _mg2

    anchor_gap, diag = 35.0, 16.0
    for i1, r1 in enumerate(runs):
        for r2 in runs[i1 + 1:]:
            if float(r1.d @ r2.d) < math.cos(3.0 * dir_tol):
                continue
            lat = r1.lateral(r2.o)
            if not 0.55 * lane_width <= lat <= 1.7 * lane_width:
                continue
            v = r2.o - r1.o
            to_right = (r1.d[0] * v[1] - r1.d[1] * v[0]) > 0
            yaw1 = math.atan2(r1.d[1], r1.d[0])
            yaw2 = math.atan2(r2.d[1], r2.d[0])
            for lo1, hi1 in r1.intervals:
                for lo2, hi2 in r2.intervals:
                    a2 = r1.proj(r2.point(lo2))
                    b2 = r1.proj(r2.point(hi2))
                    lo = max(lo1, min(a2, b2))
                    hi = min(hi1, max(a2, b2))
                    if hi - lo < anchor_gap:
                        continue
                    for s in np.arange(lo + 6.0, hi - 6.0 - diag,
                                       anchor_gap):
                        s2 = r2.proj(r1.point(s))
                        if not (clear_of_junctions(r1, s, s + diag)
                                and clear_of_junctions(
                                    r2, s2, s2 + diag)):
                            continue
                        if geometry is not None:
                            # the gap between the lanes must be road
                            # surface (rejects parallel SEPARATE roads,
                            # e.g. a service road beside a highway)
                            mids = 0.5 * (
                                r1.point(s + 0.5 * diag)
                                + r2.point(s2 + 0.5 * diag)
                            )[None, :]
                            _, sd_m, _ = _mg2.boundary_project(
                                geometry.bnd_ab, mids
                            )
                            if float(sd_m[0]) < 0.3:
                                continue
                        opt12 = (
                            RoadOption.CHANGELANERIGHT if to_right
                            else RoadOption.CHANGELANELEFT
                        )
                        opt21 = (
                            RoadOption.CHANGELANELEFT if to_right
                            else RoadOption.CHANGELANERIGHT
                        )
                        pa, pb = r1.point(s), r2.point(s2 + diag)
                        r1.cuts.append(float(s))
                        r2.cuts.append(float(s2 + diag))
                        lane_change_edges.append(_Piece(
                            _sample_arc(pa, yaw1, pb, yaw2), opt12,
                            False, yaw_in=yaw1, yaw_out=yaw2,
                        ))
                        qa, qb = r2.point(s2), r1.point(s + diag)
                        r2.cuts.append(float(s2))
                        r1.cuts.append(float(s + diag))
                        lane_change_edges.append(_Piece(
                            _sample_arc(qa, yaw2, qb, yaw1), opt21,
                            False, yaw_in=yaw2, yaw_out=yaw1,
                        ))

    # 5. assemble edges
    snap = _NodeSnap()
    edges: List[LaneEdge] = []

    def add_edge(pts: np.ndarray, option: RoadOption, is_junction: bool):
        if len(pts) < 2 or np.linalg.norm(pts[-1] - pts[0]) < 0.5:
            return
        src = snap.get(pts[0])
        dst = snap.get(pts[-1])
        if src == dst:
            return
        edges.append(LaneEdge(src, dst, pts, option, is_junction))

    for run in runs:
        for lo, hi in run.intervals:
            cuts = sorted(
                {lo, hi, *(c for c in run.cuts if lo < c < hi)}
            )
            for a, b in zip(cuts[:-1], cuts[1:]):
                if b - a < 0.5:
                    continue
                mid = 0.5 * (a + b)
                in_junction = any(
                    s - 0.5 <= mid <= e + 0.5
                    for s, e in run.junction_spans
                )
                add_edge(
                    _sample_line(run.point(a), run.point(b)),
                    RoadOption.LANEFOLLOW, in_junction,
                )
    for piece in curves.values():
        add_edge(piece.pts, RoadOption.LANEFOLLOW, False)
    for piece in snapped_arcs:
        add_edge(piece.pts, piece.option, True)
    for piece in lane_change_edges:
        add_edge(piece.pts, piece.option, False)

    adjacency: Dict[int, List[int]] = {}
    for k, e in enumerate(edges):
        adjacency.setdefault(e.src, []).append(k)

    # --- signal phase-coherence post-pass (geometry untouched) ---
    # The greedy 15-m corner clustering fragments large junctions
    # (Town03+) into several junction ids with INDEPENDENT phases, so one
    # crossing can legally cross 2-3 foreign red stop lines back to back;
    # crossing-derived phantom clusters also duplicate real lights at
    # identical poses. Union junction ids whose lights sit within one
    # junction's extent, drop the duplicates, and re-derive phase groups
    # against the merged junction's principal axis (the real map gives one
    # controller per junction — traffic_light.py:79-111).
    if lights:
        centers = np.array([0.5 * (t.stop_a + t.stop_b) for t in lights])
        jids = [t.junction for t in lights]
        parent = {j: j for j in set(jids)}

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i in range(len(lights)):
            for k in range(i + 1, len(lights)):
                if jids[i] != jids[k] and float(np.linalg.norm(
                    centers[i] - centers[k]
                )) < 20.0:
                    a, b = find(jids[i]), find(jids[k])
                    if a != b:
                        parent[max(a, b)] = min(a, b)
        deduped: List[TrafficLightFixture] = []
        principal: Dict[int, float] = {}
        for i, t in enumerate(lights):
            j = find(t.junction)
            if any(
                m.junction == j and float(np.linalg.norm(
                    0.5 * (m.stop_a + m.stop_b) - centers[i]
                )) < 4.0 and abs(_wrap(m.yaw - t.yaw)) < 0.6
                for m in deduped
            ):
                continue
            p = principal.setdefault(j, t.yaw)
            group = (
                0 if abs(math.cos(t.yaw - p)) > math.cos(math.pi / 4)
                else 1
            )
            deduped.append(
                dataclasses.replace(t, junction=j, group=group)
            )
        lights = deduped

    return LaneGraph(
        nodes=np.array(snap.nodes).reshape(-1, 2),
        edges=edges,
        adjacency=adjacency,
        traffic_lights=lights,
        stop_signs=[],
        lane_width=lane_width,
    )


# ---------------------------------------------------------------------------
# Mask-guided repair (H5 road layer as geometry ground truth)
# ---------------------------------------------------------------------------

def repair_polyline(
    xy: np.ndarray, geometry, clearance: float = 1.0,
    smooth_passes: int = 2,
) -> np.ndarray:
    """Pull polyline points that are outside (or within ``clearance`` m of
    the edge of) the ground-truth road mask back to ``clearance`` m inside,
    then locally smooth the moved spans. Points already deeper than
    ``clearance`` (true lane centres sit ~1.75 m in) are untouched."""
    from gail_carla_tpu_torch.scene import mask_geo

    xy = np.asarray(xy, np.float64)
    closest, sd, inward = mask_geo.boundary_project(geometry.bnd_ab, xy)
    bad = sd < clearance
    if not bad.any():
        return xy
    out = xy.copy()
    out[bad] = closest[bad] + inward[bad] * clearance
    # neighbour-average smoothing over moved points only (keeps anchors)
    for _ in range(smooth_passes):
        if len(out) < 3:
            break
        sm = out.copy()
        sm[1:-1] = 0.25 * out[:-2] + 0.5 * out[1:-1] + 0.25 * out[2:]
        out[bad] = sm[bad]
    return out


def repair_graph_to_mask(graph: LaneGraph, geometry,
                         clearance: float = 1.0) -> LaneGraph:
    """Repair every edge polyline of a reconstructed lane graph against the
    H5 road mask (see ``repair_polyline``). Node positions are preserved
    when still valid so graph connectivity is untouched."""
    new_edges = []
    for e in graph.edges:
        pts = repair_polyline(e.pts, geometry, clearance)
        new_edges.append(dataclasses.replace(e, pts=pts))
    return LaneGraph(
        nodes=graph.nodes, edges=new_edges, adjacency=graph.adjacency,
        traffic_lights=graph.traffic_lights, stop_signs=graph.stop_signs,
        lane_width=graph.lane_width,
    )


def smooth_dense_route(
    dense: DenseRoute, geometry=None, min_radius: float = 4.6,
    span: float = 6.0, max_passes: int = 3,
    score_ab: Optional[np.ndarray] = None, score_floor: float = 0.0,
    respice_below: float = -2.5,
) -> DenseRoute:
    """Replace every over-curvature corner of a dense route with a
    bounded-curvature Dubins splice (scene/town.py::_sample_uturn — CSC/CCC
    words at ``min_radius``).

    Dense routes are assembled from several sources (posed-leg blends,
    evidence-graph A* slices, mask-planned splices); their seams can leave
    kinks the hero vehicle cannot steer (min turning radius ~4.2 m,
    sim/dynamics.py:46-48), and the graph contains turnaround connectors
    that retrace a lane (a 180-degree point reversal — CARLA's median
    U-turns). Either way the fix is the same: take the poses ``span``
    metres before and after the offending corner group and re-connect them
    with a Dubins path. With ``geometry`` the candidate words are scored
    by H5 road-mask adherence first (depth in 0.5 m buckets), length
    second, and spans deeper than ``respice_below`` off-mask also trigger
    a re-splice — drivability is guaranteed by construction, mask
    adherence is best-effort. ``score_ab``/``score_floor`` switch the
    scored boundary (e.g. the hard curb-to-wall surface with its
    clearance floor, for seams left by hard-surface splices). This
    mirrors what CARLA's planner gets for free from OpenDRIVE
    junction-connector geometry."""
    sab = score_ab
    if geometry is not None:
        from gail_carla_tpu_torch.scene import mask_geo

        if sab is None:
            sab = geometry.bnd_ab

    def pick(q0, y0, q1, y1):
        cands = _sample_uturn(q0, y0, q1, y1, radius=min_radius,
                              candidates=True)
        if geometry is None:
            return min(cands, key=lambda lp: lp[0])[1]

        def score(lp):
            ln, pts = lp
            sd = mask_geo.boundary_signed_distance(sab, pts)
            depth = max(0.0, score_floor - float(sd.min()))
            return (round(depth * 2.0) / 2.0, ln)

        return min(cands, key=score)[1]

    xy, cmd = dense.xy, dense.cmd
    for _ in range(max_passes):
        seg = np.diff(xy, axis=0)
        ln = np.linalg.norm(seg, axis=1)
        good = ln > 1e-6
        gidx = np.nonzero(good)[0]
        if len(gidx) < 3:
            break
        hdg = np.arctan2(seg[gidx][:, 1], seg[gidx][:, 0])
        turn = np.abs(np.vectorize(_wrap)(np.diff(hdg)))
        bad = gidx[1:][turn > 0.7]      # corner point index into xy
        if geometry is not None:
            sd_all = mask_geo.boundary_signed_distance(sab, xy)
            deep = np.nonzero(sd_all < respice_below)[0]
            deep = deep[(deep > 2) & (deep < len(xy) - 3)]
            bad = np.unique(np.concatenate([bad, deep]))
        if len(bad) == 0:
            break
        # group nearby corners, splice back-to-front to keep indices valid
        s = np.concatenate([[0.0], np.cumsum(ln)])
        groups: List[Tuple[int, int]] = []
        for b in bad:
            if groups and s[b] - s[groups[-1][1]] < 2.0 * span:
                groups[-1] = (groups[-1][0], int(b))
            else:
                groups.append((int(b), int(b)))
        for b0, b1 in reversed(groups):
            i0 = int(np.searchsorted(s, s[b0] - span))
            i1 = int(np.searchsorted(s, s[b1] + span))
            i0 = max(0, min(i0, len(xy) - 2))
            i1 = max(i0 + 1, min(i1, len(xy) - 1))
            yaw0 = math.atan2(*(xy[min(i0 + 1, len(xy) - 1)]
                                - xy[i0])[::-1])
            yaw1 = math.atan2(*(xy[i1] - xy[max(i1 - 1, 0)])[::-1])
            new = pick(xy[i0], yaw0, xy[i1], yaw1)
            fill = np.full(len(new), int(cmd[(b0 + b1) // 2]), np.int32)
            xy = np.concatenate([xy[:i0], new, xy[i1 + 1:]], axis=0)
            cmd = np.concatenate([cmd[:i0], fill, cmd[i1 + 1:]])
        keep = np.ones(len(xy), dtype=bool)
        keep[1:] = np.linalg.norm(np.diff(xy, axis=0), axis=1) > 1e-6
        xy, cmd = xy[keep], cmd[keep]
    d = np.diff(xy, axis=0)
    yaw_seg = np.arctan2(d[:, 1], d[:, 0])
    yaw = (np.concatenate([yaw_seg, yaw_seg[-1:]])
           if len(yaw_seg) else np.zeros(1))
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
    plan_idx = _downsample(xy, cmd, sample_factor=50.0)
    return DenseRoute(
        xy=xy, yaw=yaw, cmd=cmd, s=s,
        plan_xy=xy[plan_idx], plan_cmd=cmd[plan_idx],
    )


def repair_dense_route(dense: DenseRoute, geometry,
                       clearance: float = 1.0) -> DenseRoute:
    """Repair a task's dense route polyline and recompute the derived
    yaw / arc-length / downsampled-plan arrays."""
    xy = repair_polyline(dense.xy, geometry, clearance)
    d = np.diff(xy, axis=0)
    yaw_seg = np.arctan2(d[:, 1], d[:, 0])
    yaw = (
        np.concatenate([yaw_seg, yaw_seg[-1:]])
        if len(yaw_seg) else np.zeros(1)
    )
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
    plan_idx = _downsample(xy, dense.cmd, sample_factor=50.0)
    return DenseRoute(
        xy=xy, yaw=yaw, cmd=dense.cmd, s=s,
        plan_xy=xy[plan_idx], plan_cmd=dense.cmd[plan_idx],
    )


def splice_offroad_spans(
    dense: DenseRoute, geometry, mask: np.ndarray, mask_off: np.ndarray,
    depth: float = 3.0, clearance: float = 1.0,
) -> DenseRoute:
    """Replace every deep off-road excursion of a dense route with an A*
    path planned directly on the H5 ``road`` mask (``plan_on_mask``).

    Last-resort repair for Town03+ legs where neither endpoint-pose
    reconstruction (``densify_leg``) nor the evidence lane graph covers the
    ground the route actually drives (the reference pulls this geometry
    from the OpenDRIVE map, ``global_route_planner.py:26-63``). Spans where
    the mask planner finds no connection are left untouched."""
    from gail_carla_tpu_torch.scene import mask_geo
    from gail_carla_tpu_torch.scene.h5_maps import PPM

    xy, cmd = dense.xy, dense.cmd
    sd = mask_geo.boundary_signed_distance(geometry.bnd_ab, xy)
    bad = sd < -depth
    if not bad.any():
        return dense

    # widen each bad region to safe on-road anchors, merge near regions
    regions = []
    i = 0
    n = len(xy)
    while i < n:
        if not bad[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and bad[j + 1]:
            j += 1
        ia = i
        while ia > 0 and sd[ia] < clearance:
            ia -= 1
        ib = j
        while ib < n - 1 and sd[ib] < clearance:
            ib += 1
        if regions and ia <= regions[-1][1] + 10:
            regions[-1][1] = ib
        else:
            regions.append([ia, ib])
        i = j + 1

    pieces_xy, pieces_cmd = [], []
    pos = 0
    for ia, ib in regions:
        path = mask_geo.plan_on_mask(
            mask, mask_off, PPM, xy[ia], xy[ib]
        )
        if path is None:
            continue
        pieces_xy.append(xy[pos:ia + 1])
        pieces_cmd.append(cmd[pos:ia + 1])
        pieces_xy.append(path[1:-1])
        pieces_cmd.append(
            np.full(max(len(path) - 2, 0), int(RoadOption.LANEFOLLOW),
                    cmd.dtype)
        )
        pos = ib
    pieces_xy.append(xy[pos:])
    pieces_cmd.append(cmd[pos:])
    xy = np.concatenate(pieces_xy, axis=0)
    cmd = np.concatenate(pieces_cmd, axis=0)
    keep = np.ones(len(xy), dtype=bool)
    keep[1:] = np.linalg.norm(np.diff(xy, axis=0), axis=1) > 1e-6
    xy, cmd = xy[keep], cmd[keep]

    d = np.diff(xy, axis=0)
    yaw_seg = np.arctan2(d[:, 1], d[:, 0])
    yaw = (
        np.concatenate([yaw_seg, yaw_seg[-1:]])
        if len(yaw_seg) else np.zeros(1)
    )
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
    plan_idx = _downsample(xy, cmd, sample_factor=50.0)
    return repair_dense_route(
        DenseRoute(xy=xy, yaw=yaw, cmd=cmd, s=s,
                   plan_xy=xy[plan_idx], plan_cmd=cmd[plan_idx]),
        geometry,
    )


def _dense_from_xy(xy: np.ndarray, cmd: np.ndarray) -> DenseRoute:
    """Rebuild a DenseRoute's derived arrays (yaw / arc-length / plan)
    from repaired xy + aligned per-point commands."""
    keep = np.ones(len(xy), dtype=bool)
    keep[1:] = np.linalg.norm(np.diff(xy, axis=0), axis=1) > 1e-6
    xy, cmd = xy[keep], cmd[keep]
    d = np.diff(xy, axis=0)
    yaw_seg = np.arctan2(d[:, 1], d[:, 0])
    yaw = (np.concatenate([yaw_seg, yaw_seg[-1:]])
           if len(yaw_seg) else np.zeros(1))
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
    plan_idx = _downsample(xy, cmd, sample_factor=50.0)
    return DenseRoute(
        xy=xy, yaw=yaw, cmd=cmd, s=s,
        plan_xy=xy[plan_idx], plan_cmd=cmd[plan_idx],
    )


def _hard_regions(sd: np.ndarray, clearance: float, n: int, pad: int):
    """Group indices with sd < clearance into padded [ia, ib] regions."""
    regions: List[List[int]] = []
    bad = sd < clearance
    i = 0
    while i < n:
        if not bad[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and bad[j + 1]:
            j += 1
        # deep violations need a long lever arm: pulling a span D m
        # sideways across a pad-long seam of ~1 m points turns the heading
        # by atan(D/pad) — keep that under the steering envelope
        depth = float(clearance - sd[i:j + 1].min())
        p = max(pad, int(3.0 * depth))
        ia, ib = max(0, i - p), min(n - 1, j + p)
        if regions and ia <= regions[-1][1] + pad:
            regions[-1][1] = max(regions[-1][1], ib)
        else:
            regions.append([ia, ib])
        i = j + 1
    return regions


def refine_dense_route(
    dense: DenseRoute, geometry, clearance: float = 0.75, pad: int = 12,
    town: Optional[str] = None,
) -> DenseRoute:
    """Final drivability stage: pull every span of a dense route off the
    HARD (curb-to-wall) surface boundary — the geometry
    ``sim/collisions.py::static_collision`` tests, beyond which CARLA's
    buildings/fences/poles produce real collision events
    (``criteria/collision.py:49-112``) — without breaking the route's
    other invariants (on-road within tolerance, steering-envelope
    curvature).

    Three sub-stages, matched to violation depth:

    1. DEEP excursions (route crosses walls/terrain the hard union never
       covers) are re-planned with A* on the ERODED hard mask intersected
       with a road dilation (``h5_maps.hard_plan_mask``) — clearance and
       road containment by construction; elastic deformation cannot fix a
       7 m excursion without printing zigzags (the round-3 failure: the
       hard-projection band put 89-178 deg kinks, collapsed duplicates
       and 14 m jumps into 16/20 Town03 routes).
    2. Seam kinks left by those splices get the Dubins pass
       (``smooth_dense_route``) scored against the HARD boundary.
    3. Residual shallow grazes get the coherent elastic band
       (``mask_geo.refine_polyline_inside``): sub-metre moves are where
       local deformation is the right tool.

    Every repaired span is ACCEPTED only when a violation score — hard
    clearance below the layout-collision threshold, kinks, off-road
    depth — does not get worse; otherwise the input span is kept. The
    three sub-stages repeat (up to 3 outer passes) until the route is
    violation-free or stops improving: the Dubins seam pass can re-graze
    a boundary the next band pass then polishes, and vice versa."""
    from gail_carla_tpu_torch.scene import mask_geo
    from gail_carla_tpu_torch.scene.h5_maps import PPM, hard_plan_mask

    edges = getattr(geometry, "hard_ab", None)
    if edges is None or not len(edges):
        edges = geometry.bnd_ab
    road = geometry.bnd_ab
    xy = np.asarray(dense.xy, np.float64)
    cmd = np.asarray(dense.cmd)
    sd = mask_geo.boundary_signed_distance(edges, xy)
    if not (sd < clearance).any():
        return dense

    # planning masks: normal = deep erosion (planned paths keep real
    # clearance even at 1 m-cell edges) within road slack; fallback =
    # eroded union only, for spans whose legal detour (a median-gap
    # crossing rerouted through the junction where the median ends) needs
    # ground the road dilation doesn't cover
    # planning-mask fallback chain: deep erosion within road slack first
    # (planned paths keep real clearance even at 1 m-cell edges), then
    # without the road constraint (legal detours through junction gaps),
    # then SHALLOW erosion — for corridors so narrow that the deep-eroded
    # mask disconnects (a 2 m hard strip vanishes at 1.0 m erosion; a
    # 0.5 m erosion still yields the ~0.4+ clearance the layout-collision
    # threshold needs)
    if town:
        chain = (
            (hard_plan_mask(town, clearance_m=1.0), 80.0),
            (hard_plan_mask(town, clearance_m=1.0), 200.0),
            (hard_plan_mask(town, clearance_m=1.0, road_slack_m=1e9),
             200.0),
            (hard_plan_mask(town, clearance_m=0.5), 200.0),
            (hard_plan_mask(town, clearance_m=0.5, road_slack_m=1e9),
             200.0),
        )
    else:
        chain = ()

    def _crop(e, p, margin=25.0):
        lo = p.min(axis=0) - margin
        hi = p.max(axis=0) + margin
        sel = ((np.maximum(e[:, 0], e[:, 2]) >= lo[0])
               & (np.minimum(e[:, 0], e[:, 2]) <= hi[0])
               & (np.maximum(e[:, 1], e[:, 3]) >= lo[1])
               & (np.minimum(e[:, 1], e[:, 3]) <= hi[1]))
        return e[sel] if sel.any() else e

    # VehicleParams half extents + 0.3 m expert-tracking margin — the
    # pose criterion mirrors sim/collisions.py::static_collision: a
    # layout collision needs ALL FOUR corners off the hard union, so a
    # pose is safe while its BEST corner stays inside
    HL, HW = 2.7, 1.3

    def _pose_min(p: np.ndarray) -> float:
        if len(p) < 3:
            return 10.0
        d = np.gradient(p, axis=0)
        yaw = np.arctan2(d[:, 1], d[:, 0])
        fw = np.stack([np.cos(yaw), np.sin(yaw)], 1)
        lt = np.stack([-np.sin(yaw), np.cos(yaw)], 1)
        corners = np.concatenate(
            [p + a * HL * fw + b * HW * lt
             for a in (1, -1) for b in (1, -1)], axis=0,
        )
        sd_c = mask_geo.boundary_signed_distance(
            _crop(edges, p, margin=30.0), corners
        ).reshape(4, len(p))
        return float(sd_c.max(axis=0).min())

    def violation(p: np.ndarray) -> float:
        """How badly a span breaks the route invariants the town gates
        assert (no layout-collision pose, depth bound 2 m, off-road
        < 3 m, kink < 45 deg), each with margin. Lower is better; 0 =
        clean. The hard term is POSE-based (best corner of the inflated
        body), matching the sim's collision criterion — a per-point
        clearance floor over-valued narrow-median crossings the body
        legally bridges, which made the scorer reject real repairs in
        favour of harmless voids."""
        sdh = mask_geo.boundary_signed_distance(_crop(edges, p), p)
        sdr = mask_geo.boundary_signed_distance(_crop(road, p), p)
        seg = np.diff(p, axis=0)
        ln = np.linalg.norm(seg, axis=1)
        g = ln > 1e-6
        v = 0.0
        if g.sum() >= 2:
            hdg = np.arctan2(seg[g][:, 1], seg[g][:, 0])
            turn = np.degrees(np.abs(
                (np.diff(hdg) + np.pi) % (2 * np.pi) - np.pi))
            v += 0.25 * max(0.0, float(turn.max()) - 40.0)
        v += 10.0 * max(0.0, 0.8 - _pose_min(p))
        v += 5.0 * max(0.0, -1.5 - float(sdh.min()))
        v += 2.0 * max(0.0, -2.0 - float(sdr.min()))
        # past -2.6 m the off-road gate itself (-3.0) is at risk: no hard
        # clearance gain may buy that (a splice once traded road -2.2 ->
        # -3.6 for a 0.6 m hard win and broke the road gate)
        v += 25.0 * max(0.0, -2.6 - float(sdr.min()))
        return v

    def _splice_deep(xy, cmd, sd):
        """Splice each excursion region independently, BACK TO FRONT so
        earlier indices stay valid. Each candidate window is locally
        Dubins-smoothed BEFORE scoring (a raw splice meets the route at a
        seam kink that is always repairable — pricing it into acceptance
        rejected clean repairs), then accepted only when the window's
        violation improves, so one unplannable region cannot poison the
        others."""
        n = len(xy)
        regions = []
        for ia, ib in _hard_regions(sd, clearance, n, pad):
            span = xy[max(0, ia - 3):min(n, ib + 4)]
            if (float(sd[ia:ib + 1].min()) >= -1.5
                    and _pose_min(span) >= 0.8):
                # body-bridgeable with comfortable margin — legal, skip.
                # (0.8: the expert tracks sharp median-crossing turns with
                # up to ~0.5-1 m error beyond the 0.3 m corner inflation —
                # marginal 0.1-0.3 poses measured real collisions)
                continue
            while ia > 0 and sd[ia] < clearance + 0.15:
                ia -= 1
            while ib < n - 1 and sd[ib] < clearance + 0.15:
                ib += 1
            if regions and ia <= regions[-1][1]:
                regions[-1][1] = max(regions[-1][1], ib)
            else:
                regions.append([ia, ib])
        for ia, ib in reversed(regions):
            path = None
            for mask, margin in chain:
                if mask is None:
                    continue
                path = mask_geo.plan_on_mask(
                    mask[0], mask[1], PPM, xy[ia], xy[ib], margin_m=margin
                )
                if path is not None:
                    break
            if path is None:
                continue
            lo, hi = max(0, ia - 20), min(n, ib + 21)
            before = xy[lo:hi]
            cand = np.concatenate(
                [xy[lo:ia + 1], path[1:-1], xy[ib:hi]], axis=0
            )
            dummy = np.full(len(cand), int(cmd[(ia + ib) // 2]), cmd.dtype)
            dr = smooth_dense_route(
                _dense_from_xy(cand, dummy), geometry,
                score_ab=edges, score_floor=0.45, respice_below=-1.5,
            )
            cs = np.asarray(dr.xy, np.float64)
            if (np.linalg.norm(cs[0] - cand[0]) > 1e-6
                    or np.linalg.norm(cs[-1] - cand[-1]) > 1e-6):
                cs = cand            # smoothing moved the window ends
            if violation(cs) <= violation(before):
                # keep the untouched window ends' real commands (they can
                # carry turn/lane options near junctions) and fill only
                # the new mid-region points with the mid command
                n_pre, n_suf = ia - lo + 1, hi - ib
                n_mid = len(cs) - n_pre - n_suf
                if n_mid >= 0:
                    win_cmd = np.concatenate([
                        cmd[lo:ia + 1],
                        np.full(n_mid, int(cmd[(ia + ib) // 2]), cmd.dtype),
                        cmd[ib:hi],
                    ])
                else:        # smoothing shrank past the preserved ends
                    win_cmd = np.full(
                        len(cs), int(cmd[(ia + ib) // 2]), cmd.dtype
                    )
                xy = np.concatenate([xy[:lo], cs, xy[hi:]], axis=0)
                cmd = np.concatenate([cmd[:lo], win_cmd, cmd[hi:]])
                n = len(xy)
        return xy, cmd

    # outer fixed point, whole-route gated as a final safety net; all
    # stage-level decisions are already locally gated on the same
    # pose-based violation score the town gates assert
    best = (xy.copy(), cmd.copy())
    best_viol = violation(xy)
    for p in range(3):
        if best_viol == 0.0:
            break
        # -- stage 1: splice collision-risk excursions on eroded masks
        xy, cmd = _splice_deep(xy, cmd, sd)

        # -- stage 2: Dubins-smooth seams, scored on the hard boundary
        # (whole-route gated: its re-splices are not individually gated
        # and once traded road -2.2 -> -3.6 for a hard win)
        dr = smooth_dense_route(
            _dense_from_xy(xy, cmd), geometry,
            score_ab=edges, score_floor=0.45, respice_below=-1.5,
        )
        sm_xy = np.asarray(dr.xy, np.float64)
        sm_cmd = np.asarray(dr.cmd)
        if violation(sm_xy) <= violation(xy):
            xy, cmd = sm_xy, sm_cmd

        # -- stage 3: coherent elastic band for residual shallow grazes
        sd = mask_geo.boundary_signed_distance(edges, xy)
        out = xy.copy()
        for ia, ib in _hard_regions(sd, clearance, len(xy), pad):
            orig = out[ia:ib + 1]
            ref = mask_geo.refine_polyline_inside(
                edges, orig, clearance=clearance,
                contain_edges=road, contain_slack=2.0,
            )
            if violation(ref) <= violation(orig):
                out[ia:ib + 1] = ref
        xy = out
        cur_viol = violation(xy)
        if cur_viol < best_viol:
            best = (xy.copy(), cmd.copy())
            best_viol = cur_viol
        else:
            xy, cmd = best[0].copy(), best[1].copy()
            break            # passes are deterministic — no progress
        sd = mask_geo.boundary_signed_distance(edges, xy)
    return _dense_from_xy(*best)


# ---------------------------------------------------------------------------
# Scene assembly
# ---------------------------------------------------------------------------

# in-process cache of the CPU scenes, by the disk cache's key
_TOWN_SCENE_CACHE: Dict[str, object] = {}

_DISK_CACHE_DIR = os.path.join(os.path.dirname(__file__), os.pardir,
                               os.pardir, ".scene_cache")


def _scene_cache_path(key: Tuple) -> str:
    """Town scenes are pure functions of (args, scene code, route data,
    mask pack); reconstruction + mask repair costs ~10 CPU-minutes per
    real town, so completed scenes are memoized to disk. The key folds in
    the mtimes of every module in gail_carla_tpu_torch/scene, so any
    geometry-code edit invalidates it; the files have their own prefix."""
    import hashlib

    scene_dir = os.path.dirname(__file__)
    stamp = sorted(
        (f, os.path.getmtime(os.path.join(scene_dir, f)))
        for f in os.listdir(scene_dir) if f.endswith(".py")
    )
    h = hashlib.sha256(repr((key, stamp)).encode()).hexdigest()[:24]
    return os.path.join(_DISK_CACHE_DIR, f"torch_scene_{h}.pt")


def _scene_cache_load(path: str):
    """The CPU ``TorchScene`` stored at ``path``, or None when there is
    none or the file cannot be read (a miss)."""
    import pickle

    import torch

    from gail_carla_tpu_torch.scene.scene import TorchScene

    if not os.path.exists(path):
        return None
    try:
        fields = torch.load(path, map_location="cpu", weights_only=True)
        return TorchScene(**fields)
    except (OSError, EOFError, RuntimeError, TypeError,
            pickle.UnpicklingError):
        return None


def _scene_cache_save(path: str, scene) -> None:
    """Store a CPU scene's fields (host tensors and numbers) at ``path``,
    written then renamed so a reader never sees half a file."""
    import torch

    os.makedirs(_DISK_CACHE_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({f.name: getattr(scene, f.name)
                for f in dataclasses.fields(scene)}, tmp)
    os.replace(tmp, path)


def _build_town_scene(town, route_file, root, route_pts_pad, n_patrols):
    """The CPU ``TorchScene`` of ``make_town_scene`` (no cache)."""
    import sys

    from gail_carla_tpu_torch.scene import mask_geo
    from gail_carla_tpu_torch.scene.scene import build_scene
    from gail_carla_tpu_torch.scene.trace import trace_route

    bench = benchmark_routes(town, route_file, root)
    if not bench:
        raise ValueError(f"no {town} routes in {route_file}")
    evidence = collect_town_routes(town, root)
    geometry = h5_maps.load_town_geometry(town)
    graph = build_town_graph(
        evidence, geometry=geometry,
        # flat grid towns: every 2D lane crossing is a real junction;
        # Town03-06 have grade separation so crossings stay off there
        crossing_junctions=town in ("Town01", "Town02"),
    )
    if geometry is not None:
        graph = repair_graph_to_mask(graph, geometry)
    dense, kept = [], []
    for r in bench:
        if len(r.waypoints) >= 4:
            dense.append(densify_route_hybrid(r.waypoints, graph, geometry))
            kept.append(r)
            continue
        try:
            dense.append(trace_route(graph, r.waypoints, use_yaw=True))
            kept.append(r)
        except RuntimeError:
            print(
                f"make_town_scene: dropped unplannable route "
                f"{r.route_id} of {route_file} ({town})",
                file=sys.stderr,
            )
    bench = [
        dataclasses.replace(r, route_id=i) for i, r in enumerate(kept)
    ]
    if geometry is not None:

        def depth_of(xy) -> float:
            sd = mask_geo.boundary_signed_distance(geometry.bnd_ab, xy)
            return max(0.0, -float(sd.min()))

        def fix_route(r, d0):
            """Full repair pipeline for one dense route: project to
            mask -> whole-route graph re-plan if still deep -> plan bad
            spans on the road mask -> Dubins drivability pass."""
            dr = repair_dense_route(d0, geometry)
            if depth_of(dr.xy) > 3.0 and len(r.waypoints) >= 4:
                # a still-deep off-road span means the leg reconstruction
                # cut across ground the road never covers; re-plan the
                # whole route through the evidence lane graph instead,
                # like the bare start/goal packs
                try:
                    dr2 = repair_dense_route(
                        trace_route(graph, r.waypoints, use_yaw=True),
                        geometry,
                    )
                    if depth_of(dr2.xy) < depth_of(dr.xy):
                        dr = dr2
                except RuntimeError:
                    pass
                # still deep off-road: plan the bad spans directly on the
                # H5 road mask
                if depth_of(dr.xy) > 3.0:
                    rm = h5_maps.road_mask(town)
                    if rm is not None:
                        dr = splice_offroad_spans(dr, geometry, rm[0],
                                                  rm[1])
            # penultimate pass: splice out seam kinks, graph turnaround
            # reversals and residual off-road spans with mask-scored
            # Dubins paths; then the three-stage hard-surface repair
            return refine_dense_route(
                smooth_dense_route(dr, geometry), geometry, town=town
            )

        fixed = []
        for r, d0 in zip(bench, dense):
            dr = fix_route(r, d0)
            if depth_of(dr.xy) > 3.0 and len(r.waypoints) >= 4:
                # the hybrid (graph-legged) variant ended badly: run the
                # same pipeline on the pure posed-leg reconstruction and
                # keep whichever ends shallower
                alt = fix_route(r, densify_route(r.waypoints))
                if depth_of(alt.xy) < depth_of(dr.xy):
                    dr = alt
            if depth_of(dr.xy) > 3.0:
                print(
                    f"make_town_scene: route {r.route_id} "
                    f"keeps an off-road span "
                    f"(depth {depth_of(dr.xy):.1f} m)",
                    file=sys.stderr,
                )
            fixed.append(dr)
        dense = fixed
    return build_scene(
        graph, bench, dense=dense, route_pts_pad=route_pts_pad,
        n_patrols=n_patrols, geometry=geometry,
    )


def make_town_scene(
    town: str = "Town01",
    route_file: str = "routes_training.xml",
    root: Optional[str] = None,
    route_pts_pad: int = 256,
    n_patrols: int = 32,
    device="cuda",
):
    """``TorchScene`` on ``device`` for a reconstructed reference town whose
    task routes are the ``town`` block of ``route_file`` (training: Town01
    routes 0-9, the reference's actual benchmark,
    ``leaderboard_env.py:7-97``).

    ``route_file`` is either a name under ``<root>/data/`` or a PATH to a
    scenario-description pack's ``routes.xml`` (NoCrash / CoRL2017,
    ``nocrash_env.py:57``). Multi-waypoint routes densify from their own
    legs; bare start/goal pairs (the NoCrash/CoRL2017 format) are PLANNED
    through the completed town graph with A* like the reference's
    GlobalRoutePlanner (``task_vehicle.py:84-93``); unplannable pairs are
    dropped with a warning. The CPU scene is cached per argument tuple and
    mask pack, in the process and on disk (``.scene_cache/``)."""
    dev = resolve_device(device)
    root = _root(root)
    key = (town, route_file, os.path.abspath(root), route_pts_pad,
           n_patrols, h5_maps.pack_stamp(town))
    cache_path = _scene_cache_path(key)
    scene = _TOWN_SCENE_CACHE.get(cache_path)
    if scene is None:
        scene = _scene_cache_load(cache_path)
        if scene is None:
            scene = _build_town_scene(town, route_file, root,
                                      route_pts_pad, n_patrols)
            _scene_cache_save(cache_path, scene)
        _TOWN_SCENE_CACHE[cache_path] = scene
    return scene.to(dev)
