# Frozen copy of gail_carla_tpu_torch/scene/town.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Host-side town model: a directed lane graph plus signal fixtures.

This is the TPU framework's replacement for the CARLA server's OpenDRIVE map
(waypoint queries, road topology — reference reaches it via
``world.get_map()``; the route graph is rebuilt from it in
``carla_gym/core/task_actor/common/navigation/global_route_planner.py:31-88``).
Everything here is offline/host-side numpy; the output is compiled into
padded jnp arrays by ``scene.scene.build_scene``.

Conventions: CARLA-style left-handed world viewed from above (x east,
y south), yaw in radians increasing clockwise (a RIGHT turn increases yaw).
Right-hand traffic: a lane is offset to the right of its driving direction.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Tuple

import numpy as np

from bench_port.plain_reference.frozen.scene.road_option import RoadOption

LANE_WIDTH = 3.5  # m, matches typical CARLA town lanes


@dataclasses.dataclass
class LaneEdge:
    """A directed lane segment: polyline sampled at ~1 m.

    ``mark_vals`` are the lane-marking mask values drawn at (-half, +half)
    lateral offsets (chauffeurnet.py:188-189 values: 120 broken white /
    255 solid); multi-lane roads set the inter-lane boundary broken."""

    src: int
    dst: int
    pts: np.ndarray            # (M, 2) float64, includes both endpoints
    option: RoadOption         # command while traversing this edge
    is_junction: bool
    mark_vals: Tuple[float, float] = (120.0, 255.0)

    @property
    def length(self) -> float:
        return float(
            np.sum(np.linalg.norm(np.diff(self.pts, axis=0), axis=1))
        )


@dataclasses.dataclass
class TrafficLightFixture:
    """One signal head controlling one junction entry.

    Counterpart of the static registry the reference builds per map
    (``carla_gym/utils/traffic_light.py:79-111``): a stop line (segment the
    vehicle must not cross on red) plus a junction id used for phase groups.
    """

    stop_a: np.ndarray      # (2,) stop-line endpoint
    stop_b: np.ndarray      # (2,)
    yaw: float              # heading of traffic passing the line
    junction: int           # junction index (lights in a junction share a controller)
    group: int              # 0 = NS axis, 1 = EW axis (phase alternation)


@dataclasses.dataclass
class StopSignFixture:
    """Stop-sign trigger volume (reference ``criteria/run_stop_sign.py``)."""

    center: np.ndarray      # (2,)
    yaw: float
    extent: np.ndarray      # (2,) half sizes


@dataclasses.dataclass
class LaneGraph:
    nodes: np.ndarray                      # (N, 2)
    edges: List[LaneEdge]
    adjacency: Dict[int, List[int]]        # node -> outgoing edge indices
    traffic_lights: List[TrafficLightFixture]
    stop_signs: List[StopSignFixture]
    lane_width: float = LANE_WIDTH

    def spawn_points(self, spacing: float = 30.0) -> np.ndarray:
        """(Q, 3) array of (x, y, yaw) on non-junction lanes, for traffic
        spawning (reference samples ``map.get_spawn_points()``,
        ``zombie_vehicle_handler.py:30-40``)."""
        out = []
        for e in self.edges:
            if e.is_junction:
                continue
            d = np.linalg.norm(np.diff(e.pts, axis=0), axis=1)
            s = np.concatenate([[0.0], np.cumsum(d)])
            for target in np.arange(spacing * 0.5, s[-1], spacing):
                i = int(np.searchsorted(s, target))
                i = min(max(i, 1), len(e.pts) - 1)
                p = e.pts[i]
                v = e.pts[i] - e.pts[i - 1]
                out.append([p[0], p[1], math.atan2(v[1], v[0])])
        return np.array(out, dtype=np.float64).reshape(-1, 3)


def _sample_line(a: np.ndarray, b: np.ndarray, step: float = 1.0) -> np.ndarray:
    n = max(int(math.ceil(np.linalg.norm(b - a) / step)), 1)
    t = np.linspace(0.0, 1.0, n + 1)[:, None]
    return a[None, :] * (1 - t) + b[None, :] * t


def _sample_arc(
    p0: np.ndarray, yaw0: float, p1: np.ndarray, yaw1: float, step: float = 1.0
) -> np.ndarray:
    """Cubic Hermite blend between two posed endpoints, sampled at ~step m.

    Used for junction connectors (the reference gets these as OpenDRIVE
    junction waypoint paths; we synthesize smooth ones)."""
    dist = np.linalg.norm(p1 - p0)
    scale = max(dist, 1e-3)
    m0 = np.array([math.cos(yaw0), math.sin(yaw0)]) * scale
    m1 = np.array([math.cos(yaw1), math.sin(yaw1)]) * scale
    n = max(int(math.ceil(dist * 1.6 / step)), 2)
    t = np.linspace(0.0, 1.0, n + 1)[:, None]
    h00 = 2 * t**3 - 3 * t**2 + 1
    h10 = t**3 - 2 * t**2 + t
    h01 = -2 * t**3 + 3 * t**2
    h11 = t**3 - t**2
    pts = h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1
    # Resample to ~uniform arc length.
    d = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    total = s[-1]
    m = max(int(round(total / step)), 2)
    s_new = np.linspace(0.0, total, m + 1)
    out = np.stack(
        [np.interp(s_new, s, pts[:, 0]), np.interp(s_new, s, pts[:, 1])], axis=1
    )
    return out


def _sample_uturn(
    p0: np.ndarray, yaw0: float, p1: np.ndarray, yaw1: float,
    radius: float = 4.6, step: float = 1.0, candidates: bool = False,
):
    """Drivable turnaround between two anti-parallel posed endpoints.

    CARLA median U-turns (Town03+ ``routes_training.xml`` has consecutive
    waypoints ~3.3 m apart with opposite headings) traverse the junction
    opening on a path the hero vehicle can actually steer — its minimum
    turning radius is wheelbase/tan(max_steer) ≈ 4.2 m
    (sim/dynamics.py:46-48), so a Hermite blend between the endpoint poses
    (a sub-metre hairpin) is untrackable at any speed. Build the shorter of
    the two same-side Dubins paths (LSL/RSR: arc — straight — arc) at
    ``radius``, the classic teardrop bulging into the junction area."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    r = radius
    two_pi = 2.0 * math.pi

    def nvec(yaw):
        return np.array([-math.sin(yaw), math.cos(yaw)])

    def word(s0, s1):
        """CSC Dubins word: arc (side s0) — straight — arc (side s1)."""
        c0 = p0 + r * s0 * nvec(yaw0)
        c1 = p1 + r * s1 * nvec(yaw1)
        D = c1 - c0
        d = float(np.linalg.norm(D))
        theta = math.atan2(D[1], D[0]) if d > 1e-9 else yaw0
        if s0 == s1:
            psi, straight = theta, d
        else:
            if d < 2.0 * r:
                return None
            psi = theta + s0 * math.asin(min(2.0 * r / d, 1.0))
            straight = math.sqrt(max(d * d - 4.0 * r * r, 0.0))
        phi0 = yaw0 - s0 * math.pi / 2.0
        phit0 = psi - s0 * math.pi / 2.0
        phit1 = psi - s1 * math.pi / 2.0
        phi1 = yaw1 - s1 * math.pi / 2.0

        def sweep(a, b, s):
            return (b - a) % two_pi if s > 0 else -((a - b) % two_pi)

        sw0 = sweep(phi0, phit0, s0)
        sw1 = sweep(phit1, phi1, s1)
        length = (abs(sw0) + abs(sw1)) * r + straight

        def arc(c, a, s):
            n = max(int(math.ceil(abs(s) * r / step)), 1)
            ang = a + np.linspace(0.0, s, n + 1)
            return c[None, :] + r * np.stack(
                [np.cos(ang), np.sin(ang)], axis=1
            )

        a0 = arc(c0, phi0, sw0)
        a1 = arc(c1, phit1, sw1)
        parts = [a0]
        if straight > step:
            parts.append(_sample_line(a0[-1], a1[0], step)[1:])
        parts.append(a1[1:])
        return length, np.concatenate(parts, axis=0)

    def word_ccc(s, bend):
        """CCC word (LRL/RLR): three mutually tangent arcs — the compact
        turnaround when the endpoint circles overlap (lateral offset
        < 2r, exactly the median-U-turn case)."""
        c0 = p0 + r * s * nvec(yaw0)
        c2 = p1 + r * s * nvec(yaw1)
        D = c2 - c0
        d = float(np.linalg.norm(D))
        if d > 4.0 * r - 1e-9:
            return None
        theta = math.atan2(D[1], D[0]) if d > 1e-9 else yaw0
        gamma = math.acos(d / (4.0 * r))
        c1 = c0 + 2.0 * r * np.array(
            [math.cos(theta + bend * gamma), math.sin(theta + bend * gamma)]
        )
        t0 = 0.5 * (c0 + c1)
        t1 = 0.5 * (c1 + c2)

        def ang(v):
            return math.atan2(v[1], v[0])

        def sweep(a, b, sg):
            return (b - a) % two_pi if sg > 0 else -((a - b) % two_pi)

        phi0 = yaw0 - s * math.pi / 2.0
        sw0 = sweep(phi0, ang(c1 - c0), s)
        swm = sweep(ang(c0 - c1), ang(c2 - c1), -s)
        sw2 = sweep(ang(c1 - c2), yaw1 - s * math.pi / 2.0, s)
        length = (abs(sw0) + abs(swm) + abs(sw2)) * r

        def arc(c, a, sg):
            n = max(int(math.ceil(abs(sg) * r / step)), 1)
            aa = a + np.linspace(0.0, sg, n + 1)
            return c[None, :] + r * np.stack(
                [np.cos(aa), np.sin(aa)], axis=1
            )

        a0 = arc(c0, phi0, sw0)
        am = arc(c1, ang(t0 - c1), swm)
        a2 = arc(c2, ang(t1 - c2), sw2)
        return length, np.concatenate([a0, am[1:], a2[1:]], axis=0)

    cands = [w for w in (word(+1, +1), word(-1, -1),
                         word(+1, -1), word(-1, +1),
                         word_ccc(+1, +1), word_ccc(+1, -1),
                         word_ccc(-1, +1), word_ccc(-1, -1))
             if w is not None]
    if candidates:
        # caller scores the words itself (e.g. by road-mask adherence)
        return cands
    return min(cands, key=lambda lp: lp[0])[1]


def _turn_option(yaw_in: float, yaw_out: float) -> RoadOption:
    d = (yaw_out - yaw_in + math.pi) % (2 * math.pi) - math.pi
    if d > 0.35:
        return RoadOption.RIGHT
    if d < -0.35:
        return RoadOption.LEFT
    return RoadOption.STRAIGHT


def make_grid_town(
    nx: int = 4,
    ny: int = 4,
    block: float = 100.0,
    lane_width: float = LANE_WIDTH,
    junction_margin: float = 8.0,
    signal_period: int = 2,
    seed: int = 0,
    lanes_per_direction: int = 1,
) -> LaneGraph:
    """Procedural Manhattan-grid town: ``nx`` x ``ny`` intersections spaced
    ``block`` metres apart, roads with ``lanes_per_direction`` lanes each
    way, junction connectors for straight/left/right, traffic lights on a
    checkerboard of junctions and stop signs on the rest.

    With ``lanes_per_direction > 1`` roads carry zero-lane-discipline
    CHANGELANE connectors between adjacent same-direction lanes (the
    reference planner's lane-change edges,
    ``global_route_planner.py:148-184``), right/left turns are restricted to
    the outer/inner lane, and the gnss command carry rule for commands 5/6
    (``navigation/gnss.py:109-116``) becomes reachable.

    This plays the role CARLA's Town01-06 play for the reference (which ships
    them pre-rendered in ``carla_gym/core/obs_manager/birdview/maps/*.h5``).
    """
    rng = np.random.default_rng(seed)
    del rng  # layout is deterministic; rng reserved for future variation

    L = max(int(lanes_per_direction), 1)
    half = lane_width / 2.0
    nodes: List[np.ndarray] = []
    edges: List[LaneEdge] = []
    lights: List[TrafficLightFixture] = []
    stops: List[StopSignFixture] = []

    def add_node(p: np.ndarray) -> int:
        nodes.append(p)
        return len(nodes) - 1

    def inter_center(i: int, j: int) -> np.ndarray:
        return np.array([i * block, j * block], dtype=np.float64)

    # For each junction, the entry/exit "ports": one per
    # (approach dir, io, lane). headings: 0=E,1=S,2=W,3=N; lane 0 is the
    # innermost (nearest road centre), lane L-1 the outer/curbside lane.
    HEADINGS = [0.0, math.pi / 2, math.pi, -math.pi / 2]
    DIRS = [np.array([1.0, 0.0]), np.array([0.0, 1.0]),
            np.array([-1.0, 0.0]), np.array([0.0, -1.0])]
    ports: Dict[Tuple[int, int, int, str, int], int] = {}

    def right_of(h: int) -> np.ndarray:
        yaw = HEADINGS[h]
        return np.array([-math.sin(yaw), math.cos(yaw)])  # (−sin, cos)

    def lane_marks(lane: int) -> Tuple[float, float]:
        # inner boundary (road centre side) is broken; between-lane
        # boundaries broken; only the outermost boundary is solid
        return (120.0, 255.0 if lane == L - 1 else 120.0)

    for i in range(nx):
        for j in range(ny):
            c = inter_center(i, j)
            for h in range(4):
                fwd = DIRS[h]
                rgt = right_of(h)
                for lane in range(L):
                    off = half + lane * lane_width
                    # Traffic moving with heading h *into* this junction
                    # arrives at the edge opposite to its travel direction.
                    p_in = c - fwd * junction_margin + rgt * off
                    p_out = c + fwd * junction_margin + rgt * off
                    ports[(i, j, h, "in", lane)] = add_node(p_in)
                    ports[(i, j, h, "out", lane)] = add_node(p_out)

    # Straight road lanes between adjacent junctions (both directions),
    # split at interior fractions when multi-lane so CHANGELANE connectors
    # have anchor nodes.
    CHANGE_FRACS = (0.35, 0.65) if L > 1 else ()

    def add_road(a: int, b: int, lane: int):
        """One directed lane a->b; returns the list of node ids along it
        (including the split points)."""
        pa, pb = nodes[a], nodes[b]
        chain = [a]
        for f in CHANGE_FRACS:
            chain.append(add_node(pa + (pb - pa) * f))
        chain.append(b)
        for u, v in zip(chain[:-1], chain[1:]):
            edges.append(
                LaneEdge(u, v, _sample_line(nodes[u], nodes[v]),
                         RoadOption.LANEFOLLOW, False,
                         mark_vals=lane_marks(lane))
            )
        return chain

    def add_lane_changes(chains: List[List[int]]):
        """CHANGELANE connectors between adjacent same-direction lanes:
        from each split node to the NEXT split node of the neighbour lane
        (zero-cost edges in the reference planner,
        global_route_planner.py:148-184; here cost = diagonal length)."""
        for lane in range(L - 1):
            lo, hi = chains[lane], chains[lane + 1]
            for k in range(1, len(lo) - 1):
                # lane -> lane+1 moves right
                edges.append(LaneEdge(
                    lo[k], hi[k + 1],
                    _sample_line(nodes[lo[k]], nodes[hi[k + 1]]),
                    RoadOption.CHANGELANERIGHT, False,
                ))
                edges.append(LaneEdge(
                    hi[k], lo[k + 1],
                    _sample_line(nodes[hi[k]], nodes[lo[k + 1]]),
                    RoadOption.CHANGELANELEFT, False,
                ))

    for i in range(nx):
        for j in range(ny):
            for h, (di, dj) in ((0, (1, 0)), (1, (0, 1))):
                i2, j2 = i + di, j + dj
                if i2 >= nx or j2 >= ny:
                    continue
                fwd_chains = [
                    add_road(ports[(i, j, h, "out", lane)],
                             ports[(i2, j2, h, "in", lane)], lane)
                    for lane in range(L)
                ]
                add_lane_changes(fwd_chains)
                h_op = (h + 2) % 4
                rev_chains = [
                    add_road(ports[(i2, j2, h_op, "out", lane)],
                             ports[(i, j, h_op, "in", lane)], lane)
                    for lane in range(L)
                ]
                add_lane_changes(rev_chains)

    # Junction connectors: from each in-port to the out-ports of the three
    # non-reverse headings (straight / right / left), when that exit road
    # exists on the grid. Lane discipline for L > 1: right turns only from
    # the outer lane, left turns only from the inner lane, straight
    # stays in lane.
    def road_exists(i: int, j: int, h: int) -> bool:
        di, dj = int(round(DIRS[h][0])), int(round(DIRS[h][1]))
        i2, j2 = i + di, j + dj
        return 0 <= i2 < nx and 0 <= j2 < ny

    for i in range(nx):
        for j in range(ny):
            for h_in in range(4):
                if not road_exists(i, j, (h_in + 2) % 4):
                    continue  # no incoming road from behind
                for h_out in range(4):
                    if h_out == (h_in + 2) % 4:
                        continue  # no U-turns
                    if not road_exists(i, j, h_out):
                        continue
                    option = _turn_option(HEADINGS[h_in], HEADINGS[h_out])
                    if option == RoadOption.STRAIGHT:
                        lane_pairs = [(l2, l2) for l2 in range(L)]
                    elif option == RoadOption.RIGHT:
                        lane_pairs = [(L - 1, L - 1)]
                    else:
                        lane_pairs = [(0, 0)]
                    for l_in, l_out in lane_pairs:
                        src = ports[(i, j, h_in, "in", l_in)]
                        dst = ports[(i, j, h_out, "out", l_out)]
                        pts = _sample_arc(
                            nodes[src], HEADINGS[h_in],
                            nodes[dst], HEADINGS[h_out],
                        )
                        edges.append(
                            LaneEdge(src, dst, pts, option, True)
                        )

    # Signals: checkerboard — even (i+j) junctions get traffic lights (when
    # they join >= 2 roads per axis), odd ones get stop signs on each entry.
    # Stop lines / trigger boxes span all L approach lanes.
    span_c = half + (L - 1) * lane_width / 2.0   # centre of the lane band
    span_h = (L * lane_width / 2.0) * 1.2        # half-extent across lanes
    for i in range(nx):
        for j in range(ny):
            c = inter_center(i, j)
            entries = [h for h in range(4) if road_exists(i, j, (h + 2) % 4)]
            if len(entries) < 3:
                continue  # corner junctions stay unsignalled
            junction_id = i * ny + j
            if (i + j) % signal_period == 0:
                for h in entries:
                    fwd = DIRS[h]
                    rgt = right_of(h)
                    p_in = c - fwd * junction_margin + rgt * span_c
                    a = p_in - rgt * span_h
                    b = p_in + rgt * span_h
                    lights.append(
                        TrafficLightFixture(
                            stop_a=a, stop_b=b, yaw=HEADINGS[h],
                            junction=junction_id, group=h % 2,
                        )
                    )
            else:
                for h in entries:
                    fwd = DIRS[h]
                    rgt = right_of(h)
                    p_in = c - fwd * junction_margin + rgt * span_c
                    stops.append(
                        StopSignFixture(
                            center=p_in - fwd * 1.0, yaw=HEADINGS[h],
                            extent=np.array([2.0, span_h]),
                        )
                    )

    adjacency: Dict[int, List[int]] = {}
    for k, e in enumerate(edges):
        adjacency.setdefault(e.src, []).append(k)

    return LaneGraph(
        nodes=np.array(nodes), edges=edges, adjacency=adjacency,
        traffic_lights=lights, stop_signs=stops, lane_width=lane_width,
    )


def grid_building_obstacles(
    nx: int = 4,
    ny: int = 4,
    block: float = 100.0,
    lane_width: float = LANE_WIDTH,
    lanes_per_direction: int = 1,
    margin: float = 2.5,
    junction_margin: float = 8.0,
) -> List[Tuple[float, float, float, float, float]]:
    """Building OBBs (x, y, yaw, half_x, half_y) filling each interior
    block of the grid town, inset ``margin`` m from the road band and from
    the junction box, whose turning arcs swing wider than the straight
    lanes. These are the static actors the reference's collision sensor
    can hit (criteria/collision.py:49-112): clipping a block corner scores
    a layout collision while part of the car is still on the road."""
    road_half = max(
        lanes_per_direction * lane_width, junction_margin
    ) + margin
    half = block / 2.0 - road_half
    out = []
    if half <= 2.0:
        return out
    for i in range(nx - 1):
        for j in range(ny - 1):
            out.append(
                ((i + 0.5) * block, (j + 0.5) * block, 0.0, half, half)
            )
    return out

def nearest_edge_point(
    graph: LaneGraph, xy: np.ndarray, yaw: float = None,
    yaw_weight: float = 8.0,
) -> Tuple[int, int]:
    """Locate (edge index, point index) nearest to a world location —
    the counterpart of ``map.get_waypoint`` localization. With ``yaw``
    the lookup is DIRECTION-aware (``map.get_waypoint`` returns the lane
    matching the query's driving side): an edge running against the query
    heading pays ``yaw_weight * (1 - cos)`` metres of penalty, so the
    correct lane of a two-way road wins over the slightly-nearer oncoming
    lane. CHANGELANE connector edges are never returned
    (``map.get_waypoint`` localizes onto driving lanes, not the planner's
    synthetic lane-change diagonals — they remain A*-traversable)."""
    lane_change = (RoadOption.CHANGELANELEFT, RoadOption.CHANGELANERIGHT)
    best = (0, 0)
    best_d = float("inf")
    for k, e in enumerate(graph.edges):
        if e.option in lane_change and len(graph.edges) > 1:
            continue
        d = np.linalg.norm(e.pts - xy[None, :], axis=1)
        m = int(np.argmin(d))
        score = float(d[m])
        if yaw is not None:
            j = min(m, len(e.pts) - 2)
            t = e.pts[j + 1] - e.pts[j]
            n = float(np.linalg.norm(t))
            if n > 1e-9:
                cosang = (
                    t[0] * math.cos(yaw) + t[1] * math.sin(yaw)
                ) / n
                score += yaw_weight * (1.0 - cosang)
        if score < best_d:
            best_d = score
            best = (k, m)
    return best


def astar(graph: LaneGraph, src_node: int, dst_node: int) -> List[int]:
    """A* over the lane graph, Euclidean heuristic — mirrors the reference's
    ``nx.astar_path`` usage (``global_route_planner.py:195-211``).
    Returns a list of edge indices; [] if src == dst, None if unreachable."""
    if src_node == dst_node:
        return []
    goal = graph.nodes[dst_node]

    def h(n: int) -> float:
        return float(np.linalg.norm(graph.nodes[n] - goal))

    dist = {src_node: 0.0}
    came: Dict[int, Tuple[int, int]] = {}
    pq = [(h(src_node), src_node)]
    seen = set()
    while pq:
        _, n = heapq.heappop(pq)
        if n in seen:
            continue
        seen.add(n)
        if n == dst_node:
            path = []
            while n != src_node:
                prev, ek = came[n]
                path.append(ek)
                n = prev
            return path[::-1]
        for ek in graph.adjacency.get(n, []):
            e = graph.edges[ek]
            nd = dist[n] + e.length
            if nd < dist.get(e.dst, float("inf")):
                dist[e.dst] = nd
                came[e.dst] = (n, ek)
                heapq.heappush(pq, (nd + h(e.dst), e.dst))
    return None
