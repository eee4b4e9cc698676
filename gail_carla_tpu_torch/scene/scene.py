"""TorchScene: the per-town constant tables the batched simulator reads.

Port of ``gail_carla_tpu/scene/scene.py``. The host compiler is the same
numpy code (``build_scene`` ``:225``, ``make_benchmark_scene`` ``:493``);
its result is a ``TorchScene`` with the field names of ``StaticScene``
(``scene.py:35-141``), holding tensors, and moved with ``.to(device)``.

The map is stored as capsule segments bucketed into a spatial grid
(scene/segments.py). ``build_scene`` takes precomputed dense routes
(``dense=``, the endless suite's chained rows), scripted scenario actors
(``scenario_actors=``), static obstacles (``obstacles=``) and the
ground-truth mask geometry of a reconstructed town (``geometry=``,
scene/h5_maps.py::TownGeometry: road and hard-surface boundaries, lane
markings, sidewalk paths for the walkers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.scene import mask_geo
from gail_carla_tpu_torch.scene import segments as seg_mod
from gail_carla_tpu_torch.scene import trace as trace_mod
from gail_carla_tpu_torch.scene.raster import rasterize_town
from gail_carla_tpu_torch.scene.routes import RouteDef, generate_routes
from gail_carla_tpu_torch.scene.town import (
    LaneGraph, make_grid_town, nearest_edge_point,
)
from gail_carla_tpu_torch.sim.transforms import location_to_gps_np

# static (non-tensor) fields of StaticScene
STATIC_FIELDS = (
    "cell_size", "half_lane", "tl_n", "ss_n", "ob_n", "bnd_dmax",
    "hard_dmax", "sa_max",
)


def _pad_to(n: int, mult: int) -> int:
    return ((max(n, 1) + mult - 1) // mult) * mult


@dataclasses.dataclass
class TorchScene:
    """Tensor counterpart of ``StaticScene``; see its field comments."""

    route_xy: torch.Tensor
    route_yaw: torch.Tensor
    route_cmd: torch.Tensor
    route_s: torch.Tensor
    route_n: torch.Tensor
    route_len_m: torch.Tensor
    plan_gps: torch.Tensor
    plan_xy: torch.Tensor
    plan_cmd: torch.Tensor
    plan_n: torch.Tensor
    cell_grid_lo: torch.Tensor
    cell_road: torch.Tensor
    cell_road_flag: torch.Tensor
    cell_lane: torch.Tensor
    cell_lane_val: torch.Tensor
    tl_stop: torch.Tensor
    tl_yaw: torch.Tensor
    tl_junction: torch.Tensor
    tl_group: torch.Tensor
    cell_size: float = 32.0
    half_lane: float = 1.75
    tl_n: int = 0
    ss_center: torch.Tensor = None
    ss_yaw: torch.Tensor = None
    ss_extent: torch.Tensor = None
    ss_n: int = 0
    spawn: torch.Tensor = None
    patrol_xy: torch.Tensor = None
    patrol_yaw: torch.Tensor = None
    patrol_cmd: torch.Tensor = None
    patrol_n: torch.Tensor = None
    endless_next: Optional[torch.Tensor] = None
    ob_pose: torch.Tensor = None
    ob_extent: torch.Tensor = None
    ob_n: int = 0
    cell_road_n: torch.Tensor = None
    cell_lane_n: torch.Tensor = None
    cell_tl: torch.Tensor = None
    cell_tl_idx: torch.Tensor = None
    cell_tl_n: torch.Tensor = None
    cell_bnd: torch.Tensor = None
    cell_bnd_n: torch.Tensor = None
    bnd_dmax: float = 40.0
    cell_hard: torch.Tensor = None
    cell_hard_n: torch.Tensor = None
    hard_dmax: float = 40.0
    cell_lane_w: torch.Tensor = None
    walk_xy: Optional[torch.Tensor] = None
    walk_yaw: Optional[torch.Tensor] = None
    walk_n: Optional[torch.Tensor] = None
    walk_cross: Optional[torch.Tensor] = None
    sa_patrol: torch.Tensor = None
    sa_speed: torch.Tensor = None
    sa_max: int = 0

    @property
    def n_routes(self) -> int:
        return self.route_xy.shape[0]

    @property
    def device(self) -> torch.device:
        return self.route_xy.device

    def to(self, device) -> "TorchScene":
        """A copy with every table on ``device``."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return TorchScene(**moved)

    def tensors(self):
        """(name, tensor) for every tensor field."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                yield f.name, v


def _pad_polyline_set(patrols, pad: int = 128):
    """Pad a list of (xy, yaw, cmd) polylines into dense patrol arrays."""
    L = _pad_to(max(len(p[0]) for p in patrols) + 32, pad)
    P = len(patrols)
    patrol_xy = np.zeros((P, L, 2), np.float32)
    patrol_yaw = np.zeros((P, L), np.float32)
    patrol_cmd = np.full((P, L), 4, np.int32)
    patrol_n = np.zeros((P,), np.int32)
    for i, (xy, yaw, cmd) in enumerate(patrols):
        n = len(xy)
        if len(yaw) < n:
            # a degenerate single-point patrol has no segment to take a
            # yaw from
            yaw = np.concatenate([yaw, np.zeros(n - len(yaw))])
        patrol_xy[i, :n] = xy
        patrol_xy[i, n:] = xy[-1]
        patrol_yaw[i, :n] = yaw
        patrol_yaw[i, n:] = yaw[-1]
        patrol_cmd[i, :n] = cmd
        patrol_n[i] = n
    return patrol_xy, patrol_yaw, patrol_cmd, patrol_n


def _polyline_with_yaw(xy: np.ndarray):
    """(xy, yaw, cmd) of a polyline: each point's heading toward the next
    (the last repeats), command 4 (LANEFOLLOW) throughout."""
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    d = np.diff(xy, axis=0)
    yaw = np.arctan2(d[:, 1], d[:, 0])
    yaw = np.concatenate([yaw, yaw[-1:]]) if len(yaw) else np.zeros(1)
    cmd = np.full(len(xy), 4, np.int32)
    return xy, yaw, cmd


def _build_patrols(
    graph: LaneGraph,
    n_patrols: int,
    length_m: float = 400.0,
    seed: int = 99,
):
    """Random lane-graph walks for background traffic (the patrol tables
    stay in the scene so that it matches the JAX one array for array)."""
    rng = np.random.default_rng(seed)
    spawns = graph.spawn_points(spacing=35.0)
    patrols = []
    for _ in range(n_patrols):
        start = spawns[int(rng.integers(len(spawns)))]
        ek, idx = nearest_edge_point(graph, start[:2])
        pts = [graph.edges[ek].pts[idx:]]
        cmds = [np.full(len(pts[0]), int(graph.edges[ek].option), np.int32)]
        total = 0.0
        node = graph.edges[ek].dst
        while total < length_m:
            outs = graph.adjacency.get(node, [])
            if not outs:
                break
            ek = int(rng.choice(outs))
            e = graph.edges[ek]
            pts.append(e.pts[1:])
            cmds.append(np.full(len(e.pts) - 1, int(e.option), np.int32))
            total += e.length
            node = e.dst
        xy = np.concatenate(pts, axis=0)
        cmd = np.concatenate(cmds, axis=0)
        d = np.diff(xy, axis=0)
        yaw = np.arctan2(d[:, 1], d[:, 0])
        yaw = np.concatenate([yaw, yaw[-1:]])
        patrols.append((xy, yaw, cmd))
    return patrols


def _walk_tables(geometry, bnd_ab: np.ndarray) -> dict:
    """The walkers' sidewalk tables of a town with sidewalk paths, else
    none (``walk_*`` stay None): each centreline padded like a patrol,
    and its road-crossing offset, the signed lateral displacement that
    carries a walker from this pavement across the adjacent road (sign
    from the side the road boundary lies on)."""
    if geometry is None or not geometry.sidewalk_paths:
        return {}
    wps = [_polyline_with_yaw(p) for p in geometry.sidewalk_paths]
    walk_xy, walk_yaw, _, walk_n = _pad_polyline_set(wps)
    crosses = []
    for p in geometry.sidewalk_paths:
        mid = np.asarray(p[:: max(len(p) // 8, 1)], np.float64)
        closest, sd, _ = mask_geo.boundary_project(bnd_ab, mid)
        d = closest - mid
        tang = np.gradient(np.asarray(p, np.float64), axis=0)[
            :: max(len(p) // 8, 1)
        ][: len(mid)]
        tang /= np.linalg.norm(tang, axis=1, keepdims=True) + 1e-9
        nrm = np.stack([-tang[:, 1], tang[:, 0]], axis=1)
        side = np.sign(np.sum(np.sum(d * nrm, axis=1)))
        side = side if side != 0 else 1.0
        # pavement-to-pavement: across the gap to the road plus a typical
        # 7 m carriageway plus the far pavement inset
        dist = 2.0 * float(np.mean(np.abs(sd))) + 7.0
        crosses.append(side * dist)
    t = torch.from_numpy
    return dict(walk_xy=t(walk_xy), walk_yaw=t(walk_yaw), walk_n=t(walk_n),
                walk_cross=t(np.asarray(crosses, np.float32)))


def build_scene(
    graph: LaneGraph,
    route_defs: Sequence[RouteDef],
    route_pts_pad: int = 256,
    plan_pts_pad: int = 32,
    cell_size: float = 32.0,
    n_patrols: int = 32,
    dense=None,
    scenario_actors=None,
    obstacles=None,
    geometry=None,
) -> TorchScene:
    """Compile a lane graph and its routes into a CPU ``TorchScene``.
    ``dense`` optionally supplies the routes' ``DenseRoute``s instead of
    tracing ``route_defs`` through the graph.

    ``scenario_actors`` maps route_id -> [(polyline_xy, target_speed),
    ...], per-task scripted vehicles (scenario_actor_handler.py:6-50):
    their polylines are appended to the patrol tables after the random
    patrols, and ``sa_patrol``/``sa_speed`` say which rows each ego route
    activates (``sim/traffic.py``). ``obstacles`` is a list of (x, y, yaw,
    half_x, half_y) static OBBs (buildings, poles); hitting one scores a
    layout collision (``sim/collisions.py::obstacle_collision``).

    ``geometry`` (scene/h5_maps.py::TownGeometry) supplies a reconstructed
    town's ground truth: its lane-marking capsules replace the graph's,
    its road boundary replaces the one traced from the graph's rasterized
    road, its hard (curb-to-wall) boundary gets its own cell tables, and
    its sidewalk centrelines become the walkers' paths (``walk_*``), each
    with the signed offset of a road crossing (``walk_cross``)."""
    if dense is None:
        dense = [trace_mod.trace_route(graph, r.waypoints)
                 for r in route_defs]

    R = len(dense)
    # +96 headroom keeps the route windows at the route tail in bounds
    L = _pad_to(max(len(d.xy) for d in dense) + 96, route_pts_pad)
    P = _pad_to(max(len(d.plan_xy) for d in dense), plan_pts_pad)

    route_xy = np.zeros((R, L, 2), np.float32)
    route_yaw = np.zeros((R, L), np.float32)
    route_cmd = np.full((R, L), 4, np.int32)
    route_s = np.zeros((R, L), np.float32)
    route_n = np.zeros((R,), np.int32)
    route_len = np.zeros((R,), np.float32)
    plan_xy = np.zeros((R, P, 2), np.float32)
    plan_cmd = np.full((R, P), 4, np.int32)
    plan_n = np.zeros((R,), np.int32)

    for r, d in enumerate(dense):
        n = len(d.xy)
        route_xy[r, :n] = d.xy
        route_xy[r, n:] = d.xy[-1]
        route_yaw[r, :n] = d.yaw
        route_yaw[r, n:] = d.yaw[-1]
        route_cmd[r, :n] = d.cmd
        route_cmd[r, n:] = d.cmd[-1]
        route_s[r, :n] = d.s
        route_s[r, n:] = d.s[-1]
        route_n[r] = n
        route_len[r] = d.length_m
        p = len(d.plan_xy)
        plan_xy[r, :p] = d.plan_xy
        plan_xy[r, p:] = d.plan_xy[-1]
        plan_cmd[r, :p] = d.plan_cmd
        plan_cmd[r, p:] = d.plan_cmd[-1]
        plan_n[r] = p

    plan_gps = location_to_gps_np(plan_xy.reshape(-1, 2)).reshape(R, P, 2)

    soup = seg_mod.extract_segments(graph)
    if geometry is not None:
        # ground-truth lane markings replace the graph-derived ones
        soup = seg_mod.SegmentSoup(
            road_ab=soup.road_ab, road_junction=soup.road_junction,
            lane_ab=np.asarray(geometry.lane_ab, np.float32).reshape(-1, 4),
            lane_val=np.asarray(geometry.lane_val, np.float32),
            lane_hw=np.asarray(geometry.lane_hw, np.float32),
        )
    all_pts = np.concatenate([e.pts for e in graph.edges], axis=0)
    table = seg_mod.build_cell_table(
        soup, all_pts.min(axis=0), all_pts.max(axis=0), cell_size=cell_size
    )

    # oriented road-boundary edges: ground truth when supplied, else from
    # the graph's own rasterized road mask (0.49 px is the simplification
    # error the JAX scene uses)
    if geometry is not None:
        bnd_ab = np.asarray(geometry.bnd_ab, np.float32).reshape(-1, 4)
        bnd_dmax = float(geometry.bnd_dmax)
    else:
        tex = rasterize_town(graph)
        bnd_ab, bnd_dmax = mask_geo.mask_boundary_edges(
            tex.road > 0, tex.world_offset.astype(np.float64), tex.ppm,
            max_err_px=0.49,
        )
    gy_, gx_ = table.road.shape[:2]
    cell_bnd, cell_bnd_n = seg_mod.build_bnd_cells(
        bnd_ab, table.grid_lo, gy_, gx_, table.cell_size, bnd_dmax
    )
    cell_bnd_t = torch.from_numpy(cell_bnd)
    cell_bnd_n_t = torch.from_numpy(cell_bnd_n)
    if geometry is not None and geometry.hard_ab is not None \
            and len(geometry.hard_ab):
        hard_ab = np.asarray(geometry.hard_ab, np.float32).reshape(-1, 4)
        hard_dmax = float(geometry.hard_dmax)
        cell_hard, cell_hard_n = seg_mod.build_bnd_cells(
            hard_ab, table.grid_lo, gy_, gx_, table.cell_size, hard_dmax
        )
        cell_hard_t = torch.from_numpy(cell_hard)
        cell_hard_n_t = torch.from_numpy(cell_hard_n)
    else:
        # procedural towns: the road corridor is the whole drivable
        # world, so the hard (curb-to-wall) boundary aliases the road's
        cell_hard_t, cell_hard_n_t, hard_dmax = (cell_bnd_t, cell_bnd_n_t,
                                                 bnd_dmax)
    walk = _walk_tables(geometry, bnd_ab)

    tls = graph.traffic_lights
    sss = graph.stop_signs
    T = max(len(tls), 1)
    S = max(len(sss), 1)
    tl_stop = np.zeros((T, 2, 2), np.float32)
    tl_yaw = np.zeros((T,), np.float32)
    tl_junction = np.zeros((T,), np.int32)
    tl_group = np.zeros((T,), np.int32)
    for i, t in enumerate(tls):
        tl_stop[i, 0] = t.stop_a
        tl_stop[i, 1] = t.stop_b
        tl_yaw[i] = t.yaw
        tl_junction[i] = t.junction
        tl_group[i] = t.group
    ss_center = np.zeros((S, 2), np.float32)
    ss_yaw = np.zeros((S,), np.float32)
    ss_extent = np.ones((S, 2), np.float32)
    for i, s in enumerate(sss):
        ss_center[i] = s.center
        ss_yaw[i] = s.yaw
        ss_extent[i] = s.extent

    cell_tl, cell_tl_idx, cell_tl_n = seg_mod.build_tl_cells(
        tl_stop, table.grid_lo, gy_, gx_, table.cell_size
    )

    spawn = graph.spawn_points().astype(np.float32)
    if len(spawn) == 0:
        spawn = np.zeros((1, 3), np.float32)

    polylines = _build_patrols(graph, n_patrols)
    sa_max = max(
        (len(v) for v in (scenario_actors or {}).values()), default=0
    )
    R_total = len(route_defs)
    sa_patrol = np.full((R_total, max(sa_max, 1)), -1, np.int32)
    sa_speed = np.zeros((R_total, max(sa_max, 1)), np.float32)
    for rid, actors in (scenario_actors or {}).items():
        for j, (poly, speed) in enumerate(actors):
            sa_patrol[rid, j] = len(polylines)
            sa_speed[rid, j] = speed
            polylines.append(_polyline_with_yaw(poly))
    patrol_xy, patrol_yaw, patrol_cmd, patrol_n = _pad_polyline_set(
        polylines
    )

    obs_list = list(obstacles or ())
    O = max(len(obs_list), 1)
    ob_pose = np.zeros((O, 3), np.float32)
    ob_extent = np.ones((O, 2), np.float32) * 0.01
    ob_pose[:, 0] = 1.0e6   # empty slots live far away
    for i, (x, y, yaw, hx, hy) in enumerate(obs_list):
        ob_pose[i] = (x, y, yaw)
        ob_extent[i] = (hx, hy)

    t = torch.from_numpy
    return TorchScene(
        route_xy=t(route_xy),
        route_yaw=t(route_yaw),
        route_cmd=t(route_cmd),
        route_s=t(route_s),
        route_n=t(route_n),
        route_len_m=t(route_len),
        plan_gps=t(plan_gps),
        plan_xy=t(plan_xy),
        plan_cmd=t(plan_cmd),
        plan_n=t(plan_n),
        cell_grid_lo=t(table.grid_lo),
        cell_road=t(table.road),
        cell_road_flag=t(table.road_flag),
        cell_road_n=t(table.road_n),
        cell_tl=t(cell_tl),
        cell_tl_idx=t(cell_tl_idx),
        cell_tl_n=t(cell_tl_n),
        cell_lane=t(table.lane),
        cell_lane_val=t(table.lane_val),
        cell_lane_w=t(table.lane_w),
        cell_lane_n=t(table.lane_n),
        cell_bnd=cell_bnd_t,
        cell_bnd_n=cell_bnd_n_t,
        bnd_dmax=bnd_dmax,
        cell_hard=cell_hard_t,
        cell_hard_n=cell_hard_n_t,
        hard_dmax=hard_dmax,
        **walk,
        cell_size=table.cell_size,
        half_lane=float(graph.lane_width / 2.0),
        tl_stop=t(tl_stop),
        tl_yaw=t(tl_yaw),
        tl_junction=t(tl_junction),
        tl_group=t(tl_group),
        tl_n=len(tls),
        ss_center=t(ss_center),
        ss_yaw=t(ss_yaw),
        ss_extent=t(ss_extent),
        ss_n=len(sss),
        spawn=t(spawn),
        patrol_xy=t(patrol_xy),
        patrol_yaw=t(patrol_yaw),
        patrol_cmd=t(patrol_cmd),
        patrol_n=t(patrol_n),
        sa_patrol=t(sa_patrol),
        sa_speed=t(sa_speed),
        sa_max=sa_max,
        ob_pose=t(ob_pose),
        ob_extent=t(ob_extent),
        ob_n=len(obs_list),
    )


def make_benchmark_scene(
    n_routes: int = 10,
    nx: int = 4,
    ny: int = 4,
    block: float = 100.0,
    seed: int = 2021,
    min_length: float = 400.0,
    device="cuda",
) -> TorchScene:
    """The deterministic grid town with ``n_routes`` generated routes
    (the JAX package's stand-in for Town01 + routes 0-9), on ``device``."""
    dev = resolve_device(device)
    graph = make_grid_town(nx=nx, ny=ny, block=block, seed=seed)
    routes = generate_routes(
        graph, n_routes=n_routes, min_length=min_length, seed=seed
    )
    return build_scene(graph, routes).to(dev)
