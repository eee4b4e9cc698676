# Frozen copy of gail_carla_tpu_torch/scene/trace.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Offline route tracing: sparse keypoints -> dense 1 m polyline + commands.

Counterpart of the reference's per-reset route build
(``task_vehicle.py:84-93`` calling ``GlobalRoutePlanner.trace_route`` at 1 m
resolution) and of the leaderboard plan downsampling
(``route_manipulation.py:114-157``, sample factor 50 m). Runs once per task on
host — routes are static per task, so none of this needs to be jitted.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from bench_port.plain_reference.frozen.scene.road_option import RoadOption
from bench_port.plain_reference.frozen.scene.town import LaneGraph, astar, nearest_edge_point


@dataclasses.dataclass
class DenseRoute:
    xy: np.ndarray       # (L, 2) ~1 m spaced points
    yaw: np.ndarray      # (L,)
    cmd: np.ndarray      # (L,) RoadOption values
    s: np.ndarray        # (L,) cumulative arc length, s[0] = 0
    plan_xy: np.ndarray  # (P, 2) downsampled leaderboard plan
    plan_cmd: np.ndarray  # (P,)

    @property
    def length_m(self) -> float:
        return float(self.s[-1])


def _edge_slices(graph: LaneGraph, a_xy: np.ndarray, b_xy: np.ndarray,
                 a_yaw=None, b_yaw=None):
    """Points + commands for the graph path from a to b (inclusive)."""
    ek_a, ia = nearest_edge_point(graph, a_xy, yaw=a_yaw)
    ek_b, ib = nearest_edge_point(graph, b_xy, yaw=b_yaw)
    pts: List[np.ndarray] = []
    cmds: List[np.ndarray] = []

    def push(edge, lo=0, hi=None):
        p = edge.pts[lo:hi]
        if len(p) == 0:
            return
        pts.append(p)
        cmds.append(np.full(len(p), int(edge.option), dtype=np.int32))

    if ek_a == ek_b and ib >= ia:
        push(graph.edges[ek_a], ia, ib + 1)
        return pts, cmds

    push(graph.edges[ek_a], ia)
    path = astar(graph, graph.edges[ek_a].dst, graph.edges[ek_b].src)
    if path is None:
        raise RuntimeError("no route between waypoints")
    for k in path:
        push(graph.edges[k], 1)  # skip shared node point
    push(graph.edges[ek_b], 1, ib + 1)
    return pts, cmds


def trace_route(graph: LaneGraph, waypoints: np.ndarray,
                use_yaw: bool = False) -> DenseRoute:
    """Trace through all route keypoints and concatenate
    (``task_vehicle.py:84-93`` iterates target transforms the same way).
    ``use_yaw``: snap each keypoint to the lane matching its heading
    (column 2) — for route packs whose waypoints carry REAL yaws
    (NoCrash/CoRL2017); grid-walk waypoints carry dummy zeros and must
    keep the distance-only snap."""
    pts: List[np.ndarray] = []
    cmds: List[np.ndarray] = []
    for i in range(len(waypoints) - 1):
        p, c = _edge_slices(
            graph, waypoints[i, :2], waypoints[i + 1, :2],
            a_yaw=waypoints[i, 2] if use_yaw else None,
            b_yaw=waypoints[i + 1, 2] if use_yaw else None,
        )
        if pts and p:
            # drop duplicated seam point
            p = [p[0][1:]] + p[1:] if len(p[0]) > 1 else p[1:]
            c = [c[0][1:]] + c[1:] if len(c[0]) > 1 else c[1:]
        pts += p
        cmds += c
    xy = np.concatenate(pts, axis=0)
    cmd = np.concatenate(cmds, axis=0)

    # De-duplicate near-coincident points, then derive yaw + arc length.
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


def _collapse_lane_changes(cmd: np.ndarray, keep: int = 2) -> np.ndarray:
    """Keep only the first ``keep`` points of each CHANGELANE run.

    The reference's lane-change graph edges have empty interior paths
    (``global_route_planner.py:148-184``), so a change contributes 1-2 route
    points; our diagonal connectors are ~20 m of sampled polyline — without
    collapsing, every metre of them would be kept by the downsampler
    (``route_manipulation.py:129-132`` samples every lane-change point)."""
    out = cmd.copy()
    lane_change = (int(RoadOption.CHANGELANELEFT),
                   int(RoadOption.CHANGELANERIGHT))
    run = 0
    for i in range(len(cmd)):
        if int(cmd[i]) in lane_change:
            run += 1
            if run > keep:
                out[i] = int(RoadOption.LANEFOLLOW)
        else:
            run = 0
    return out


def _downsample(xy: np.ndarray, cmd: np.ndarray, sample_factor: float):
    """Keep command changes, lane changes, every ``sample_factor`` m, and the
    final point — the exact rule of ``route_manipulation.downsample_route``
    (``route_manipulation.py:114-157``)."""
    ids = []
    prev_option = None
    dist = 0.0
    lane_change = (int(RoadOption.CHANGELANELEFT), int(RoadOption.CHANGELANERIGHT))
    for i in range(len(xy)):
        curr = int(cmd[i])
        if curr in lane_change:
            ids.append(i)
            dist = 0.0
        elif prev_option is not None and prev_option != curr \
                and prev_option not in lane_change:
            ids.append(i)
            dist = 0.0
        elif dist > sample_factor:
            ids.append(i)
            dist = 0.0
        elif i == len(xy) - 1:
            ids.append(i)
            dist = 0.0
        else:
            if i > 0:
                dist += float(np.linalg.norm(xy[i] - xy[i - 1]))
        prev_option = curr
    if not ids or ids[0] != 0:
        ids = [0] + ids
    return np.array(sorted(set(ids)), dtype=np.int64)
