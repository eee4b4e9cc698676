# Frozen copy of gail_carla_tpu_torch/sim/criteria.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Stateful infraction criteria as branchless masked updates, batched.

Port of ``gail_carla_tpu/sim/criteria.py`` (RunRedLight, RunStopSign,
EncounterLight, OutsideRouteLane). Every argument carries a leading env
axis (N, ...); per-light and per-sign tests run over a second axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.plain_reference.frozen.sim import signals
from bench_port.plain_reference.frozen.sim.dynamics import VehicleParams, VehicleState
from bench_port.plain_reference.frozen.sim.transforms import (
    cast_angle, deg2rad_f32, norm2,
)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none), as
    ``jnp.argmax`` of a bool array gives it."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` per env for a (T, ...) table and (N,) indices."""
    return table[idx.long()]


def run_red_light(
    scene,
    params: VehicleParams,
    ego: VehicleState,
    states,               # (N, T) light states this tick
    last_red_light,       # (N,) i32
    last_cross_light,     # (N,) i32 last stop line crossed at ANY colour
    distance_light: float = 30.0,
):
    """Returns (last_red_light', last_cross_light', ran_now (bool))."""
    fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], dim=-1)
    tail_close = ego.xy - 0.8 * params.half_length * fwd
    tail_far = ego.xy - (params.half_length + 1.0) * fwd

    center = signals.stopline_center(scene)                # (T, 2)
    T = states.shape[1]
    ar = torch.arange(T, device=states.device)
    near = norm2(center[None] - ego.xy[:, None]) < distance_light
    red = states == signals.RED
    not_last = ar[None, :] != last_red_light[:, None]
    # within 60 deg of the light's inbound direction
    aligned = torch.cos(scene.tl_yaw[None, :] - ego.yaw[:, None]) > 0.5
    # one red per junction traversal
    safe_last = last_red_light.clamp_min(0)
    last_ju = torch.where(
        last_red_light >= 0, _pick(scene.tl_junction, safe_last), -2
    )
    d_last = norm2(_pick(center, safe_last) - ego.xy)
    same_junc_near = (
        (scene.tl_junction[None, :] == last_ju[:, None])
        & (d_last < 40.0)[:, None]
        & (last_red_light >= 0)[:, None]
    )
    # lane containment of the tail
    a = scene.tl_stop[:, 0]
    b = scene.tl_stop[:, 1]
    ab = b - a
    rt = tail_far[:, None, :] - a[None]
    t = (rt[..., 0] * ab[:, 0] + rt[..., 1] * ab[:, 1]) / (
        (ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1]) + 1e-9
    )
    in_lane = (t > 0.0) & (t < 1.0)

    crossing = signals.segments_intersect(
        tail_close[:, None, :], tail_far[:, None, :], a[None], b[None]
    )
    live = ar < scene.tl_n
    # entering-the-junction gate (criteria.py:84-100)
    safe_cross = last_cross_light.clamp_min(0)
    cross_ju = torch.where(
        last_cross_light >= 0, _pick(scene.tl_junction, safe_cross), -2
    )
    d_cross = norm2(_pick(center, safe_cross) - ego.xy)
    inside_junc = (
        (scene.tl_junction[None, :] == cross_ju[:, None])
        & (d_cross < 40.0)[:, None]
        & (last_cross_light >= 0)[:, None]
    )
    crossed_any = near & aligned & in_lane & crossing & live
    hit = crossed_any & red & not_last & ~same_junc_near & ~inside_junc
    any_hit = hit.any(dim=1)
    last = torch.where(any_hit, _first_true(hit), last_red_light)
    any_cross = crossed_any.any(dim=1)
    last_cross = torch.where(
        any_cross, _first_true(crossed_any), last_cross_light
    )
    return last.to(torch.int32), last_cross.to(torch.int32), any_hit


class StopSignState(NamedTuple):
    target: torch.Tensor       # (N,) i32, -1 = none
    completed: torch.Tensor    # (N,) bool
    affected: torch.Tensor     # (N,) bool


def _affected_by_stop(scene, route_pts, ego_xy):
    """(N, S) which stop signs cover the ego or its next ~20 route metres
    (run_stop_sign.is_affected_by_stop over the dense-route window)."""
    pts = torch.cat([ego_xy[:, None, :], route_pts], dim=1)   # (N, 21, 2)
    inside = signals.point_in_stop_box(
        pts[:, :, None, :], scene.ss_center[None, None],
        scene.ss_extent[None, None],
    )                                                         # (N, 21, S)
    near = norm2(scene.ss_center[None] - ego_xy[:, None]) < 50.0
    S = scene.ss_center.shape[0]
    valid = torch.arange(S, device=ego_xy.device) < scene.ss_n
    return inside.any(dim=1) & near & valid


def run_stop_sign(
    scene,
    ego: VehicleState,
    route_pts,            # (N, 20, 2) dense route ahead (1 m spacing)
    route_yaw0,           # (N,) lane direction at the ego
    st: StopSignState,
    speed_threshold: float = 0.1,
):
    """Returns (st', encountered_now, ran_now)."""
    affected_mask = _affected_by_stop(scene, route_pts, ego.xy)

    # no target: scan (only when heading along the lane)
    right_way = torch.cos(route_yaw0 - ego.yaw) > 0.0
    any_affecting = affected_mask.any(dim=1) & right_way
    first = _first_true(affected_mask)
    no_target = st.target < 0
    encountered = no_target & any_affecting
    target_new = torch.where(encountered, first, st.target)

    # with target: track stop / containment / leave
    has_target = ~no_target
    speed = torch.abs(ego.speed)
    completed = st.completed | (has_target & (speed < speed_threshold))
    tgt = st.target.clamp_min(0).long()
    inside_now = signals.point_in_stop_box(
        ego.xy, scene.ss_center[tgt], scene.ss_extent[tgt]
    )
    affected = st.affected | (has_target & inside_now)
    still_affecting = affected_mask.gather(1, tgt[:, None])[:, 0]
    left = has_target & (~still_affecting)
    ran = left & affected & (~completed)

    new = StopSignState(
        target=torch.where(left, -1, target_new).to(torch.int32),
        completed=torch.where(left, False, completed),
        affected=torch.where(left, False, affected),
    )
    return new, encountered, ran


def encounter_light(scene, ego: VehicleState, states, encountered_id,
                    dist_threshold: float = 7.5):
    """criteria/encounter_light.py: a (new) light whose stop line is
    within 7.5 m ahead. Returns (encountered_id', encountered_now)."""
    _, _, idx = signals.affecting_light(
        scene, ego.xy, ego.yaw, states, dist_threshold=dist_threshold
    )
    hit = (idx >= 0) & (idx != encountered_id)
    new_id = torch.where(hit, idx, encountered_id).to(torch.int32)
    return new_id, hit


def outside_route_lane(
    scene,
    ego: VehicleState,
    road_segs,            # (N, Mr, 4) ego cell road capsules
    road_is_junction,     # (N, Mr) f32 1.0 = junction connector
    allowed_out: float = 1.3,
    max_vehicle_angle_deg: float = 120.0,
):
    """outside_route_lane.py, adapted: the nearest road capsule plays the
    role of map.get_waypoint. Returns (outside, wrong)."""
    a = road_segs[..., :2]
    b = road_segs[..., 2:]
    ab = b - a
    xa = ego.xy[:, None, :] - a
    t = torch.clamp(
        (xa[..., 0] * ab[..., 0] + xa[..., 1] * ab[..., 1])
        / ((ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1]) + 1e-9),
        0.0, 1.0,
    )
    d = norm2(ego.xy[:, None, :] - (a + t[..., None] * ab))
    nearest = torch.argmin(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    outside = d[rows, nearest] > (scene.half_lane + allowed_out)

    seg_dir = ab[rows, nearest]
    seg_yaw = torch.atan2(seg_dir[:, 1], seg_dir[:, 0])
    angle = torch.abs(cast_angle(seg_yaw - ego.yaw))
    in_junction = road_is_junction[rows, nearest] > 0.5
    wrong = (~in_junction) & (
        angle > deg2rad_f32(max_vehicle_angle_deg)
    ) & (~outside)
    return outside, wrong
