"""Collision detection, batched: port of ``gail_carla_tpu/sim/collisions.py``
(the stand-in for CARLA's ``sensor.other.collision``,
``criteria/collision.py:6-117``).

- static layout: the vehicle body fully off the hard surface;
- static obstacles and dynamic actors: only their empty cases are ported
  (the procedural scene has no obstacles, and this slice runs zero NPCs).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gail_carla_tpu_torch.ops.bev import boundary_inside
from gail_carla_tpu_torch.sim.dynamics import VehicleParams, VehicleState
from gail_carla_tpu_torch.sim.transforms import norm2


class DynHits(NamedTuple):
    veh: torch.Tensor
    ped: torch.Tensor
    veh_id: torch.Tensor
    ped_id: torch.Tensor
    veh_rel_speed: torch.Tensor
    ped_rel_speed: torch.Tensor


def static_collision(params: VehicleParams, ego: VehicleState, bnd_segs,
                     dmax: float):
    """(N,) bool: all four bounding-box corners off the hard surface
    (``bnd_segs`` (N, Mh, 4) from the step's shared fetch)."""
    c, s = torch.cos(ego.yaw), torch.sin(ego.yaw)
    f = torch.stack([c, s], dim=-1) * params.half_length
    r = torch.stack([-s, c], dim=-1) * params.half_width
    corners = ego.xy[:, None, :] + torch.stack(
        [f + r, f - r, -f + r, -f - r], dim=1
    )
    on_road = boundary_inside(corners, bnd_segs, dmax)
    return ~on_road.any(dim=1)


def obstacle_collision(scene, params: VehicleParams, ego: VehicleState):
    """Ego vs static-obstacle OBBs; the procedural scene has none."""
    if scene.ob_n != 0:
        raise NotImplementedError("static obstacles are not ported yet")
    return torch.zeros_like(ego.yaw, dtype=torch.bool)


def dynamic_collisions(traffic, params: VehicleParams,
                       ego: VehicleState) -> DynHits:
    """Ego vs NPC vehicles and walkers; only the zero-NPC case is ported."""
    if traffic.veh_yaw.shape[1] != 0 or traffic.walker_yaw.shape[1] != 0:
        raise NotImplementedError("NPC collisions are not ported yet")
    f = torch.zeros_like(ego.yaw, dtype=torch.bool)
    i = torch.zeros_like(ego.yaw, dtype=torch.int32)
    z = torch.zeros_like(ego.yaw)
    return DynHits(f, f, i, i, z, z)


class CollisionEvents(NamedTuple):
    static: torch.Tensor
    veh: torch.Tensor
    ped: torch.Tensor
    any: torch.Tensor
    intensity: torch.Tensor
    col_xy: torch.Tensor
    col_time: torch.Tensor
    col_id: torch.Tensor


def dedup_events(ego, sim_time, raw_static, hits: DynHits, n_veh_slots,
                 col_xy, col_time, col_id) -> CollisionEvents:
    """Collision-sensor dedup (criteria/collision.py:27-47 + 54-62): a
    registered location suppresses events within 3 m and is forgotten
    once the ego moves 5 m away; the last hit actor id is remembered 5 s."""
    d_prev = norm2(ego.xy - col_xy)
    reg_xy = torch.where((d_prev > 5.0)[:, None], 1e9, col_xy)
    near_prev = norm2(ego.xy - reg_xy) <= 3.0
    id_live = (sim_time - col_time) <= 5.0
    veh_gid = 1 + hits.veh_id
    ped_gid = 1 + n_veh_slots + hits.ped_id
    ev_static = raw_static & ~near_prev
    ev_veh = hits.veh & ~near_prev & ~(id_live & (col_id == veh_gid))
    ev_ped = hits.ped & ~near_prev & ~(id_live & (col_id == ped_gid))
    ev_any = ev_static | ev_veh | ev_ped
    new_xy = torch.where(ev_any[:, None], ego.xy, reg_xy)
    new_time = torch.where(ev_any, sim_time, col_time)
    new_id = torch.where(
        ev_veh, veh_gid, torch.where(ev_ped, ped_gid, col_id)
    ).to(torch.int32)
    intensity = torch.where(
        ev_veh, hits.veh_rel_speed,
        torch.where(ev_ped, hits.ped_rel_speed,
                    torch.where(ev_static, torch.abs(ego.speed), 0.0)),
    )
    return CollisionEvents(
        ev_static, ev_veh, ev_ped, ev_any, intensity,
        new_xy, new_time, new_id,
    )
