# Frozen copy of gail_carla_tpu_torch/sim/collisions.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Collision detection, batched: port of ``gail_carla_tpu/sim/collisions.py``
(the stand-in for CARLA's ``sensor.other.collision``,
``criteria/collision.py:6-117``).

- static layout: the vehicle body fully off the hard surface;
- static obstacles: ego OBB vs the scene's building/pole OBBs (separating
  axis), a layout collision too;
- dynamic: ego OBB vs NPC and scenario vehicles (separating axis) and vs
  walkers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.plain_reference.frozen.ops.bev import boundary_inside
from bench_port.plain_reference.frozen.sim.dynamics import VehicleParams, VehicleState
from bench_port.plain_reference.frozen.sim.transforms import norm2, vec_global_to_ref


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
    """(N,) bool: the ego OBB overlaps one of the scene's O static-obstacle
    OBBs (``scene.ob_pose``/``ob_extent``): the separating-axis test over
    (N, O, 4 axes), no axis separating. The reference's collision sensor
    fires on any static actor (criteria/collision.py:49-112, layout
    penalty 0.65)."""
    if scene.ob_n == 0:
        return torch.zeros_like(ego.yaw, dtype=torch.bool)
    n, O = ego.yaw.shape[0], scene.ob_pose.shape[0]
    ego_ax = _axes(ego.yaw)                                   # (N, 2, 2)
    ob_ax = _axes(scene.ob_pose[:, 2])                        # (O, 2, 2)
    d = scene.ob_pose[None, :, :2] - ego.xy[:, None, :]       # (N, O, 2)
    all_ax = torch.cat([ego_ax[:, None].expand(n, O, 2, 2),
                        ob_ax[None].expand(n, O, 2, 2)], dim=2)
    proj_d = torch.abs(_dot2(all_ax, d[:, :, None, :]))       # (N, O, 4)
    m_ego = torch.abs(_dot2(all_ax[:, :, :, None, :],
                            ego_ax[:, None, None, :, :]))     # (N,O,4,2)
    r_ego = m_ego[..., 0] * params.half_length + (
        m_ego[..., 1] * params.half_width)
    m_ob = torch.abs(_dot2(all_ax[:, :, :, None, :],
                           ob_ax[None, :, None, :, :]))
    ext = scene.ob_extent[None, :, None, :]
    r_ob = m_ob[..., 0] * ext[..., 0] + m_ob[..., 1] * ext[..., 1]
    separated = (proj_d > r_ego + r_ob).any(dim=2)
    return (~separated).any(dim=1)


def _axes(yaw):
    """(..., 2, 2) box axes [[cos, sin], [-sin, cos]] of headings (...)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, s], dim=-1),
                        torch.stack([-s, c], dim=-1)], dim=-2)


def _dot2(a, b):
    """Dot product over a last axis of size 2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _first(hit):
    """(N,) index of the first True of each row of ``hit`` (N, M), 0 if
    there is none (``jnp.argmax`` of a bool row)."""
    return torch.argmax(hit.to(torch.uint8), dim=1)


def _heading_vel(speed, yaw):
    return speed[..., None] * torch.stack([torch.cos(yaw), torch.sin(yaw)],
                                          dim=-1)


def dynamic_collisions(traffic, params: VehicleParams,
                       ego: VehicleState) -> DynHits:
    """Ego vs NPC vehicles (OBB-OBB separating axis) and vs walkers
    (containment in the ego box inflated by 0.4 m); the ids are those of
    the first actor hit, and the intensity proxy is the relative speed."""
    n, K = traffic.veh_patrol.shape
    W = traffic.walker_patrol.shape[1]
    rows = torch.arange(n, device=ego.yaw.device)
    f = torch.zeros_like(ego.yaw, dtype=torch.bool)
    i = torch.zeros_like(ego.yaw, dtype=torch.int32)
    z = torch.zeros_like(ego.yaw)
    ego_vel = _heading_vel(ego.speed, ego.yaw)                # (N, 2)

    col_veh, veh_id, veh_rel = f, i, z
    if K > 0:
        hl, hw = params.half_length, params.half_width
        ego_ax = _axes(ego.yaw)                                # (N, 2, 2)
        npc_ax = _axes(traffic.veh.yaw)                        # (N, K, 2, 2)
        d = traffic.veh.xy - ego.xy[:, None, :]                # (N, K, 2)
        all_ax = torch.cat(
            [ego_ax[:, None].expand(n, K, 2, 2), npc_ax], dim=2
        )                                                      # (N, K, 4, 2)
        proj_d = torch.abs(_dot2(all_ax, d[:, :, None, :]))
        m_ego = torch.abs(_dot2(all_ax[:, :, :, None, :],
                                ego_ax[:, None, None, :, :]))  # (N,K,4,2)
        r_ego = m_ego[..., 0] * hl + m_ego[..., 1] * hw
        m_npc = torch.abs(_dot2(all_ax[:, :, :, None, :],
                                npc_ax[:, :, None, :, :]))
        r_npc = m_npc[..., 0] * hl + m_npc[..., 1] * hw
        hit = ~(proj_d > r_ego + r_npc).any(dim=2)             # (N, K)
        col_veh = hit.any(dim=1)
        k = _first(hit)
        veh_id = k.to(torch.int32)
        npc_vel = _heading_vel(traffic.veh.speed[rows, k],
                               traffic.veh.yaw[rows, k])
        veh_rel = norm2(ego_vel - npc_vel)

    col_ped, ped_id, ped_rel = f, i, z
    if W > 0:
        local = vec_global_to_ref(traffic.walker_xy - ego.xy[:, None, :],
                                  ego.yaw[:, None])
        inside = (
            (torch.abs(local[..., 0]) < params.half_length + 0.4)
            & (torch.abs(local[..., 1]) < params.half_width + 0.4)
        )
        col_ped = inside.any(dim=1)
        w = _first(inside)
        ped_id = w.to(torch.int32)
        w_vel = _heading_vel(traffic.walker_speed[rows, w],
                             traffic.walker_yaw[rows, w])
        ped_rel = norm2(ego_vel - w_vel)

    return DynHits(col_veh, col_ped, veh_id, ped_id, veh_rel, ped_rel)


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
