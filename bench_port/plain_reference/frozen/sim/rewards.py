# Frozen copy of gail_carla_tpu_torch/sim/rewards.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Reward handlers, batched: port of ``gail_carla_tpu/sim/rewards.py``.

- ``delta_completion``: what training optimises (carla_env.py:148-153),
  computed inline in sim/env.py;
- ``valeo_action``: the dense shaped reward (valeo_action.py:26-132).

The hazard detectors port ``carla_gym/utils/hazard_actor.py`` over the
traffic tensors; with zero NPCs they report no hazard.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.plain_reference.frozen.sim import signals
from bench_port.plain_reference.frozen.sim.transforms import (
    cast_angle, deg2rad_f32, norm2, vec_global_to_ref,
)

MAX_SPEED = 6.0  # valeo_action.py:22


def hazard_vehicle(traffic, ego_xy, ego_yaw,
                   proximity_threshold: float = 9.5,
                   distance_threshold: float = 15.0):
    """lbc_hazard_vehicle (hazard_actor.py:16-29): the nearest
    same-heading vehicle within a 45 deg cone ahead. Returns (found (N,),
    dist (N,), 0 where none)."""
    if traffic.veh_patrol.shape[1] == 0:
        z = torch.zeros_like(ego_yaw)
        return torch.zeros_like(z, dtype=torch.bool), z
    veh = traffic.veh
    local = vec_global_to_ref(veh.xy - ego_xy[:, None, :], ego_yaw[:, None])
    dist = norm2(local)
    same_heading = torch.abs(cast_angle(veh.yaw - ego_yaw[:, None])
                             ) <= deg2rad_f32(150.0)
    angle = torch.abs(torch.atan2(local[..., 1], local[..., 0]))
    ahead = (angle < deg2rad_f32(45.0)) | (dist < 1e-3)
    hit = (same_heading & ahead & (dist < proximity_threshold)
           & (dist < distance_threshold))
    return _nearest(hit, dist)


def hazard_walker(traffic, ego_xy, ego_yaw,
                  proximity_threshold: float = 9.5):
    """lbc_hazard_walker (hazard_actor.py:32-46): a cone that widens as
    the walker comes closer. Returns (found (N,), dist (N,))."""
    if traffic.walker_patrol.shape[1] == 0:
        z = torch.zeros_like(ego_yaw)
        return torch.zeros_like(z, dtype=torch.bool), z
    local = vec_global_to_ref(traffic.walker_xy - ego_xy[:, None, :],
                              ego_yaw[:, None])
    dist = norm2(local)
    # a tensor numerator: torch evaluates ``162.0 / t`` as
    # ``reciprocal(t) * 162.0``, which rounds twice
    degree = torch.full_like(dist, 162.0) / (torch.clamp(dist, 1.5, 10.5)
                                             + 0.3)
    angle = torch.abs(torch.rad2deg(torch.atan2(local[..., 1],
                                                local[..., 0])))
    hit = ((angle < degree) | (dist < 1e-3)) & (dist < proximity_threshold)
    return _nearest(hit, dist)


def _nearest(hit, dist):
    found = hit.any(dim=1)
    d = torch.where(hit, dist, 1e9).amin(dim=1)
    return found, torch.where(found, d, 0.0)


class ValeoInputs(NamedTuple):
    ego_xy: torch.Tensor
    ego_yaw: torch.Tensor
    ego_speed: torch.Tensor
    steer: torch.Tensor
    last_steer: torch.Tensor
    route_tf_xy: torch.Tensor
    route_tf_yaw: torch.Tensor
    light_state: torch.Tensor
    light_dist: torch.Tensor
    stop_dist: torch.Tensor
    has_stop: torch.Tensor
    terminal_reward: torch.Tensor


def valeo_action_reward(traffic, inp: ValeoInputs):
    """valeo_action.py:26-132. Returns (reward, desired_speed)."""
    r_action = torch.where(
        torch.abs(inp.steer - inp.last_steer) > 0.01, -0.1, 0.0
    )

    veh_found, veh_dist = hazard_vehicle(traffic, inp.ego_xy, inp.ego_yaw)
    ped_found, ped_dist = hazard_walker(traffic, inp.ego_xy, inp.ego_yaw)

    def ramp(dist, margin):
        return MAX_SPEED * torch.clamp(
            torch.clamp_min(dist - margin, 0.0), 0.0, 5.0
        ) / 5.0

    spd_veh = torch.where(veh_found, ramp(veh_dist, 8.0), MAX_SPEED)
    spd_ped = torch.where(ped_found, ramp(ped_dist, 6.0), MAX_SPEED)
    red_or_yellow = (inp.light_state == signals.RED) | (
        inp.light_state == signals.YELLOW
    )
    spd_rl = torch.where(red_or_yellow, ramp(inp.light_dist, 5.0), MAX_SPEED)
    spd_stop = torch.where(inp.has_stop, ramp(inp.stop_dist, 5.0), MAX_SPEED)
    desired = torch.minimum(
        torch.minimum(torch.minimum(spd_veh, spd_ped), spd_rl),
        torch.clamp_max(spd_stop, MAX_SPEED),
    )

    r_speed = 1.0 - torch.abs(inp.ego_speed - desired) / MAX_SPEED

    d = inp.ego_xy - inp.route_tf_xy
    lateral = torch.abs(
        -torch.sin(inp.route_tf_yaw) * d[:, 0]
        + torch.cos(inp.route_tf_yaw) * d[:, 1]
    )
    r_position = -1.0 * (lateral / 2.0)
    r_rotation = -1.0 * torch.abs(cast_angle(inp.ego_yaw - inp.route_tf_yaw))

    reward = r_speed + r_position + r_rotation + inp.terminal_reward + r_action
    return reward, desired
