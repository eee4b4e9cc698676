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

from gail_carla_tpu_torch.sim import signals
from gail_carla_tpu_torch.sim.transforms import cast_angle

MAX_SPEED = 6.0  # valeo_action.py:22


def hazard_vehicle(traffic, ego_xy, ego_yaw):
    """lbc_hazard_vehicle (hazard_actor.py:16-29). Returns (found, dist);
    only the zero-NPC case is ported."""
    if traffic.veh_yaw.shape[1] != 0:
        raise NotImplementedError("NPC vehicles are not ported yet")
    z = torch.zeros_like(ego_yaw)
    return torch.zeros_like(z, dtype=torch.bool), z


def hazard_walker(traffic, ego_xy, ego_yaw):
    """lbc_hazard_walker (hazard_actor.py:32-46). Returns (found, dist);
    only the zero-walker case is ported."""
    if traffic.walker_yaw.shape[1] != 0:
        raise NotImplementedError("NPC walkers are not ported yet")
    z = torch.zeros_like(ego_yaw)
    return torch.zeros_like(z, dtype=torch.bool), z


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
