"""The LocalPlanner decision of the scripted driver, batched.

Port of ``gail_carla_tpu/agents/autopilot.py::local_planner_act``
(local_planner.py:22-78 with the controller.py PIDs). The background
vehicles drive their patrols with it; the expert (``autopilot_act``)
comes with the demo slice.
"""
from __future__ import annotations

import torch

from gail_carla_tpu_torch.agents.controllers import AutopilotState, pid_step
from gail_carla_tpu_torch.sim.cursor import take_window
from gail_carla_tpu_torch.sim.transforms import norm2, vec_global_to_ref

# local_planner.py defaults
LON_PID = (0.5, 0.025, 0.1)
LAT_PID = (0.75, 0.05, 0.0)
THRESHOLD_BEFORE = 7.5
THRESHOLD_AFTER = 5.0
MAX_SKIP = 20
TARGET_SPEED = 6.0  # m/s, carla_exp.py:49


def local_planner_act(route_xy, route_cmd, ap: AutopilotState, ego_xy,
                      ego_yaw, ego_speed, rid, head, target_speed):
    """One LocalPlanner decision for every vehicle of a batch (any leading
    shape, e.g. (N envs, K NPCs)) over a padded route family (ego routes
    or NPC patrols): scan the next 20 route points; each point within the
    threshold becomes the new target and updates the last command
    *sequentially* (the threshold of later points depends on earlier
    updates). Returns (state', action (..., 2) = steer, throttle)."""
    lead = rid.shape
    # the 20-point window starts at the cursor, clamped into the row as
    # ``dynamic_slice`` clamps it (the window shifts near the row end)
    pts = take_window(route_xy, rid.reshape(-1), head.reshape(-1),
                      MAX_SKIP).reshape(lead + (MAX_SKIP, 2))
    opts = take_window(route_cmd, rid.reshape(-1), head.reshape(-1),
                       MAX_SKIP).reshape(lead + (MAX_SKIP,))
    dists = norm2(pts - ego_xy[..., None, :])

    last_cmd = ap.last_command
    target_i = torch.full_like(last_cmd, -1)
    for i in range(MAX_SKIP):
        opt = opts[..., i]
        thresh = torch.where((last_cmd == 4) & (opt != 4), THRESHOLD_BEFORE,
                             THRESHOLD_AFTER)
        hit = dists[..., i] < thresh
        last_cmd = torch.where(hit, opt, last_cmd)
        target_i = torch.where(hit, i, target_i)
    # local_planner.py:52-53: step one past the last point within threshold
    target_i = torch.clamp_max(target_i + 1, MAX_SKIP - 1).long()
    target_cmd = torch.gather(opts, -1, target_i[..., None])[..., 0]
    target_xy = torch.gather(
        pts, -2, target_i[..., None, None].expand(lead + (1, 2)))[..., 0, :]

    local = vec_global_to_ref(target_xy - ego_xy, ego_yaw)
    theta = torch.atan2(local[..., 1], local[..., 0])
    turn_pid, steer = pid_step(ap.turn_pid, theta, *LAT_PID)

    # slow down off lane-follow/straight (local_planner.py:66-67)
    tspeed = torch.where((target_cmd == 3) | (target_cmd == 4), target_speed,
                         target_speed * 0.75)
    delta = tspeed - ego_speed
    speed_pid, throttle = pid_step(ap.speed_pid, delta, *LON_PID)

    action = torch.stack([torch.clamp(steer, -1.0, 1.0),
                          torch.clamp(throttle, 0.0, 1.0)], dim=-1)
    return AutopilotState(turn_pid=turn_pid, speed_pid=speed_pid,
                          last_command=last_cmd.to(torch.int32)), action
