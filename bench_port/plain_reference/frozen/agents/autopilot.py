# Frozen copy of gail_carla_tpu_torch/agents/autopilot.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""The scripted agent, batched: the reference's BasicAgent /
LocalPlanner / PID stack.

Port of ``gail_carla_tpu/agents/autopilot.py``:
- ``local_planner_act``: target-waypoint selection + 2 PIDs
  (local_planner.py:22-78 with the controller.py PIDs); the background
  vehicles drive their patrols with it;
- ``autopilot_act``: the expert (BasicAgent, carla_exp.py:49-53), the
  LocalPlanner over the ego's dense route, optionally capped for signals
  and hazards;
- ``reset_autopilot_where``: fresh controllers at episode ends.
"""
from __future__ import annotations

import torch

from bench_port.plain_reference.frozen.agents.controllers import (
    AutopilotState, make_autopilot, pid_step,
)
from bench_port.plain_reference.frozen.sim import signals
from bench_port.plain_reference.frozen.sim.cursor import take_window
from bench_port.plain_reference.frozen.sim.rewards import hazard_vehicle, hazard_walker
from bench_port.plain_reference.frozen.sim.state import WorldState, tree_select
from bench_port.plain_reference.frozen.sim.transforms import (
    div_const_add, norm2, vec_global_to_ref,
)

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


# the expert's route scan for stop lines: the next ROUTE_SCAN segments
ROUTE_SCAN = 64


def _cap(dist: torch.Tensor, margin: float, a: float = 0.45):
    """Coast-to-stop speed cap: the action space has no brake
    (carla_env.py:93-94), so slowing relies on engine braking:
    v_max(d) = sqrt(2 a (d - margin))."""
    return torch.sqrt(2.0 * a * torch.clamp_min(dist - margin, 0.0))


def _signal_speed(scene, world: WorldState, tspeed: torch.Tensor):
    """The target speed (N,) capped for red and yellow lights, stop signs
    not yet completed and lead vehicles and walkers (``autopilot.py:
    122-256``, a leaderboard-clean expert the reference never had)."""
    ego = world.ego
    n = ego.speed.shape[0]
    ar = torch.arange(n, device=ego.speed.device)
    t_now = world.step.to(torch.float32) * 0.1
    tl_states = signals.light_states(scene, t_now)
    state_f, loc_f, idx_f = signals.affecting_light(
        scene, ego.xy, ego.yaw, tl_states, dist_threshold=50.0,
        lateral_slack=0.6,
    )
    # Route-scan detection: the pose-based query sees a light only once
    # the ego projects onto its stop span, too late on curved approaches;
    # the expert knows its route, so it scans the next ~64 m of it for the
    # first stop line it crosses (in the line's inbound direction) and
    # measures the distance along the route. The pose query is the
    # fallback.
    win = take_window(scene.route_xy, world.route_id, world.head,
                      ROUTE_SCAN + 1)                        # (N, 65, 2)
    wa, wb = win[:, :-1], win[:, 1:]
    seglen = norm2(wb - wa)                                  # (N, 64)
    cum = torch.cumsum(seglen, dim=1) - seglen
    segdir = torch.atan2(wb[..., 1] - wa[..., 1], wb[..., 0] - wa[..., 0])
    tl_a, tl_b = scene.tl_stop[:, 0], scene.tl_stop[:, 1]
    inter = signals.segments_intersect(
        wa[:, :, None, :], wb[:, :, None, :], tl_a[None, None],
        tl_b[None, None],
    )                                                        # (N, 64, T)
    n_tl = tl_a.shape[0]
    tl_ok = (
        (torch.cos(scene.tl_yaw[None, None, :] - segdir[..., None]) > 0.5)
        & (seglen[..., None] > 1e-3)
        & (torch.arange(n_tl, device=ar.device) < scene.tl_n)
    )
    valid_wt = inter & tl_ok
    any_w = valid_wt.any(dim=2)
    found_r = any_w.any(dim=1)
    # the first crossed segment, then its first light (argmax of an
    # integer cast: the first maximum, as jnp.argmax of a bool array)
    first_w = torch.argmax(any_w.to(torch.int32), dim=1)
    idx_r = torch.argmax(valid_wt[ar, first_w].to(torch.int32), dim=1)
    d_route = (cum[ar, first_w] + norm2(win[:, 0] - ego.xy)
               + 0.5 * seglen[ar, first_w])
    found_f = idx_f >= 0
    idx = torch.where(found_r, idx_r, torch.where(found_f, idx_f.long(), -1))
    d_line = torch.where(found_r, d_route, norm2(loc_f))
    state = torch.where(found_r, tl_states[ar, idx_r],
                        torch.where(found_f, state_f, -1))

    # Stop or commit: predict the colour at the instant the ego's tail
    # would clear the stop line if it commits (accelerating at ~1 m/s^2
    # from its speed, then cruising; +0.5 s margin), and coast only when
    # that colour is red and the stop is still feasible.
    found = idx >= 0
    d_tail = d_line + 6.5
    v0 = torch.clamp_min(ego.speed, 0.0)
    a_acc = 1.0
    t_ramp = torch.clamp_min(tspeed - v0, 0.0) / a_acc
    d_ramp = (torch.square(tspeed) - torch.square(v0)) / (2.0 * a_acc)
    t_clear = torch.where(
        d_tail <= d_ramp,
        (torch.sqrt(torch.square(v0) + 2.0 * a_acc * d_tail) - v0) / a_acc,
        t_ramp + (d_tail - torch.clamp_min(d_ramp, 0.0))
        / torch.clamp_min(tspeed, 1.0),
    ) + 0.5
    state_at_clear = signals.light_states(scene, t_now + t_clear)[
        ar, torch.clamp_min(idx, 0)]
    want_stop = (state == signals.RED) | (state_at_clear == signals.RED)
    can_stop = d_line > div_const_add(torch.square(ego.speed), 2.0 * 0.45,
                                      2.5)
    spd_rl = torch.where(found & want_stop & can_stop, _cap(d_line, 4.0),
                         tspeed)

    ss_active = (world.stop_target >= 0) & ~world.stop_completed
    tgt = torch.clamp_min(world.stop_target, 0).long()
    d_stop = norm2(scene.ss_center[tgt] - ego.xy)
    spd_stop = torch.where(ss_active, _cap(d_stop, 2.0), tspeed)

    # look as far ahead as the coast-only braking distance needs
    # (v^2 / 2a + margin, ~48 m at 6 m/s)
    veh_found, d_veh = hazard_vehicle(
        world.traffic, ego.xy, ego.yaw, proximity_threshold=48.0,
        distance_threshold=48.0,
    )
    ped_found, d_ped = hazard_walker(world.traffic, ego.xy, ego.yaw,
                                     proximity_threshold=30.0)
    spd_veh = torch.where(veh_found, _cap(d_veh, 8.0), tspeed)
    spd_ped = torch.where(ped_found, _cap(d_ped, 6.0), tspeed)
    return torch.minimum(
        tspeed,
        torch.minimum(torch.minimum(spd_rl, spd_stop),
                      torch.minimum(spd_veh, spd_ped)),
    )


def autopilot_act(scene, ap: AutopilotState, world: WorldState,
                  target_speed: float = TARGET_SPEED,
                  obey_signals: bool = False):
    """The expert (BasicAgent, carla_exp.py:49) for N envs: the
    LocalPlanner over each ego's dense route. Returns (state', action
    (N, 2)).

    ``obey_signals=False`` matches the reference: BasicAgent's red-light
    and hazard checks are disabled (basic_agent.py:32). ``obey_signals=
    True`` caps the target speed for red and yellow lights, stop signs and
    lead hazards (``_signal_speed``)."""
    ego = world.ego
    tspeed = torch.full_like(ego.speed, target_speed)
    if obey_signals:
        tspeed = _signal_speed(scene, world, tspeed)
    return local_planner_act(scene.route_xy, scene.route_cmd, ap, ego.xy,
                             ego.yaw, ego.speed, world.route_id, world.head,
                             tspeed)


def reset_autopilot_where(done: torch.Tensor,
                          ap: AutopilotState) -> AutopilotState:
    """Fresh controllers where ``done`` (N,) (a new BasicAgent is built per
    episode in carla_exp.py:49)."""
    return tree_select(done, make_autopilot(done.shape, done.device), ap)
