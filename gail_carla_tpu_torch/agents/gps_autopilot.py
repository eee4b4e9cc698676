"""GPS-space expert, batched over envs: port of
``gail_carla_tpu/agents/gps_autopilot.py`` (the reference's alternate
autopilot, ``auto_pilot/auto_pilot.py:11-71`` + ``planner.py:40-100``).

It navigates in GPS coordinates along the leaderboard plan
(``scene.plan_gps``): a pop-window route follower (pop distance 4e-5
degrees, look-ahead 50e-5), a window-40 steering PID (1.25 / 0.75 / 0.3)
on the heading angle to the near plan point over 90 degrees, a speed PID
(5 / 0.5 / 1) toward a fixed 4 m/s with the throttle clipped to 0.75,
and Gaussian steer noise of 1e-2 (an injectable draw).

The JAX version acts for one world and its tests vmap it under jit; this
one acts for N envs at once with the arithmetic XLA compiles there: the
division of the angle by 90 is a multiply by the float32 reciprocal, the
PID's window mean a tensor division. The 8-point plan window is a
``dynamic_slice`` whose start is clamped near the plan's end, so it stops
lining up with the indices it is masked by, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from gail_carla_tpu_torch.sim.cursor import take_row, take_window
from gail_carla_tpu_torch.sim.transforms import (
    gps_to_location, location_to_gps, norm2, recip_f32, vec_global_to_ref,
)

GPS_PID_WINDOW = 40      # pid_controller.py n=40
PLAN_WINDOW = 8          # plan points looked at per step
MIN_DIST_DEG = 4.0e-5    # near planner pop distance (auto_pilot.py:16)
MAX_DIST_DEG = 50.0e-5
TARGET_SPEED = 4.0       # m/s (auto_pilot.py:53)
STEER_NOISE = 1e-2
# jnp.rad2deg multiplies by the float32 180/pi
RAD2DEG = 180.0 / math.pi


@dataclasses.dataclass
class GpsPIDState:
    buf: torch.Tensor     # (N, GPS_PID_WINDOW) f32 error window
    idx: torch.Tensor     # (N,) i32 next write slot
    count: torch.Tensor   # (N,) i32 valid entries
    prev: torch.Tensor    # (N,) f32 last error


@dataclasses.dataclass
class GpsAutopilotState:
    turn_pid: GpsPIDState
    speed_pid: GpsPIDState
    near_idx: torch.Tensor   # (N,) i32 cursor into the plan


def _make_gps_pid(n: int, device) -> GpsPIDState:
    return GpsPIDState(
        buf=torch.zeros((n, GPS_PID_WINDOW), device=device),
        idx=torch.zeros(n, dtype=torch.int32, device=device),
        count=torch.zeros(n, dtype=torch.int32, device=device),
        prev=torch.zeros(n, device=device),
    )


def make_gps_autopilot(n: int, device="cpu") -> GpsAutopilotState:
    """The controller state of ``n`` envs, each at plan index 1."""
    return GpsAutopilotState(
        turn_pid=_make_gps_pid(n, device),
        speed_pid=_make_gps_pid(n, device),
        near_idx=torch.ones(n, dtype=torch.int32, device=device),
    )


def _gps_pid_step(st: GpsPIDState, error: torch.Tensor, kp: float,
                  ki: float, kd: float):
    """auto_pilot/pid_controller.py: the integral is the window's MEAN
    (not sum * dt), the derivative the last difference."""
    rows = torch.arange(error.shape[0], device=error.device)
    buf = st.buf.clone()
    buf[rows, st.idx.long()] = error
    count = torch.clamp(st.count + 1, max=GPS_PID_WINDOW)
    have2 = count >= 2
    integral = torch.where(
        have2, buf.sum(dim=1) / count.clamp_min(1).to(buf.dtype), 0.0)
    deriv = torch.where(have2, error - st.prev, 0.0)
    out = kp * error + ki * integral + kd * deriv
    return GpsPIDState(buf=buf, idx=(st.idx + 1) % GPS_PID_WINDOW,
                       count=count, prev=error), out


def draw_gps_noise(n: int, device,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """(N,) standard normal steer draws of one step."""
    return torch.randn(n, generator=generator, device=device)


def gps_autopilot_act(scene, ap: GpsAutopilotState, world,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
    """One step for N envs: (state', actions (N, 2)). Mirrors run_step
    (auto_pilot.py:61-71) with the plan-window cursor in place of the
    deque pop loop. ``world`` is a ``WorldState`` (its ego pose and speed
    and its route ids are read); ``noise`` (N,) holds the steer draws,
    drawn from ``generator`` when not given."""
    ego = world.ego
    rid = world.route_id
    pn = scene.plan_n[rid.long()]
    gps = location_to_gps(ego.xy)
    n = gps.shape[0]

    # pop-window: advance past plan points within MIN_DIST_DEG, looking
    # ahead while the cumulative plan distance stays within MAX_DIST_DEG
    # (planner.py:76-93); the window's start clamps near the plan's end
    offs = torch.arange(PLAN_WINDOW, device=gps.device)
    idxs = torch.minimum(ap.near_idx[:, None] + offs, pn[:, None] - 1)
    window = take_window(scene.plan_gps, rid, ap.near_idx, PLAN_WINDOW)
    d = norm2(window - gps[:, None, :])
    seg = norm2(window[:, 1:] - window[:, :-1])
    cum = torch.cat([torch.zeros_like(seg[:, :1]),
                     torch.cumsum(seg, dim=1)], dim=1)
    valid = (cum <= MAX_DIST_DEG) & (idxs < pn[:, None] - 1)
    popmask = (d <= MIN_DIST_DEG) & valid
    to_pop = torch.where(popmask, offs + 1, 0).amax(dim=1)
    near_idx = torch.minimum(ap.near_idx + to_pop, pn - 2).to(torch.int32)

    # heading angle to the near point, in degrees over 90
    # (auto_pilot.py:28-44), computed in the world frame
    target_xy = gps_to_location(take_row(scene.plan_gps, rid, near_idx))
    local = vec_global_to_ref(target_xy - ego.xy, ego.yaw)
    angle = torch.atan2(local[:, 1], local[:, 0]) * RAD2DEG * recip_f32(90.0)

    turn_pid, steer = _gps_pid_step(ap.turn_pid, angle, 1.25, 0.75, 0.3)
    steer = torch.clamp(steer, -1.0, 1.0)
    if noise is None:
        noise = draw_gps_noise(n, gps.device, generator)
    steer = torch.clamp(steer + STEER_NOISE * noise, -1.0, 1.0)

    delta = torch.clamp(TARGET_SPEED - ego.speed, 0.0, 0.25)
    speed_pid, throttle = _gps_pid_step(ap.speed_pid, delta, 5.0, 0.5, 1.0)
    throttle = torch.clamp(throttle, 0.0, 0.75)

    return (GpsAutopilotState(turn_pid=turn_pid, speed_pid=speed_pid,
                              near_idx=near_idx),
            torch.stack([steer, throttle], dim=-1))
