# Frozen copy of gail_carla_tpu_torch/sim/state.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""WorldState: the complete simulation state of N envs as batched tensors.

Port of ``gail_carla_tpu/sim/state.py``. Every field carries a leading env
axis. The JAX state also carries its PRNG key; here randomness comes from
a ``torch.Generator`` (or injected draws) passed to reset and step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bench_port.plain_reference.frozen.agents.controllers import (
    AutopilotState, make_autopilot,
)
from bench_port.plain_reference.frozen.sim.dynamics import VehicleState


@dataclasses.dataclass
class TrafficState:
    """Background actors, K vehicles and W walkers per env (K = W = 0
    disables traffic; the tensors then have a zero-size second axis).
    Vehicles drive lane-graph patrols with the LocalPlanner; walkers
    follow a patrol polyline at a signed lateral offset (the pavement
    band), and a crossing moves the offset to the other side."""

    veh: VehicleState              # (N, K, ...) vehicle states
    veh_patrol: torch.Tensor       # (N, K) i32 patrol route id
    veh_head: torch.Tensor         # (N, K) i32 patrol cursor
    veh_ap: AutopilotState         # (N, K) LocalPlanner controller state
    veh_target_speed: torch.Tensor  # (N, K) f32
    walker_xy: torch.Tensor        # (N, W, 2)
    walker_yaw: torch.Tensor       # (N, W)
    walker_patrol: torch.Tensor    # (N, W) i32 polyline id
    walker_head: torch.Tensor      # (N, W) i32 polyline cursor
    walker_off: torch.Tensor       # (N, W) f32 current signed offset
    walker_off_t: torch.Tensor     # (N, W) f32 target offset
    walker_speed: torch.Tensor     # (N, W) 1-2 m/s


def make_empty_traffic(n_envs: int, n_veh: int, n_walkers: int,
                       device) -> TrafficState:
    """Traffic tensors at their initial values: every vehicle parked at
    the origin with a fresh controller, every walker at the origin."""
    k = (n_envs, n_veh)
    w = (n_envs, n_walkers)
    zi = dict(dtype=torch.int32, device=device)
    return TrafficState(
        veh=VehicleState(
            xy=torch.zeros(k + (2,), device=device),
            yaw=torch.zeros(k, device=device),
            speed=torch.zeros(k, device=device),
        ),
        veh_patrol=torch.zeros(k, **zi),
        veh_head=torch.zeros(k, **zi),
        veh_ap=make_autopilot(k, device),
        veh_target_speed=torch.full(k, 5.5, device=device),
        walker_xy=torch.zeros(w + (2,), device=device),
        walker_yaw=torch.zeros(w, device=device),
        walker_patrol=torch.zeros(w, **zi),
        walker_head=torch.zeros(w, **zi),
        walker_off=torch.zeros(w, device=device),
        walker_off_t=torch.zeros(w, device=device),
        walker_speed=torch.ones(w, device=device),
    )


@dataclasses.dataclass
class HistoryState:
    """20-tick ring of dynamic-actor snapshots per env for the full BEV
    mask stack (chauffeurnet.py:48's deque(maxlen=20)). Allocated only
    when ``EnvConfig.full_bev`` is on."""

    veh_pose: torch.Tensor     # (N, 20, K, 3) x, y, yaw
    walker_pose: torch.Tensor  # (N, 20, W, 3)
    tl_state: torch.Tensor     # (N, 20, T) i8 light states
    stop_active: torch.Tensor  # (N, 20, S) bool un-completed target sign
    idx: torch.Tensor          # (N,) i32 next write slot
    count: torch.Tensor        # (N,) i32 valid entries


HISTORY_LEN = 20


def make_empty_history(n_envs: int, n_veh: int, n_walkers: int, n_tl: int,
                       n_ss: int, device) -> HistoryState:
    ring = (n_envs, HISTORY_LEN)
    return HistoryState(
        veh_pose=torch.zeros(ring + (n_veh, 3), device=device),
        walker_pose=torch.zeros(ring + (n_walkers, 3), device=device),
        tl_state=torch.zeros(ring + (n_tl,), dtype=torch.int8,
                             device=device),
        stop_active=torch.zeros(ring + (n_ss,), dtype=torch.bool,
                                device=device),
        idx=torch.zeros(n_envs, dtype=torch.int32, device=device),
        count=torch.zeros(n_envs, dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class WorldState:
    # ego vehicle
    ego: VehicleState
    last_steer: torch.Tensor        # (N,) f32
    # route progress (task_vehicle.py)
    route_id: torch.Tensor          # (N,) i32
    head: torch.Tensor              # (N,) i32 dense-route cursor
    last_head: torch.Tensor         # (N,) i32
    start_idx: torch.Tensor         # (N,) i32
    s0: torch.Tensor                # (N,) f32 arc length at spawn
    route_len_ep: torch.Tensor      # (N,) f32
    plan_idx: torch.Tensor          # (N,) i32 gnss target index
    # criteria accumulators
    blocked_elapsed: torch.Tensor
    out_route_dist: torch.Tensor
    stop_target: torch.Tensor
    stop_completed: torch.Tensor
    stop_affected: torch.Tensor
    encountered_light: torch.Tensor
    last_red_light: torch.Tensor
    last_cross_light: torch.Tensor
    # valeo terminal state (terminal/valeo.py:26-33)
    speed_q: torch.Tensor           # (N, 10)
    speed_q_len: torch.Tensor
    stuck_counter: torch.Tensor
    last_lat_dist: torch.Tensor
    # collision-event dedup memory
    col_xy: torch.Tensor            # (N, 2)
    col_time: torch.Tensor
    col_id: torch.Tensor
    # episode infraction counters
    n_col_static: torch.Tensor
    n_col_vehicle: torch.Tensor
    n_col_walker: torch.Tensor
    n_red: torch.Tensor
    n_stop: torch.Tensor
    n_enc_light: torch.Tensor
    n_enc_stop: torch.Tensor
    outside_lane_m: torch.Tensor
    wrong_lane_m: torch.Tensor
    # episode bookkeeping
    step: torch.Tensor
    episode_reward: torch.Tensor
    last_total: torch.Tensor
    # curriculum carry, persists across auto-resets
    resume_idx: torch.Tensor
    completed_last: torch.Tensor
    # traffic
    traffic: TrafficState
    # BEV actor history (None unless EnvConfig.full_bev)
    history: Optional[HistoryState] = None


def tree_select(cond: torch.Tensor, a, b):
    """``where(cond, a, b)`` over every tensor of two states of the same
    dataclass structure; ``cond`` ((N,) or (N, K)) broadcasts over the
    trailing axes."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)
    return type(a)(**{
        f.name: tree_select(cond, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
    })
