"""WorldState: the complete simulation state of N envs as batched tensors.

Port of ``gail_carla_tpu/sim/state.py``. Every field carries a leading env
axis. The JAX state also carries its PRNG key; here randomness comes from
a ``torch.Generator`` (or injected draws) passed to reset and step. Only
the empty ``TrafficState`` and ``AutopilotState`` that zero NPCs need are
ported.
"""
from __future__ import annotations

import dataclasses

import torch

from gail_carla_tpu_torch.sim.dynamics import VehicleState

PID_WINDOW = 30  # controller.py:5


@dataclasses.dataclass
class PIDState:
    buf: torch.Tensor    # (N, K, PID_WINDOW)
    idx: torch.Tensor    # (N, K) i32
    count: torch.Tensor  # (N, K) i32
    prev: torch.Tensor   # (N, K) f32


@dataclasses.dataclass
class AutopilotState:
    turn_pid: PIDState
    speed_pid: PIDState
    last_command: torch.Tensor  # (N, K) i32


@dataclasses.dataclass
class TrafficState:
    """Background actors, K vehicles and W walkers per env. Only K = W = 0
    is ported; the tensors then have a zero-size second axis."""

    veh_xy: torch.Tensor           # (N, K, 2)
    veh_yaw: torch.Tensor          # (N, K)
    veh_ap: AutopilotState
    walker_xy: torch.Tensor        # (N, W, 2)
    walker_yaw: torch.Tensor       # (N, W)


def _empty_pid(n: int, device) -> PIDState:
    return PIDState(
        buf=torch.zeros((n, 0, PID_WINDOW), device=device),
        idx=torch.zeros((n, 0), dtype=torch.int32, device=device),
        count=torch.zeros((n, 0), dtype=torch.int32, device=device),
        prev=torch.zeros((n, 0), device=device),
    )


def make_empty_traffic(n_envs: int, device) -> TrafficState:
    z = torch.zeros((n_envs, 0), device=device)
    return TrafficState(
        veh_xy=torch.zeros((n_envs, 0, 2), device=device),
        veh_yaw=z,
        veh_ap=AutopilotState(
            turn_pid=_empty_pid(n_envs, device),
            speed_pid=_empty_pid(n_envs, device),
            last_command=torch.zeros((n_envs, 0), dtype=torch.int32,
                                     device=device),
        ),
        walker_xy=torch.zeros((n_envs, 0, 2), device=device),
        walker_yaw=z,
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


def tree_select(cond: torch.Tensor, a, b):
    """``where(cond, a, b)`` over every tensor of two states of the same
    dataclass structure; ``cond`` (N,) broadcasts over trailing axes."""
    if isinstance(a, torch.Tensor):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - 1))
        return torch.where(c, a, b)
    return type(a)(**{
        f.name: tree_select(cond, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
    })
