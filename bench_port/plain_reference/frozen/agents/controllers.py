# Frozen copy of gail_carla_tpu_torch/agents/controllers.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""PID controllers and LocalPlanner controller state, batched.

Port of ``gail_carla_tpu/agents/controllers.py`` (controller.py:4-29, the
window-30 PID, and local_planner.py:22-37, two PIDs plus the last
command). Every field carries the caller's leading batch axes, e.g.
(N envs, K NPCs).
"""
from __future__ import annotations

import dataclasses

import torch

PID_WINDOW = 30  # controller.py:5


@dataclasses.dataclass
class PIDState:
    """Ring buffer equivalent of controller.py's deque(maxlen=30). Unused
    slots are zero, so summing the whole buffer equals summing the window."""

    buf: torch.Tensor    # (..., PID_WINDOW) f32
    idx: torch.Tensor    # (...) i32 next write slot
    count: torch.Tensor  # (...) i32 samples held, at most PID_WINDOW
    prev: torch.Tensor   # (...) f32 previous error


@dataclasses.dataclass
class AutopilotState:
    turn_pid: PIDState
    speed_pid: PIDState
    last_command: torch.Tensor  # (...) i32, local_planner.py:37


def make_pid(shape, device) -> PIDState:
    shape = tuple(shape)
    return PIDState(
        buf=torch.zeros(shape + (PID_WINDOW,), device=device),
        idx=torch.zeros(shape, dtype=torch.int32, device=device),
        count=torch.zeros(shape, dtype=torch.int32, device=device),
        prev=torch.zeros(shape, device=device),
    )


def make_autopilot(shape, device) -> AutopilotState:
    return AutopilotState(
        turn_pid=make_pid(shape, device),
        speed_pid=make_pid(shape, device),
        last_command=torch.full(tuple(shape), 4, dtype=torch.int32,
                                device=device),
    )


def pid_step(state: PIDState, error: torch.Tensor, kp: float, ki: float,
             kd: float, dt: float = 0.1):
    """controller.py:14-29: integral = window sum * dt, derivative from the
    last two samples, both zero until two samples exist. Returns
    (state', output)."""
    buf = state.buf.scatter(-1, state.idx.long()[..., None], error[..., None])
    count = torch.clamp_max(state.count + 1, PID_WINDOW)
    have2 = count >= 2
    integral = torch.where(have2, buf.sum(dim=-1) * dt, 0.0)
    deriv = torch.where(have2, (error - state.prev) / dt, 0.0)
    out = kp * error + ki * integral + kd * deriv
    new = PIDState(
        buf=buf, idx=((state.idx + 1) % PID_WINDOW).to(torch.int32),
        count=count.to(torch.int32), prev=error,
    )
    return new, out
