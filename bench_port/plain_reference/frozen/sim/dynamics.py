# Frozen copy of gail_carla_tpu_torch/sim/dynamics.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Vehicle dynamics: kinematic bicycle model at the reference's 10 Hz tick.

Port of ``gail_carla_tpu/sim/dynamics.py`` on batched tensors: every
field of ``VehicleState`` carries a leading batch axis, and the arithmetic
keeps the JAX version's float32 op order.
"""
from __future__ import annotations

import dataclasses

import torch

from bench_port.plain_reference.frozen.sim.transforms import cast_angle


@dataclasses.dataclass
class VehicleState:
    xy: torch.Tensor       # (..., 2) world position, metres
    yaw: torch.Tensor      # (...) heading, radians
    speed: torch.Tensor    # (...) forward speed, m/s


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Static physical parameters (Lincoln MKZ-class hero vehicle)."""

    wheelbase: float = 2.9
    lr: float = 1.45
    max_steer: float = 0.6109
    max_accel: float = 3.8
    max_brake: float = 8.0
    max_speed: float = 30.0
    roll_drag: float = 0.08
    quad_drag: float = 0.0035
    engine_brake: float = 0.6
    half_length: float = 2.45
    half_width: float = 1.06
    substeps: int = 4


DEFAULT_VEHICLE = VehicleParams()


def step_vehicle(
    state: VehicleState,
    steer: torch.Tensor,
    throttle: torch.Tensor,
    brake: torch.Tensor,
    dt: float = 0.1,
    params: VehicleParams = DEFAULT_VEHICLE,
) -> VehicleState:
    """Advance one sim tick; controls mirror ``carla.VehicleControl``."""
    steer = torch.clamp(steer, -1.0, 1.0)
    throttle = torch.clamp(throttle, 0.0, 1.0)
    brake = torch.clamp(brake, 0.0, 1.0)

    delta = steer * params.max_steer
    beta = torch.atan(params.lr / params.wheelbase * torch.tan(delta))

    h = dt / params.substeps
    xy, yaw, v = state.xy, state.yaw, state.speed
    for _ in range(params.substeps):
        accel = (
            throttle * params.max_accel * (1.0 - v / params.max_speed)
            - brake * params.max_brake
            - (1.0 - throttle) * params.engine_brake * torch.sign(v)
            - params.roll_drag * torch.sign(v)
            - params.quad_drag * v * torch.abs(v)
        )
        v = torch.clamp_min(v + accel * h, 0.0)  # no reverse gear
        course = yaw + beta
        xy = xy + h * v[..., None] * torch.stack(
            [torch.cos(course), torch.sin(course)], dim=-1
        )
        yaw = cast_angle(yaw + h * v / params.lr * torch.sin(beta))

    return VehicleState(xy=xy, yaw=yaw, speed=v)
