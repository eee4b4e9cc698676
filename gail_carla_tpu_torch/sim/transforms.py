"""2D rigid-frame geometry on batched tensors, and the GPS conversion (of
tensors, and in numpy for the host scene builder).

Port of ``gail_carla_tpu/sim/transforms.py``. Conventions: positions are
metres in the world frame (x east, y "CARLA south"), ``yaw`` in radians.
Every function broadcasts over leading batch dimensions and keeps the JAX
version's float32 op order, so results agree to the ulp on the same
inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

EARTH_RADIUS_EQUA = 6378137.0  # route_manipulation.py:20
PI = math.pi
TWO_PI = 2.0 * math.pi


def cast_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle to [-pi, pi) the way ``jnp.mod(theta + pi, 2 pi) - pi``
    does: a truncated remainder shifted into the divisor's sign."""
    return py_mod(theta + PI, TWO_PI) - PI


def norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of size 2, summed in the order
    ``jnp.linalg.norm`` uses."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def vec_global_to_ref(vec: torch.Tensor, ref_yaw: torch.Tensor):
    """Express a world-frame 2D vector in a frame rotated by ``ref_yaw``."""
    c, s = torch.cos(ref_yaw), torch.sin(ref_yaw)
    x = vec[..., 0] * c + vec[..., 1] * s
    y = -vec[..., 0] * s + vec[..., 1] * c
    return torch.stack([x, y], dim=-1)


def location_to_gps(xy: torch.Tensor) -> torch.Tensor:
    """World metres -> (lat, lon) degrees, Web-Mercator at the equator
    (route_manipulation.py:23-29), latitude through the Gudermannian form
    as in ``location_to_gps_np``."""
    lon = xy[..., 0] * 180.0 / (math.pi * EARTH_RADIUS_EQUA)
    lat = (360.0 / math.pi) * torch.atan(
        torch.tanh(-xy[..., 1] / (2.0 * EARTH_RADIUS_EQUA))
    )
    return torch.stack([lat, lon], dim=-1)


def location_to_gps_np(xy: np.ndarray) -> np.ndarray:
    """World metres -> (lat, lon) degrees, Web-Mercator at the equator,
    in float32 with the op order of the JAX ``location_to_gps``
    (route_manipulation.py:23-29; latitude through the Gudermannian form
    atan(tanh(u/2)), which keeps float32 precision near the origin)."""
    xy = np.asarray(xy, np.float32)
    lon = xy[..., 0] * np.float32(180.0) / np.float32(
        math.pi * EARTH_RADIUS_EQUA
    )
    lat = np.float32(360.0 / math.pi) * np.arctan(
        np.tanh(-xy[..., 1] / np.float32(2.0 * EARTH_RADIUS_EQUA))
    )
    return np.stack([lat, lon], axis=-1).astype(np.float32)


def py_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.remainder`` (Python ``%``) for a positive float divisor: the
    truncated remainder shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def deg2rad_f32(deg: float) -> float:
    """``jnp.deg2rad`` of a Python float: the float32 product of the
    float32 degrees and the float32 factor pi/180."""
    return float(np.float32(deg) * np.float32(math.pi / 180.0))


def div_const_add(a: torch.Tensor, divisor: float, addend: float):
    """``a / divisor + addend`` for a float32 ``a`` as XLA compiles it
    inside jit: the division by a constant becomes a multiply by the
    float32 reciprocal, fused with the add into one rounding (an FMA).
    Computed in float64, where the product of two float32 values is exact,
    then rounded once to float32."""
    recip = float(np.float32(1.0) / np.float32(divisor))
    return (a.double() * recip + addend).float()
