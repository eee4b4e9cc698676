"""Dynamic weather: closed-form port of ``gail_carla_tpu/sim/weather.py``
(``carla_gym/utils/dynamic_weather.py``).

The reference ticks two stateful objects every frame: ``Sun``
(dynamic_weather.py:34-48: phase ``t += 0.008*dt``, ``altitude =
70*sin(t) - 20``, ``azimuth += 0.25*dt``) and ``Storm`` (dynamic_weather.
py:51-81: a +-1.3/s triangle wave of an internal ``_t`` clamped to [-250,
100], read out as clouds, rain, puddles, wetness, wind and fog).
``WeatherHandler`` (ibid.:84-127) pins a named preset or, for
``'dynamic[_speed]'``, picks a random pool preset and evolves it;
``task_vehicle.py:175-181`` turns the headlights on whenever the sun is
below the horizon.

``weather_at(params, t)`` is the closed form of those recurrences after
``t`` seconds of sim time, on tensors of any shape. ``make_weather`` draws
from a Python ``random.Random`` exactly as the JAX version does, so both
packages pick the same preset and sun phase from the same seed. Weather
is visual only: it lights the pseudo-cameras (``ops/camera.py``).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional, Tuple

import numpy as np
import torch

from gail_carla_tpu_torch.sim.transforms import py_mod

# CARLA's stock presets (the public WeatherParameters constants), as
# (cloudiness, precipitation, precipitation_deposits, wind_intensity,
#  sun_azimuth_angle, sun_altitude_angle). Only azimuth + precipitation
# seed the dynamic evolution (Sun.__init__/Storm.__init__); the rest is
# what a pinned preset reports.
PRESETS = {
    "ClearNoon": (15.0, 0.0, 0.0, 0.35, 0.0, 75.0),
    "ClearSunset": (15.0, 0.0, 0.0, 0.35, 0.0, 15.0),
    "CloudyNoon": (80.0, 0.0, 0.0, 0.35, 0.0, 75.0),
    "CloudySunset": (80.0, 0.0, 0.0, 0.35, 0.0, 15.0),
    "WetNoon": (20.0, 0.0, 50.0, 0.35, 0.0, 75.0),
    "WetSunset": (20.0, 0.0, 50.0, 0.35, 0.0, 15.0),
    "MidRainyNoon": (80.0, 30.0, 50.0, 0.40, 0.0, 75.0),
    "MidRainSunset": (80.0, 30.0, 50.0, 0.40, 0.0, 15.0),
    "WetCloudyNoon": (80.0, 0.0, 50.0, 0.35, 0.0, 75.0),
    "WetCloudySunset": (80.0, 0.0, 50.0, 0.35, 0.0, 15.0),
    "HardRainNoon": (90.0, 60.0, 100.0, 1.0, 0.0, 75.0),
    "HardRainSunset": (90.0, 60.0, 100.0, 1.0, 0.0, 15.0),
    "SoftRainNoon": (70.0, 15.0, 50.0, 0.35, 0.0, 75.0),
    "SoftRainSunset": (70.0, 15.0, 50.0, 0.35, 0.0, 15.0),
}

# WeatherHandler.reset's dynamic pool (dynamic_weather.py:6-27)
DYNAMIC_POOL = list(PRESETS)


@dataclasses.dataclass(frozen=True)
class WeatherParams:
    """One weather parameterisation, host float32 values. ``dynamic`` is
    0.0 (``static`` reported verbatim) or 1.0 (the closed-form evolution
    from ``sun_t0``, ``az0`` and ``storm_t0`` at ``speed`` x real time)."""

    dynamic: float
    speed: float
    sun_t0: float
    az0: float
    storm_t0: float
    static: Tuple[float, ...]   # the pinned preset row (6,)


@dataclasses.dataclass
class Weather:
    """What ``world.get_weather()`` reports (dynamic_weather.py:113-121),
    each a tensor of the shape of the sim time it was evaluated at."""

    cloudiness: torch.Tensor
    precipitation: torch.Tensor
    precipitation_deposits: torch.Tensor
    wind_intensity: torch.Tensor
    fog_density: torch.Tensor
    wetness: torch.Tensor
    sun_azimuth_angle: torch.Tensor
    sun_altitude_angle: torch.Tensor


def _f32(v) -> float:
    return float(np.float32(v))


def make_weather(cfg_weather: str,
                 py_rng: Optional[random.Random] = None) -> WeatherParams:
    """WeatherHandler.reset (dynamic_weather.py:89-106): a preset name
    pins that preset; ``'dynamic'`` / ``'dynamic_<speed>'`` samples a pool
    preset and evolves it. Unknown names fall back to ClearNoon."""
    py_rng = py_rng or random.Random(0)
    if cfg_weather in PRESETS:
        row = PRESETS[cfg_weather]
        return WeatherParams(
            dynamic=0.0, speed=0.0, sun_t0=0.0, az0=_f32(row[4]),
            storm_t0=0.0, static=tuple(_f32(v) for v in row))
    if "dynamic" in cfg_weather:
        row = PRESETS[py_rng.choice(DYNAMIC_POOL)]
        parts = cfg_weather.split("_")
        speed = float(parts[1]) if len(parts) == 2 else 1.0
        precip = row[1]
        return WeatherParams(
            dynamic=1.0, speed=_f32(speed),
            sun_t0=_f32(py_rng.uniform(0.0, 2.0 * math.pi)),
            az0=_f32(row[4]),
            storm_t0=_f32(precip if precip > 0.0 else -50.0),
            static=tuple(_f32(v) for v in row))
    return make_weather("ClearNoon", py_rng)


def weather_at(wp: WeatherParams, t_seconds: torch.Tensor) -> Weather:
    """Closed form of Sun.tick/Storm.tick after ``t_seconds`` (float32
    tensor) of sim time, x ``wp.speed``, including the reference's priming
    ``tick(0.1)`` at reset (dynamic_weather.py:103)."""
    s = (t_seconds.to(torch.float32) + 0.1) * wp.speed

    # Sun (dynamic_weather.py:41-45)
    t_sun = wp.sun_t0 + 0.008 * s
    altitude = 70.0 * torch.sin(t_sun) - 20.0
    azimuth = py_mod(wp.az0 + 0.25 * s, 360.0)

    # Storm (dynamic_weather.py:62-75): _t walks +-1.3/s between the
    # rails -250 and 100, an exact triangle wave of period 700 in
    # walk-distance units, anchored at storm_t0 ascending
    pos = py_mod(wp.storm_t0 + 250.0 + 1.3 * s, 700.0)
    increasing = pos <= 350.0
    storm_t = torch.where(increasing, pos, 700.0 - pos) - 250.0

    clouds = torch.clamp(storm_t + 40.0, 0.0, 90.0)
    rain = torch.clamp(storm_t, 0.0, 80.0)
    delay = torch.where(increasing, -10.0, 90.0)
    puddles = torch.clamp(storm_t + delay, 0.0, 85.0)
    wetness = torch.clamp(storm_t * 5.0, 0.0, 100.0)
    wind = torch.where(clouds <= 20.0, 5.0,
                       torch.where(clouds >= 70.0, 90.0, 40.0))
    fog = torch.clamp(storm_t - 10.0, 0.0, 30.0)

    st, d = wp.static, wp.dynamic

    def mix(dyn, fixed):
        return d * dyn + (1.0 - d) * fixed

    return Weather(
        cloudiness=mix(clouds, st[0]),
        precipitation=mix(rain, st[1]),
        precipitation_deposits=mix(puddles, st[2]),
        wind_intensity=mix(wind, st[3]),
        fog_density=mix(fog, 0.0),
        wetness=mix(wetness, 0.0),
        sun_azimuth_angle=mix(azimuth, st[4]),
        sun_altitude_angle=mix(altitude, st[5]),
    )


def headlights_on(weather: Weather) -> torch.Tensor:
    """task_vehicle.py:175-181: Position|LowBeam whenever the sun is below
    the horizon."""
    return weather.sun_altitude_angle < 0.0


def sun_brightness(weather: Weather) -> torch.Tensor:
    """Ambient light factor of the pseudo-cameras (ops/camera.py): 1.0 at
    high noon, 0.25 under a below-horizon sun (a smooth ramp on the sun's
    altitude for the UE4 renderer's day/night swing)."""
    alt = weather.sun_altitude_angle
    return 0.25 + 0.75 * torch.clamp(alt / 60.0, 0.0, 1.0)
