"""Minimal gym-compatible space descriptions: port of
``gail_carla_tpu/envs/spaces.py`` (a numpy copy; the reference exposes Box
spaces from carla_env.py:93-100)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Box:
    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: type = np.float32

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return rng.uniform(self.low, self.high, self.shape).astype(
            self.dtype
        )

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool((x >= self.low).all())
            and bool((x <= self.high).all())
        )
