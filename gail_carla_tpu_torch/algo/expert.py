"""Expert demonstrations: the ``DemoBatch`` holder of
``gail_carla_tpu/algo/expert.py``. Demos are kept as compact (RenderState,
metrics, action) tuples; ``algo/buffers.py::build_expert_buffer`` compacts
them and renders their observations. The scripted expert that generates
them (``generate_demos``) is not ported yet."""
from __future__ import annotations

import dataclasses

import torch

from gail_carla_tpu_torch.algo.buffers import map_state


@dataclasses.dataclass
class DemoBatch:
    """(T, N, ...) expert transitions; obs re-renderable from ``render``."""

    render: object          # RenderState, leaves (T, N, ...)
    metrics: torch.Tensor   # (T, N, 4)
    actions: torch.Tensor   # (T, N, 2)
    valid: torch.Tensor     # (T, N) bool: inside a successful episode

    def flatten(self):
        t, n = self.actions.shape[:2]
        return (
            map_state(lambda a: a.reshape((t * n,) + a.shape[2:]),
                      self.render),
            self.metrics.reshape(-1, 4),
            self.actions.reshape(-1, 2),
            self.valid.reshape(-1),
        )
