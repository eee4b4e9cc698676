# Frozen copy of gail_carla_tpu_torch/algo/optim.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""The optimizer of both updates, ported by hand from optax 0.2.6:
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, b1, b2,
eps))`` with an optional linear-decay learning rate
(``gail_carla_tpu/algo/ppo.py:26-48``, ``algo/wdgail.py:28-51``).

Where it differs from torch's own tools:

- Clip: the gradients are left alone when their global norm is below
  ``max_norm``, else each becomes ``(g / norm) * max_norm``
  (``clip_grad_norm_`` divides by ``norm + 1e-6``).
- Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, then with
  the count incremented first ``u = (mu / (1 - b1^count)) /
  (sqrt(nu / (1 - b2^count)) + eps)`` (``torch.optim.Adam`` adds eps to
  ``sqrt(nu) / sqrt(1 - b2^count)``), and the step is
  ``-lr(count before the increment) * u``.

The step count lives on the host, so the learning rate and the bias
corrections are host floats computed in float32 as optax computes them;
the moments are plain tensors, updated with ``torch._foreach_*`` over the
parameter list (a few launches per step, not a few per tensor).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    count: int                  # optimizer steps taken
    mu: List[torch.Tensor]      # first moments, one per parameter
    nu: List[torch.Tensor]      # second moments


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    max_norm: float
    lr: float
    b1: float
    b2: float
    eps: float
    # linear decay: the rate falls by lr / n_updates every
    # ``steps_per_update`` steps (None: constant rate)
    steps_per_update: Optional[int] = None
    n_updates: int = 1

    def lr_at(self, count: int) -> float:
        """The learning rate of the step taken at ``count``, in float32."""
        if self.steps_per_update is None:
            return float(np.float32(self.lr))
        f32 = np.float32
        frac = f32(1.0) - f32(count // self.steps_per_update) / f32(
            self.n_updates)
        return float(f32(self.lr) * max(frac, f32(0.0)))

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: AdamState) -> AdamState:
        """Apply one update to ``params`` in place; returns the new state
        (the moment tensors are updated in place too)."""
        params, grads = list(params), list(grads)
        # clip_by_global_norm, selected on the device: keep * g + (1 - keep)
        # * c equals g or c exactly for a keep of 1 or 0 (c stays finite
        # when kept: it is then divided by 1, not by a norm that may be 0)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        below = norm < self.max_norm
        keep = below.to(norm.dtype)
        clipped = torch._foreach_div(grads, torch.where(below, 1.0, norm))
        torch._foreach_mul_(clipped, self.max_norm)
        torch._foreach_mul_(clipped, 1.0 - keep)
        grads = torch._foreach_mul(grads, keep)
        torch._foreach_add_(grads, clipped)

        # scale_by_adam
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - self.b2)
        torch._foreach_add_(nu, sq)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)

        # scale_by_learning_rate, then apply_updates
        torch._foreach_mul_(upd, -self.lr_at(state.count))
        torch._foreach_add_(params, upd)
        return AdamState(count=count, mu=mu, nu=nu)
