# Frozen copy of gail_carla_tpu_torch/ops/gae.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Generalised Advantage Estimation: port of ``gail_carla_tpu/ops/gae.py``
(``tools/storage.py:37-50``), a reverse loop over the T steps in place of
the reverse ``lax.scan``. The TD targets mix GAIL and env rewards
(gail_coef = 1, env_coef = 0 by default: GAIL reward only); masks zero the
bootstrap across episode boundaries."""
from __future__ import annotations

import torch


def compute_returns(
    gail_rewards: torch.Tensor,   # (T, N)
    env_rewards: torch.Tensor,    # (T, N)
    values: torch.Tensor,         # (T+1, N); values[T] is the bootstrap
    masks: torch.Tensor,          # (T+1, N); masks[t+1] = 0 where step t ended
    gamma: float,
    gae_lambda: float,
    gail_coef: float = 1.0,
    env_coef: float = 0.0,
) -> torch.Tensor:
    """Returns (T, N) GAE returns (advantage + value)."""
    rewards = gail_coef * gail_rewards + env_coef * env_rewards
    returns = torch.empty_like(rewards)
    gae = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        m_next = masks[t + 1]
        delta = rewards[t] + gamma * values[t + 1] * m_next - values[t]
        gae = delta + gamma * gae_lambda * m_next * gae
        returns[t] = gae + values[t]
    return returns
