"""Actor-critic policy: port of ``gail_carla_tpu/models/policy.py``
(``tools/model.py:15-128``). CNN + metrics features -> 3-layer MLP body
(512) -> head (256) -> value + (steer, throttle) means with a fixed
per-dim log-std, tanh on steer and sigmoid on throttle, diagonal Normal
action distribution.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.models.processors import MetricsEncoder, ObsEncoder
from gail_carla_tpu_torch.utils.trace import span

LOG_2PI = 1.8378770664093453


class PolicyNet(nn.Module):
    def __init__(self, cfg: ModelConfig, obs_shape=(3, 192, 192),
                 n_actions: int = 2):
        super().__init__()
        self.cfg = cfg
        self.obs_enc = ObsEncoder(cfg, obs_shape)
        self.met_enc = MetricsEncoder(cfg)
        d = self.obs_enc.out_dim + 5 + cfg.cmd_embed_dim
        body = []
        for _ in range(3):
            body.append(nn.Linear(d, cfg.hidden_size))
            d = cfg.hidden_size
        self.body = nn.ModuleList(body)
        self.head = nn.Linear(d, cfg.head_size)
        self.out = nn.Linear(cfg.head_size, 1 + n_actions)
        self.register_buffer(
            "logstd", torch.tensor(cfg.logstd, dtype=torch.float32),
            persistent=False,
        )

    def forward(self, obs: torch.Tensor, metrics: torch.Tensor):
        c = self.cfg
        x = torch.cat([self.obs_enc(obs), self.met_enc(metrics)], dim=1)
        for layer in self.body:
            x = F.leaky_relu(layer(x), c.leaky_slope)
        x = F.leaky_relu(self.head(x), c.leaky_slope)
        out = self.out(x)
        value = out[:, 0]
        mean = out[:, 1:]
        if c.use_activation:  # model.py:80-82
            mean = torch.stack(
                [torch.tanh(mean[:, 0]), torch.sigmoid(mean[:, 1])], dim=1
            )
        logstd = self.logstd.expand_as(mean)
        return value, mean, logstd


def normal_logprob(action, mean, logstd):
    """Sum of per-dim Normal log-probs (model.py:34 ``log_prob(...).sum``)."""
    var = torch.exp(2.0 * logstd)
    lp = -0.5 * ((action - mean) ** 2 / var + 2.0 * logstd + LOG_2PI)
    return lp.sum(dim=-1)


def normal_entropy(logstd):
    return (0.5 + 0.5 * LOG_2PI + logstd).sum(dim=-1)


@torch.no_grad()
def act(net: PolicyNet, obs, metrics, generator: Optional[torch.Generator]
        = None, deterministic: bool = False,
        noise: Optional[torch.Tensor] = None):
    """Policy.act (model.py:25-36): (value, action, logp). ``noise`` holds
    the standard normal action draws (``policy.py:72``); it is drawn from
    ``generator`` when not given."""
    with span("policy.act"):
        value, mean, logstd = net(obs, metrics)
        if deterministic:
            action = mean
        else:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device)
            action = mean + torch.exp(logstd) * noise
        logp = normal_logprob(action, mean, logstd)
        return value, action, logp


def evaluate_actions(net: PolicyNet, obs, metrics, actions):
    """Policy.evaluate_actions (model.py:45-53)."""
    value, mean, logstd = net(obs, metrics)
    logp = normal_logprob(actions, mean, logstd)
    entropy = normal_entropy(logstd)
    return value, logp, entropy
