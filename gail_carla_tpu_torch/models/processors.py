"""Input processors of the policy: port of
``gail_carla_tpu/models/processors.py`` (``tools/model.py:131-213``).

The convolutions (and the state-vector encoder's Dense layers) run in
``ModelConfig.dtype`` (bfloat16 by default) with float32 parameters, as
the flax modules do: inputs, kernels and biases are cast to that type for
each layer, and the features come back as float32. Everything after the convs stays float32, as in the JAX model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gail_carla_tpu_torch.config import ModelConfig

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# width of the state-vector encoder's two Dense layers (processors.py:38)
STATE_HIDDEN = 256


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def conv_out_width(width: int, n_convs: int) -> int:
    """Spatial width after ``n_convs`` VALID 4x4 stride-2 convs."""
    for _ in range(n_convs):
        width = (width - 4) // 2 + 1
    return width


class ObsEncoder(nn.Module):
    """4 x (Conv k4 s2 VALID + LeakyReLU 0.2) on the (B, C, H, W) BEV obs,
    flattened channels-last (NHWC) as the flax encoder flattens it; or,
    built for a (D,) state-vector obs, 2 x (Dense 256 + LeakyReLU 0.2)
    (``ops/state_obs.py``). The branch is fixed by ``obs_shape`` at
    construction; ``out_dim`` is the width of the features."""

    def __init__(self, cfg: ModelConfig, obs_shape=(3, 192, 192)):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList()
        self.dense = nn.ModuleList()
        if len(obs_shape) == 1:
            d = obs_shape[0]
            for _ in range(2):
                self.dense.append(nn.Linear(d, STATE_HIDDEN))
                d = STATE_HIDDEN
            self.out_dim = d
            return
        c, h, w = obs_shape
        if h != w:
            raise ValueError("the BEV observation is square")
        chans = (c,) + tuple(cfg.conv_channels)
        self.convs.extend(
            nn.Conv2d(chans[i], chans[i + 1], 4, stride=2)
            for i in range(len(cfg.conv_channels))
        )
        side = conv_out_width(w, len(cfg.conv_channels))
        self.out_dim = side * side * cfg.conv_channels[-1]
        self.register_buffer("mean", torch.tensor(
            IMAGENET_MEAN + (0.5,) * (c - 3)).view(1, c, 1, 1),
            persistent=False)
        self.register_buffer("std", torch.tensor(
            IMAGENET_STD + (0.25,) * (c - 3)).view(1, c, 1, 1),
            persistent=False)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.cfg)
        if self.dense:
            # flax's Dense(dtype=dt) casts input, kernel and bias to dt
            x = obs.to(dt)
            for layer in self.dense:
                x = F.linear(x, layer.weight.to(dt), layer.bias.to(dt))
                x = F.leaky_relu(x, self.cfg.leaky_slope)
            return x.float()
        # channels-last (NHWC) activations and kernels: the card's bf16
        # conv engines take NHWC, and fed NCHW they transpose every conv's
        # input and output; the flatten below is then a view
        cl = torch.channels_last
        x = ((obs - self.mean) / self.std).to(dt, memory_format=cl)
        for conv in self.convs:
            x = F.conv2d(x, conv.weight.to(dt, memory_format=cl),
                         conv.bias.to(dt), stride=2)
            x = F.leaky_relu(x, self.cfg.leaky_slope)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()


class MetricsEncoder(nn.Module):
    """metrics (B, 4) = [target lat, target lon, speed, command] ->
    [1000x, 1000y, 1000r, 0.3theta, 0.1speed, embed(command)]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.max_road_options, cfg.cmd_embed_dim)

    def forward(self, metrics: torch.Tensor) -> torch.Tensor:
        x = metrics[:, 0]
        y = metrics[:, 1]
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(y, x)
        speed = metrics[:, 2]
        feats = torch.stack(
            [1000.0 * x, 1000.0 * y, 1000.0 * r, 0.3 * theta, 0.1 * speed],
            dim=1,
        )
        cmd = metrics[:, 3].to(torch.int64)
        emb = self.embed(cmd.clamp(0, self.cfg.max_road_options - 1))
        return torch.cat([feats, emb], dim=1)
