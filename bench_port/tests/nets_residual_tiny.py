"""A nets module for the tests only: ``cnn4`` with ``residual_blocks``
3x3 stride-1 SAME convolutions after its last conv, each adding
LeakyReLU(conv(x)) to its input. It shows that a family of nets comes in
as a module of its own (``bench_port/nets/``); no program runs it, and no
cell names it. ``registered()`` installs it as ``bench_port.nets.<NAME>``
while a test runs."""
from __future__ import annotations

import contextlib
import sys

import torch.nn.functional as F
from torch import nn

from bench_port.nets import cnn4
from bench_port.plain_reference.frozen.models.discriminator import DiscriminatorNet
from bench_port.plain_reference.frozen.models.policy import PolicyNet
from bench_port.plain_reference.frozen.models.processors import ObsEncoder
from bench_port.plain_reference.nets import fp8_round

NAME = "residual_tiny"
# a tiny configuration's model (bev6 at 32 px) that names this module
MODEL = {"nets": NAME, "hidden_size": 32, "head_size": 16,
         "conv_channels": [8, 16], "leaky_slope": 0.2, "cmd_embed_dim": 8,
         "max_road_options": 10, "logstd": [-1.4, -3.2],
         "use_activation": True, "disc_hidden": 16, "dtype": "bfloat16",
         "residual_blocks": 1}
OBS_SHAPE = (6, 32, 32)


@contextlib.contextmanager
def registered():
    full = f"bench_port.nets.{NAME}"
    sys.modules[full] = sys.modules[__name__]
    try:
        yield NAME
    finally:
        del sys.modules[full]


def param_shapes(model: dict, obs_shape, critic: bool):
    out = cnn4.param_shapes(model, obs_shape, critic)
    n = len(model["conv_channels"])
    ch = model["conv_channels"][-1]
    res = []
    for i in range(n, n + model["residual_blocks"]):
        res.append((("ObsEncoder_0", f"Conv_{i}", "kernel"), (3, 3, ch, ch),
                    9 * ch))
        res.append((("ObsEncoder_0", f"Conv_{i}", "bias"), (ch,), None))
    return out[:2 * n] + res + out[2 * n:]


class ResidualEncoder(ObsEncoder):
    """The frozen encoder's strided convs, then the residual ones, whose
    operands pass ``rnd``."""

    blocks = 0

    @staticmethod
    def rnd(x):
        return x

    def forward(self, obs):
        x = (obs - self.mean) / self.std
        n = len(self.convs) - self.blocks
        for i, conv in enumerate(self.convs):
            y = F.conv2d(self.rnd(x), self.rnd(conv.weight), conv.bias,
                         stride=2 if i < n else 1, padding=0 if i < n else 1)
            y = F.leaky_relu(y, self.cfg.leaky_slope)
            x = y if i < n else x + y
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class Fp8ResidualEncoder(ResidualEncoder):
    rnd = staticmethod(fp8_round)


def reference_nets(model: dict, obs_shape, policy_params, critic_params,
                   device, precision: str = "float32"):
    encoder = {"float32": ResidualEncoder,
               "fp8": Fp8ResidualEncoder}[precision]
    cfg = cnn4.model_config(model)
    blocks = model["residual_blocks"]
    ch = cfg.conv_channels[-1]
    nets = []
    for cls, params, names in ((PolicyNet, policy_params, cnn4.POLICY_DENSE),
                               (DiscriminatorNet, critic_params,
                                cnn4.CRITIC_DENSE)):
        if params is None:
            nets.append(None)
            continue
        net = cls(cfg, obs_shape)
        net.obs_enc.convs.extend(nn.Conv2d(ch, ch, 3, padding=1)
                                 for _ in range(blocks))
        net.obs_enc.__class__ = encoder
        net.obs_enc.blocks = blocks
        net.load_state_dict(cnn4.state_dict(
            params, len(cfg.conv_channels) + blocks, names))
        nets.append(net.to(device))
    return nets


def net_layers(model: dict, obs_shape, critic: bool):
    convs, dense = cnn4.net_layers(model, obs_shape, critic)
    _, feat = cnn4.conv_flops(obs_shape, model["conv_channels"])
    ch = model["conv_channels"][-1]
    return convs + [2 * feat * ch * 9] * model["residual_blocks"], dense
