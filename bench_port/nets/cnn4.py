"""The reference's CNN policy and WDGAIL critic (``tools/model.py`` of
github.com/gustavokcouto/gail-carla): 4 x (Conv k4 s2 VALID + LeakyReLU)
on the BEV, the metrics' features and command embedding, a 3 x
``hidden_size`` body, a ``head_size`` head; the critic a
``disc_hidden``-wide hidden layer. The frozen nets of the plain
reference, as the float32 reference or with fp8-rounded convolution
operands (the control: the next precision below the configuration's
bfloat16). The package's docstring gives the module contract."""
from __future__ import annotations

import dataclasses

import torch.nn.functional as F

from bench_port.plain_reference.frozen.config import ModelConfig
from bench_port.plain_reference.frozen.models.discriminator import DiscriminatorNet
from bench_port.plain_reference.frozen.models.policy import PolicyNet
from bench_port.plain_reference.frozen.models.processors import (
    ObsEncoder,
    conv_out_width,
)
from bench_port.plain_reference.nets import fp8_round

POLICY_DENSE = ("body.0", "body.1", "body.2", "head", "out")
CRITIC_DENSE = ("hidden", "out")


def param_shapes(model: dict, obs_shape, critic: bool):
    """[(flax path, shape, fan_in or None)] of the kernels, biases and the
    command embedding; fan_in None marks a zero bias."""
    c, _, w = obs_shape
    out = []
    cin = c
    for i, ch in enumerate(model["conv_channels"]):
        out.append((("ObsEncoder_0", f"Conv_{i}", "kernel"), (4, 4, cin, ch),
                    16 * cin))
        out.append((("ObsEncoder_0", f"Conv_{i}", "bias"), (ch,), None))
        cin = ch
    side = conv_out_width(w, len(model["conv_channels"]))
    feat = side * side * model["conv_channels"][-1]
    out.append((("MetricsEncoder_0", "Embed_0", "embedding"),
                (model["max_road_options"], model["cmd_embed_dim"]), "embed"))
    if critic:
        dims = [feat + 5 + model["cmd_embed_dim"] + 2, model["disc_hidden"], 1]
    else:
        dims = ([feat + 5 + model["cmd_embed_dim"]]
                + [model["hidden_size"]] * 3 + [model["head_size"], 3])
    for i in range(len(dims) - 1):
        out.append(((f"Dense_{i}", "kernel"), (dims[i], dims[i + 1]), dims[i]))
        out.append(((f"Dense_{i}", "bias"), (dims[i + 1],), None))
    return out


def model_config(model: dict) -> ModelConfig:
    """The frozen ``ModelConfig`` of ``model`` in float32, from the keys
    that class declares."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model.items() if k in names}
    kw["conv_channels"] = tuple(kw["conv_channels"])
    kw["logstd"] = tuple(kw["logstd"])
    kw["dtype"] = "float32"
    return ModelConfig(**kw)


def state_dict(params: dict, n_convs: int, dense_names) -> dict:
    """Torch state-dict entries of flax-layout params: conv kernels HWIO
    to OIHW, Dense kernels (in, out) to (out, in)."""
    p = params["params"]
    sd = {}
    for i in range(n_convs):
        conv = p["ObsEncoder_0"][f"Conv_{i}"]
        sd[f"obs_enc.convs.{i}.weight"] = conv["kernel"].permute(3, 2, 0, 1)
        sd[f"obs_enc.convs.{i}.bias"] = conv["bias"]
    sd["met_enc.embed.weight"] = p["MetricsEncoder_0"]["Embed_0"]["embedding"]
    for i, name in enumerate(dense_names):
        sd[f"{name}.weight"] = p[f"Dense_{i}"]["kernel"].T
        sd[f"{name}.bias"] = p[f"Dense_{i}"]["bias"]
    return {k: v.float().contiguous() for k, v in sd.items()}


class Fp8ObsEncoder(ObsEncoder):
    """The frozen encoder with fp8-rounded convolution operands."""

    def forward(self, obs):
        x = (obs - self.mean) / self.std
        for conv in self.convs:
            x = F.conv2d(fp8_round(x), fp8_round(conv.weight), conv.bias,
                         stride=2)
            x = F.leaky_relu(x, self.cfg.leaky_slope)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def reference_nets(model: dict, obs_shape, policy_params, critic_params,
                   device, precision: str = "float32"):
    """(PolicyNet, DiscriminatorNet or None) on ``device``."""
    cfg = model_config(model)
    n_convs = len(cfg.conv_channels)
    nets = []
    for cls, params, names in ((PolicyNet, policy_params, POLICY_DENSE),
                               (DiscriminatorNet, critic_params,
                                CRITIC_DENSE)):
        if params is None:
            nets.append(None)
            continue
        net = cls(cfg, obs_shape)
        net.load_state_dict(state_dict(params, n_convs, names))
        net = net.to(device)
        if precision == "fp8":
            net.obs_enc.__class__ = Fp8ObsEncoder
        elif precision != "float32":
            raise ValueError(precision)
        nets.append(net)
    return nets


def conv_flops(obs_shape, channels):
    """Forward FLOPs (2 per multiply-add) of each k4 s2 VALID conv."""
    c, _, w = obs_shape
    out = []
    for ch in channels:
        w = (w - 4) // 2 + 1
        out.append(2 * w * w * ch * c * 16)
        c = ch
    return out, w * w * c


def dense_flops(dims):
    return [2 * a * b for a, b in zip(dims[:-1], dims[1:])]


def net_layers(model: dict, obs_shape, critic: bool):
    """(conv FLOPs per layer, dense FLOPs per layer) of one row forward."""
    convs, feat = conv_flops(obs_shape, model["conv_channels"])
    base = feat + 5 + model["cmd_embed_dim"]
    if critic:
        dims = [base + 2, model["disc_hidden"], 1]
    else:
        dims = [base] + [model["hidden_size"]] * 3 + [model["head_size"], 3]
    return convs, dense_flops(dims)
