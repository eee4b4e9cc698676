"""The reference's policy and critic: the frozen nets, built from the
benchmark's flax-layout weights, computing in float32 with TF32 off (the
reference) or with every convolution's input and kernel rounded to fp8
e4m3 under one scale per tensor (the control: the next precision below
the configuration's bfloat16)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.plain_reference.frozen.config import ModelConfig
from bench_port.plain_reference.frozen.models.discriminator import DiscriminatorNet
from bench_port.plain_reference.frozen.models.policy import PolicyNet
from bench_port.plain_reference.frozen.models.processors import ObsEncoder

POLICY_DENSE = ("body.0", "body.1", "body.2", "head", "out")
CRITIC_DENSE = ("hidden", "out")
FP8_MAX = 448.0


def strict_float32() -> None:
    """Float32 products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model_config(model: dict) -> ModelConfig:
    kw = dict(model)
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


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under the scale that maps its largest
    magnitude to the format's largest value, back in float32. Gradients
    pass the rounding unchanged, and the backward works on the rounded
    operands, as an fp8 forward with a higher-precision backward does."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q / scale - x).detach()


class Fp8ObsEncoder(ObsEncoder):
    """The frozen encoder with fp8-rounded convolution operands."""

    def forward(self, obs):
        x = (obs - self.mean) / self.std
        for conv in self.convs:
            x = F.conv2d(fp8_round(x), fp8_round(conv.weight), conv.bias,
                         stride=2)
            x = F.leaky_relu(x, self.cfg.leaky_slope)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def make_nets(model: dict, obs_shape, policy_params, critic_params, device,
              precision: str = "float32"):
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
