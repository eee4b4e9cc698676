"""Policy parameters: flax layout -> the port's ``PolicyNet``, and a
numpy-seeded initialiser for runs without JAX.

Flax keeps ``{"params": {"ObsEncoder_0": {"Conv_i": ...},
"MetricsEncoder_0": {"Embed_0": ...}, "Dense_0".."Dense_4": ...}}`` as
nested dicts of arrays. Conv kernels are HWIO and become OIHW; Dense
kernels are (in, out) and become ``nn.Linear`` weights (out, in).
``Dense_0`` consumes the NHWC flatten of the conv features, which the
port's ``ObsEncoder`` reproduces.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.models.policy import PolicyNet
from gail_carla_tpu_torch.models.processors import conv_out_width

N_DENSE = 5   # 3 body layers, head, value/mean output


def flax_to_state_dict(params: Mapping, cfg: ModelConfig) -> Dict:
    """``PolicyNet.state_dict()`` entries from flax policy params (the
    ``{"params": ...}`` tree or its inner dict, leaves array-like)."""
    p = params.get("params", params)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for i in range(len(cfg.conv_channels)):
        conv = p["ObsEncoder_0"][f"Conv_{i}"]
        sd[f"obs_enc.convs.{i}.weight"] = t(conv["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        sd[f"obs_enc.convs.{i}.bias"] = t(conv["bias"])
    sd["met_enc.embed.weight"] = t(
        p["MetricsEncoder_0"]["Embed_0"]["embedding"]
    )
    names = [f"body.{i}" for i in range(3)] + ["head", "out"]
    for i, name in enumerate(names):
        dense = p[f"Dense_{i}"]
        sd[f"{name}.weight"] = t(dense["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = t(dense["bias"])
    return sd


def policy_from_flax(params: Mapping, cfg: ModelConfig,
                     obs_shape=(3, 192, 192), device="cuda") -> PolicyNet:
    """A ``PolicyNet`` on ``device`` holding the given flax params."""
    dev = resolve_device(device)
    net = PolicyNet(cfg, obs_shape)
    net.load_state_dict(flax_to_state_dict(params, cfg))
    return net.to(dev).eval()


def _lecun_normal(rng: np.random.Generator, shape, fan_in: int):
    """flax's default kernel init: truncated normal (two sigmas) with
    variance 1/fan_in."""
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    x = rng.standard_normal(shape)
    while True:
        bad = np.abs(x) > 2.0
        if not bad.any():
            break
        x[bad] = rng.standard_normal(int(bad.sum()))
    return (x * std).astype(np.float32)


def init_flax_params(cfg: ModelConfig, obs_shape=(3, 192, 192),
                     seed: int = 0) -> Dict:
    """Flax-layout policy params drawn with numpy from ``seed``, with
    flax's default initialisers (lecun normal kernels, zero biases,
    embeddings of variance 1/features)."""
    rng = np.random.default_rng(seed)
    c, _, w = obs_shape
    p = {"ObsEncoder_0": {}}
    cin = c
    for i, ch in enumerate(cfg.conv_channels):
        p["ObsEncoder_0"][f"Conv_{i}"] = {
            "kernel": _lecun_normal(rng, (4, 4, cin, ch), 16 * cin),
            "bias": np.zeros((ch,), np.float32),
        }
        cin = ch
    p["MetricsEncoder_0"] = {"Embed_0": {"embedding": (
        rng.standard_normal((cfg.max_road_options, cfg.cmd_embed_dim))
        / np.sqrt(cfg.cmd_embed_dim)).astype(np.float32)}}
    side = conv_out_width(w, len(cfg.conv_channels))
    dims = [side * side * cfg.conv_channels[-1] + 5 + cfg.cmd_embed_dim]
    dims += [cfg.hidden_size] * 3 + [cfg.head_size, 3]
    for i in range(N_DENSE):
        p[f"Dense_{i}"] = {
            "kernel": _lecun_normal(rng, (dims[i], dims[i + 1]), dims[i]),
            "bias": np.zeros((dims[i + 1],), np.float32),
        }
    return {"params": p}


def init_policy(cfg: ModelConfig, obs_shape=(3, 192, 192), seed: int = 0,
                device="cuda") -> PolicyNet:
    """A numpy-seeded ``PolicyNet`` on ``device``."""
    return policy_from_flax(init_flax_params(cfg, obs_shape, seed), cfg,
                            obs_shape, device)
