"""Policy and critic parameters: flax layout -> the port's ``PolicyNet``
and ``DiscriminatorNet``, and numpy-seeded initialisers for runs without
JAX.

Flax keeps ``{"params": {"ObsEncoder_0": {"Conv_i": ...},
"MetricsEncoder_0": {"Embed_0": ...}, "Dense_0".."Dense_<k>": ...}}`` as
nested dicts of arrays; for a (D,) state-vector obs ``ObsEncoder_0``
holds ``Dense_0`` and ``Dense_1`` instead of the convs. Conv kernels are
HWIO and become OIHW; Dense kernels are (in, out) and become
``nn.Linear`` weights (out, in). The top ``Dense_0`` consumes the NHWC
flatten of the conv features, which the port's ``ObsEncoder`` reproduces
(the critic's also takes the action).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.models.discriminator import DiscriminatorNet
from gail_carla_tpu_torch.models.policy import PolicyNet
from gail_carla_tpu_torch.models.processors import (
    STATE_HIDDEN, conv_out_width,
)
from gail_carla_tpu_torch.utils.checkpoint import save_checkpoint

# the flax Dense_i layers, in order, as the port's modules name them
POLICY_DENSE = ("body.0", "body.1", "body.2", "head", "out")
CRITIC_DENSE = ("hidden", "out")


def _state_dict(params: Mapping, cfg: ModelConfig, dense_names) -> Dict:
    """State-dict entries of the encoders and of the Dense layers, which
    become the modules named ``dense_names`` in order."""
    p = params.get("params", params)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def linear(prefix, dense):
        sd[f"{prefix}.weight"] = t(dense["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = t(dense["bias"])

    sd = {}
    enc = p["ObsEncoder_0"]
    if "Dense_0" in enc:                 # the state-vector encoder
        for i in range(2):
            linear(f"obs_enc.dense.{i}", enc[f"Dense_{i}"])
    else:
        for i in range(len(cfg.conv_channels)):
            conv = enc[f"Conv_{i}"]
            sd[f"obs_enc.convs.{i}.weight"] = t(conv["kernel"]).permute(
                3, 2, 0, 1).contiguous()
            sd[f"obs_enc.convs.{i}.bias"] = t(conv["bias"])
    sd["met_enc.embed.weight"] = t(
        p["MetricsEncoder_0"]["Embed_0"]["embedding"]
    )
    for i, name in enumerate(dense_names):
        linear(name, p[f"Dense_{i}"])
    return sd


def flax_to_state_dict(params: Mapping, cfg: ModelConfig) -> Dict:
    """``PolicyNet.state_dict()`` entries from flax policy params (the
    ``{"params": ...}`` tree or its inner dict, leaves array-like)."""
    return _state_dict(params, cfg, POLICY_DENSE)


def critic_state_dict(params: Mapping, cfg: ModelConfig) -> Dict:
    """``DiscriminatorNet.state_dict()`` entries from flax critic params."""
    return _state_dict(params, cfg, CRITIC_DENSE)


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


def _init_params(cfg: ModelConfig, obs_shape, seed: int, extra_in: int,
                 dense_out) -> Dict:
    """Flax-layout params of the encoders and the Dense layers of widths
    ``dense_out``, drawn with numpy from ``seed`` with flax's default
    initialisers (lecun normal kernels, zero biases, embeddings of
    variance 1/features). ``Dense_0`` takes the encoder's features (the
    NHWC flatten of the conv features, or the state encoder's 256), the
    metrics features and ``extra_in`` more inputs."""
    rng = np.random.default_rng(seed)

    def dense(d_in, d_out):
        return {"kernel": _lecun_normal(rng, (d_in, d_out), d_in),
                "bias": np.zeros((d_out,), np.float32)}

    enc = {}
    if len(obs_shape) == 1:              # the state-vector encoder
        dims = [obs_shape[0], STATE_HIDDEN, STATE_HIDDEN]
        for i in range(2):
            enc[f"Dense_{i}"] = dense(dims[i], dims[i + 1])
        feat = STATE_HIDDEN
    else:
        c, _, w = obs_shape
        cin = c
        for i, ch in enumerate(cfg.conv_channels):
            enc[f"Conv_{i}"] = {
                "kernel": _lecun_normal(rng, (4, 4, cin, ch), 16 * cin),
                "bias": np.zeros((ch,), np.float32),
            }
            cin = ch
        side = conv_out_width(w, len(cfg.conv_channels))
        feat = side * side * cfg.conv_channels[-1]
    p = {"ObsEncoder_0": enc}
    p["MetricsEncoder_0"] = {"Embed_0": {"embedding": (
        rng.standard_normal((cfg.max_road_options, cfg.cmd_embed_dim))
        / np.sqrt(cfg.cmd_embed_dim)).astype(np.float32)}}
    dims = [feat + 5 + cfg.cmd_embed_dim + extra_in] + list(dense_out)
    for i in range(len(dense_out)):
        p[f"Dense_{i}"] = dense(dims[i], dims[i + 1])
    return {"params": p}


def init_flax_params(cfg: ModelConfig, obs_shape=(3, 192, 192),
                     seed: int = 0) -> Dict:
    """Flax-layout policy params drawn with numpy from ``seed``."""
    return _init_params(cfg, obs_shape, seed, 0,
                        [cfg.hidden_size] * 3 + [cfg.head_size, 3])


def init_critic_flax_params(cfg: ModelConfig, obs_shape=(3, 192, 192),
                            seed: int = 0) -> Dict:
    """Flax-layout critic params drawn with numpy from ``seed``; its
    ``Dense_0`` also takes the 2 action inputs."""
    return _init_params(cfg, obs_shape, seed, 2, [cfg.disc_hidden, 1])


def init_policy(cfg: ModelConfig, obs_shape=(3, 192, 192), seed: int = 0,
                device="cuda") -> PolicyNet:
    """A numpy-seeded ``PolicyNet`` on ``device``."""
    return policy_from_flax(init_flax_params(cfg, obs_shape, seed), cfg,
                            obs_shape, device)


def critic_from_flax(params: Mapping, cfg: ModelConfig,
                     obs_shape=(3, 192, 192), device="cuda"
                     ) -> DiscriminatorNet:
    """A ``DiscriminatorNet`` on ``device`` holding the given flax params."""
    dev = resolve_device(device)
    net = DiscriminatorNet(cfg, obs_shape)
    net.load_state_dict(critic_state_dict(params, cfg))
    return net.to(dev)


def save_flax_params_checkpoint(params: Mapping, cfg: ModelConfig,
                                path: str) -> None:
    """Write a JAX params-only policy checkpoint (the ``{"params": ...}``
    tree of ``gail_carla_tpu``'s ``best_params``, leaves as numpy arrays)
    as the port's params-only checkpoint at ``path``, the shape
    ``train.py --init-params`` reads. Reading the orbax directory itself
    needs JAX; this function takes the restored tree."""
    save_checkpoint(path, {"params": flax_to_state_dict(params, cfg)})
