"""The policy's and the critic's weights, made on the device from the
seed in a few large calls: flax's default initialisers (kernels truncated
normal at two sigmas with variance 1/fan_in, zero biases, embeddings of
variance 1/features), in float32, the type the nets keep them in. The
same values go to the program (flax layout, which ``WDGAILLearner`` and
``convert.policy_from_flax`` take) and to the reference."""
from __future__ import annotations

import math

import torch

from bench_port.harness.feed import generator

TRUNC_STD = 0.87962566103423978   # sd of a unit normal cut at +-2 sigma


def conv_out_width(width: int, n_convs: int) -> int:
    for _ in range(n_convs):
        width = (width - 4) // 2 + 1
    return width


def layer_shapes(model: dict, obs_shape, critic: bool):
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


def make_params(model: dict, obs_shape, critic: bool, seed: int, device):
    """Flax-layout ``{"params": {...}}`` of device tensors."""
    shapes = layer_shapes(model, obs_shape, critic)
    sizes = [math.prod(s) for _, s, f in shapes if f is not None]
    g = generator(device, seed, "critic" if critic else "policy")
    x = torch.randn(sum(sizes), generator=g, device=device)
    for _ in range(4):
        x = torch.where(x.abs() > 2.0,
                        torch.randn(x.shape, generator=g, device=device), x)
    x = x.clamp(-2.0, 2.0)
    params, off = {}, 0
    for path, shape, fan in shapes:
        if fan is None:
            leaf = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            std = (1.0 / math.sqrt(shape[-1]) if fan == "embed"
                   else math.sqrt(1.0 / fan) / TRUNC_STD)
            leaf = (x[off:off + n] * std).reshape(shape)
            off += n
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return {"params": params}


def to_host(params):
    """The same tree with every leaf copied to the host in one transfer."""
    leaves = []

    def walk(node):
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append(v)

    walk(params)
    flat = torch.cat([v.reshape(-1) for v in leaves]).cpu()
    it = iter(torch.split(flat, [v.numel() for v in leaves]))

    def rebuild(node):
        return {k: rebuild(v) if isinstance(v, dict)
                else next(it).reshape(v.shape) for k, v in node.items()}

    return rebuild(params)
