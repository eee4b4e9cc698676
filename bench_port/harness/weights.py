"""The policy's and the critic's weights, made on the device from the
seed in a few large calls: flax's default initialisers (kernels truncated
normal at two sigmas with variance 1/fan_in, zero biases, embeddings of
variance 1/features), in float32, the type the nets keep them in, for
the tree that the configuration's nets module lists
(``bench_port/nets/``). The same values go to the program (flax layout,
which ``WDGAILLearner`` and ``convert.policy_from_flax`` take) and to
the reference."""
from __future__ import annotations

import math

import torch

from bench_port.harness.feed import generator
from bench_port.nets import of

TRUNC_STD = 0.87962566103423978   # sd of a unit normal cut at +-2 sigma


def make_params(model: dict, obs_shape, critic: bool, seed: int, device):
    """Flax-layout ``{"params": {...}}`` of device tensors."""
    shapes = of(model).param_shapes(model, obs_shape, critic)
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
