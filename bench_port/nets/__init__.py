"""The benchmark's nets, one module per family of networks. A
configuration picks its module by the key ``"nets"`` of its ``model``
object (``configs/<config>.json``); without the key it is ``cnn4``.

Each module ``bench_port/nets/<name>.py`` provides exactly three things,
all of them plain PyTorch that imports nothing of the program and nothing
of JAX:

- ``param_shapes(model, obs_shape, critic)``: ``[(path, shape, fan_in)]``
  of the policy's (``critic`` false) or the critic's weights, in the
  flax layout that the program's ``WDGAILLearner(policy_params=,
  disc_params=)`` and ``convert.policy_from_flax`` take, in the order the
  seeded draw fills them (``harness/weights.py::make_params``). ``fan_in``
  is the kernel's fan-in, ``None`` for a zero bias, ``"embed"`` for an
  embedding.
- ``reference_nets(model, obs_shape, policy_params, critic_params,
  device, precision)``: ``(policy, critic or None)``, the plain reference
  nets built from those weights, in float32 (``precision="float32"``;
  the caller turns TF32 off) or as the control (``precision="fp8"``: the
  operands of the layers that see the image rounded by
  ``plain_reference/nets.py::fp8_round``). The nets keep this contract:

  - ``policy(obs, metrics)`` returns ``(value, mean, logstd)``;
  - ``critic(obs, metrics, action)`` returns D, one raw output per row;
  - ``parameters()`` come in the program's order with the program's
    shapes (``plain_reference/follow.py::load`` copies the program's
    parameters into them in order);
  - the last Linear of each net is its attribute ``out``
    (``plain_reference/check.py::HeadTerms`` reads its terms).
- ``net_layers(model, obs_shape, critic)``: ``(FLOPs of each layer that
  sees the image, FLOPs of each dense layer)`` of one row forward, two
  FLOPs to a multiply-add; the first entry is the layer whose input
  gradient no backward computes (``bench_port/flops.py``).
"""
from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "cnn4"


def of(model: dict) -> ModuleType:
    """The nets module that ``model`` names."""
    name = model.get("nets", DEFAULT)
    full = f"{__name__}.{name}"
    if not (isinstance(name, str) and name.isidentifier()):
        raise ValueError(f"nets module {name!r}: not a module name")
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"nets module {name!r}: no {full}") from None
