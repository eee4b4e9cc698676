"""Checkpoint / resume: the semantics of
``gail_carla_tpu/utils/checkpoint.py`` with ``torch.save``.

The FULL learner state round-trips: both nets, both optimizer states, the
env states (zero-size traffic tensors included), the render state and
metrics, the BCGAIL weight, the reward statistics, the return carry, the
update counter and the ``torch.Generator``'s state. A checkpoint is a
directory holding one ``checkpoint.pt`` of plain containers (dicts,
lists, tensors, Python scalars), so that ``torch.load`` reads it with
``weights_only=True``; it is restored into a template of the same
structure, as the JAX version restores into a template pytree.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import torch

FILE = "checkpoint.pt"


def to_saved(obj: Any):
    """The plain-container form of a state: a dataclass becomes a dict of
    its fields, an ``nn.Module`` its state dict, a generator its state,
    tensors move to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, torch.nn.Module):
        return {k: v.detach().cpu() for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_saved(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_saved(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_saved(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def from_saved(saved: Any, template: Any, where: str = "state"):
    """``template`` with the values of ``saved`` (``to_saved``'s form of a
    state of the same structure). Tensors take the template's device and
    must match its shape and dtype; modules load the saved state dict and
    generators the saved state, in place."""
    if isinstance(template, torch.Tensor):
        if (saved.shape != template.shape
                or saved.dtype != template.dtype):
            raise ValueError(
                f"{where}: saved {saved.dtype}{tuple(saved.shape)}, template "
                f"{template.dtype}{tuple(template.shape)}")
        return saved.to(template.device)
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(saved)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(saved)
        return template
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: from_saved(saved[f.name], getattr(template, f.name),
                               f"{where}.{f.name}")
            for f in dataclasses.fields(template)
        })
    if isinstance(template, dict):
        return {k: from_saved(saved[k], v, f"{where}.{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"{where}: saved {len(saved)} items, template "
                             f"{len(template)}")
        return type(template)(from_saved(s, t, f"{where}[{i}]")
                              for i, (s, t) in enumerate(zip(saved,
                                                             template)))
    return saved


def save_checkpoint(path: str, state: Any, elapsed: float = 0.0) -> None:
    """Write ``state`` to the checkpoint directory ``path`` (replacing
    what is there), through a temporary file so that a crash leaves the
    previous checkpoint whole."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save({"state": to_saved(state), "elapsed": float(elapsed)}, tmp)
    os.replace(tmp, os.path.join(path, FILE))


def restore_checkpoint(path: str, template_state: Any):
    """Returns (state, elapsed); ``template_state`` supplies the structure,
    shapes, dtypes and devices."""
    saved = torch.load(os.path.join(path, FILE), map_location="cpu",
                       weights_only=True)
    return from_saved(saved["state"], template_state), saved["elapsed"]


def _update_dirs(directory: str):
    """The ``update_<i>`` checkpoint directories, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        (d for d in os.listdir(directory)
         if d.startswith("update_")
         and os.path.isdir(os.path.join(directory, d))),
        key=lambda d: int(d.split("_")[1]),
    )


def prune_checkpoints(directory: str, keep: int = 2) -> None:
    """Delete all but the newest ``keep`` ``update_*`` checkpoints (other
    directories, like ``best``, stay)."""
    steps = _update_dirs(directory)
    for d in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    steps = _update_dirs(directory)
    return os.path.join(directory, steps[-1]) if steps else None
