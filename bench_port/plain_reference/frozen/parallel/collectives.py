# Frozen copy of gail_carla_tpu_torch/parallel/collectives.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""The reductions of a data-parallel update, in place of JAX's ``pmean``
over a mesh axis: a process group stands where the JAX package passes an
``axis_name``, and ``None`` means one process (no reduction at all).

Only ``all_reduce`` is used (``broadcast`` and ``barrier`` elsewhere):
gloo supports nothing else on CUDA tensors. Every call reduces one flat
buffer, so a step's gradients cost one collective, not one per tensor.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def world_size(group) -> int:
    """The ranks of ``group``; 1 for ``None``."""
    return 1 if group is None else dist.get_world_size(group)


def all_mean(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor averaged over the ranks of ``group`` as ``pmean`` does
    (the sum over ranks divided by their number), through one
    ``all_reduce`` of a flat float32 buffer; each result keeps its
    tensor's shape and dtype. With ``group=None`` the tensors come back
    as they are."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    dist.all_reduce(flat, group=group)
    flat = flat / world_size(group)
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(t.shape).to(t.dtype))
        i += n
    return out


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """One tensor averaged over the ranks of ``group`` (``None``: x)."""
    return all_mean([x], group)[0]
