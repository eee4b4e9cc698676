# Frozen copy of gail_carla_tpu_torch/utils/running_mean_std.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Running reward statistics: port of
``gail_carla_tpu/utils/running_mean_std.py`` (``common/running_mean_std.py``
of the reference): the Chan et al. parallel-moments update and the clamped
EMA scale tracker that reward normalisation uses. With a process group
(data parallelism over ranks) the batch moments are averaged across the
ranks first, so every replica folds in the global batch."""
from __future__ import annotations

import dataclasses

import torch

from bench_port.plain_reference.frozen.parallel.collectives import all_mean, world_size


@dataclasses.dataclass
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @property
    def std(self):
        return torch.sqrt(self.var)


def make_rms(shape=(), device="cpu") -> RunningMeanStd:
    return RunningMeanStd(
        mean=torch.zeros(shape, device=device),
        var=torch.ones(shape, device=device),
        count=torch.tensor(1e-4, device=device),
    )


def _batch_moments(batch: torch.Tensor, group=None):
    """Mean, population variance (``jnp.var``) and count over axis 0. With
    ``group`` the moments are those of the batches of all its ranks, in
    the JAX package's op order: the variance is the averaged ``E[x^2]``
    less the square of the averaged mean (which cancels where the
    unsharded ``jnp.var`` does not; kept as the reference has it)."""
    if group is None:
        return (batch.mean(dim=0), batch.var(dim=0, unbiased=False),
                batch.shape[0])
    sq_mean, batch_mean = all_mean(
        [torch.mean(batch ** 2, dim=0), batch.mean(dim=0)], group)
    return (batch_mean, sq_mean - batch_mean ** 2,
            batch.shape[0] * world_size(group))


def update_rms(rms: RunningMeanStd, batch: torch.Tensor,
               group=None) -> RunningMeanStd:
    """Chan et al. parallel update, the reference's update_from_moments
    (over the ranks of ``group`` when given)."""
    batch_mean, batch_var, batch_count = _batch_moments(batch, group)
    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * batch_count / tot
    m_a = rms.var * rms.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * rms.count * batch_count / tot
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


def update_scale(rms: RunningMeanStd, batch: torch.Tensor, group=None,
                 ema: float = 0.8, max_ratio: float = 1.25
                 ) -> RunningMeanStd:
    """Robust scale tracker for reward normalisation, not the cumulative
    update: an EMA of the batch std whose step is clamped to the geometric
    trust region ``[std / max_ratio, std * max_ratio]``, so that one
    outlier batch (the critic's warm-up drifts D's level) moves the scale
    by at most ``max_ratio``. ``count`` keeps accumulating. The moments
    are averaged across the ranks of ``group`` as in ``update_rms``."""
    batch_mean, batch_var, batch_count = _batch_moments(batch, group)
    std = rms.std
    target = ema * std + (1.0 - ema) * torch.sqrt(
        torch.clamp(batch_var, min=0.0))
    new_std = torch.clamp(target, std / max_ratio, std * max_ratio)
    new_mean = ema * rms.mean + (1.0 - ema) * batch_mean
    return RunningMeanStd(mean=new_mean, var=new_std ** 2,
                          count=rms.count + batch_count)
