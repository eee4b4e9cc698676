"""Running reward statistics: port of
``gail_carla_tpu/utils/running_mean_std.py`` (``common/running_mean_std.py``
of the reference): the Chan et al. parallel-moments update and the clamped
EMA scale tracker that reward normalisation uses. Single device: the
moments are the local batch's."""
from __future__ import annotations

import dataclasses

import torch


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


def _batch_moments(batch: torch.Tensor):
    """Mean, population variance (``jnp.var``) and count over axis 0."""
    return (batch.mean(dim=0), batch.var(dim=0, unbiased=False),
            batch.shape[0])


def update_rms(rms: RunningMeanStd, batch: torch.Tensor) -> RunningMeanStd:
    """Chan et al. parallel update, the reference's update_from_moments."""
    batch_mean, batch_var, batch_count = _batch_moments(batch)
    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * batch_count / tot
    m_a = rms.var * rms.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * rms.count * batch_count / tot
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


def update_scale(rms: RunningMeanStd, batch: torch.Tensor, ema: float = 0.8,
                 max_ratio: float = 1.25) -> RunningMeanStd:
    """Robust scale tracker for reward normalisation, not the cumulative
    update: an EMA of the batch std whose step is clamped to the geometric
    trust region ``[std / max_ratio, std * max_ratio]``, so that one
    outlier batch (the critic's warm-up drifts D's level) moves the scale
    by at most ``max_ratio``. ``count`` keeps accumulating."""
    batch_mean, batch_var, batch_count = _batch_moments(batch)
    std = rms.std
    target = ema * std + (1.0 - ema) * torch.sqrt(
        torch.clamp(batch_var, min=0.0))
    new_std = torch.clamp(target, std / max_ratio, std * max_ratio)
    new_mean = ema * rms.mean + (1.0 - ema) * batch_mean
    return RunningMeanStd(mean=new_mean, var=new_std ** 2,
                          count=rms.count + batch_count)
