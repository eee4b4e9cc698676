# Frozen copy of gail_carla_tpu_torch/algo/wdgail.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""WDGAIL critic training, reward relabelling and validation: port of
``gail_carla_tpu/algo/wdgail.py`` (``algo/wdgail.py:100-189`` and the
warm-up schedule of ``tools/learn.py:144-209`` in the reference).

- per epoch: zip shuffled expert batches with shuffled policy (rollout)
  batches; loss = -(E[tanh D_e] - E[tanh D_p]) + 10 * gradient penalty on
  alpha-mixed samples (image gradient only); clip then Adam(2.5e-4).
- warm-up: epochs per update decay 6 -> 1 over the first ``gail_thre``
  updates. A Python loop runs exactly ``n_epochs`` epochs (the JAX
  package scans a fixed length and skips the rest with ``lax.cond``).
- relabel: gail_reward = softplus(D) (== -log(1 - sigmoid(D))).
- validation WD: the tanh-D gap between a held-out expert buffer and
  rollout samples, before and after the critic's epochs.

With a process group (data parallelism over ranks) ``disc_update``
averages each step's gradients across the ranks; the gradient penalty
stays each rank's own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from bench_port.plain_reference.frozen.algo.buffers import (
    ExpertBuffer, Rollout, fetch_expert_obs, fetch_rollout_obs,
)
from bench_port.plain_reference.frozen.algo.optim import AdamState, ClipAdam
from bench_port.plain_reference.frozen.algo.ppo import draw_perms
from bench_port.plain_reference.frozen.config import EnvConfig, TrainConfig
from bench_port.plain_reference.frozen.models import discriminator as disc_mod
from bench_port.plain_reference.frozen.parallel.collectives import all_mean

AUX_KEYS = ("dis_total_loss", "dis_loss", "dis_gp", "policy_reward",
            "expert_reward", "expert_loss", "policy_loss")


class DiscEpochDraws(NamedTuple):
    """The draws of one critic epoch: expert and policy rows (n_mb, mb)
    and the penalty's mixing weights (n_mb, mb, 1, 1, 1)."""

    expert_idx: torch.Tensor
    policy_idx: torch.Tensor
    alpha: torch.Tensor


def make_disc_optimizer(tcfg: TrainConfig, mb_per_update: int = 1
                        ) -> ClipAdam:
    """clip_by_global_norm then adam; with ``gail_use_linear_lr_decay``
    the rate falls linearly per update, counted as ``mb_per_update``
    optimizer steps (warm-up updates run more epochs and advance the
    count faster, as in the JAX package)."""
    steps = max(mb_per_update, 1) if tcfg.gail_use_linear_lr_decay else None
    return ClipAdam(tcfg.gail_max_grad_norm, tcfg.gail_lr,
                    tcfg.gail_betas[0], tcfg.gail_betas[1], tcfg.gail_eps,
                    steps_per_update=steps,
                    n_updates=max(tcfg.n_updates, 1))


def warmup_epochs(tcfg: TrainConfig, i_update: int) -> int:
    """tools/learn.py:146-151 (i_update is 1-based)."""
    e = tcfg.gail_epoch
    if i_update < tcfg.gail_thre:
        e += (
            (tcfg.gail_pre_epoch - tcfg.gail_epoch)
            * (tcfg.gail_thre - (i_update - 1))
            / tcfg.gail_thre
        )
    return int(e)


def draw_disc_epoch(n_mb: int, mb: int, expert_size: int, total: int,
                    device, generator: Optional[torch.Generator]
                    ) -> DiscEpochDraws:
    e_idx = draw_perms(1, expert_size, n_mb * mb, device, generator)
    p_idx = draw_perms(1, total, n_mb * mb, device, generator)
    alpha = torch.rand((n_mb, mb, 1, 1, 1), generator=generator,
                       device=device)
    return DiscEpochDraws(e_idx.reshape(n_mb, mb), p_idx.reshape(n_mb, mb),
                          alpha)


def disc_update(
    scene,
    env_cfg: EnvConfig,
    tcfg: TrainConfig,
    dnet: disc_mod.DiscriminatorNet,
    optimizer: ClipAdam,
    dopt_state: AdamState,
    rollout: Rollout,
    expert: ExpertBuffer,
    generator: Optional[torch.Generator],
    n_epochs: int,
    draws: Optional[Sequence[DiscEpochDraws]] = None,
    group=None,
):
    """``n_epochs`` critic epochs; updates ``dnet``'s parameters in place
    and returns (opt_state, aux), the aux averaged over the minibatches of
    each epoch and then over the epochs run (zeros when none ran).
    ``draws`` holds one ``DiscEpochDraws`` per epoch; ``generator`` draws
    them when not given. With ``group`` each step's gradients are
    averaged over its ranks before the optimizer's step."""
    T, N = rollout.T, rollout.N
    total = T * N
    mb = tcfg.gail_batch_size
    n_mb = min(expert.size, total) // mb
    dev = rollout.actions.device
    met_f = rollout.metrics[:-1].reshape(-1, 4)
    act_f = rollout.actions.reshape(-1, 2)
    params = list(dnet.parameters())

    epoch_aux = []
    for ep in range(n_epochs):
        d = (draw_disc_epoch(n_mb, mb, expert.size, total, dev, generator)
             if draws is None else draws[ep])
        auxs = []
        for i in range(n_mb):
            e_idx = d.expert_idx[i].to(dev)
            p_idx = d.policy_idx[i].to(dev)
            e = (fetch_expert_obs(scene, env_cfg, expert, e_idx),
                 expert.metrics[e_idx], expert.actions[e_idx])
            p = (fetch_rollout_obs(scene, env_cfg, rollout, p_idx // N,
                                   p_idx % N),
                 met_f[p_idx], act_f[p_idx])
            wd, d_e, d_p = disc_mod.wd_loss(dnet, e, p)
            gp = disc_mod.grad_penalty(dnet, e, p, tcfg.grad_pen_lambda,
                                       alpha=d.alpha[i].to(dev))
            loss = -wd + gp
            grads = all_mean(torch.autograd.grad(loss, params), group)
            dopt_state = optimizer.step(params, grads, dopt_state)
            auxs.append(torch.stack([
                loss, wd, gp, d_p, d_e, torch.tanh(d_e),
                torch.tanh(d_p)]).detach())
        epoch_aux.append(torch.stack(auxs).mean(dim=0))
    if epoch_aux:
        aux = torch.stack(epoch_aux).sum(dim=0) / len(epoch_aux)
    else:
        aux = torch.zeros(len(AUX_KEYS), device=dev)
    return dopt_state, dict(zip(AUX_KEYS, aux))


@torch.no_grad()
def relabel_rewards(scene, env_cfg: EnvConfig,
                    dnet: disc_mod.DiscriminatorNet, rollout: Rollout,
                    chunk: int = 512) -> torch.Tensor:
    """tools/learn.py:196-209: gail_rewards[t] = predict_reward(obs_t,
    metrics_t, action_t), in chunks over the flattened buffer (the last
    chunk wraps around to the buffer's start, as the JAX package pads)."""
    T, N = rollout.T, rollout.N
    total = T * N
    n_chunks = -(-total // chunk)
    dev = rollout.actions.device
    idx = (torch.arange(n_chunks * chunk, device=dev) % total).reshape(
        n_chunks, chunk)
    met_f = rollout.metrics[:-1].reshape(-1, 4)
    act_f = rollout.actions.reshape(-1, 2)
    rew = []
    for ii in idx:
        obs = fetch_rollout_obs(scene, env_cfg, rollout, ii // N, ii % N)
        rew.append(disc_mod.predict_reward(dnet, obs, met_f[ii], act_f[ii]))
    return torch.cat(rew)[:total].reshape(T, N)


def draw_validation(expert_size: int, total: int, device,
                    generator: Optional[torch.Generator],
                    chunk: int = 256) -> torch.Tensor:
    """(n_chunks, chunk) uniform rollout rows for ``validation_wd``."""
    n_chunks = -(-expert_size // chunk)
    return torch.randint(0, total, (n_chunks, chunk), generator=generator,
                         device=device)


@torch.no_grad()
def validation_wd(scene, env_cfg: EnvConfig,
                  dnet: disc_mod.DiscriminatorNet, rollout: Rollout,
                  expert_val: ExpertBuffer,
                  generator: Optional[torch.Generator],
                  chunk: int = 256,
                  policy_idx: Optional[torch.Tensor] = None):
    """discriminator.compute_loss (wdgail.py:149-179): the mean tanh-D gap
    between the held-out expert set and rollout samples. Returns (wd,
    expert tanh mean, policy tanh mean). ``policy_idx`` (n_chunks, chunk)
    holds the rollout rows; ``generator`` draws them when not given."""
    T, N = rollout.T, rollout.N
    total = T * N
    m = expert_val.size
    n_chunks = -(-m // chunk)
    dev = rollout.actions.device
    e_idx = (torch.arange(n_chunks * chunk, device=dev) % m).reshape(
        n_chunks, chunk)
    if policy_idx is None:
        policy_idx = draw_validation(m, total, dev, generator, chunk)
    policy_idx = policy_idx.to(dev)
    met_f = rollout.metrics[:-1].reshape(-1, 4)
    act_f = rollout.actions.reshape(-1, 2)
    d_e, d_p = [], []
    for ei, pi in zip(e_idx, policy_idx):
        e_obs = fetch_expert_obs(scene, env_cfg, expert_val, ei)
        d_e.append(torch.tanh(dnet(e_obs, expert_val.metrics[ei],
                                   expert_val.actions[ei])))
        p_obs = fetch_rollout_obs(scene, env_cfg, rollout, pi // N, pi % N)
        d_p.append(torch.tanh(dnet(p_obs, met_f[pi], act_f[pi])))
    e_mean = torch.mean(torch.cat(d_e)[:m])
    p_mean = torch.mean(torch.cat(d_p)[:m])
    return e_mean - p_mean, e_mean, p_mean
