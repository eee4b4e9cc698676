# Frozen copy of gail_carla_tpu_torch/algo/ppo.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""PPO with the clipped surrogate, the clipped value loss and the optional
BC blend ("BCGAIL"): port of ``gail_carla_tpu/algo/ppo.py``
(``algo/ppo.py:45-141`` of the reference).

Advantages are normalised over the whole buffer; ``ppo_epoch`` epochs of
shuffled minibatches follow, one Python iteration per minibatch in place
of the ``lax.scan``. The action loss is blended with a BC term weighted by
``gail_gamma``, on one fresh random expert batch per minibatch. Entropy is
logged but is not part of the loss, as in the reference. With a process
group (data parallelism over ranks) the advantage moments and every
step's gradients are averaged across the ranks, so each replica applies
the same step.
"""
from __future__ import annotations

from typing import Optional

import torch

from bench_port.plain_reference.frozen.algo.buffers import (
    ExpertBuffer, Rollout, fetch_expert_obs, fetch_rollout_obs,
)
from bench_port.plain_reference.frozen.algo.optim import AdamState, ClipAdam
from bench_port.plain_reference.frozen.config import EnvConfig, TrainConfig
from bench_port.plain_reference.frozen.models import policy as policy_mod
from bench_port.plain_reference.frozen.parallel.collectives import all_mean, pmean

AUX_KEYS = ("value_loss", "action_loss", "gail_action_loss", "bc_loss",
            "dist_entropy")


def make_policy_optimizer(tcfg: TrainConfig) -> ClipAdam:
    """clip_by_global_norm then adam; with ``use_linear_lr_decay`` the
    rate falls linearly per *update* (``tools/utli.py:121-125``), and an
    update takes ``ppo_epoch * minibatches`` optimizer steps."""
    steps = None
    if tcfg.use_linear_lr_decay:
        steps = max(tcfg.ppo_epoch * (tcfg.steps_per_env * tcfg.n_envs
                                      // tcfg.mini_batch_size), 1)
    return ClipAdam(tcfg.max_grad_norm, tcfg.lr, tcfg.betas[0],
                    tcfg.betas[1], tcfg.eps, steps_per_update=steps,
                    n_updates=max(tcfg.n_updates, 1))


def draw_perms(n_rows: int, total: int, keep: int, device,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """(n_rows, keep): the first ``keep`` of a fresh permutation of
    ``range(total)`` per row."""
    return torch.stack([
        torch.randperm(total, generator=generator, device=device)[:keep]
        for _ in range(n_rows)
    ])


def ppo_update(
    scene,
    env_cfg: EnvConfig,
    tcfg: TrainConfig,
    net: policy_mod.PolicyNet,
    optimizer: ClipAdam,
    opt_state: AdamState,
    rollout: Rollout,
    returns: torch.Tensor,        # (T, N)
    generator: Optional[torch.Generator],
    gail_gamma,                   # () BC weight (decays outside)
    expert: Optional[ExpertBuffer] = None,
    perms: Optional[torch.Tensor] = None,
    expert_idx: Optional[torch.Tensor] = None,
    group=None,
):
    """Updates ``net``'s parameters in place; returns (opt_state, aux),
    the aux averaged over the minibatches. ``perms`` (ppo_epoch, n_mb*mb)
    holds each epoch's shuffled rows and ``expert_idx`` (ppo_epoch*n_mb,
    mb) each minibatch's expert rows; ``generator`` draws what is not
    given. With ``group`` the advantage moments and the gradients are
    averaged over its ranks (the gradients before the optimizer's step,
    so the global-norm clip sees the mean gradient, as optax does after
    ``pmean``); the aux stays this rank's."""
    T, N = rollout.T, rollout.N
    total = T * N
    mb = tcfg.mini_batch_size
    n_mb = total // mb
    dev = returns.device

    values = rollout.values[:-1]
    adv = returns - values
    adv_mean = pmean(torch.mean(adv), group)
    adv_sq = pmean(torch.mean((adv - adv_mean) ** 2), group)
    adv = (adv - adv_mean) / (torch.sqrt(adv_sq) + 1e-5)

    adv_f = adv.reshape(-1)
    ret_f = returns.reshape(-1)
    val_f = values.reshape(-1)
    logp_f = rollout.logp.reshape(-1)
    act_f = rollout.actions.reshape(-1, 2)
    met_f = rollout.metrics[:-1].reshape(-1, 4)

    if perms is None:
        perms = draw_perms(tcfg.ppo_epoch, total, n_mb * mb, dev, generator)
    idx_all = perms.to(dev).reshape(tcfg.ppo_epoch * n_mb, mb)
    if expert is not None and expert_idx is None:
        expert_idx = torch.randint(0, expert.size, idx_all.shape,
                                   generator=generator, device=dev)
    params = list(net.parameters())
    auxs = []
    for i, idx in enumerate(idx_all):
        obs = fetch_rollout_obs(scene, env_cfg, rollout, idx // N, idx % N)
        metrics, actions = met_f[idx], act_f[idx]
        old_logp, old_v = logp_f[idx], val_f[idx]
        ret, advt = ret_f[idx], adv_f[idx]

        value, logp, entropy = policy_mod.evaluate_actions(
            net, obs, metrics, actions)
        ratio = torch.exp(logp - old_logp)
        surr1 = ratio * advt
        surr2 = torch.clamp(ratio, 1.0 - tcfg.clip_param,
                            1.0 + tcfg.clip_param) * advt
        action_loss = -torch.mean(torch.minimum(surr1, surr2))
        gail_action_loss = action_loss

        bc_loss = torch.zeros((), device=dev)
        if expert is not None:
            e_idx = expert_idx[i].to(dev)
            e_obs = fetch_expert_obs(scene, env_cfg, expert, e_idx)
            _, e_logp, _ = policy_mod.evaluate_actions(
                net, e_obs, expert.metrics[e_idx], expert.actions[e_idx])
            bc_loss = -torch.mean(e_logp)
            action_loss = (gail_gamma * bc_loss
                           + (1.0 - gail_gamma) * action_loss)

        v_clip = old_v + torch.clamp(value - old_v, -tcfg.clip_param,
                                     tcfg.clip_param)
        v_losses = (value - ret) ** 2
        v_losses_clip = (v_clip - ret) ** 2
        value_loss = 0.5 * torch.mean(torch.maximum(v_losses, v_losses_clip))

        total_loss = value_loss * tcfg.value_loss_coef + action_loss
        grads = all_mean(torch.autograd.grad(total_loss, params), group)
        opt_state = optimizer.step(params, grads, opt_state)
        auxs.append(torch.stack([
            value_loss, action_loss, gail_action_loss, bc_loss,
            torch.mean(entropy)]).detach())
    aux_mean = torch.stack(auxs).mean(dim=0)
    return opt_state, dict(zip(AUX_KEYS, aux_mean))
