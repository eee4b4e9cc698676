"""Behaviour cloning: port of ``gail_carla_tpu/algo/bc.py``
(``learn_bc.py:15-72``).

Maximises the expert actions' log-probability with Adam (3e-4) over
shuffled minibatches, evaluates on a held-out buffer after each epoch, and
keeps the best parameters (the reference saves ``carla_actor_bc.pt`` at
each improvement, learn_bc.py:70-72). Observations come through
``algo/buffers.py::fetch_expert_obs``: a buffer's stored planes or packed
obs, or a re-render (kernel B1 or B2 on the card).

Randomness: each epoch's permutation is injectable (``perms``); what is
not given is drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch

from gail_carla_tpu_torch.algo.buffers import ExpertBuffer, fetch_expert_obs
from gail_carla_tpu_torch.algo.optim import AdamState, ClipAdam
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.models import policy as policy_mod

BC_LR = 3e-4        # learn_bc.py:27 (Adam's default betas)
EVAL_BATCH = 256    # bc_eval's minibatch


def make_bc_optimizer(lr: float = BC_LR,
                      max_grad_norm: float = 1.0) -> ClipAdam:
    """Adam with global-norm clipping at 1.0. The reference's BC runs
    unclipped (learn_bc.py:27), but with the policy's small fixed action
    std the NLL gradient scales like (a - mu) / std^2: an unclipped run of
    the JAX package diverged into a dead network (docs/results/logs/
    r3b_bc_s0.log). The clip is PPO's bound and leaves the objective as
    it is."""
    return ClipAdam(max_norm=max_grad_norm, lr=lr, b1=0.9, b2=0.999,
                    eps=1e-8)


def _nll(scene, env_cfg: EnvConfig, net, expert: ExpertBuffer, idx):
    obs = fetch_expert_obs(scene, env_cfg, expert, idx)
    _, logp, _ = policy_mod.evaluate_actions(
        net, obs, expert.metrics[idx], expert.actions[idx])
    return -torch.mean(logp)


def bc_epoch(scene, env_cfg: EnvConfig, net, optimizer: ClipAdam,
             opt_state: AdamState, expert: ExpertBuffer,
             perm: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             batch_size: int = 32):
    """One training epoch over the expert buffer, updating ``net`` in
    place: the first ``size // batch_size`` minibatches of the
    permutation ``perm`` (size,). Returns (opt_state', mean train loss)."""
    dev = expert.actions.device
    if perm is None:
        perm = torch.randperm(expert.size, generator=generator, device=dev)
    n_mb = expert.size // batch_size
    idx = perm[:n_mb * batch_size].to(dev).reshape(n_mb, batch_size)
    params = list(net.parameters())
    losses = []
    for mb in idx:
        loss = _nll(scene, env_cfg, net, expert, mb)
        grads = torch.autograd.grad(loss, params)
        opt_state = optimizer.step(params, grads, opt_state)
        losses.append(loss.detach())
    if not losses:
        # a buffer smaller than one minibatch: the mean of no losses, as
        # JAX's mean over an empty scan
        return opt_state, torch.full((), float("nan"), device=dev)
    return opt_state, torch.stack(losses).mean()


@torch.no_grad()
def bc_eval(scene, env_cfg: EnvConfig, net, expert: ExpertBuffer,
            batch_size: int = EVAL_BATCH) -> torch.Tensor:
    """Mean negative log-prob on a (held-out) buffer (learn_bc.py:44-63):
    ``max(size // batch_size, 1)`` minibatches of consecutive rows,
    wrapping around a buffer smaller than one."""
    n_mb = max(expert.size // batch_size, 1)
    dev = expert.actions.device
    idx = (torch.arange(n_mb * batch_size, device=dev)
           % expert.size).reshape(n_mb, batch_size)
    return torch.stack([_nll(scene, env_cfg, net, expert, mb)
                        for mb in idx]).mean()


def learn_bc(scene, env_cfg: EnvConfig, net, expert_train: ExpertBuffer,
             expert_eval: ExpertBuffer,
             generator: Optional[torch.Generator] = None,
             epochs: int = 300,           # learn_bc.py:28
             batch_size: int = 32,
             log_fn: Optional[Callable] = None,
             perms: Optional[Sequence[torch.Tensor]] = None):
    """A full BC run from ``net``'s weights (trained in place); returns
    (a copy of the net at its best held-out loss, that loss)."""
    optimizer = make_bc_optimizer()
    opt_state = optimizer.init(list(net.parameters()))
    best_net, best_loss = copy.deepcopy(net), float("inf")
    for e in range(epochs):
        opt_state, train_loss = bc_epoch(
            scene, env_cfg, net, optimizer, opt_state, expert_train,
            None if perms is None else perms[e], generator, batch_size)
        eval_loss = float(bc_eval(scene, env_cfg, net, expert_eval))
        if eval_loss < best_loss:
            best_net, best_loss = copy.deepcopy(net), eval_loss
        if log_fn:
            log_fn(e, float(train_loss), eval_loss)
    return best_net, best_loss
