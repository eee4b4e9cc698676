"""The reference's optimizer steps: one step of the critic or of PPO as
the frozen ``disc_update`` and ``ppo_update`` take it, from given weights
on given rows, with the minibatch's gradient summed over slices of its
rows so that float32 fits on the card beside its inputs. Every loss is a
mean over the minibatch's rows, so the sum of the slices' gradients of
their rows' share is the minibatch's gradient; only the order of the
float32 sums differs from the unsliced step.

``half`` plants the fault of a step that leaves out half of its batch and
takes the mean over the rest, in the reference put in the program's
place (PERF.md)."""
from __future__ import annotations

import dataclasses

import torch

from bench_port.plain_reference.frozen.algo.buffers import (
    fetch_expert_obs, fetch_rollout_obs,
)
from bench_port.plain_reference.frozen.models import policy as policy_mod


def _add(acc, grads):
    if acc is None:
        return [g.clone() for g in grads]
    torch._foreach_add_(acc, grads)
    return acc


def _kept(mb: int, half: bool) -> int:
    return mb // 2 if half else mb


def disc_step(scene, cfg, tcfg, dnet, rollout, expert, e_idx, p_idx, alpha,
              rows: int = 1024, half: bool = False):
    """(loss, gradients, size) of one critic step on expert rows ``e_idx``
    and rollout rows ``p_idx`` (mb,) with the penalty's mixing weights
    ``alpha`` (mb, 1, 1, 1): loss = -(E tanh D_e - E tanh D_p) + lambda
    E (|grad D(mix)| - 1)^2; size the same sum of the terms' magnitudes,
    which cancels nowhere."""
    N = rollout.N
    mb = _kept(e_idx.shape[0], half)
    met_f = rollout.metrics[:-1].reshape(-1, 4)
    act_f = rollout.actions.reshape(-1, 2)
    params = list(dnet.parameters())
    lam = tcfg.grad_pen_lambda
    grads, loss, size = None, 0.0, 0.0
    for lo in range(0, mb, rows):
        sl = slice(lo, min(lo + rows, mb))
        e, p = e_idx[sl], p_idx[sl]
        e_obs = fetch_expert_obs(scene, cfg, expert, e)
        e_met, e_act = expert.metrics[e], expert.actions[e]
        p_obs = fetch_rollout_obs(scene, cfg, rollout, p // N, p % N)
        p_met, p_act = met_f[p], act_f[p]
        d_e = dnet(e_obs, e_met, e_act)
        d_p = dnet(p_obs, p_met, p_act)
        a = alpha[sl]
        a2 = a[:, :, 0, 0]
        mix = (a * e_obs + (1 - a) * p_obs).requires_grad_(True)
        dm = dnet(mix, a2 * e_met + (1 - a2) * p_met,
                  a2 * e_act + (1 - a2) * p_act)
        (g,) = torch.autograd.grad(dm.sum(), mix, create_graph=True)
        norm = torch.linalg.vector_norm(g.reshape(g.shape[0], -1), dim=1)
        gp_sum = lam * ((norm - 1.0) ** 2).sum()
        part = (-(torch.tanh(d_e).sum() - torch.tanh(d_p).sum())
                + gp_sum) / mb
        grads = _add(grads, torch.autograd.grad(part, params))
        loss += float(part.detach())
        size += float((torch.tanh(d_e).abs().sum() + torch.tanh(d_p).abs(
        ).sum() + gp_sum).detach()) / mb
    return loss, grads, size


@dataclasses.dataclass
class PPOBatch:
    """The update's rows as PPO takes them: flat (T*N, ...) with the
    advantages normalised over the whole buffer."""

    adv: torch.Tensor
    ret: torch.Tensor
    val: torch.Tensor
    logp: torch.Tensor
    act: torch.Tensor
    met: torch.Tensor


def ppo_batch(rollout, returns) -> PPOBatch:
    values = rollout.values[:-1]
    adv = returns - values
    mean = torch.mean(adv)
    adv = (adv - mean) / (torch.sqrt(torch.mean((adv - mean) ** 2)) + 1e-5)
    return PPOBatch(adv.reshape(-1), returns.reshape(-1), values.reshape(-1),
                    rollout.logp.reshape(-1), rollout.actions.reshape(-1, 2),
                    rollout.metrics[:-1].reshape(-1, 4))


def ppo_step(scene, cfg, tcfg, net, rollout, batch: PPOBatch, idx_mb,
             rows: int = 2048, half: bool = False):
    """(loss, gradients, size) of one PPO step on the rows ``idx_mb``
    (mb,), no BC blend: loss = value_loss_coef * the clipped value loss +
    the clipped surrogate's; size the same sum of the terms' magnitudes."""
    N = rollout.N
    mb = _kept(idx_mb.shape[0], half)
    params = list(net.parameters())
    clip = tcfg.clip_param
    grads, loss, size = None, 0.0, 0.0
    for lo in range(0, mb, rows):
        idx = idx_mb[lo:min(lo + rows, mb)]
        obs = fetch_rollout_obs(scene, cfg, rollout, idx // N, idx % N)
        value, logp, _ = policy_mod.evaluate_actions(
            net, obs, batch.met[idx], batch.act[idx])
        ratio = torch.exp(logp - batch.logp[idx])
        advt = batch.adv[idx]
        a_rows = torch.minimum(ratio * advt, torch.clamp(
            ratio, 1.0 - clip, 1.0 + clip) * advt)
        a_sum = -a_rows.sum()
        old_v, ret = batch.val[idx], batch.ret[idx]
        v_clip = old_v + torch.clamp(value - old_v, -clip, clip)
        v_sum = 0.5 * torch.maximum((value - ret) ** 2,
                                    (v_clip - ret) ** 2).sum()
        part = (v_sum * tcfg.value_loss_coef + a_sum) / mb
        grads = _add(grads, torch.autograd.grad(part, params))
        loss += float(part.detach())
        size += float((v_sum * tcfg.value_loss_coef + a_rows.abs().sum()
                       ).detach()) / mb
    return loss, grads, size
