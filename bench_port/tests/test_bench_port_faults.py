"""Whole runs of each cell, cut to a CPU size (``tinycells``), past the
harness's look for a card: a sound run comes out correct under the cells'
limits, and a run whose timed path is broken underneath comes out not
correct, for each fault the cell can have: a step that returns its state
unchanged (from the first step, or from the fourth of each update on),
half of the batch left out with the mean over the rest (of the rows a
step takes, or inside a loss), PPO's epochs after the first skipped, and
an answer altered where it is produced. (One chip: no exchange between
chips to leave out.)"""
import dataclasses
import json

import pytest
import torch

from bench_port.harness import feed
from bench_port.tests.tinycells import run_tiny

TRAIN = ("bev6.train.4096",)
ROLLOUT = ("bev6.rollout.dense.4096",)


@pytest.fixture(autouse=True)
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(feed, "CACHE_DIR", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def correct(capsys, name, **kw):
    assert run_tiny(name, **kw) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "correct"]


@pytest.mark.parametrize("name", TRAIN + ROLLOUT)
def test_sound_run_is_correct(capsys, name):
    assert correct(capsys, name)


def unchanged_update(monkeypatch):
    from gail_carla_tpu_torch.algo import optim

    monkeypatch.setattr(optim.ClipAdam, "step",
                        lambda self, params, grads, state: state)


def half_batch_update(monkeypatch):
    from gail_carla_tpu_torch.algo import ppo

    real = ppo.ppo_update

    def half(*a, perms=None, **k):
        mb = a[2].mini_batch_size
        p = perms.reshape(perms.shape[0], -1, mb).clone()
        p[..., mb // 2:] = p[..., :mb // 2]
        return real(*a, perms=p.reshape(perms.shape), **k)

    monkeypatch.setattr(ppo, "ppo_update", half)


def unchanged_after_three(monkeypatch):
    """PPO's optimizer leaves the state unchanged from the fourth step of
    each update on."""
    from gail_carla_tpu_torch.algo import ppo

    real = ppo.ppo_update

    def lazy(scene, env_cfg, tcfg, net, optimizer, *a, **k):
        calls = []

        class Lazy:
            def step(self, params, grads, state):
                calls.append(1)
                return (optimizer.step(params, grads, state)
                        if len(calls) <= 3 else state)

        return real(scene, env_cfg, tcfg, net, Lazy(), *a, **k)

    monkeypatch.setattr(ppo, "ppo_update", lazy)


def first_epoch_only(monkeypatch):
    """PPO skips every epoch after the first."""
    from gail_carla_tpu_torch.algo import ppo

    real = ppo.ppo_update

    def one(scene, env_cfg, tcfg, *a, perms=None, **k):
        return real(scene, env_cfg, dataclasses.replace(tcfg, ppo_epoch=1),
                    *a, perms=perms[:1], **k)

    monkeypatch.setattr(ppo, "ppo_update", one)


class HalfMean:
    """``torch``, whose mean over a vector (a loss's mean over its rows)
    takes the first half of the rows alone."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def mean(x, *a, **k):
        if x.dim() == 1 and not a and not k:
            return torch.mean(x[:x.shape[0] // 2])
        return torch.mean(x, *a, **k)


def half_batch_ppo_loss(monkeypatch):
    from gail_carla_tpu_torch.algo import ppo

    monkeypatch.setattr(ppo, "torch", HalfMean())


def half_batch_critic_loss(monkeypatch):
    from gail_carla_tpu_torch.models import discriminator

    monkeypatch.setattr(discriminator, "torch", HalfMean())


def altered_relabel(monkeypatch):
    from gail_carla_tpu_torch.algo import wdgail

    real = wdgail.relabel_rewards
    monkeypatch.setattr(wdgail, "relabel_rewards",
                        lambda *a, **k: real(*a, **k) + 0.1)


def unchanged_step(monkeypatch):
    from gail_carla_tpu_torch.algo import rollout

    real = rollout.step_batch

    def step(scene, cfg, state, action, *a, **k):
        _, out = real(scene, cfg, state, action, *a, **k)
        return state, out

    monkeypatch.setattr(rollout, "step_batch", step)


def half_batch_step(monkeypatch):
    from gail_carla_tpu_torch.algo import rollout
    from gail_carla_tpu_torch.sim.state import tree_select

    real = rollout.step_batch

    def step(scene, cfg, state, action, *a, **k):
        new, out = real(scene, cfg, state, action, *a, **k)
        n = action.shape[0]
        first = torch.arange(n, device=action.device) < n // 2
        return tree_select(first, new, state), out

    monkeypatch.setattr(rollout, "step_batch", step)


def altered_action(monkeypatch):
    from gail_carla_tpu_torch.models import policy

    real = policy.act

    def act(*a, **k):
        value, action, logp = real(*a, **k)
        return value, action + 0.05, logp

    monkeypatch.setattr(policy, "act", act)


TRAIN_FAULTS = [unchanged_update, unchanged_after_three, half_batch_update,
                half_batch_ppo_loss, half_batch_critic_loss, first_epoch_only,
                altered_relabel]


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_are_caught(capsys, monkeypatch, name, fault):
    fault(monkeypatch)
    assert not correct(capsys, name)


@pytest.mark.parametrize("fault", [unchanged_step, half_batch_step,
                                   altered_action])
@pytest.mark.parametrize("name", ROLLOUT)
def test_rollout_faults_are_caught(capsys, monkeypatch, name, fault):
    fault(monkeypatch)
    assert not correct(capsys, name)
