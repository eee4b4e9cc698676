"""On-device rollout collection: port of ``gail_carla_tpu/algo/rollout.py``
(``tools/learn.py:111-133``). The policy acts and the world steps on the
device, one Python iteration per step in place of ``lax.scan``; each
step's observation comes from the BEV renderer of ``cfg.obs_mode`` (a
CUDA kernel on the card) or, at ``"state"``, from the state vector.

With ``store_obs=True`` (the learner's default) each step's observation
and the bootstrap's are kept bit-packed (``algo/buffers.py``; state
vectors as float32); with ``store_obs=False`` minibatches re-derive them
from the compact render states and metrics.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from gail_carla_tpu_torch.algo.buffers import Rollout, obs_batch, store_encode
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.models import policy as policy_mod
from gail_carla_tpu_torch.sim.env import StepDraws, step_batch
from gail_carla_tpu_torch.utils.trace import span


def stack_states(states: List):
    """Stack a list of same-structure dataclass states along a new axis 0."""
    first = states[0]
    return type(first)(**{
        f.name: torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(first)
    })


def collect_rollout(
    scene,
    cfg: EnvConfig,
    net,
    env_states,
    metrics0,
    render0,
    generator: Optional[torch.Generator],
    n_steps: int,
    store_obs: bool = False,
    action_noise: Optional[torch.Tensor] = None,
    env_draws: Optional[Sequence[StepDraws]] = None,
) -> Tuple:
    """Returns (env_states', metrics', render', rollout, ep_stats).
    ``action_noise`` (n_steps, N, 2) optionally supplies the standard
    normal action draws and ``env_draws`` (one ``StepDraws`` per step) the
    environment's; ``generator`` draws whatever is not supplied."""
    st, metrics, render = env_states, metrics0, render0
    tr = {k: [] for k in ("metrics", "render", "action", "logp", "value",
                          "reward", "done", "ep_reward", "ep_length",
                          "completed", "obs")}
    for t in range(n_steps):
        obs = obs_batch(scene, cfg, render, metrics)
        value, action, logp = policy_mod.act(
            net, obs, metrics, generator,
            noise=None if action_noise is None else action_noise[t],
        )
        draws = {} if env_draws is None else env_draws[t]._asdict()
        st2, out = step_batch(scene, cfg, st, action, generator, **draws)
        if store_obs:
            with span("rollout.store"):
                tr["obs"].append(store_encode(cfg, obs))
        tr["metrics"].append(metrics)
        tr["render"].append(render)
        tr["action"].append(action)
        tr["logp"].append(logp)
        tr["value"].append(value)
        tr["reward"].append(out.reward)
        tr["done"].append(out.done)
        tr["ep_reward"].append(out.info["episode_reward"])
        tr["ep_length"].append(out.info["episode_length"])
        tr["completed"].append(out.info["route_completed"])
        st, metrics, render = st2, out.metrics, out.render

    # bootstrap value for the final obs (tools/learn.py:137-139)
    obs_f = obs_batch(scene, cfg, render, metrics)
    value_f, _, _ = policy_mod.act(net, obs_f, metrics, deterministic=True)
    obs_all = None
    if store_obs:
        with span("rollout.store"):
            obs_all = torch.stack(tr["obs"] + [store_encode(cfg, obs_f)])

    done = torch.stack(tr["done"])
    masks = 1.0 - done.to(torch.float32)
    rollout = Rollout(
        render=stack_states(tr["render"] + [render]),
        metrics=torch.stack(tr["metrics"] + [metrics]),
        obs=obs_all,
        actions=torch.stack(tr["action"]),
        logp=torch.stack(tr["logp"]),
        values=torch.stack(tr["value"] + [value_f]),
        env_rewards=torch.stack(tr["reward"]),
        masks=torch.cat([torch.ones_like(masks[:1]), masks]),
        gail_rewards=torch.zeros_like(masks),
    )

    ep_reward = torch.stack(tr["ep_reward"])
    ep_length = torch.stack(tr["ep_length"])
    completed = torch.stack(tr["completed"])
    n_done = done.sum()
    n_eps = n_done.clamp_min(1)
    ep_stats = {
        "n_episodes": n_done,
        "ep_reward_mean": torch.where(done, ep_reward, 0.0).sum() / n_eps,
        "ep_length_mean": torch.where(done, ep_length, 0).sum() / n_eps,
        "completion_rate": torch.where(
            done, completed.to(torch.float32), 0.0).sum() / n_eps,
        "env_reward_mean": rollout.env_rewards.mean(),
    }
    return st, metrics, render, rollout, ep_stats
