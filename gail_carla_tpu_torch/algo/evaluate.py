"""Deterministic policy evaluation: port of
``gail_carla_tpu/algo/evaluate.py`` (``tools/learn.py:225-258``). Runs the
policy with deterministic actions and reports, per env, the first
finished episode's reward / length / completion and leaderboard fields
(``ego_vehicle_handler.py:208-248``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from gail_carla_tpu_torch.algo.buffers import obs_batch
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.models import policy as policy_mod
from gail_carla_tpu_torch.sim.env import (
    ResetDraws, StepDraws, reset_batch, step_batch,
)

_LATCH_KEYS = (
    ("reward", "episode_reward", torch.float32),
    ("length", "episode_length", torch.int32),
    ("completed", "route_completed", torch.bool),
    ("score_route", "score_route", torch.float32),
    ("score_penalty", "score_penalty", torch.float32),
    ("score_composed", "score_composed", torch.float32),
    ("n_red_light", "n_red_light", torch.int32),
    ("n_stop_sign", "n_stop_sign", torch.int32),
    ("red_light_per_km", "red_light_per_km", torch.float32),
    ("collision", "collision", torch.bool),
)


def evaluate_policy(
    scene,
    env_cfg: EnvConfig,
    net,
    generator: Optional[torch.Generator],
    route_id: Optional[int] = None,
    n_envs: int = 1,
    max_steps: int = 2400,
    route_ids=None,
    reset_draws: Optional[ResetDraws] = None,
    reset_gnss: Optional[torch.Tensor] = None,
    env_draws: Optional[Sequence[StepDraws]] = None,
):
    """Returns a dict of (n_envs,) tensors for the FIRST episode finished
    in each env (episodes auto-reset; the first done is latched). The loop
    stops once every env has finished one episode, which returns what the
    full ``max_steps`` would.

    Pass either a scalar ``route_id`` (all envs on that route, the
    held-out-route eval) or ``route_ids`` (one env per route).
    ``reset_draws`` and ``reset_gnss`` optionally supply the draws of the
    initial reset (``reset_batch``'s ``draws`` and ``gnss_noise``) and
    ``env_draws`` (one ``StepDraws`` per step) the environment's at each
    step; ``generator`` draws whatever is not supplied."""
    # leaderboard termination keeps driving scores comparable across
    # training terminal modes
    eval_cfg = dataclasses.replace(
        env_cfg, train=False, terminal_mode="leaderboard"
    )
    dev = scene.device
    if route_ids is None:
        route_ids = torch.full((n_envs,), route_id, dtype=torch.int32,
                               device=dev)
    else:
        route_ids = torch.as_tensor(route_ids, dtype=torch.int32,
                                    device=dev)
        n_envs = route_ids.shape[0]
    st, metrics, render = reset_batch(scene, eval_cfg, route_ids, generator,
                                      draws=reset_draws,
                                      gnss_noise=reset_gnss)

    latched = {"done": torch.zeros(n_envs, dtype=torch.bool, device=dev)}
    for name, _, dt in _LATCH_KEYS:
        latched[name] = torch.zeros(n_envs, dtype=dt, device=dev)
    for t in range(max_steps):
        obs = obs_batch(scene, eval_cfg, render)
        _, action, _ = policy_mod.act(net, obs, metrics, deterministic=True)
        draws = {} if env_draws is None else env_draws[t]._asdict()
        st, out = step_batch(scene, eval_cfg, st, action, generator, **draws)
        first_done = out.done & (~latched["done"])
        latched["done"] = latched["done"] | out.done
        for name, info_key, dt in _LATCH_KEYS:
            latched[name] = torch.where(
                first_done, out.info[info_key].to(dt), latched[name]
            )
        metrics, render = out.metrics, out.render
        # nothing after every env's first episode reaches the result
        if bool(latched["done"].all()):
            break
    return latched
