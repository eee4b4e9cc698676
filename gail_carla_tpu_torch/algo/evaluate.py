"""Deterministic policy evaluation: port of
``gail_carla_tpu/algo/evaluate.py`` (``tools/learn.py:225-258``). Runs the
policy with deterministic actions and reports, per env, the first
finished episode's reward / length / completion and leaderboard fields
(``ego_vehicle_handler.py:208-248``).

``run_latched`` is the loop itself, shared with the policy benchmarks
(``tools/benchmark_policy.py``, ``tools/nocrash_bench.py``): it drives
one env per route id with the policy or the scripted expert and latches
chosen info fields at each env's first done.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from gail_carla_tpu_torch.agents.autopilot import (
    TARGET_SPEED, autopilot_act, reset_autopilot_where,
)
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.algo.buffers import obs_batch
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.models import policy as policy_mod
from gail_carla_tpu_torch.sim.env import (
    ResetDraws, StepDraws, reset_batch, step_batch,
)

# (result name, info key, dtype) latched by evaluate_policy
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


def run_latched(
    scene,
    cfg: EnvConfig,
    route_ids: torch.Tensor,
    latch_keys: Sequence[Tuple[str, str, torch.dtype]],
    max_steps: int,
    generator: Optional[torch.Generator],
    net=None,
    expert: bool = False,
    obey_signals: bool = True,
    reset_draws: Optional[ResetDraws] = None,
    reset_gnss: Optional[torch.Tensor] = None,
    env_draws: Optional[Sequence[StepDraws]] = None,
):
    """Resets one env per entry of ``route_ids`` and steps them with the
    policy ``net`` (deterministic actions on ``obs_batch``'s observation)
    or, with ``expert``, the scripted expert at 6 m/s (``autopilot_act``,
    fresh controllers after each done). Returns (a dict of (N,) tensors:
    ``done`` and each ``latch_keys`` entry taken at the env's FIRST done,
    the steps run). The loop stops once every env has finished an
    episode, which returns what the full ``max_steps`` would. The draws
    arguments are ``evaluate_policy``'s."""
    dev = scene.device
    n = route_ids.shape[0]
    st, metrics, render = reset_batch(scene, cfg, route_ids, generator,
                                      draws=reset_draws,
                                      gnss_noise=reset_gnss)
    ap = make_autopilot((n,), dev) if expert else None
    latched = {"done": torch.zeros(n, dtype=torch.bool, device=dev)}
    for name, _, dt in latch_keys:
        latched[name] = torch.zeros(n, dtype=dt, device=dev)
    steps = 0
    for t in range(max_steps):
        if expert:
            ap, action = autopilot_act(scene, ap, st, TARGET_SPEED,
                                       obey_signals)
        else:
            obs = obs_batch(scene, cfg, render)
            _, action, _ = policy_mod.act(net, obs, metrics,
                                          deterministic=True)
        draws = {} if env_draws is None else env_draws[t]._asdict()
        st, out = step_batch(scene, cfg, st, action, generator, **draws)
        steps += 1
        if expert:
            ap = reset_autopilot_where(out.done, ap)
        first_done = out.done & (~latched["done"])
        latched["done"] = latched["done"] | out.done
        for name, info_key, dt in latch_keys:
            latched[name] = torch.where(
                first_done, out.info[info_key].to(dt), latched[name]
            )
        metrics, render = out.metrics, out.render
        # nothing after every env's first episode reaches the result
        if bool(latched["done"].all()):
            break
    return latched, steps


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
    latched, _ = run_latched(scene, eval_cfg, route_ids, _LATCH_KEYS,
                             max_steps, generator, net=net,
                             reset_draws=reset_draws, reset_gnss=reset_gnss,
                             env_draws=env_draws)
    return latched
