"""Named environment registry: port of ``gail_carla_tpu/envs/registry.py``
(the gym registrations in ``carla_gym/__init__.py:8-79``, 10 env ids)."""
from __future__ import annotations

from typing import Dict

from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.envs.gym_env import DrivingEnv
from gail_carla_tpu_torch.envs.suites import (
    corl2017_suite, endless_suite, leaderboard_suite, nocrash_suite,
)

_AVAILABLE_ENVS = {
    "NoCrash-v0": (nocrash_suite, {"background_traffic": "empty"},
                   "Empty background traffic."),
    "NoCrash-v1": (nocrash_suite, {"background_traffic": "regular"},
                   "Regular background traffic."),
    "NoCrash-v2": (nocrash_suite, {"background_traffic": "dense"},
                   "Dense background traffic."),
    "NoCrash-v3": (nocrash_suite, {"background_traffic": "leaderboard"},
                   "Moderate background traffic."),
    "CoRL2017-v0": (corl2017_suite, {"task_type": "straight"}, "straight"),
    "CoRL2017-v1": (corl2017_suite, {"task_type": "one_curve"},
                    "one_curve"),
    "CoRL2017-v2": (corl2017_suite, {"task_type": "navigation"},
                    "navigation"),
    "CoRL2017-v3": (corl2017_suite, {"task_type": "navigation_dynamic"},
                    "navigation_dynamic"),
    "Endless-v0": (endless_suite, {}, "endless env for rl training"),
    "LeaderBoard-v0": (leaderboard_suite, {}, "leaderboard routes"),
}

# built suites, keyed on the id, the overrides and the device
_SUITE_CACHE: Dict[tuple, tuple] = {}


def available_envs():
    return {k: v[2] for k, v in _AVAILABLE_ENVS.items()}


def make(env_id: str, device="cuda", **overrides) -> DrivingEnv:
    """A ``DrivingEnv`` over the suite of ``env_id`` on ``device`` (the
    card unless the caller names another); ``overrides`` go to the suite
    builder."""
    if env_id not in _AVAILABLE_ENVS:
        raise KeyError(
            f"unknown env {env_id!r}; available: {sorted(_AVAILABLE_ENVS)}"
        )
    dev = resolve_device(device)
    suite_fn, kwargs, _ = _AVAILABLE_ENVS[env_id]
    key = (env_id, tuple(sorted(overrides.items())), str(dev))
    if key not in _SUITE_CACHE:
        _SUITE_CACHE[key] = suite_fn(**{**kwargs, **overrides}, device=dev)
    scene, cfg, tasks = _SUITE_CACHE[key]
    return DrivingEnv(scene, cfg, tasks)
