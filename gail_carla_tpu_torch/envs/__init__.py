"""The gym-style environment API: ``DrivingEnv`` (one world), ``VecEnv``
(a batch of worlds), the task suites and the registry of the reference's
10 env ids (``make``)."""
from gail_carla_tpu_torch.envs.gym_env import DrivingEnv
from gail_carla_tpu_torch.envs.registry import available_envs, make
from gail_carla_tpu_torch.envs.suites import (
    corl2017_suite, endless_suite, leaderboard_suite, nocrash_suite,
)
from gail_carla_tpu_torch.envs.vec_env import VecEnv

__all__ = [
    "DrivingEnv", "VecEnv", "available_envs", "make", "corl2017_suite",
    "endless_suite", "leaderboard_suite", "nocrash_suite",
]
