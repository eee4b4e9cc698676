"""Gym-style single-env wrapper: port of
``gail_carla_tpu/envs/gym_env.py::DrivingEnv``, the ``CarlaEnv`` drop-in
(``carla_env.py:81-174``): a host-facing numpy API over one world (N=1)
of the batched simulator on the scene's device.

reset() -> (obs, metrics); step(action) -> (obs, metrics, reward, done,
info). obs is the (3, W, W) float BEV (mask 0, the 3-channel render for
every suite, traffic or not, as in the JAX package), rendered by the
CUDA kernel B1 on the card and by its plain version on the CPU; metrics
the 4-vector [target lat, target lon, speed, command]. With
``obs_dict=True`` the obs is instead the reference's full per-hero
ObsManager dict (``sim/observations.py::observe_full``). For throughput
use ``VecEnv`` or the batched rollout in ``algo/``.

Randomness: the world's draws come from a ``torch.Generator`` seeded
with ``seed`` unless ``reset``/``step`` are given them; the task shuffle
and the weather come from ``random.Random(seed)``, the task index first
and then the weather at every reset, as in the JAX package.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.envs.spaces import Box
from gail_carla_tpu_torch.envs.vec_env import host_outputs
from gail_carla_tpu_torch.ops.bev import render_bev_batch_auto
from gail_carla_tpu_torch.sim.env import (
    ResetDraws, StepDraws, reset_batch, step_batch,
)
from gail_carla_tpu_torch.sim.observations import observe_full
from gail_carla_tpu_torch.sim.weather import (
    Weather, headlights_on, make_weather, weather_at,
)


def _numpy_tree(tree):
    """A nested dict of (1, ...) tensors as numpy arrays without the env
    axis."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree[0].cpu().numpy()


class DrivingEnv:
    def __init__(
        self,
        scene,
        env_cfg: EnvConfig,
        tasks: Optional[List[Dict]] = None,
        route_id: int = 0,
        seed: int = 2021,
        shuffle_tasks: bool = True,
        obs_dict: bool = False,
    ):
        self.scene = scene
        self.cfg = env_cfg
        self.tasks = tasks or [
            {"route_id": route_id, "weather": "ClearNoon",
             "n_npc_vehicles": env_cfg.n_npc_vehicles,
             "n_npc_walkers": env_cfg.n_npc_walkers}
        ]
        self._task_idx = 0
        self._shuffle = shuffle_tasks
        self._py_rng = random.Random(seed)
        self._gen = torch.Generator(device=scene.device)
        self._gen.manual_seed(seed)
        self._obs_dict = obs_dict
        self._state = None
        self._last_info: Dict = {}

        w = env_cfg.bev_width
        self.action_space = Box(-10.0, 10.0, (2,))          # carla_env.py:93
        self.observation_space = Box(0.0, 1.0, (3, w, w))
        self.metrics_space = Box(-100.0, 100.0, (4,))

    # -- CarlaMultiAgentEnv.set_task_idx (carla_multi_agent_env.py:52) --
    def set_task_idx(self, task_idx: int):
        self._task_idx = task_idx % len(self.tasks)

    @property
    def task(self) -> Dict:
        return self.tasks[self._task_idx]

    @property
    def route_completed(self) -> bool:
        return bool(self._last_info.get("route_completed", False))

    def _render(self, render):
        """The BEV to copy with this step's outputs, None in dict mode."""
        if self._obs_dict:
            return None
        return render_bev_batch_auto(self.scene, self.cfg, render)

    def _obs(self, obs):
        if self._obs_dict:
            return _numpy_tree(observe_full(self.scene, self.cfg,
                                            self._state))
        return obs[0]

    def reset(self, draws: Optional[ResetDraws] = None,
              gnss_noise: Optional[torch.Tensor] = None):
        """Starts an episode on the (shuffled) task's route. ``draws`` and
        ``gnss_noise`` optionally give ``reset_batch``'s draws for N=1."""
        if self._shuffle and len(self.tasks) > 1:
            self._task_idx = self._py_rng.randrange(len(self.tasks))
        route_id = torch.tensor([self.task["route_id"]], dtype=torch.int32,
                                device=self.scene.device)
        self._state, metrics, render = reset_batch(
            self.scene, self.cfg, route_id, self._gen, draws=draws,
            gnss_noise=gnss_noise,
        )
        obs, metrics, _, _, _ = host_outputs(self._render(render), metrics)
        self._last_info = {}
        self.episode_reward = 0.0
        # WeatherHandler.reset semantics (dynamic_weather.py:89-106),
        # evolved on the host per step: weather is visual-only metadata
        self._weather_params = make_weather(
            self.task.get("weather", "ClearNoon"), self._py_rng
        )
        self._sim_t = 0.0
        return self._obs(obs), metrics[0]

    def _weather_now(self) -> Weather:
        return weather_at(self._weather_params,
                          torch.tensor(self._sim_t, dtype=torch.float32))

    @property
    def weather(self) -> Weather:
        """``world.get_weather()``: the current Weather (numpy scalars),
        evolved to the episode's elapsed sim time."""
        w = self._weather_now()
        return Weather(**{k: v.numpy() for k, v in vars(w).items()})

    def step(self, action, draws: Optional[StepDraws] = None):
        """One tick; ``draws`` optionally gives ``step_batch``'s draws for
        N=1."""
        assert self._state is not None, "call reset() first"
        action = torch.as_tensor(
            np.asarray(action, np.float32)[None], device=self.scene.device
        )
        kw = {} if draws is None else draws._asdict()
        self._state, out = step_batch(self.scene, self.cfg, self._state,
                                      action, self._gen, **kw)
        obs, metrics, reward, done, infos = host_outputs(
            self._render(out.render), out.metrics, out
        )
        reward, done, info = float(reward[0]), bool(done[0]), infos[0]
        self.episode_reward += reward
        info["route_id"] = self.task["route_id"]
        info["episode_reward"] = self.episode_reward
        # weather tick + the sun-angle headlight rule
        # (task_vehicle.py:175-181), on the host
        self._sim_t += self.cfg.dt
        w = self._weather_now()
        info["sun_altitude_angle"] = float(w.sun_altitude_angle)
        info["vehicle_lights_on"] = bool(headlights_on(w))
        if done:
            info["episode"] = {
                "r": self.episode_reward, "l": info["episode_length"]
            }
            self.episode_reward = 0.0
        self._last_info = info
        return self._obs(obs), metrics[0], reward, done, info

    def close(self):
        pass
