"""Vector-env API over the batched simulator: port of
``gail_carla_tpu/envs/vec_env.py::TpuVecEnv``, the SubprocVecEnv
replacement with the reference ABC's surface (``vec_env/vec_env.py:6-104``:
reset / step_async / step_wait / step / close), minus the N worker
processes and pickled pipes: all worlds advance in one batched step on
the scene's device.

Outputs are numpy, as the reference's are. Each step's outputs (the
observation, the metrics, reward and done, every info value) reach the
host in one device-to-host copy (``host_outputs``), and the per-env info
dicts are built there.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.envs.spaces import Box
from gail_carla_tpu_torch.ops.bev import render_bev_batch_auto
from gail_carla_tpu_torch.sim.env import (
    ResetDraws, StepDraws, StepOutput, reset_batch, step_batch,
)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def host_outputs(obs: Optional[torch.Tensor], metrics: torch.Tensor,
                 out: Optional[StepOutput] = None):
    """(obs, metrics, reward, done, infos) on the host from one copy: the
    float32 observation's bytes and every scalar output as float64 (exact
    for float32, int32 and bool) go to the host in one buffer. ``infos``
    holds one dict per env with Python bool / int / float values, as
    ``.item()`` gives them. Without ``out`` (a reset) reward, done and
    infos are None."""
    n = metrics.shape[0]
    cols = [metrics.to(torch.float64)]
    keys: List[str] = []
    if out is not None:
        keys = list(out.info)
        cols += [out.reward.to(torch.float64)[:, None],
                 out.done.to(torch.float64)[:, None]]
        cols += [out.info[k].to(torch.float64)[:, None] for k in keys]
    scalars = torch.cat(cols, dim=1)
    parts = [_bytes(scalars)]
    if obs is not None:
        parts.insert(0, _bytes(obs.to(torch.float32)))
    buf = torch.cat(parts).cpu().numpy()
    n_obs = 0 if obs is None else obs.numel() * 4
    obs_np = (None if obs is None else
              buf[:n_obs].view(np.float32).reshape(tuple(obs.shape)))
    sc = buf[n_obs:].view(np.float64).reshape(n, -1)
    metrics_np = sc[:, :4].astype(np.float32)
    if out is None:
        return obs_np, metrics_np, None, None, None
    reward = sc[:, 4].astype(np.float32)
    done = sc[:, 5] != 0.0
    values = []
    for j, k in enumerate(keys):
        col = sc[:, 6 + j]
        dt = out.info[k].dtype
        if dt == torch.bool:
            values.append((col != 0.0).tolist())
        elif dt.is_floating_point:
            values.append(col.tolist())
        else:
            values.append(col.astype(np.int64).tolist())
    infos = [dict(zip(keys, row)) for row in zip(*values)]
    return obs_np, metrics_np, reward, done, infos


class VecEnv:
    """``num_envs`` worlds on ``scene``'s device; env i drives route
    ``route_ids[i]`` (round-robin over the scene's routes by default,
    tools/envs.py:29-33). ``reset`` and ``step_wait`` take optional draws
    (``ResetDraws`` and the first observe's GNSS noise; a ``StepDraws``),
    else ``seed``'s generator draws them."""

    def __init__(
        self,
        scene,
        env_cfg: EnvConfig,
        num_envs: int,
        route_ids: Optional[List[int]] = None,
        seed: int = 2021,
        render_obs: bool = True,
    ):
        self.scene = scene
        self.cfg = env_cfg
        self.num_envs = num_envs
        self.render_obs = render_obs
        if route_ids is None:
            route_ids = [i % scene.n_routes for i in range(num_envs)]
        self._route_ids = torch.as_tensor(route_ids, dtype=torch.int32,
                                          device=scene.device)
        self._route_list = [int(r) for r in route_ids]
        self._gen = torch.Generator(device=scene.device)
        self._gen.manual_seed(seed)
        self._state = None
        self._pending = None

        w = env_cfg.bev_width
        self.action_space = Box(-10.0, 10.0, (2,))
        self.observation_space = Box(0.0, 1.0, (3, w, w))
        self.metrics_space = Box(-100.0, 100.0, (4,))

    def _render(self, render):
        if not self.render_obs:
            return None
        return render_bev_batch_auto(self.scene, self.cfg, render)

    def reset(self, draws: Optional[ResetDraws] = None,
              gnss_noise: Optional[torch.Tensor] = None):
        self._state, metrics, render = reset_batch(
            self.scene, self.cfg, self._route_ids, self._gen, draws=draws,
            gnss_noise=gnss_noise,
        )
        obs, metrics, _, _, _ = host_outputs(self._render(render), metrics)
        return obs, metrics

    def step_async(self, actions):
        self._pending = torch.as_tensor(
            np.asarray(actions, np.float32), device=self.scene.device
        )

    def step_wait(self, draws: Optional[StepDraws] = None):
        assert self._pending is not None
        kw = {} if draws is None else draws._asdict()
        self._state, out = step_batch(self.scene, self.cfg, self._state,
                                      self._pending, self._gen, **kw)
        self._pending = None
        obs, metrics, rewards, dones, infos = host_outputs(
            self._render(out.render), out.metrics, out
        )
        for i, info in enumerate(infos):
            info["route_id"] = self._route_list[i]
            if dones[i]:
                info["episode"] = {
                    "r": info["episode_reward"],
                    "l": info["episode_length"],
                }
        return obs, metrics, rewards, dones, infos

    def step(self, actions, draws: Optional[StepDraws] = None):
        self.step_async(actions)
        return self.step_wait(draws)

    def close(self):
        pass

