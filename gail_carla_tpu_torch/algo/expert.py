"""Expert demonstrations: port of ``gail_carla_tpu/algo/expert.py``.

The reference generates demos by driving BasicAgent + ExpertNoiser
through a live CARLA server and writing PNGs + episode.json
(``carla_exp.py:23-80``). Here the scripted expert (``agents/
autopilot.py::autopilot_act``) and the noisers (``agents/noiser.py``)
drive N envs at once on the scene's device, one Python iteration per
step; demos are kept as compact (RenderState, metrics, action) tuples and
``algo/buffers.py::build_expert_buffer`` renders their observations.

Randomness: every draw can be injected through ``DemoDraws``; what is not
given is drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gail_carla_tpu_torch.agents.autopilot import (
    TARGET_SPEED, autopilot_act, reset_autopilot_where,
)
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.agents.noiser import (
    NoiserDraws, NoiserInitDraws, apply_steer_noise, apply_throttle_noise,
    draw_noiser, draw_noiser_init, make_noiser, noiser_step,
)
from gail_carla_tpu_torch.algo.buffers import map_state
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.sim.env import (
    RenderState, ResetDraws, StepDraws, draw_gnss, draw_reset, draw_step,
    reset_batch, step_batch,
)

# the two noisers of carla_exp.py:33-34: (frequency per minute, intensity,
# min_amount in s)
THROTTLE_NOISE = (15.0, 10.0, 2.0)
STEER_NOISE = (25.0, 4.0, 0.5)


@dataclasses.dataclass
class DemoBatch:
    """(T, N, ...) expert transitions; obs re-renderable from ``render``."""

    render: object          # RenderState, leaves (T, N, ...)
    metrics: torch.Tensor   # (T, N, 4)
    actions: torch.Tensor   # (T, N, 2)
    valid: torch.Tensor     # (T, N) bool: inside a successful episode

    def flatten(self):
        t, n = self.actions.shape[:2]
        return (
            map_state(lambda a: a.reshape((t * n,) + a.shape[2:]),
                      self.render),
            self.metrics.reshape(-1, 4),
            self.actions.reshape(-1, 2),
            self.valid.reshape(-1),
        )


class DemoDraws(NamedTuple):
    """Every draw of one ``generate_demos`` call of N envs and T steps;
    ``None`` fields are drawn from the generator."""

    reset: Optional[ResetDraws] = None          # the initial reset
    reset_gnss: Optional[torch.Tensor] = None   # (N, 2) its GNSS noise
    throttle_init: Optional[NoiserInitDraws] = None
    steer_init: Optional[NoiserInitDraws] = None
    throttle: Optional[NoiserDraws] = None      # fields (T, N)
    steer: Optional[NoiserDraws] = None         # fields (T, N)
    env: Optional[Sequence[StepDraws]] = None   # one per step


def draw_demos(scene, cfg: EnvConfig, n: int, n_steps: int,
               generator: Optional[torch.Generator]) -> DemoDraws:
    """Every draw of ``generate_demos`` for n envs and ``n_steps`` steps,
    on the scene's device."""
    dev = scene.device
    return DemoDraws(
        reset=draw_reset(scene, cfg, n, generator),
        reset_gnss=draw_gnss(n, dev, generator),
        throttle_init=draw_noiser_init(n, dev, generator),
        steer_init=draw_noiser_init(n, dev, generator),
        throttle=draw_noiser((n_steps, n), dev, generator),
        steer=draw_noiser((n_steps, n), dev, generator),
        env=[draw_step(scene, cfg, n, generator) for _ in range(n_steps)],
    )


def _stack_renders(renders):
    return RenderState(**{
        f.name: torch.stack([getattr(r, f.name) for r in renders])
        for f in dataclasses.fields(RenderState)
    })


def valid_steps(done: np.ndarray, completed: np.ndarray) -> np.ndarray:
    """(T, N) bool: a step is valid iff the episode it belongs to ends
    with ``route_completed`` (the reference records only full successful
    episodes, carla_exp.py:50). Scans backwards; a trailing partial
    episode is dropped."""
    valid = np.zeros_like(done)
    ep_ok = np.zeros(done.shape[1:], bool)
    for t in range(done.shape[0] - 1, -1, -1):
        ep_ok = np.where(done[t], completed[t], ep_ok)
        valid[t] = ep_ok
    return valid


def generate_demos(
    scene,
    cfg: EnvConfig,
    generator: Optional[torch.Generator],
    route_ids,
    n_steps: int,
    target_speed: float = TARGET_SPEED,
    with_noise: bool = True,
    obey_signals: bool = False,
    draws: Optional[DemoDraws] = None,
) -> DemoBatch:
    """Drive the scripted expert for ``n_steps`` ticks on each route
    (carla_exp caps at 6000). Steps of episodes that did not complete the
    route are marked invalid so that they can be filtered out downstream.
    Each step emits the pre-step render state and metrics and the
    (noised) action the expert took there."""
    dev = scene.device
    route_ids = torch.as_tensor(route_ids, dtype=torch.int32, device=dev)
    n = route_ids.shape[0]
    d = draws if draws is not None else DemoDraws()
    states, metrics, render = reset_batch(scene, cfg, route_ids, generator,
                                          draws=d.reset,
                                          gnss_noise=d.reset_gnss)
    ap = make_autopilot((n,), dev)
    if with_noise:
        thr_ns = make_noiser(n, THROTTLE_NOISE[1], THROTTLE_NOISE[2], dev,
                             generator, d.throttle_init)
        st_ns = make_noiser(n, STEER_NOISE[1], STEER_NOISE[2], dev,
                            generator, d.steer_init)

    renders, metrics_t, actions_t, done_t, completed_t = [], [], [], [], []
    for t in range(n_steps):
        ap, actions = autopilot_act(scene, ap, states, target_speed,
                                    obey_signals)
        if with_noise:
            tt = states.step.to(torch.float32) * cfg.dt
            speed_kmh = metrics[:, 2] * 3.6  # carla_exp.py:52-53
            thr_ns, ap_thr, nz_thr = noiser_step(
                thr_ns, tt, THROTTLE_NOISE[0], THROTTLE_NOISE[2], cfg.dt,
                None if d.throttle is None else d.throttle.at(t), generator)
            st_ns, ap_st, nz_st = noiser_step(
                st_ns, tt, STEER_NOISE[0], STEER_NOISE[2], cfg.dt,
                None if d.steer is None else d.steer.at(t), generator)
            actions = apply_throttle_noise(actions, ap_thr, nz_thr)
            actions = apply_steer_noise(actions, ap_st, nz_st, speed_kmh)
        step_kw = {} if d.env is None else d.env[t]._asdict()
        states, out = step_batch(scene, cfg, states, actions, generator,
                                 **step_kw)
        ap = reset_autopilot_where(out.done, ap)
        renders.append(render)
        metrics_t.append(metrics)
        actions_t.append(actions)
        done_t.append(out.done)
        completed_t.append(out.info["route_completed"])
        metrics, render = out.metrics, out.render

    valid = valid_steps(torch.stack(done_t).cpu().numpy(),
                        torch.stack(completed_t).cpu().numpy())
    return DemoBatch(
        render=_stack_renders(renders),
        metrics=torch.stack(metrics_t),
        actions=torch.stack(actions_t),
        valid=torch.from_numpy(valid).to(dev),
    )
