"""Expert demo exporter in the reference's on-disk format.

Port of ``gail_carla_tpu/tools/gen_trajectories.py`` (``carla_exp.py:
23-80``): for each route, drive the scripted expert with its throttle and
steer noise until the episode ends, writing
``<out>/<traj>/route_XX/ep_YY/``:

- ``episode.json``: per-step ``actions`` [steer, throttle] and
  ``metrics`` [target lat, target lon, speed, command], in the layout of
  pandas' ``to_json(orient="columns")``;
- ``birdview_masks/{step:04d}_{m:02d}.png``: the 15-channel mask stack
  (``ops/bev_full.py``) three planes per RGB file, m = 0..4 (mask 00 =
  road/route/lane, the policy observation);
- ``birdview/{step:04d}.png``: the colour-composed BEV;
- ``rgb/``, ``rgb_left/``, ``rgb_right/``: the pseudo-cameras
  (``ops/camera.py``), lit by the weather (``sim/weather.py``).

PNGs are written by ``utils/png.py``. Randomness: the JAX tool draws
everything from ``PRNGKey(1337)``; here each episode's draws (its reset,
the two noisers' initial draws and per-step draws, the env's per-step
draws) are an ``algo/expert.py::DemoDraws``, injected through ``draws`` or
drawn from a generator seeded with 1337.

Usage (on the card unless ``--device cpu``):
    python -m gail_carla_tpu_torch.tools.gen_trajectories --out gail_experts \\
        [--routes 10] [--max-steps 6000] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gail_carla_tpu_torch.agents.autopilot import autopilot_act
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.agents.noiser import (
    apply_steer_noise, apply_throttle_noise, make_noiser, noiser_step,
)
from gail_carla_tpu_torch.algo.expert import (
    STEER_NOISE, THROTTLE_NOISE, DemoDraws,
)
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.ops.bev_full import render_bev_full
from gail_carla_tpu_torch.ops.camera import CAMERAS, render_camera
from gail_carla_tpu_torch.sim import signals
from gail_carla_tpu_torch.sim.env import reset_batch, step_batch
from gail_carla_tpu_torch.sim.weather import (
    make_weather, sun_brightness, weather_at,
)
from gail_carla_tpu_torch.utils.png import write_png

SEED = 1337              # the JAX tool's PRNGKey and weather seed
EXPERT_SPEED = 6.0       # m/s, the expert's target speed there
SUBDIRS = ("rgb", "rgb_left", "rgb_right", "birdview", "birdview_masks")


def _cameras(scene, render, traffic, t, wp):
    """The three camera frames (name -> (H, W, 3) uint8 numpy) of env 0
    at sim time ``t`` (1,)."""
    w = weather_at(wp, t)
    kw = dict(
        veh_pose=torch.cat([traffic.veh.xy, traffic.veh.yaw[..., None]],
                           dim=-1),
        walker_pose=torch.cat([traffic.walker_xy,
                               traffic.walker_yaw[..., None]], dim=-1),
        tl_states=signals.light_states(scene, t),
        brightness=sun_brightness(w), sun_altitude=w.sun_altitude_angle,
        sun_azimuth=w.sun_azimuth_angle, fog_density=w.fog_density,
    )
    return {name: render_camera(scene, render.xy, render.yaw, off,
                                **kw)[0].cpu().numpy()
            for name, off in CAMERAS.items()}


def gen_trajectories(
    out_dir: str = "gail_experts",
    traj_name: str = "routes_training",
    n_routes: int = 10,
    n_eps: int = 1,
    max_steps: int = 6000,
    with_cameras: bool = True,
    scene_kwargs=None,
    compliant: bool = False,
    weather: str = "ClearNoon",
    device="cuda",
    draws: Optional[Sequence[DemoDraws]] = None,
    scene=None,
):
    """Export ``n_eps`` episodes on each of ``n_routes`` routes; returns
    one ``{"route", "ep", "steps", "completed"}`` per episode. ``draws``
    holds each episode's ``DemoDraws`` in route-then-episode order
    (fields left None, or no ``draws``, come from the generator);
    ``scene`` replaces the one ``scene_kwargs`` would build."""
    from gail_carla_tpu_torch.train import make_scene

    dev = resolve_device(device)
    if scene is None:
        scene = make_scene(dict(scene_kwargs or {}), dev)
    cfg = EnvConfig(train=False, full_bev=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    wp = make_weather(weather, random.Random(SEED))
    root = Path(out_dir) / traj_name
    summary = []
    for route_id in range(n_routes):
        for ep_id in range(n_eps):
            ep_dir = root / f"route_{route_id:02d}" / f"ep_{ep_id:02d}"
            for sub in SUBDIRS:
                (ep_dir / sub).mkdir(parents=True, exist_ok=True)
            d = draws[len(summary)] if draws is not None else DemoDraws()
            states, metrics, render = reset_batch(
                scene, cfg, torch.tensor([route_id], device=dev), gen,
                draws=d.reset, gnss_noise=d.reset_gnss)
            ap = make_autopilot((1,), dev)
            thr_ns = make_noiser(1, THROTTLE_NOISE[1], THROTTLE_NOISE[2],
                                 dev, gen, d.throttle_init)
            st_ns = make_noiser(1, STEER_NOISE[1], STEER_NOISE[2], dev,
                                gen, d.steer_init)

            actions_ep, metrics_ep = [], []
            completed = False
            for i in range(max_steps):
                ap, action = autopilot_act(scene, ap, states, EXPERT_SPEED,
                                           obey_signals=compliant)
                # the JAX tool's sim time: the float64 product, rounded
                t = torch.tensor([i * cfg.dt], dtype=torch.float32,
                                 device=dev)
                speed_kmh = metrics[:, 2] * 3.6
                thr_ns, ap_t, nz_t = noiser_step(
                    thr_ns, t, THROTTLE_NOISE[0], THROTTLE_NOISE[2], cfg.dt,
                    None if d.throttle is None else d.throttle.at(i), gen)
                st_ns, ap_s, nz_s = noiser_step(
                    st_ns, t, STEER_NOISE[0], STEER_NOISE[2], cfg.dt,
                    None if d.steer is None else d.steer.at(i), gen)
                action = apply_throttle_noise(action, ap_t, nz_t)
                action = apply_steer_noise(action, ap_s, nz_s, speed_kmh)

                # the observation of this step, before the action
                # (carla_exp.py:55-62)
                masks, rendered, _ = render_bev_full(
                    scene, cfg, render.xy, render.yaw, render.route_id,
                    render.head, states.history)
                masks = masks[0].cpu().numpy()
                for m in range(5):
                    write_png(
                        ep_dir / "birdview_masks" / f"{i:04d}_{m:02d}.png",
                        np.transpose(masks[m * 3:m * 3 + 3], (1, 2, 0)))
                write_png(ep_dir / "birdview" / f"{i:04d}.png",
                          rendered[0].cpu().numpy())
                if with_cameras:
                    for name, img in _cameras(scene, render, states.traffic,
                                              t, wp).items():
                        write_png(ep_dir / name / f"{i:04d}.png", img)
                actions_ep.append(action[0].tolist())
                metrics_ep.append(metrics[0].tolist())

                step_kw = {} if d.env is None else d.env[i]._asdict()
                states, out = step_batch(scene, cfg, states, action, gen,
                                         **step_kw)
                metrics, render = out.metrics, out.render
                if bool(out.done[0]):
                    completed = bool(out.info["route_completed"][0])
                    break

            n = len(actions_ep)
            payload = {
                "actions": {str(k): actions_ep[k] for k in range(n)},
                "metrics": {str(k): metrics_ep[k] for k in range(n)},
            }
            (ep_dir / "episode.json").write_text(json.dumps(payload))
            summary.append(dict(route=route_id, ep=ep_id, steps=n,
                                completed=completed))
            print(f"route {route_id:02d} ep {ep_id:02d}: {n} steps "
                  f"completed={completed}", file=sys.stderr)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="gail_experts")
    p.add_argument("--routes", type=int, default=10)
    p.add_argument("--eps", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=6000)
    p.add_argument("--no-cameras", action="store_true")
    p.add_argument("--town", default=None,
                   help="generate on a reconstructed town (e.g. Town01) "
                        "instead of the reference grid")
    p.add_argument("--compliant", action="store_true",
                   help="expert obeys signals (obey_signals=True)")
    p.add_argument("--weather", default="ClearNoon",
                   help="weather preset or 'dynamic[_speed]' for the "
                        "cameras' sun and fog (sim/weather.py presets)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)
    return gen_trajectories(
        out_dir=args.out, n_routes=args.routes, n_eps=args.eps,
        max_steps=args.max_steps, with_cameras=not args.no_cameras,
        scene_kwargs=dict(town=args.town) if args.town else None,
        compliant=args.compliant, weather=args.weather, device=args.device,
    )


if __name__ == "__main__":
    main()
