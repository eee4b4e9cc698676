"""Leaderboard-style policy benchmark: port of
``gail_carla_tpu/tools/benchmark_policy.py``. Deterministic evaluation
over every route with the reference's scoring (score_route x penalty,
per-km infraction rates, ``ego_vehicle_handler.py:208-248``); the
reference's closest equivalent is running tools/evaluation.py per route
and reading the CSVs.

The policy is ``ModelConfig()`` on the ``--obs-mode`` BEV (``bev``: the
CUDA kernel B1 renders it on the card; ``bev6``: B2), with ``--expert``
the scripted expert instead (the imitation ceiling), which also runs at
``--obs-mode state``. ``--town`` (a reconstructed reference town) needs
the town importers, which are not ported yet (ROADMAP A7), and raises; so
does a policy at ``--obs-mode state`` (``STATE_POLICY_ERROR``).

Usage (on the card unless ``--device cpu``):
    python -m gail_carla_tpu_torch.tools.benchmark_policy [--ckpt DIR]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from gail_carla_tpu_torch.algo.evaluate import run_latched
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig
from gail_carla_tpu_torch.convert import init_policy
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.utils import checkpoint as ckpt_mod

# what a benchmark row averages, latched at each route's first done
LATCH_KEYS = (
    ("score_route", "score_route", torch.float32),
    ("score_penalty", "score_penalty", torch.float32),
    ("score_composed", "score_composed", torch.float32),
    ("episode_reward", "episode_reward", torch.float32),
    ("episode_length", "episode_length", torch.int32),
    ("route_completed", "route_completed", torch.bool),
    ("collision", "collision", torch.bool),
)

# gail_carla_tpu/tools/benchmark_policy.py:35-38 initialises a conv policy
# on (3, W, W) whatever the obs mode, and applying it to state vectors
# fails; its expert mode never applies the policy
STATE_POLICY_ERROR = (
    "benchmark_policy scores no policy at obs_mode='state': the "
    "reference's tool builds a conv policy on the (3, W, W) BEV for every "
    "obs mode, which fails on state vectors; use --expert, or a BEV mode"
)


def load_policy(ckpt_dir, obs_shape, device):
    """``ModelConfig()``'s policy on ``device``: numpy-seeded weights
    (seed 0), or the newest checkpoint under ``ckpt_dir``."""
    net = init_policy(ModelConfig(), obs_shape, seed=0, device=device)
    if ckpt_dir:
        latest = ckpt_mod.latest_checkpoint(ckpt_dir) or ckpt_dir
        ckpt_mod.restore_checkpoint(latest, {"params": net})
    return net


def benchmark(ckpt_dir=None, episodes_per_route: int = 1,
              scene_kwargs=None, max_steps: int = 2400,
              obs_mode: str = "bev", expert: bool = False,
              obey_signals: bool = True, device="cuda", net=None,
              scene=None, episode_draws: Optional[Sequence[dict]] = None):
    """One row per route, printed as one JSON line. Episode ``e`` draws
    from a generator seeded with ``1 + e`` (the JAX tool's ``PRNGKey(1 +
    e)``) unless ``episode_draws[e]`` gives ``run_latched``'s draw
    arguments; ``net`` replaces the policy and ``scene`` the scene that
    ``scene_kwargs`` would build."""
    from gail_carla_tpu_torch.train import make_scene

    if obs_mode == "state" and not expert:
        raise NotImplementedError(STATE_POLICY_ERROR)
    dev = resolve_device(device)
    if scene is None:
        scene = make_scene(dict(scene_kwargs or {}), dev)
    # max_time must track the step cap or the env's own 240 s timeout
    # ends episodes regardless of max_steps
    cfg = EnvConfig(train=False, obs_mode=obs_mode,
                    max_time=max_steps * 0.1)
    if not expert and net is None:
        c = 6 if obs_mode == "bev6" else 3
        net = load_policy(ckpt_dir, (c, cfg.bev_width, cfg.bev_width), dev)

    R = scene.n_routes
    route_ids = torch.arange(R, dtype=torch.int32, device=dev)
    # episodes_per_route: driving-score evals are noisy (traffic spawns and
    # GNSS noise come from the reset draws); average over seeds for a
    # stable headline number
    outs = []
    for e in range(episodes_per_route):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1 + e)
        draws = {} if episode_draws is None else episode_draws[e]
        latched, _ = run_latched(
            scene, cfg, route_ids, LATCH_KEYS, max_steps, gen, net=net,
            expert=expert, obey_signals=obey_signals, **draws)
        outs.append({k: v.cpu().numpy() for k, v in latched.items()})
    rows = []
    for r in range(R):
        ds = [float(o["score_composed"][r]) for o in outs]
        rows.append({
            "route": r,
            "driving_score": round(float(np.mean(ds)), 1),
            "driving_score_std": round(float(np.std(ds)), 1),
            "route_score": round(
                float(np.mean([o["score_route"][r] for o in outs])), 1),
            "penalty": round(
                float(np.mean([o["score_penalty"][r] for o in outs])), 1),
            "reward": round(
                float(np.mean([o["episode_reward"][r] for o in outs])), 3),
            "steps": int(np.mean([o["episode_length"][r] for o in outs])),
            "completed_rate": round(
                float(np.mean([o["route_completed"][r] for o in outs])), 2),
            "collision_rate": round(
                float(np.mean([o["collision"][r] for o in outs])), 2),
        })
        print(rows[-1], file=sys.stderr)
    mean_ds = float(np.mean([r["driving_score"] for r in rows]))
    print(json.dumps({"mean_driving_score": round(mean_ds, 2),
                      "episodes_per_route": episodes_per_route,
                      "routes": rows}))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--town", default=None,
                   help="benchmark on a reconstructed reference town "
                        "(e.g. Town01) instead of the procedural grid; "
                        "needs the town importers (not ported yet)")
    p.add_argument("--route-file", default=None,
                   help="route pack for --town (routes_training.xml "
                        "default; Town02/05 only exist in "
                        "routes_testing.xml)")
    p.add_argument("--obs-mode", default="bev",
                   choices=["bev", "bev6", "state"])
    p.add_argument("--episodes", type=int, default=1,
                   help="episodes per route (different env seeds), "
                        "averaged")
    p.add_argument("--expert", action="store_true",
                   help="score the scripted expert autopilot instead of "
                        "a policy (the imitation ceiling)")
    p.add_argument("--no-obey-signals", action="store_true",
                   help="with --expert: ignore red lights (the "
                        "reference's BasicAgent default)")
    p.add_argument("--max-steps", type=int, default=2400,
                   help="episode step cap; Town03+ benchmark routes run "
                        "1.5-2 km, past what 2400 steps covers at the "
                        "6 m/s expert cruise (carla_exp.py:25 uses 6000 "
                        "for demo episodes)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)
    scene_kwargs = {"town": args.town} if args.town else None
    if scene_kwargs and args.route_file:
        scene_kwargs["route_file"] = args.route_file
    return benchmark(args.ckpt, episodes_per_route=args.episodes,
                     scene_kwargs=scene_kwargs, obs_mode=args.obs_mode,
                     expert=args.expert, max_steps=args.max_steps,
                     obey_signals=not args.no_obey_signals,
                     device=args.device)


if __name__ == "__main__":
    main()
