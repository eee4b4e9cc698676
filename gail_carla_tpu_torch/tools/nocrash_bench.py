"""NoCrash benchmark runner: port of
``gail_carla_tpu/tools/nocrash_bench.py``, the success-rate table the
reference family reports.

The reference builds these tasks in ``nocrash_env.py:7-81`` (per-town
traffic densities, weather groups, the shipped 25-pair route packs) and
leaves success semantics to its terminal config; the community NoCrash
metric is: an episode SUCCEEDS iff the agent reaches the goal within the
time budget with no collision. Here: ``route_completed & ~collision``
latched at first episode end under leaderboard termination (which keeps
driving through infractions like the benchmark's agents do).

Weather note: policy obs are BEV masks, which are weather-invariant in
CARLA too (chauffeurnet.py renders from map+actor state, not camera), so
the train/new-weather split only varies the episode seeds here (2021 and
4077); dynamics are identical. Reported for table-format parity.

``run_tier`` runs on any suite's scene, the grid suites of
``envs/suites.py`` included (``nocrash_suite(background_traffic=...)``).
``main`` benchmarks the reconstructed towns (``--town``, Town01 by
default: scene/town_import.py, on the reference's data at
``<repo>/reference``); without that data it raises, as the JAX tool
does.

Usage (on the card unless ``--device cpu``):
  python -m gail_carla_tpu_torch.tools.nocrash_bench --ckpt <dir> \
      --town Town02 --obs-mode bev6 [--traffic regular] [--episodes 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from gail_carla_tpu_torch.algo.evaluate import run_latched
from gail_carla_tpu_torch.device import resolve_device

LATCH_KEYS = (
    ("route_completed", "route_completed", torch.bool),
    ("collision", "collision", torch.bool),
    ("score_composed", "score_composed", torch.float32),
)


def episode_seed(seed: int, episode: int) -> int:
    """The generator seed of one episode of a tier: ``seed`` and the
    episode index mixed by numpy's SeedSequence (the counterpart of JAX's
    ``fold_in(PRNGKey(seed), episode)``)."""
    return int(np.random.SeedSequence([seed, episode]).generate_state(1)[0])


def run_tier(scene, cfg, net, seed: int, episodes: int, max_steps: int,
             expert: bool = False,
             episode_draws: Optional[Sequence[dict]] = None):
    """Success rate and mean driving score of ``episodes`` episodes on
    every route of ``scene`` (one env per route), with the policy ``net``
    on ``cfg.obs_mode`` or, with ``expert``, the compliant scripted expert.
    Episode ``e`` draws from a generator seeded with ``episode_seed(seed,
    e)`` unless ``episode_draws[e]`` gives ``run_latched``'s draw
    arguments. ``steps_run`` lists the steps each episode ran (it stops
    once every route has ended one)."""
    dev = scene.device
    R = scene.n_routes
    route_ids = torch.arange(R, dtype=torch.int32, device=dev)
    succ, ds, steps = [], [], []
    for e in range(episodes):
        gen = torch.Generator(device=dev)
        gen.manual_seed(episode_seed(seed, e))
        draws = {} if episode_draws is None else episode_draws[e]
        # the NoCrash ceiling: the compliant autopilot hazard-brakes for
        # lead vehicles and walkers, so its success rate bounds what
        # traffic-aware imitation can reach
        out, n = run_latched(scene, cfg, route_ids, LATCH_KEYS, max_steps,
                             gen, net=net, expert=expert,
                             obey_signals=True, **draws)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        # NoCrash success: goal reached (timeout counts as failure via
        # ~route_completed) and zero collisions
        succ.append(out["route_completed"] & ~out["collision"])
        ds.append(out["score_composed"])
        steps.append(n)
    succ = np.stack(succ)           # (E, R)
    return {
        "success_rate": round(float(succ.mean()) * 100.0, 1),
        "n_routes": int(succ.shape[1]),
        "episodes": episodes,
        "mean_driving_score": round(float(np.stack(ds).mean()), 1),
        "steps_run": steps,
    }


def tier_config(cfg, obs_mode: str, expert: bool):
    """The evaluation settings of a suite's config: episodes start at the
    route start (no resume curriculum), the policy's observation mode, and
    for the expert no rendering at all."""
    cfg = dataclasses.replace(cfg, train=False, obs_mode=obs_mode)
    if expert:
        cfg = dataclasses.replace(cfg, obs_mode="state")
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--expert", action="store_true",
                   help="score the compliant scripted expert instead of a "
                        "policy (the traffic-aware imitation ceiling)")
    p.add_argument("--town", default="Town01",
                   choices=["Town01", "Town02"])
    p.add_argument("--obs-mode", default="bev6",
                   choices=["bev", "bev6"])
    p.add_argument("--traffic", default=None,
                   help="single tier (empty/regular/dense); default all")
    p.add_argument("--weather", default=None,
                   help="single group (train/new); default both")
    p.add_argument("--episodes", type=int, default=2,
                   help="episodes per route per weather group")
    p.add_argument("--max-steps", type=int, default=2400)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)
    if not args.ckpt and not args.expert:
        p.error("one of --ckpt or --expert is required")

    from gail_carla_tpu_torch.envs.suites import nocrash_suite
    from gail_carla_tpu_torch.tools.benchmark_policy import load_policy

    dev = resolve_device(args.device)
    tiers = [args.traffic] if args.traffic else [
        "empty", "regular", "dense", "leaderboard"
    ]
    weathers = [args.weather] if args.weather else ["train", "new"]

    net = None
    table = {}
    for tier in tiers:
        scene, cfg, _ = nocrash_suite(
            town=args.town, background_traffic=tier,
            weather_group="train", device=dev,
        )
        cfg = tier_config(cfg, args.obs_mode, args.expert)
        if not args.expert and net is None:
            c = 6 if args.obs_mode == "bev6" else 3
            net = load_policy(args.ckpt, (c, cfg.bev_width, cfg.bev_width),
                              dev)
        for wg in weathers:
            # weather only varies seeds for a BEV policy (docstring)
            res = run_tier(
                scene, cfg, net, 2021 if wg == "train" else 4077,
                args.episodes, args.max_steps, expert=args.expert,
            )
            table[f"{tier}/{wg}"] = res
            print(f"{args.town} {tier:8s} {wg:6s} "
                  f"success {res['success_rate']:5.1f}% "
                  f"ds {res['mean_driving_score']}", file=sys.stderr)
    print(json.dumps({"town": args.town, "obs_mode": args.obs_mode,
                      "expert": args.expert, "table": table}))
    return table


if __name__ == "__main__":
    main()
