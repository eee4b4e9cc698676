"""CoRL2017 benchmark runner: port of
``gail_carla_tpu/tools/corl_bench.py``, the success-rate table over the
four original task types (straight / one_curve / navigation /
navigation_dynamic).

The reference builds these tasks in ``corl2017_env.py:7-72`` (per-shape
25-pair route packs under ``scenario_descriptions/CoRL2017``, traffic only
for navigation_dynamic: Town01 20 veh/50 walkers, Town02 15/50). The
original CoRL2017 metric is: an episode SUCCEEDS iff the agent reaches the
goal within the time budget; infractions are tallied separately. Our
episodes run under leaderboard termination, where a collision ends the
episode (terminal/leaderboard.py:1-42 semantics), so the success number
here is the STRICTER reach-goal-without-terminal-collision variant; for
the traffic-free task types the two protocols coincide.

Reuses ``nocrash_bench.run_tier`` (the same latched success loop) on
``envs/suites.py::corl2017_suite``; only the suite builder and the
task-type axis differ. ``main`` benchmarks the reconstructed towns
(``--town``, Town01 by default: scene/town_import.py, on the reference's
data at ``<repo>/reference``).

Usage (on the card unless ``--device cpu``):
  python -m gail_carla_tpu_torch.tools.corl_bench --ckpt <dir> \
      --town Town01 [--task navigation] [--episodes 2]
"""
from __future__ import annotations

import argparse
import json
import sys

from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.tools.nocrash_bench import run_tier, tier_config

TASK_TYPES = ["straight", "one_curve", "navigation", "navigation_dynamic"]

# generous step budgets (10 Hz): the short shaped legs fit easily in
# 2400 (240 s); cross-town navigation pairs need the demo-generation cap
MAX_STEPS = {"straight": 2400, "one_curve": 2400,
             "navigation": 6000, "navigation_dynamic": 6000}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--expert", action="store_true",
                   help="score the compliant scripted expert instead "
                        "(the imitation ceiling per task type)")
    p.add_argument("--town", default="Town01",
                   choices=["Town01", "Town02"])
    p.add_argument("--obs-mode", default="bev6", choices=["bev", "bev6"])
    p.add_argument("--task", default=None,
                   help="single task type; default all four")
    p.add_argument("--weather", default=None,
                   help="single group (train/new); default both")
    p.add_argument("--episodes", type=int, default=2,
                   help="episodes per route per weather group")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)
    if not args.ckpt and not args.expert:
        p.error("one of --ckpt or --expert is required")

    from gail_carla_tpu_torch.envs.suites import corl2017_suite
    from gail_carla_tpu_torch.tools.benchmark_policy import load_policy

    dev = resolve_device(args.device)
    tasks = [args.task] if args.task else TASK_TYPES
    weathers = [args.weather] if args.weather else ["train", "new"]

    net = None
    table = {}
    for task in tasks:
        scene, cfg, _ = corl2017_suite(
            task_type=task, town=args.town, weather_group="train",
            device=dev,
        )
        cfg = tier_config(cfg, args.obs_mode, args.expert)
        if not args.expert and net is None:
            c = 6 if args.obs_mode == "bev6" else 3
            net = load_policy(args.ckpt, (c, cfg.bev_width, cfg.bev_width),
                              dev)
        for wg in weathers:
            res = run_tier(
                scene, cfg, net, 2017 if wg == "train" else 6017,
                args.episodes, MAX_STEPS[task], expert=args.expert,
            )
            table[f"{task}/{wg}"] = res
            print(f"{args.town} {task:20s} {wg:6s} "
                  f"success {res['success_rate']:5.1f}% "
                  f"ds {res['mean_driving_score']}", file=sys.stderr)
    print(json.dumps({"town": args.town, "obs_mode": args.obs_mode,
                      "expert": args.expert, "table": table}))
    return table


if __name__ == "__main__":
    main()
