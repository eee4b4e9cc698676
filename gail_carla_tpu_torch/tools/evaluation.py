"""Checkpoint evaluation: port of ``gail_carla_tpu/tools/evaluation.py``
(``tools/evaluation.py:7-58``). Loads a policy checkpoint and runs
deterministic episodes on one route, reporting each episode's reward,
length and completion as a JSON list.

The policy is ``ModelConfig()`` on the 3-channel BEV, as in the JAX
tool; ``--smoke`` evaluates a ``learn_bc --smoke`` checkpoint on its
scene and model instead.

Usage (on the card unless ``--device cpu``):
    python -m gail_carla_tpu_torch.tools.evaluation --ckpt <dir> [--route 3]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from gail_carla_tpu_torch.algo.evaluate import evaluate_policy
from gail_carla_tpu_torch.convert import init_policy
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.tools.learn_bc import make_bc_presets
from gail_carla_tpu_torch.utils import checkpoint as ckpt_mod


def evaluate(ckpt_dir=None, route: int = 3, episodes: int = 10,
             scene_kwargs=None, device="cuda", smoke: bool = False,
             episode_draws: Optional[Sequence[dict]] = None, scene=None):
    """One result dict per episode. Episode ``ep`` draws from a generator
    seeded with ``ep`` (the JAX tool's ``PRNGKey(ep)``), unless
    ``episode_draws[ep]`` gives ``evaluate_policy``'s draw arguments
    (``reset_draws``, ``reset_gnss``, ``env_draws``); ``scene`` replaces
    the one ``scene_kwargs`` would build."""
    from gail_carla_tpu_torch.train import make_scene

    dev = resolve_device(device)
    preset = make_bc_presets()["smoke" if smoke else "default"]
    if scene is None:
        scene = make_scene(dict(scene_kwargs or preset["scene"]), dev)
    env_cfg = preset["env"]
    w = env_cfg.bev_width
    net = init_policy(preset["model"], (3, w, w), seed=0, device=dev)
    if ckpt_dir:
        latest = ckpt_mod.latest_checkpoint(ckpt_dir) or ckpt_dir
        ckpt_mod.restore_checkpoint(latest, {"params": net})

    results = []
    for ep in range(episodes):
        gen = torch.Generator(device=dev)
        gen.manual_seed(ep)
        draws = {} if episode_draws is None else episode_draws[ep]
        out = evaluate_policy(scene, env_cfg, net, gen, route_id=route,
                              max_steps=env_cfg.max_steps, **draws)
        results.append({
            "episode": ep,
            "reward": float(out["reward"][0]),
            "length": int(out["length"][0]),
            "completed": bool(out["completed"][0]),
        })
        print(results[-1], file=sys.stderr)
    print(json.dumps(results))
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--route", type=int, default=3)
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--smoke", action="store_true",
                   help="the scene and model of learn_bc --smoke")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)
    return evaluate(args.ckpt, args.route, args.episodes,
                    device=args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
