"""Behaviour-cloning entry point: port of ``gail_carla_tpu/tools/
learn_bc.py`` (``learn_bc.py:75-106``'s main block). Builds the expert
train and held-out buffers, trains the actor-critic by behaviour cloning
(``algo/bc.py``) and writes the best policy to ``{out}/best`` as
``{"params": policy}``, the checkpoint ``train --init-params`` reads.

By default the demos are generated on the device by the scripted expert;
``--experts-dir`` reads a ``gail_experts/`` PNG tree instead. As in the
JAX tool, the tree is read with 3 channels whatever ``--obs-mode`` says.

Usage (on the card unless ``--device cpu``):
    python -m gail_carla_tpu_torch.tools.learn_bc [--epochs 300]
    python -m gail_carla_tpu_torch.tools.learn_bc --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from gail_carla_tpu_torch.algo.bc import learn_bc
from gail_carla_tpu_torch.algo.buffers import build_expert_buffer
from gail_carla_tpu_torch.algo.expert import generate_demos
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig
from gail_carla_tpu_torch.convert import init_policy
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.utils import checkpoint as ckpt_mod

# the demo generators' seeds (train split, held-out split) and the seed
# of the epochs' permutations
DEMO_SEED, DEMO_EVAL_SEED, PERM_SEED = 1337, 7331, 1
TRAIN_ROUTES = (0, 1, 2, 4, 5, 6, 7, 8, 9)


def make_bc_presets():
    """``smoke``: a small scene, 64 px, a small float32 model, at most 5
    epochs; ``default``: the benchmark scene at the reference widths."""
    return {
        "smoke": dict(
            scene=dict(n_routes=2, nx=3, ny=3, block=80.0,
                       min_length=150.0),
            env=EnvConfig(train=False, bev_width=64),
            model=ModelConfig(conv_channels=(8, 16), hidden_size=64,
                              head_size=32, dtype="float32"),
            max_epochs=5, routes=(0,), eval_route=1, demo_steps=900),
        "default": dict(
            scene={}, env=EnvConfig(train=False), model=ModelConfig(),
            max_epochs=None, routes=TRAIN_ROUTES, eval_route=3,
            demo_steps=4000),
    }


def _generator(dev, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--experts-dir", default=None,
                   help="read the demos from a gail_experts/ PNG tree")
    p.add_argument("--out", default="runs/bc")
    p.add_argument("--smoke", action="store_true",
                   help="tiny scene + few epochs")
    p.add_argument("--town", default=None,
                   help="train on a reconstructed town (e.g. Town01) "
                        "instead of the grid")
    p.add_argument("--obs-mode", default=None, choices=["bev", "bev6"])
    p.add_argument("--compliant-demos", action="store_true",
                   help="expert obeys signals when generating demos")
    p.add_argument("--seed", type=int, default=0, help="net-init seed")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)

    from gail_carla_tpu_torch.tools.expert_dataset import (
        expert_buffer_from_tree,
    )
    from gail_carla_tpu_torch.train import make_scene

    dev = resolve_device(args.device)
    preset = make_bc_presets()["smoke" if args.smoke else "default"]
    scene_kwargs = dict(town=args.town) if args.town else preset["scene"]
    scene = make_scene(scene_kwargs, dev)
    env_cfg, model_cfg = preset["env"], preset["model"]
    epochs = args.epochs
    if preset["max_epochs"] is not None:
        epochs = min(epochs, preset["max_epochs"])
    if args.obs_mode:
        env_cfg = dataclasses.replace(env_cfg, obs_mode=args.obs_mode)
    routes, eval_route = preset["routes"], preset["eval_route"]

    if args.experts_dir:
        train_buf = expert_buffer_from_tree(args.experts_dir, routes,
                                            device=dev)
        eval_buf = expert_buffer_from_tree(args.experts_dir, [eval_route],
                                           device=dev)
    else:
        def demos(seed, route_ids):
            return build_expert_buffer(scene, env_cfg, generate_demos(
                scene, env_cfg, _generator(dev, seed), route_ids,
                preset["demo_steps"], obey_signals=args.compliant_demos))

        train_buf = demos(DEMO_SEED, routes)
        eval_buf = demos(DEMO_EVAL_SEED, [eval_route])

    n_ch = 6 if env_cfg.obs_mode == "bev6" else 3
    w = env_cfg.bev_width
    net = init_policy(model_cfg, (n_ch, w, w), seed=args.seed, device=dev)
    best_net, best_loss = learn_bc(
        scene, env_cfg, net, train_buf, eval_buf,
        _generator(dev, PERM_SEED), epochs=epochs,
        log_fn=lambda e, tr, ev: print(
            f"epoch {e}: train {tr:.4f} eval {ev:.4f}", file=sys.stderr))
    ckpt_mod.save_checkpoint(f"{args.out}/best", {"params": best_net})
    print(f"best eval loss {best_loss:.4f} -> {args.out}/best")
    return best_net, best_loss


if __name__ == "__main__":
    main()
