"""WDGAIL training entry point: port of ``gail_carla_tpu/train.py`` (the
reference's ``wdail_carla.py``).

Pipeline (wdail_carla.py:129-250):
1. compile the static scene (the stand-in for a CARLA town + its routes);
2. generate expert demos on the device with the scripted expert and the
   noisers (``algo/expert.py::generate_demos``) and build the expert and
   validation buffers (``algo/buffers.py::build_expert_buffer``), or, with
   ``--demo-tree``, read both from a ``gail_experts/`` PNG tree
   (``tools/expert_dataset.py``, the reference's input path);
3. build the learner (``algo/learner.py::WDGAILLearner``);
4. loop updates; evaluate the policy deterministically on the held-out
   route every ``eval_interval`` updates; write the metrics log
   (``utils/logging.py``) and checkpoint the full state
   (``utils/checkpoint.py``).

Usage (on the card unless ``--device cpu``):
    python -m gail_carla_tpu_torch.train --preset smoke --device cpu
    python -m gail_carla_tpu_torch.train --preset reference
    python -m gail_carla_tpu_torch.train --params params.json

More than one GPU: one process per card, launched by
``torch.distributed.run`` (NCCL, each rank on ``cuda:LOCAL_RANK``; gloo
with ``--device cpu``), trains data-parallel over the envs
(``parallel/mesh.py::ShardedWDGAILLearner``):
    python -m torch.distributed.run --nproc_per_node=4 \
        -m gail_carla_tpu_torch.train --preset reference --n-envs 12
The ranks must divide ``--n-envs`` (the preset's 10 envs do not divide
over 4), else the run raises. Every rank builds the same expert buffer
from the same demo seeds and keeps its block; rank 0 alone evaluates,
logs and writes checkpoints, which hold the unsharded layout and resume
on one rank or on many.

``--obs-mode state`` trains with ``algo="ppo"`` only (``--params`` sets
it): the reference's WDGAIL critic fails on state vectors, and the port
raises ``NotImplementedError`` for it before the demos. The town presets
(``town01``, ``town03``, ``town04``) train on reconstructed reference
towns (scene/town_import.py), which read the reference's data at
``<repo>/reference`` (``tools/synthetic_town.py`` writes a synthetic tree
of the same layout).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gail_carla_tpu_torch.algo.buffers import build_expert_buffer
from gail_carla_tpu_torch.algo.evaluate import evaluate_policy
from gail_carla_tpu_torch.algo.expert import generate_demos
from gail_carla_tpu_torch.algo.learner import WDGAILLearner
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.models.discriminator import STATE_OBS_ERROR
from gail_carla_tpu_torch.parallel.mesh import ShardedWDGAILLearner, dp_group
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.utils import checkpoint as ckpt_mod
from gail_carla_tpu_torch.utils.logging import MetricsWriter

# the demo generators' seeds (train split, held-out validation split)
DEMO_SEED, DEMO_VAL_SEED = 1337, 7331
# the seed of the leaderboard-table evaluation's resets (fixed, so in-run
# scores stay comparable across updates)
TABLE_EVAL_SEED = 4242
# expert buffer sizes: the train buffer is capped near the reference's
# demo size (~7,200 steps, params_variable.json:13-14), the validation
# buffer holds at most VAL_ROWS
EXPERT_MAX_ROWS, VAL_ROWS = 12288, 1024


def make_scene(scene_kwargs, device="cuda"):
    """Scene dispatch: ``{"town": "Town01"}`` builds the reconstructed
    reference town (scene/town_import.py); otherwise the procedural grid
    benchmark."""
    if "town" in scene_kwargs:
        from gail_carla_tpu_torch.scene.town_import import make_town_scene

        return make_town_scene(**scene_kwargs, device=device)
    return make_benchmark_scene(**scene_kwargs, device=device)


def make_presets():
    smoke = dict(
        env=EnvConfig(train=True, bev_width=64),
        model=ModelConfig(conv_channels=(8, 16), hidden_size=64,
                          head_size=32, disc_hidden=32, dtype="float32"),
        train=TrainConfig(
            n_envs=4, num_steps=256, num_env_steps=2048,
            mini_batch_size=32, ppo_epoch=2, gail_batch_size=32,
            gail_pre_epoch=2, gail_epoch=1, gail_thre=2,
            routes=(0, 1), eval_route=1, eval_interval=2,
        ),
        scene=dict(n_routes=2, nx=3, ny=3, block=80.0, min_length=150.0),
        demo_steps=900,
    )
    reference = dict(
        env=EnvConfig(train=True),
        model=ModelConfig(),
        train=TrainConfig(n_envs=10),
        scene=dict(n_routes=10, nx=4, ny=4, block=100.0, min_length=400.0),
        demo_steps=4000,
    )
    # the reference's ACTUAL benchmark: reconstructed Town01, training
    # routes 0-9 (route 3 held out), params_variable.json:10-14; the
    # multi-lane towns Town03/Town04 (gail_carla_tpu/train.py:78-108)
    town01 = dict(
        env=EnvConfig(train=True),
        model=ModelConfig(),
        train=TrainConfig(n_envs=10),
        scene=dict(town="Town01"),
        demo_steps=4000,
    )
    town03 = dict(
        env=EnvConfig(train=True, max_time=600.0),
        model=ModelConfig(),
        train=TrainConfig(
            n_envs=16,
            routes=(0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 14, 15, 16,
                    18, 19),
            eval_route=13,
        ),
        scene=dict(town="Town03"),
        demo_steps=6000,
    )
    town04 = dict(
        env=EnvConfig(train=True, max_time=600.0),
        model=ModelConfig(),
        train=TrainConfig(n_envs=10),
        scene=dict(town="Town04"),
        demo_steps=6000,
    )
    return {"smoke": smoke, "reference": reference, "town01": town01,
            "town03": town03, "town04": town04}


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def demo_config(env_cfg: EnvConfig) -> EnvConfig:
    """The env settings of demo generation: no resume curriculum, the
    longer episode cap of carla_exp.py:25 (env_ep_length 6000 vs the
    training 2400), and leaderboard termination (a dagger terminal that
    ends on red lights would cut expert episodes before completion)."""
    return dataclasses.replace(
        env_cfg, train=False, max_time=max(env_cfg.max_time, 600.0),
        terminal_mode="leaderboard",
    )


def _table_eval(scene, env_cfg, policy, device, eval_seeds, eval_chunk):
    """Leaderboard-table evaluation: ``eval_seeds`` envs per route,
    deterministic policy, fixed reset seed, optionally in equal chunks of
    ``eval_chunk`` envs. Returns the eval metrics."""
    all_ids = np.tile(np.arange(scene.n_routes), eval_seeds)
    chunk = eval_chunk or len(all_ids)
    pad = (-len(all_ids)) % chunk
    all_ids = np.concatenate([all_ids, all_ids[:pad]])
    parts = [
        evaluate_policy(scene, env_cfg, policy,
                        _generator(device, TABLE_EVAL_SEED),
                        route_ids=all_ids[j:j + chunk],
                        max_steps=env_cfg.max_steps)
        for j in range(0, len(all_ids), chunk)
    ]
    evr = {k: torch.cat([p[k].cpu() for p in parts])[:len(all_ids) - pad]
           for k in parts[0]}
    return {
        "eval/mean_driving_score": float(evr["score_composed"].mean()),
        "eval/routes_completed": float(evr["completed"].sum()),
        "eval/red_light_per_km": float(evr["red_light_per_km"].mean()),
    }


def _profiled_update(learner, state, device, log_dir):
    """One update under ``torch.profiler``; its Chrome trace goes to
    ``log_dir/profile``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        state, metrics = learner.update(state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(out, f"update_{state.update_i}.json"))
    return state, metrics


def _sharding(use_sharding, tcfg) -> tuple:
    """(sharded, lead): whether the run is data-parallel over the default
    process group, and whether this process writes the log and the
    checkpoints (rank 0, or the only process). ``use_sharding=None``
    shards when the group has more than one rank. Sharding raises without
    a group or with ranks that do not divide ``n_envs``: where the JAX
    package falls back to one device, each of N processes here would
    train a full copy of its own."""
    up = dist.is_available() and dist.is_initialized()
    if use_sharding is None:
        use_sharding = up and dist.get_world_size() > 1
    if use_sharding:
        _, _, world = dp_group()
        if tcfg.n_envs % world:
            raise ValueError(f"n_envs={tcfg.n_envs} must divide over "
                             f"{world} ranks")
    return bool(use_sharding), not up or dist.get_rank() == 0


def run(env_cfg, model_cfg, tcfg, scene_kwargs, demo_steps,
        max_updates=None, log_dir="runs/wdgail", ckpt_dir=None,
        use_sharding=None, profile=False, demo_obey_signals=False,
        eval_all_routes=False, ckpt_keep=2, init_params=None,
        eval_seeds=1, demo_tree=None, eval_chunk=0, device="cuda"):
    """Train as ``gail_carla_tpu/train.py::run`` does; returns (the last
    ``LearnerState``, the last update's metrics with the eval metrics).
    Under an initialised process group ``use_sharding`` (default: when
    it has more than one rank) trains data-parallel; the state returned
    is then this rank's."""
    if env_cfg.obs_mode == "state" and tcfg.algo != "ppo":
        # the reference fails at its first critic update; refuse before
        # the demos are paid for
        raise NotImplementedError(STATE_OBS_ERROR)
    sharded, lead = _sharding(use_sharding, tcfg)
    dev = resolve_device(device)
    scene = make_scene(scene_kwargs, dev)

    if demo_tree:
        # expert demos from a gail_experts/ PNG tree (the reference's input
        # path, wdail_carla.py + ExpertDataset, algo/wdgail.py:192-241);
        # the obs planes are stored, so nothing re-renders
        from gail_carla_tpu_torch.tools.expert_dataset import (
            expert_buffer_from_tree,
        )

        n_ch = 6 if env_cfg.obs_mode == "bev6" else 3
        expert = expert_buffer_from_tree(demo_tree, tcfg.routes,
                                         n_channels=n_ch, device=dev)
        expert_val = expert_buffer_from_tree(demo_tree, [tcfg.eval_route],
                                             n_channels=n_ch, device=dev)
    else:
        # expert demos on the device (train + held-out validation), the
        # same on every rank (fixed seeds); a sharded learner keeps its
        # block
        demo_cfg = demo_config(env_cfg)
        demos = generate_demos(scene, demo_cfg, _generator(dev, DEMO_SEED),
                               tcfg.routes, demo_steps,
                               obey_signals=demo_obey_signals)
        demos_val = generate_demos(scene, demo_cfg,
                                   _generator(dev, DEMO_VAL_SEED),
                                   [tcfg.eval_route], demo_steps,
                                   obey_signals=demo_obey_signals)
        expert = build_expert_buffer(scene, env_cfg, demos,
                                     max_size=EXPERT_MAX_ROWS)
        expert_val = build_expert_buffer(scene, env_cfg, demos_val,
                                         size=min(VAL_ROWS, expert.size))
    if lead:
        print(f"expert buffer: {expert.size} transitions "
              f"(+{expert_val.size} val)", file=sys.stderr)

    learner_cls = ShardedWDGAILLearner if sharded else WDGAILLearner
    learner = learner_cls(scene, env_cfg, model_cfg, tcfg, expert,
                          expert_val)
    state = learner.init_state()
    if init_params:
        # warm start the POLICY only from a params-only checkpoint
        # (ckpt_dir/best_params, or convert.py's from a JAX one); the
        # critic, optimizers and env states start fresh
        ckpt_mod.restore_checkpoint(init_params, {"params": state.policy})
        if lead:
            print(f"warm-started policy from {init_params}",
                  file=sys.stderr)

    elapsed0 = 0.0
    best_score = -1.0
    if ckpt_dir and tcfg.resume_training:
        latest = ckpt_mod.latest_checkpoint(ckpt_dir)
        if latest:
            # a checkpoint holds the unsharded layout: a sharded run
            # restores it whole and keeps its block
            template = learner.init_full_state() if sharded else state
            state, elapsed0 = ckpt_mod.restore_checkpoint(latest, template)
            if sharded:
                state = learner.local_state(state)
            if lead:
                print(f"resumed from {latest}", file=sys.stderr)
        # a resumed run must not clobber ckpt_dir/best with a worse
        # post-resume eval: restore the recorded best score too
        try:
            with open(os.path.join(ckpt_dir, "best_score.json")) as f:
                best_score = float(json.load(f)["score"])
            if lead:
                print(f"resumed best score {best_score:.2f}",
                      file=sys.stderr)
        except (OSError, ValueError, KeyError):
            pass

    n_updates = tcfg.n_updates if max_updates is None else max_updates
    t0 = time.time() - elapsed0
    eval_metrics, metrics = {}, {}
    writer = MetricsWriter(log_dir) if lead else None
    first = True
    try:
        while state.update_i < n_updates:
            if profile and state.update_i == 1 and lead:
                state, metrics = _profiled_update(learner, state, dev,
                                                  log_dir)
            else:
                state, metrics = learner.update(state)
            i = state.update_i
            do_eval = i % tcfg.eval_interval == 0 or first
            save = ckpt_dir and (i % tcfg.eval_interval == 0
                                 or i == n_updates)
            first = False
            # the unsharded state to save (collective when sharded, so
            # every rank takes part whenever rank 0 may save)
            full = state
            if sharded and (save or (ckpt_dir and do_eval
                                     and eval_all_routes)):
                full = learner.global_state(state)
            if not lead:
                continue

            if do_eval:
                ev = evaluate_policy(scene, env_cfg, state.policy,
                                     _generator(dev, i),
                                     route_id=tcfg.eval_route,
                                     max_steps=env_cfg.max_steps)
                eval_metrics = {
                    "eval/reward": float(ev["reward"][0]),
                    "eval/length": float(ev["length"][0]),
                    "eval/completed": float(ev["completed"][0]),
                    "eval/score": float(ev["score_composed"][0]),
                }
                if eval_all_routes:
                    eval_metrics.update(_table_eval(
                        scene, env_cfg, state.policy, dev, eval_seeds,
                        eval_chunk))
                    score = eval_metrics["eval/mean_driving_score"]
                    if ckpt_dir and score > best_score:
                        best_score = score
                        ckpt_mod.save_checkpoint(
                            os.path.join(ckpt_dir, "best"), full,
                            time.time() - t0)
                        # params-only copy, the shape --init-params reads
                        ckpt_mod.save_checkpoint(
                            os.path.join(ckpt_dir, "best_params"),
                            {"params": state.policy})
                        with open(os.path.join(ckpt_dir, "best_score.json"),
                                  "w") as f:
                            json.dump({"score": best_score, "update": i}, f)
                        print(f"new best mean driving score "
                              f"{best_score:.1f} at update {i}",
                              file=sys.stderr)
            metrics = {**metrics, **eval_metrics}
            writer.write(i, metrics)

            steps_done = i * tcfg.num_steps
            fps = steps_done / max(time.time() - t0, 1e-9)
            print(
                f"update {i}/{n_updates}  steps {steps_done}  fps {fps:.0f}"
                f"  ep_rew {float(metrics['ep_reward_mean']):.3f}  "
                f"eval_rew {eval_metrics['eval/reward']:.3f}  "
                f"wd {float(metrics['disc/post_val_wd']):.4f}",
                file=sys.stderr,
            )
            if save:
                ckpt_mod.save_checkpoint(
                    os.path.join(ckpt_dir, f"update_{i}"), full,
                    time.time() - t0)
                ckpt_mod.prune_checkpoints(ckpt_dir, keep=ckpt_keep)
    finally:
        if writer is not None:
            writer.close()
    return state, metrics


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="smoke",
                   choices=list(make_presets().keys()))
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--params", default=None,
                   help="reference-schema params_variable.json")
    p.add_argument("--max-updates", type=int, default=None)
    p.add_argument("--log-dir", default="runs/wdgail")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of update 2")
    p.add_argument("--compliant-demos", action="store_true",
                   help="expert demos obey signals (obey_signals=True)")
    p.add_argument("--obs-mode", default=None,
                   choices=["bev", "bev6", "state"],
                   help="override the preset's observation mode")
    p.add_argument("--eval-all-routes", action="store_true",
                   help="run a leaderboard-table eval over every route "
                        "each eval_interval and keep the best checkpoint")
    p.add_argument("--terminal-mode", default=None,
                   choices=["leaderboard", "valeo", "valeo_nodetpx",
                            "leaderboard_dagger"],
                   help="override the preset's terminal handler")
    p.add_argument("--init-params", default=None,
                   help="warm-start the policy from a params-only "
                        "checkpoint (e.g. <ckpt-dir>/best_params, or one "
                        "that convert.py made from a JAX checkpoint)")
    p.add_argument("--gail-reward-shift", type=float, default=None,
                   help="constant added to the GAIL reward (see "
                        "TrainConfig)")
    p.add_argument("--resume", action="store_true",
                   help="resume the FULL training state (policy, critic, "
                        "optimizers, env states, generator, update "
                        "counter) from the newest update_* checkpoint in "
                        "--ckpt-dir")
    p.add_argument("--disc-lr-decay", action="store_true",
                   help="linear critic LR decay over the run "
                        "(TrainConfig.gail_use_linear_lr_decay)")
    p.add_argument("--norm-gail-reward", action="store_true",
                   help="normalise the GAIL reward by its running std "
                        "before the shift (TrainConfig.gail_norm_reward)")
    p.add_argument("--eval-seeds", type=int, default=1,
                   help="envs per route in the --eval-all-routes eval")
    p.add_argument("--eval-chunk", type=int, default=0,
                   help="max envs per evaluate_policy call in the "
                        "--eval-all-routes table (0 = one call)")
    p.add_argument("--seed", type=int, default=None,
                   help="training seed (TrainConfig.seed: net init, "
                        "rollout sampling)")
    p.add_argument("--eval-interval", type=int, default=None,
                   help="updates between evals / checkpoints "
                        "(TrainConfig.eval_interval, default 3)")
    p.add_argument("--demo-tree", default=None,
                   help="train from an on-disk gail_experts/ PNG tree "
                        "(tools/gen_trajectories.py writes one)")
    p.add_argument("--npc-vehicles", type=int, default=None,
                   help="background NPC vehicles per world during "
                        "training, demos and eval; demos need "
                        "--compliant-demos so the expert brakes for them")
    p.add_argument("--npc-walkers", type=int, default=None,
                   help="background NPC walkers per world")
    p.add_argument("--routes", default=None,
                   help="comma-separated training route ids, overriding "
                        "the preset")
    p.add_argument("--eval-route", type=int, default=None,
                   help="held-out route id (TrainConfig.eval_route)")
    p.add_argument("--n-envs", type=int, default=None,
                   help="training envs; routes are assigned round-robin")
    return p.parse_args(argv)


def launch_group(device):
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` above 1 in the
    environment) initialise the default process group from the launcher's
    environment: NCCL with this process on ``cuda:LOCAL_RANK``, or gloo
    for ``--device cpu``. Returns (the device to run on, whether a group
    was initialised here)."""
    dev = resolve_device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return dev, False
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, True


def main(argv=None):
    args = parse_args(argv)
    preset = make_presets()[args.preset]
    tcfg = preset["train"]
    if args.params:
        tcfg = TrainConfig.from_json(args.params)
    updates = {}
    if args.gail_reward_shift is not None:
        updates["gail_reward_shift"] = args.gail_reward_shift
    if args.resume:
        updates["resume_training"] = True
    if args.seed is not None:
        updates["seed"] = args.seed
    if args.disc_lr_decay:
        updates["gail_use_linear_lr_decay"] = True
    if args.norm_gail_reward:
        updates["gail_norm_reward"] = True
    if args.eval_interval:
        updates["eval_interval"] = args.eval_interval
    if args.routes:
        updates["routes"] = tuple(int(r) for r in args.routes.split(","))
    if args.eval_route is not None:
        updates["eval_route"] = args.eval_route
    if args.n_envs is not None:
        updates["n_envs"] = args.n_envs
    tcfg = dataclasses.replace(tcfg, **updates)
    if args.max_updates and (args.disc_lr_decay
                             or tcfg.use_linear_lr_decay):
        # LR schedules decay over n_updates = num_env_steps / num_steps;
        # align that horizon with the run's length
        tcfg = dataclasses.replace(
            tcfg, num_env_steps=args.max_updates * tcfg.num_steps)
    env_updates = {}
    if args.obs_mode:
        env_updates["obs_mode"] = args.obs_mode
    if args.terminal_mode:
        env_updates["terminal_mode"] = args.terminal_mode
    if args.npc_vehicles is not None:
        env_updates["n_npc_vehicles"] = args.npc_vehicles
    if args.npc_walkers is not None:
        env_updates["n_npc_walkers"] = args.npc_walkers
    env_cfg = dataclasses.replace(preset["env"], **env_updates)
    dev, launched = launch_group(args.device)
    try:
        return run(
            env_cfg, preset["model"], tcfg, preset["scene"],
            preset["demo_steps"], max_updates=args.max_updates,
            log_dir=args.log_dir, ckpt_dir=args.ckpt_dir,
            profile=args.profile, demo_obey_signals=args.compliant_demos,
            eval_all_routes=args.eval_all_routes,
            init_params=args.init_params,
            eval_seeds=args.eval_seeds,
            demo_tree=args.demo_tree,
            eval_chunk=args.eval_chunk,
            device=dev,
        )
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
