"""Full-pipeline WDGAIL update throughput at large env counts: port of
``gail_carla_tpu/tools/wdgail_scale_bench.py``.

It measures the whole update (the rollout with the BEV rendered and the
policy acting at every step, the critic's ``disc_update``,
``relabel_rewards``, GAE and PPO) on the procedural benchmark scene, or
``--town``, and projects the wall-clock time to the reference's 10 M
env-step budget (params_variable.json:4). The rollout's observations are
stored bit-packed, one byte per pixel (``algo/buffers.py::pack_bev_obs``),
so each frame renders once per update (the CUDA kernel B1 at ``--obs-mode
bev``, B2 at ``bev6``); ``--no-store-obs`` re-renders every PPO and critic
minibatch from the compact render states instead.

Times are read after ``torch.cuda.synchronize``. The port compiles
nothing ahead of its first update, so the JAX tool's "compile+first
update" line is "first update" here; ``--updates`` more updates follow and
the best counts. ``--phases`` then times each part of the update alone,
the best of three after one untimed call. On the card the peak device
memory (``torch.cuda.max_memory_allocated``) is printed too. The last
stdout line is one JSON record with the JAX tool's keys.

Usage (on the card unless ``--device cpu``):
    python -m gail_carla_tpu_torch.tools.wdgail_scale_bench \\
        --n-envs 4096 --obs-mode bev6 --steps-per-env 16 \\
        --ppo-epoch 4 --mb 8192 --updates 3
    python -m gail_carla_tpu_torch.tools.wdgail_scale_bench --device cpu \\
        --n-envs 2 --steps-per-env 4 --mb 4 --gail-batch 4 --updates 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from gail_carla_tpu_torch.algo import ppo as ppo_mod
from gail_carla_tpu_torch.algo import wdgail as wdgail_mod
from gail_carla_tpu_torch.algo.buffers import build_expert_buffer
from gail_carla_tpu_torch.algo.expert import generate_demos
from gail_carla_tpu_torch.algo.learner import WDGAILLearner
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.ops.gae import compute_returns

# the procedural benchmark scene of the reference preset
GRID_SCENE = dict(n_routes=10, nx=4, ny=4, block=100.0, min_length=400.0)
# the seeds of the demos' generator and of the phases' draws (the JAX
# tool's PRNGKey(0) and PRNGKey(123))
DEMO_SEED, PHASE_SEED = 0, 123
# the expert buffer's row cap
EXPERT_MAX_ROWS = 12288


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_phases(learner, state, num_steps, n_reps: int = 3):
    """Per-phase wall times, each the best of ``n_reps`` calls after one
    untimed call, printed on stderr. Each call of a phase draws from one
    generator on the device, seeded with the phase's seed first, so every
    call draws the same values. The critic and PPO phases update the
    state's nets in place, as the learner's update does."""
    scene, env_cfg, tcfg = learner.scene, learner.env_cfg, learner.tcfg
    dev = learner.device
    gen = torch.Generator(device=dev)
    k_roll, k_disc, k_ppo = PHASE_SEED, PHASE_SEED + 1, PHASE_SEED + 2

    def timeit(name, f):
        out = f()
        _sync(dev)
        best = float("inf")
        for _ in range(n_reps):
            t0 = time.perf_counter()
            out = f()
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        print(f"phase {name}: {best*1e3:,.0f} ms", file=sys.stderr)
        return out, best

    def f_roll():
        gen.manual_seed(k_roll)
        return collect_rollout(
            scene, env_cfg, state.policy, state.env_states, state.metrics,
            state.render, gen, tcfg.steps_per_env, learner.store_obs)

    (_, _, _, rollout, _), t_roll = timeit("rollout", f_roll)

    def f_disc():
        gen.manual_seed(k_disc)
        return wdgail_mod.disc_update(
            scene, env_cfg, tcfg, state.disc, learner.disc_optimizer,
            state.disc_opt, rollout, learner.expert, gen, 1)

    _, t_disc = timeit("disc epoch", f_disc)

    gail_rewards, t_rel = timeit("relabel", lambda: (
        wdgail_mod.relabel_rewards(scene, env_cfg, state.disc, rollout)))
    rollout = dataclasses.replace(rollout, gail_rewards=gail_rewards)

    returns, t_gae = timeit("gae", lambda: compute_returns(
        rollout.gail_rewards, rollout.env_rewards, rollout.values,
        rollout.masks, tcfg.gamma, tcfg.gae_lambda))

    def f_ppo():
        gen.manual_seed(k_ppo)
        return ppo_mod.ppo_update(
            scene, env_cfg, tcfg, state.policy, learner.policy_optimizer,
            state.policy_opt, rollout, returns, gen, state.gail_gamma, None)

    _, t_ppo = timeit("ppo", f_ppo)
    total = t_roll + t_disc + t_rel + t_gae + t_ppo
    print(
        f"phase total {total:.2f}s  rollout {t_roll/total:.0%} "
        f"disc {t_disc/total:.0%} ppo {t_ppo/total:.0%}",
        file=sys.stderr,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-envs", type=int, default=4096)
    p.add_argument("--obs-mode", default="bev6",
                   choices=["bev", "bev6", "state"])
    p.add_argument("--steps-per-env", type=int, default=16)
    p.add_argument("--ppo-epoch", type=int, default=4)
    p.add_argument("--mb", type=int, default=8192,
                   help="minibatch size (the reference's 128 is sized for "
                        "7200-sample updates; scale it with the batch)")
    p.add_argument("--gail-batch", type=int, default=4096)
    p.add_argument("--updates", type=int, default=3)
    p.add_argument("--town", default=None)
    p.add_argument("--demo-steps", type=int, default=2400)
    p.add_argument("--phases", action="store_true",
                   help="additionally time each pipeline phase with its "
                        "own jit (rollout / disc / relabel / GAE / PPO)")
    p.add_argument("--no-store-obs", action="store_true",
                   help="re-render obs per minibatch instead of storing "
                        "bit-packed frames (the pre-r3 behaviour)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    return p.parse_args(argv)


def make_configs(args):
    """(scene kwargs, env config, train config, demo env config) of the
    JAX tool's set-up (``wdgail_scale_bench.py:125-145``)."""
    scene_kwargs = ({"town": args.town} if args.town
                    else dict(GRID_SCENE))
    env_cfg = EnvConfig(train=True, obs_mode=args.obs_mode)
    tcfg = TrainConfig(
        n_envs=args.n_envs, num_steps=args.n_envs * args.steps_per_env,
        mini_batch_size=args.mb, ppo_epoch=args.ppo_epoch,
        gail_batch_size=args.gail_batch,
        gail_pre_epoch=2, gail_epoch=1, gail_thre=2,
    )
    demo_cfg = dataclasses.replace(env_cfg, train=False, max_time=600.0)
    return scene_kwargs, env_cfg, tcfg, demo_cfg


def main(argv=None):
    args = parse_args(argv)
    from gail_carla_tpu_torch.train import make_scene

    dev = resolve_device(args.device)
    scene_kwargs, env_cfg, tcfg, demo_cfg = make_configs(args)
    num_steps = tcfg.num_steps
    scene = make_scene(scene_kwargs, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(DEMO_SEED)
    demos = generate_demos(scene, demo_cfg, gen, tcfg.routes,
                           args.demo_steps, obey_signals=True)
    expert = build_expert_buffer(scene, env_cfg, demos,
                                 max_size=EXPERT_MAX_ROWS)
    print(f"expert buffer: {expert.size}", file=sys.stderr)

    learner = WDGAILLearner(
        scene, env_cfg, ModelConfig(), tcfg, expert,
        store_obs=not args.no_store_obs,
    )
    state = learner.init_state()

    t0 = time.perf_counter()
    state, metrics = learner.update(state)
    _sync(dev)
    print(f"first update: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    best = float("inf")
    for _ in range(args.updates):
        t0 = time.perf_counter()
        state, metrics = learner.update(state)
        _sync(dev)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        print(f"update: {dt:.2f}s  ({num_steps / dt:,.0f} steps/s)",
              file=sys.stderr)

    if args.phases:
        _time_phases(learner, state, num_steps)
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              file=sys.stderr)

    steps_per_sec = num_steps / best
    hours_to_10m = 1e7 / steps_per_sec / 3600.0
    record = {
        "metric": "wdgail_full_pipeline_steps_per_sec",
        "n_envs": args.n_envs,
        "obs_mode": args.obs_mode,
        "steps_per_update": num_steps,
        "sec_per_update": round(best, 3),
        "value": round(steps_per_sec, 1),
        "unit": "steps/s",
        "hours_to_10M_steps": round(hours_to_10m, 2),
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
