"""Chip smoke test of the PyTorch/CUDA port (gail_carla_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``gail_carla_tpu_torch/csrc`` into
``gail_carla_tpu_torch/_build/`` (one ``nvcc`` per source, all at once),
holds each kernel against its plain PyTorch version on the card, then
drives the two observation paths at the full width of the ``reference``
preset (the 4x4 grid town with 10 routes, 192 px BEV, convs
32-64-128-256, hidden 512, bfloat16 convs, random weights from a numpy
seed), each through the entry points a user calls: deterministic
evaluation on the held-out route and a rollout, and on the ``"bev"`` path
the training entry point ``train.run``.

- the ``"bev"`` path: 3-channel observation, no traffic, kernel
  ``bev_raster`` (the TPU kernel ``ops/bev_pallas.py``);
- the ``"bev6"`` path: 6-channel observation with 20 NPC vehicles and 50
  walkers per env (NoCrash "regular" Town01 densities), kernel
  ``bev6_raster`` (the TPU kernel ``ops/bev6_pallas.py``); then one
  profiled forward and backward of its policy's conv encoder at
  ``LAYOUT_ENVS`` envs, which must launch none of cuDNN's NCHW/NHWC
  transposes (the encoder runs channels-last); it prints their count and
  the conv kernels, conv1's named;
- the ``"train bev"`` path: ``train.run(use_sharding=True)`` at the
  reference preset inside a world-1 NCCL group (the data-parallel
  learner, its collectives and the gathered checkpoint): the scripted
  expert's demos with noise (``generate_demos``) on the training routes
  ``TRAIN_ROUTES`` and the held-out route ``TRAIN_EVAL_ROUTE``, the
  expert and validation buffers, ``TRAIN_UPDATES`` update(s) (10 envs x
  720 steps, the packed
  observation store, 6 warm-up critic epochs with the gradient penalty,
  16 PPO epochs of 128-sample minibatches), the evaluation on the held-out route, the
  metrics log and the checkpoints; the demos' ms per step and valid rows
  per route, each update's wall time, its per-part breakdown (CUDA
  events) and B1's launches per part of the run. The last checkpoint must
  restore on the card bit for bit;
- the ``"tree bc"`` path, the reference's demo-file recipe at the same
  widths: ``tools/gen_trajectories`` writes a ``gail_experts/`` PNG tree
  (10 routes x ``TREE_STEPS`` steps, the 15-channel BEV, three cameras,
  dynamic weather; ms per step split into env step, full render,
  cameras and PNG writes), ``tools/learn_bc --experts-dir`` trains BC on
  it (ms per epoch, losses), ``train.run(demo_tree=...,
  init_params=<BC's best>)`` takes one update (the warm start must equal
  BC's best, 0 tensors different) and ``tools/evaluation.evaluate`` runs
  BC's best on route 3 (both evaluations capped at ``TREE_EVAL_STEPS``
  steps). B1 runs in the update and the evaluations. The
  full render at the rollout's 256 envs with a filled history ring is
  held against B1 (planes 0-2) and B2 (planes 0-2, 14, 6, 10), 0 values
  differing, and a tree made on the card against one made on the CPU
  from the same draws (smoke scene, 2 routes x ``CMP_STEPS`` steps):
  masks equal, cameras within one level, ``episode.json`` within
  ``DEMO_TOL``;
- the ``"suites"`` path, the gym-style env API and the policy benchmarks
  at the same widths: ``envs.make`` on the card for one id of each suite
  family (each ``DrivingEnv`` renders its one world through B1), a
  ``VecEnv`` of ``VEC_ENVS`` envs on the NoCrash regular scene through an
  ``EnvMonitor``, ``tools/nocrash_bench.run_tier`` on the four NoCrash
  traffic tiers (dense: 100 vehicles and 250 walkers per world) and the
  four CoRL2017 task types with the bev6 policy (B2 once per step) and
  the expert, ``tools/benchmark_policy.benchmark`` on the reference scene
  (B1) and with the expert, each for ``SUITE_STEPS`` steps, and the
  expert on the endless suite's chained rows until an env has switched
  rows and passed the first row's length. Then B1 on the switched envs
  against its plain version, B2 at the dense tier's 351 boxes per env on
  the rollout's 256 envs against its plain version (0 values differ),
  timed, with its shared memory per block, and a tier and a
  ``DrivingEnv`` run on the card against the CPU with the same draws
  (latched flags and 0 observation values equal, scores and metrics
  within ``DEMO_TOL``);
- the ``"options"`` path, the options of ported modules at the same
  widths: (a) the state-vector observation (``obs_mode="state"``): one
  ``algo="ppo"`` update with ``ModelConfig()`` at the preset's 10 envs
  and at ``STATE_BIG_ENVS`` envs (rollout / PPO split, the float32
  store's bytes), the scripted expert's state demos into
  ``build_expert_buffer`` and ``evaluate_policy`` of the state policy;
  (b) the state observation of ``ROLL_ENVS`` envs and a toy state update
  on the card against the CPU; (c) ``leaderboard_suite(scenario_actors=
  ...)`` with one scripted adversary per route and ``SA_SLOTS`` scenario
  slots: the compliant expert yields to it (0 vehicle collisions, every
  route within ``SA_GAP`` m of its adversary) and the bev6 policy draws
  the slots through B2; (d) B2 at 20 NPC vehicles + the scenario slots
  (1 live, 2 parked ~1e6 m away) + 50 walkers on ``ROLL_ENVS`` envs
  against its plain version (0 values differ), timed, with its shared
  memory; (e) the reference scene with the grid's building obstacles: a
  hard right turn scores a layout collision (penalty 65) in every env,
  the expert none, and the obstacle test on ``OB_POSES`` random poses and
  the cameras on the card agree with the CPU;
- the ``"sharded"`` path, training on more than one rank: (b) a world-1
  ``ShardedWDGAILLearner`` repeats the reference phase's card update at
  the smoke preset (same weights and draws) within the CPU tests'
  tolerances, as a second run of the plain update does; (d) the GPS
  expert drives one env per route for ``GPS_STEPS`` steps (each at least
  ``GPS_MIN_M`` m along its route) and its first ``GPS_CMP_STEPS`` steps
  agree card vs CPU; (c) ``SHARD_WORLD`` processes of this script
  (``--sharded-rank``), gloo ranks with CUDA tensors on the one card
  (NCCL refuses two ranks on one GPU), each a ``ShardedWDGAILLearner`` at
  the reference widths, started before the reference phase so that their
  set-up and updates run beside it (the timed phases after it wait until
  their updates have ended): after two updates every replicated
  leaf is bitwise equal on both ranks and the metrics are equal, a
  replica perturbed by 1 stays apart after an update, at most 40 policy
  all-reduces per update; they time the policy's all-reduce once this
  phase waits for them.
- the ``"town"`` path, the reconstructed towns (the town importers) at
  the same widths, on a synthetic reference tree that it writes to a
  temporary directory (``tools/synthetic_town.py``: the 3x3 grid town at
  90 m blocks as Town01's mask pack with a sidewalk ring, ``TOWN_ROUTES``
  training routes and a NoCrash pack of bare start/goal pairs; the pack
  goes through ``h5py`` when it imports, else to the pack reader in
  memory, and the script prints which): ``make_town_scene`` (build
  seconds, the table maxima, the blocks' shared bytes), B1 and B2 against
  their plain versions on the town tables at ``ROLL_ENVS`` envs x 192 px
  (B2 at 20 + 50 and 100 + 250 actors, walkers on the sidewalk paths),
  timed, and on a town table whose blocks need more than 48 KB of shared
  memory (the road's edge serrated, ``SERRATED_ENVS`` envs); a float32
  bev6 rollout with sidewalk walkers on the card against the CPU; then,
  with the launch counts set to 0, ``train.run`` at the ``town01``
  preset (``ModelConfig()``, 10 envs, 192 px; ``TOWN_DEMO_STEPS`` demo
  steps and episode steps, ``TOWN_STEPS`` steps per env of one update,
  the evaluation on held-out route 3) and ``run_tier`` on the town's
  NoCrash suite with the bev6 policy;
- the ``"scale"`` path, the full-pipeline scale bench
  (``tools/wdgail_scale_bench.py``) through its ``main`` in bev6 on the
  reference scene at ``SCALE_ENVS`` envs x ``SCALE_STEPS`` steps with
  ``--phases``, ``--updates 1`` and ``SCALE_DEMO_STEPS`` demo steps, in a
  process of this script (``--scale``) started beside the reference
  phase: its set-up (scene, demos, expert buffer) runs beside that
  phase, its timed updates and phases alone once that phase has ended.
  Its record must have the tool's keys and a positive ``value``, each
  phase its time, the last update finite losses and weights, the expert
  buffer one critic minibatch, and B2 one launch per render (B1 none); it
  prints each phase's ms and share, the rollout's ms per env step, the
  peak memory, and then the bev6 rollout step at ``SCALE_BREAKDOWN_ENVS``
  envs. B1 and B2 are held against their plain versions at the batches
  the tool launches, ``SCALE_LAUNCH_ENVS`` envs of distinct poses.

Each kernel is checked against its plain version on the same render
states of the rollout's 256 envs, at W=192 and W=100, with envs placed on
the cell grid's corners and with boundary edges, stop lines, stop signs
and actors on tile-corner pixels (``ops/bev6.py::place_in_view`` with
``tiles``); 0 values may differ. Each kernel is then timed alone
(CUDA-graph device time) and as the render a rollout step calls (its
PyTorch prologue and checks included), beside its plain version and its
bound: the larger of the bytes it must move over the memory rate and the
operations of the pixel-item pairs within reach over the float32 peak
(``pair_counts``). The outputs of its first and last launch on the timed
inputs are held against the plain version's too, and the observation
store's pack/unpack round trip of each kernel's output must change 0
values. A float32 update at the smoke preset and the scripted expert's
demos with signals and traffic run on the card and on the CPU with the
same draws and must agree within the CPU tests' tolerances; a minibatch
fetched from the training path's packed store must equal its re-render
through B1.

It prints the host's CPU model and count, one progress line per phase
(with ``ptxas``'s registers, shared memory and spills of each build), a
per-step time breakdown of each path (the bev env step at 256 envs is the
host-speed marker, printed again beside the total), a JSON line of kernel
measurements, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before printing a
result.

``python3 chip_smoke.py --shard-cost`` instead measures what the world-1
sharded learner adds to a reference-preset update: a plain and a sharded
learner side by side in one process (``shard_cost``).

float32 matrix products and convolutions run in full float32: TF32 is
switched off for both (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False).
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from gail_carla_tpu_torch import cuda_build
from gail_carla_tpu_torch import train as train_mod
from gail_carla_tpu_torch.agents.autopilot import (
    TARGET_SPEED, autopilot_act, reset_autopilot_where,
)
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.agents.gps_autopilot import (
    draw_gps_noise, gps_autopilot_act, make_gps_autopilot,
)
from gail_carla_tpu_torch.algo import bc as bc_mod
from gail_carla_tpu_torch.algo import learner as learner_mod
from gail_carla_tpu_torch.algo import ppo as ppo_mod
from gail_carla_tpu_torch.algo import wdgail as wdgail_mod
from gail_carla_tpu_torch.algo.buffers import (
    EXPERT_CHUNK,
    build_expert_buffer, fetch_expert_obs, fetch_rollout_obs, map_state,
    pack_bev_obs, unpack_bev_obs,
)
from gail_carla_tpu_torch.algo.evaluate import evaluate_policy, run_latched
from gail_carla_tpu_torch.algo.expert import (
    DemoBatch, DemoDraws, draw_demos, generate_demos,
)
from gail_carla_tpu_torch.algo.learner import UpdateDraws, WDGAILLearner
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig
from gail_carla_tpu_torch.convert import (
    init_critic_flax_params, init_flax_params, init_policy, policy_from_flax,
)
from gail_carla_tpu_torch.envs import registry
from gail_carla_tpu_torch.envs.gym_env import DrivingEnv
from gail_carla_tpu_torch.envs.suites import (
    NOCRASH_TRAFFIC, leaderboard_suite, nocrash_suite,
)
from gail_carla_tpu_torch.envs.vec_env import VecEnv, host_outputs
from gail_carla_tpu_torch.models import policy as policy_mod
from gail_carla_tpu_torch.ops import bev as bev_plain
from gail_carla_tpu_torch.ops import bev6 as bev6_plain
from gail_carla_tpu_torch.ops import bev6_cuda, bev_cuda, bev_tiles, camera
from gail_carla_tpu_torch.ops.bev import INV_255, ROUTE_HALF_W
from gail_carla_tpu_torch.ops.bev_full import TL_LINE_HALF_W, render_bev_full
from gail_carla_tpu_torch.ops.gae import compute_returns
from gail_carla_tpu_torch.ops.state_obs import (
    STATE_OBS_DIM, state_observation_batch,
)
from gail_carla_tpu_torch.parallel.collectives import all_mean
from gail_carla_tpu_torch.parallel.mesh import ShardedWDGAILLearner
from gail_carla_tpu_torch.scene import h5_maps, mask_geo
from gail_carla_tpu_torch.scene import segments as seg_mod
from gail_carla_tpu_torch.scene.routes import generate_routes
from gail_carla_tpu_torch.scene.scene import build_scene, make_benchmark_scene
from gail_carla_tpu_torch.scene.town import (
    grid_building_obstacles, make_grid_town,
)
from gail_carla_tpu_torch.scene.town_import import make_town_scene
from gail_carla_tpu_torch.scene.trace import trace_route
from gail_carla_tpu_torch.sim.collisions import obstacle_collision
from gail_carla_tpu_torch.sim.dynamics import DEFAULT_VEHICLE, VehicleState
from gail_carla_tpu_torch.sim.env import (
    RenderState, draw_gnss, draw_reset, draw_step, reset_batch, step_batch,
)
from gail_carla_tpu_torch.sim.traffic import step_traffic
from gail_carla_tpu_torch.tools import benchmark_policy
from gail_carla_tpu_torch.tools import evaluation as evaluation_mod
from gail_carla_tpu_torch.tools import gen_trajectories as gen_mod
from gail_carla_tpu_torch.tools import learn_bc as learn_bc_mod
from gail_carla_tpu_torch.tools import nocrash_bench
from gail_carla_tpu_torch.tools import synthetic_town
from gail_carla_tpu_torch.tools import wdgail_scale_bench as scale_mod
from gail_carla_tpu_torch.tools.corl_bench import TASK_TYPES
from gail_carla_tpu_torch.train import make_presets
from gail_carla_tpu_torch.utils import checkpoint as ckpt_mod
from gail_carla_tpu_torch.utils.logging import TAG_MAP
from gail_carla_tpu_torch.utils.monitor import EnvMonitor
from gail_carla_tpu_torch.utils.png import read_png

KERNEL_SOURCES = ("bev_raster.cu", "bev6_raster.cu")
# NoCrash "regular" Town01 traffic (gail_carla_tpu/envs/suites.py:40-46)
N_VEHICLES, N_WALKERS = 20, 50
# depth of each path: evaluation on the held-out route, then a rollout
EVAL_ROUTE, EVAL_ENVS, EVAL_STEPS = 3, 16, 200
ROLL_ENVS, ROLL_STEPS = 256, 32
# the training phase: train.run at the reference preset (TrainConfig(
# n_envs=10): 720 steps per env), cut to TRAIN_UPDATES updates and
# DEMO_STEPS expert steps per route on the training routes TRAIN_ROUTES
# and the held-out route TRAIN_EVAL_ROUTE: the three routes whose first
# episodes end first (with the preset's 9 + 1 routes on the card: route 2
# at step 763, 7 at 1,021, 1 at 1,050, the others at 1,106-1,499; with
# these three on the card: 842, 1,032 and 1,004), so that the preset's
# 4,000 steps cut to DEMO_STEPS still complete an episode on every route
TRAIN_UPDATES, DEMO_STEPS = 1, 1050
TRAIN_ROUTES, TRAIN_EVAL_ROUTE = (2, 7), 1
# the card-vs-CPU update's expert demos: route 0 of the smoke scene ends
# its first episode near step 520
SMOKE_DEMO_STEPS = 600
# card-vs-CPU demos: actions, metrics and positions (closed loop,
# CMP_DEMO_STEPS steps, float32 sin/cos of the two devices)
DEMO_TOL = 1e-4
CMP_DEMO_STEPS = 100
# the card-vs-CPU update at the smoke preset: 16 steps per env
SMOKE_STEPS_PER_ENV = 16
# the CPU tests' tolerances (tests/test_torch_learner.py): losses and aux
# 1e-4 relative (1e-6 absolute), parameters 2e-5 absolute
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-6, 2e-5
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the tree bc phase: the exporter's depth (routes x steps), BC epochs,
# the update's steps per env from the tree, the evaluations' step cap,
# the steps that fill the full render's ring, the card-vs-CPU tree
# (routes x steps)
TREE_ROUTES, TREE_STEPS = 10, 16
BC_EPOCHS = 1
TREE_UPDATE_STEPS = 16
TREE_EVAL_STEPS = 30
RING_STEPS = 22
CMP_ROUTES, CMP_STEPS = 2, 2
# the suites phase: steps of each DrivingEnv the registry makes, the
# vector env (envs x steps), the step cap of each NoCrash tier, CoRL task
# type and leaderboard benchmark (the tools' 2,400-6,000 cut), the endless
# expert (envs x at most steps), the card-vs-CPU tier's steps and
# DrivingEnv's steps
REGISTRY_STEPS = 2
VEC_ENVS, VEC_STEPS = 16, 30
SUITE_STEPS = 3
ENDLESS_ENVS, ENDLESS_STEPS = 8, 400
CMP_TIER_STEPS, CMP_ENV_STEPS = 8, 6
# the registry's ids driven in the suites phase, one per family; Endless
# with the short rows of the endless check
REGISTRY_IDS = ("LeaderBoard-v0", "NoCrash-v2", "CoRL2017-v1",
                "CoRL2017-v3", "Endless-v0")
ENDLESS_ROWS = dict(n_rows=6, row_m=45.0)
NOCRASH_IDS = {"empty": "NoCrash-v0", "regular": "NoCrash-v1",
               "dense": "NoCrash-v2", "leaderboard": "NoCrash-v3"}
CORL_IDS = {t: f"CoRL2017-v{i}" for i, t in enumerate(TASK_TYPES)}
# the options phase: (a) steps per env of the state path's update at the
# preset's envs, the larger update's envs and steps per env, the state
# demos' steps per route, the state evaluation's step cap; (b) the state observation's card-vs-CPU bound;
# (c) the adversary's parking point along each route (the least distance
# and the straight road before it), the scenario slots
# per env (1 live, 2 parked), the expert's step cap, the gap it must
# close and the steps it then keeps driving; (e) the hard right turn's
# steps, the expert's steps and the random poses of the card-vs-CPU SAT
STATE_STEPS, STATE_BIG_ENVS, STATE_BIG_STEPS = 16, 256, 8
STATE_DEMO_STEPS, STATE_EVAL_STEPS = 30, 100
STATE_OBS_ATOL = 1e-6
SA_AHEAD_M, SA_STRAIGHT_M, SA_SLOTS = 45.0, 30.0, 3
SA_EXPERT_STEPS, SA_GAP, SA_HOLD = 400, 20.0, 10
OB_STEPS, OB_EXPERT_STEPS, OB_POSES = 240, 60, 4096
# the sharded phase: (c) two gloo ranks on the one card at the reference
# widths, each with SHARD_STEPS steps of its one env per update, PPO and
# critic minibatches of SHARD_MB rows (SHARD_PPO_EPOCHS x 2 policy
# all-reduces per update), an expert buffer of SHARD_DEMO_STEPS demo steps
# on 2 routes, and its time limit; (d) the GPS expert, one env per route
# for GPS_STEPS steps (each must make GPS_MIN_M of route progress; the
# JAX test asks 100 m in 600 steps), its first GPS_CMP_STEPS steps on the
# card against the CPU
SHARD_WORLD, SHARD_STEPS, SHARD_MB, SHARD_PPO_EPOCHS = 2, 32, 16, 4
SHARD_DEMO_STEPS, SHARD_TIMEOUT_S = 48, 240
# the files that tell the ranks the main process waits for them, and the
# main process that a rank's updates are done
GO_FILE, UPDATED_FILE = "go", "updated"
GPS_STEPS, GPS_MIN_M, GPS_CMP_STEPS = 300, 40.0, 50
# the town phase: the synthetic reference tree (tools/synthetic_town.py:
# the 3x3 grid town at 90 m blocks as Town01, TOWN_ROUTES training routes
# of TOWN_ROUTE_M metres, so that the town01 preset's routes 0-2, 4-9 and
# held-out 3 exist and the expert completes each within TOWN_DEMO_STEPS
# steps (on the CPU every first episode ended by step 258), and a NoCrash
# pack of bare start/goal pairs); train.run at the town01 preset cut to
# TOWN_DEMO_STEPS demo steps per route, episodes of as many steps (the
# evaluation's cap) and TOWN_STEPS steps per env of one update; the table
# whose blocks need more than 48 KB (the road layer's edge serrated in
# SERRATE_PX-pixel checks) at SERRATED_ENVS envs
TOWN_ROUTES, TOWN_ROUTE_M, TOWN_DEMO_STEPS, TOWN_STEPS = (
    10, (60.0, 140.0), 280, 64)
SERRATE_PX, SERRATED_ENVS = 2, 64
# the scale phase: tools/wdgail_scale_bench.py's main on the card in
# bev6 at SCALE_ENVS envs x SCALE_STEPS steps (its default), --mb and
# --gail-batch scaled from the tool's 8,192 and 4,096 at 4,096 envs,
# --updates 1, --phases and SCALE_DEMO_STEPS demo steps: enough for the
# expert buffer to fill one --gail-batch critic minibatch (the buffer
# holds the steps of the episodes that end; on the card the nine
# training routes' first episodes end at steps 802 (route 2), 1,086 (7)
# and 1,110 (1), the others after 1,150); its time limit
SCALE_ENVS, SCALE_STEPS, SCALE_DEMO_STEPS = 1024, 16, 1120
SCALE_TIMEOUT_S = 300
# the bev6 rollout step's breakdown at the tool's default 4,096 envs; the
# batches the tool launches B1 and B2 at: its default PPO minibatch under
# --no-store-obs, its default rollout and critic minibatch, this phase's
# rollout
SCALE_BREAKDOWN_ENVS = 4096
SCALE_LAUNCH_ENVS = (8192, 4096, SCALE_ENVS)
# the keys of the tool's final record and its phases, as the JAX tool
# prints them
SCALE_KEYS = ("metric", "n_envs", "obs_mode", "steps_per_update",
              "sec_per_update", "value", "unit", "hours_to_10M_steps")
SCALE_PHASES = ("rollout", "disc epoch", "relabel", "gae", "ppo")
# the encoder's layout check: one forward and backward of the bev6
# policy's conv encoder at this many envs under the profiler; cuDNN's
# layout transposes, by kernel name; the conv kernels, by name
LAYOUT_ENVS = 1024
TRANSPOSE_KERNELS = ("nchwToNhwc", "nhwcToNchw")
CONV_KERNEL_WORDS = ("conv", "xmma", "fprop", "dgrad", "wgrad", "cutlass")
# cuDNN's helpers beside a conv: workspace set-up, split-K reduction
CONV_HELPER_WORDS = ("init_device_workspace", "ReduceSplitK")
SEED = 0
T0 = time.time()


def progress(phase: str, t_start: float) -> None:
    print(f"[chip_smoke] {phase} ok {time.time() - t_start:.2f}s",
          flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def route_poses(scene, n: int, seed: int):
    """A RenderState of ``n`` poses along all routes, jittered off the
    route; the first envs of each route sit within the route window
    (84 points) of the route end, where the window start is clamped."""
    rng = np.random.default_rng(seed)
    route_n = scene.route_n.cpu().numpy()
    R = len(route_n)
    rid = (np.arange(n) % R).astype(np.int32)
    nr = route_n[rid]
    head = (rng.uniform(0.0, 1.0, n) * (nr - 1)).astype(np.int32)
    tail = np.arange(n) < 2 * R
    head[tail] = nr[tail] - 1 - rng.integers(0, 84, int(tail.sum()))
    xy = scene.route_xy.cpu().numpy()[rid, head]
    xy = (xy + rng.normal(0.0, 1.5, (n, 2))).astype(np.float32)
    yaw = scene.route_yaw.cpu().numpy()[rid, head]
    yaw = (yaw + rng.normal(0.0, 0.3, n)).astype(np.float32)
    dev = scene.device
    z = torch.zeros(n, dtype=torch.int32, device=dev)
    return RenderState(
        xy=torch.from_numpy(xy).to(dev), yaw=torch.from_numpy(yaw).to(dev),
        route_id=torch.from_numpy(rid).to(dev),
        head=torch.from_numpy(head).to(dev), step=z, stop_idx=z - 1,
        npc_pose=torch.zeros((n, 0, 3), device=dev),
        walker_pose=torch.zeros((n, 0, 3), device=dev),
    )


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the card, replayed from a CUDA
    graph of ``iters`` calls: the device's time, without the host's launch
    gaps between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# Operations of the plain version per pixel and item it weighs (ops/bev.py,
# ops/bev6.py; a clamp counts 2, |.| is an operand modifier): a boundary
# edge's distance and cross (18), tie key (3) and min; a route capsule's
# distance (16) and min; a lane capsule's or stop line's distance, compare,
# select and max; a box's 2 subtractions, lx (3), ly (4), 2 abs, 2
# compares, and, any.
PAIR_OPS = {"road": 22, "route": 17, "lane": 19, "light": 19, "boxes": 15}
# per pixel: its world coordinates (8), and one op per channel value
PIXEL_OPS = 8


def pair_counts(cfg: EnvConfig, inp, tables, dmax: float):
    """{table: (pairs within reach, pairs weighed without culling)} of one
    render of these inputs (for bev6, ``tables`` holds what the kernel
    reads of the lights and boxes; None for bev): the pixel-item pairs
    whose distance is within the item's reach (ops/bev_tiles.py's reaches,
    no pad), the only pairs that can change a pixel, and the pairs of every
    live item (every box row) with every pixel."""
    six = tables is not None
    base = inp.base if six else inp
    n, w = base.pose.shape[0], cfg.bev_width

    def live(count, m):
        return (torch.arange(m, device=count.device)[None, :]
                < count.to(torch.int64)[:, None])

    def full(segs, r):
        return torch.full(segs.shape[:2], r, device=segs.device)

    items = {
        "road": (base.bnd, live(base.counts[:, 0], base.bnd.shape[1]),
                 full(base.bnd, bev_tiles.road_reach(dmax))),
        "route": (base.route, full(base.route, True),
                  full(base.route, ROUTE_HALF_W)),
        "lane": (base.lane, live(base.counts[:, 1], base.lane.shape[1]),
                 base.lane_w.abs()),
    }
    if six:
        tl, boxes = tables.tl, tables.boxes
        items["light"] = (tl, live(tables.n_tl, tl.shape[1]),
                          full(tl, TL_LINE_HALF_W))
        items["boxes"] = (boxes[..., [0, 1, 0, 1]],
                          bev_tiles.box_live(boxes),
                          bev_tiles.box_reach(boxes))
    near = dict.fromkeys(items, 0)
    for lo in range(0, n, 8):
        sl = slice(lo, min(lo + 8, n))
        pose = base.pose[sl]
        px = bev_plain.pixel_world_coords(cfg, pose[:, :2], pose[:, 2],
                                          pose[:, 3])
        for name, (segs, ok, r) in items.items():
            d2 = bev_tiles.seg_dist2(px, segs[sl])
            r2 = (r[sl] * r[sl])[:, None, :]
            near[name] += int((ok[sl][:, None, :] & (d2 <= r2)).sum())
    every = {name: int(ok.sum()) * w * w for name, (_, ok, _) in
             items.items()}
    if six:
        every["boxes"] = boxes.shape[0] * boxes.shape[1] * w * w
    return {name: (near[name], every[name]) for name in items}


def bound_ms(pairs, n_pix: int, channels: int, tensors, out_bytes: int):
    """Least time the card could take for one render: the larger of the
    operations these inputs need (the pixel-item pairs within reach, at
    ``PAIR_OPS`` each, plus ``PIXEL_OPS`` and one op per channel value per
    pixel) over the float32 peak, and the bytes moved (each input tensor
    read once, ``out_bytes`` written once) over the memory rate. Returns
    (ms, "operations" or "bytes", ms of the operations of all pairs)."""
    per_pixel = n_pix * (PIXEL_OPS + channels)
    ops = per_pixel + sum(PAIR_OPS[k] * v[0] for k, v in pairs.items())
    ops_all = per_pixel + sum(PAIR_OPS[k] * v[1] for k, v in pairs.items())
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + out_bytes
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_all = ops_all / PEAK_F32_FLOPS * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", t_all
    return t_bytes, "bytes", t_all


def kernel_tensors(scene, ren, prologue, six: bool):
    """The tensors a kernel reads: the render state's, the prologue's
    (cos, sin and, for bev6, the light values) and the scene tables."""
    tensors = [ren.xy, ren.route_id, ren.head, *prologue,
               scene.cell_grid_lo, scene.cell_bnd, scene.cell_bnd_n,
               scene.cell_lane, scene.cell_lane_val, scene.cell_lane_w,
               scene.cell_lane_n, scene.route_xy]
    if six:
        tensors += [ren.stop_idx, ren.npc_pose, ren.walker_pose,
                    scene.cell_tl, scene.cell_tl_idx, scene.cell_tl_n,
                    scene.ss_center, scene.ss_extent]
    return tensors


def tile_states(scene, cfg: EnvConfig, ren: RenderState, envs, seed: int):
    """``ren`` with the envs ``envs`` and all their actors placed on tile
    corners for this width (``ops/bev6.py::place_in_view``); on a scene
    without stop signs (a reconstructed town) the envs of the stop-sign
    kind (j % 4 == 3) stay where they are."""
    envs = [j for j in envs if scene.ss_n or j % 4 != 3]
    return bev6_plain.place_in_view(
        scene, ren, envs, np.random.default_rng(seed),
        ren.npc_pose.shape[1], ren.walker_pose.shape[1], tiles=cfg)


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            what: str) -> float:
    """Raises unless the kernel output ``got`` equals the plain version's
    ``want`` at every value; prints and returns the max abs difference."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name} output shape {tuple(got.shape)}, "
                             f"plain {tuple(want.shape)}")
    diff = int((got != want).sum())
    err = float((got - want).abs().max())
    lit = [int((want[:, c] != 0).sum()) for c in range(want.shape[1])]
    print(f"  {name} {what}: {diff} of {got.numel()} values differ, max "
          f"abs err {err}, nonzero values per channel {lit}", flush=True)
    if diff != 0:
        raise AssertionError(f"{name} and its plain version differ at "
                             f"{diff} values ({what})")
    return err


def check_kernel(scene, cfg: EnvConfig, n: int, seed: int):
    """Kernel vs plain version on the same render states: ``n`` route
    poses, the first half placed on tile corners. Raises unless every value
    is equal; returns the max abs difference."""
    ren = tile_states(scene, cfg, route_poses(scene, n, seed),
                      range(n // 2), seed)
    out = bev_cuda.render_bev_cuda_batch(scene, cfg, ren)
    err = compare("bev_raster", out,
                  bev_plain.render_bev_batch(scene, cfg, ren),
                  f"W={cfg.bev_width} n={n} ({n // 2} on tile corners)")
    check_pack_round_trip("bev_raster", cfg, out)
    return err


def check_pack_round_trip(name: str, cfg: EnvConfig, out: torch.Tensor):
    """Raises unless the observation store's unpack(pack(out)) equals the
    kernel output ``out`` at every value."""
    back = unpack_bev_obs(cfg, pack_bev_obs(cfg, out))
    torch.cuda.synchronize()
    diff = int((back != out).sum())
    print(f"  {name} W={cfg.bev_width}: pack/unpack round trip {diff} of "
          f"{out.numel()} values differ", flush=True)
    if diff != 0:
        raise AssertionError(f"the packed store changes {diff} values of "
                             f"{name}'s output")


def to_device(x, dev):
    """A tensor, or a (nested) tuple of tensors and Nones, on ``dev``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(*(to_device(v, dev) for v in x))


def bev6_states(scene, cfg: EnvConfig, n: int, seed: int):
    """A RenderState of ``n`` envs after 10 steps of a bev6 rollout with
    traffic; the first 32 envs are then moved next to stop lines (at
    random sim steps, so every light phase shows) and to active stop
    signs, with their first 4 vehicles and 6 walkers in the view
    (``ops/bev6.py::place_in_view``), so that every channel of the kernel
    is drawn."""
    dev = scene.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    route_ids = torch.arange(n, device=dev) % scene.n_routes
    st, met, ren = reset_batch(scene, cfg, route_ids, gen)
    net = init_policy(ModelConfig(), (6, cfg.bev_width, cfg.bev_width),
                      seed=seed, device=dev)
    _, _, ren, _, _ = collect_rollout(scene, cfg, net, st, met, ren, gen, 10)
    return bev6_plain.place_in_view(scene, ren, range(32),
                                    np.random.default_rng(seed), 4, 6,
                                    view=(6.0, 20.0, 12.0))


def check_kernel6(scene, cfg: EnvConfig, ren: RenderState):
    """bev6 kernel vs plain version on the same render states; raises
    unless every value is equal and the signal, vehicle and walker
    channels are drawn, and returns the max abs difference."""
    b = bev6_plain.render_bev6_batch(scene, cfg, ren)
    out = bev6_cuda.render_bev6_cuda_batch(scene, cfg, ren)
    err = compare("bev6_raster", out, b,
                  f"W={cfg.bev_width} n={ren.yaw.shape[0]}")
    check_pack_round_trip("bev6_raster", cfg, out)
    if min(int((b[:, c] != 0).sum()) for c in range(3, 6)) == 0:
        raise AssertionError("a signal/vehicle/walker channel is empty: "
                             "the comparison would prove nothing")
    return err


def time_kernel(name: str, scene, cfg: EnvConfig, ren, inp, tables,
                prologue, kernel, render, plain):
    """Times the kernel alone (CUDA-graph device time, and eager), the
    render with its fetch and prologue (eager, as a rollout step pays it),
    the plain version and a bare write of an output of the same size, and
    states the bound; prints them with the items each tile keeps. The
    outputs of the kernel's first launch and of a launch after all the
    timed ones are held against the plain version's. Returns (max abs
    difference, (ms, plain ms, bound ms, bound_by))."""
    w = cfg.bev_width
    n = ren.xy.shape[0]
    six = tables is not None
    channels = 6 if six else 3
    dmax = scene.bnd_dmax
    first = kernel()
    k_ms = graph_ms(kernel)
    k_eager = cuda_ms(kernel, iters=50)
    r_ms = cuda_ms(render, iters=50)
    r_graph = graph_ms(render)
    p_ms = cuda_ms(plain, iters=3, warmup=1)
    out = torch.empty((n, channels, w, w), device=ren.xy.device)
    z_ms = graph_ms(out.zero_)
    want = plain()
    err = max(compare(name, first, want, f"{n} envs x {w} px, timed "
                      f"inputs, first launch"),
              compare(name, kernel(), want, f"{n} envs x {w} px, timed "
                      f"inputs, launch after the timed ones"))
    pairs = pair_counts(cfg, inp, tables, dmax)
    b_ms, b_by, all_ms = bound_ms(
        pairs, n * w * w, channels,
        kernel_tensors(scene, ren, prologue, six), n * channels * w * w * 4)
    keep = (bev_tiles.bev6_keep(cfg, inp, tables, dmax) if six
            else bev_tiles.bev_keep(cfg, inp, dmax))
    kept = bev_tiles.mean_kept(keep)
    base = inp.base if six else inp
    print(f"  {name} {n} envs x {w} px: kernel {k_ms:.4f} ms (graph), "
          f"{k_eager:.4f} ms (eager); render with fetch {r_ms:.4f} ms "
          f"(eager), {r_graph:.4f} ms (graph); plain {p_ms:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}), operations of all pairs {all_ms:.4f} "
          f"ms; writing the output alone (zero_) {z_ms:.4f} ms", flush=True)
    print(f"  {name} pixel-item pairs (within reach, all): "
          + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in pairs.items()),
          flush=True)
    live = base.counts.float().mean(0)
    print(f"  {name} mean items kept per tile: "
          + ", ".join(f"{k} {v:.3f}" for k, v in kept.items())
          + f"; mean live per env: road {float(live[0]):.3f}, lane "
          f"{float(live[1]):.3f}, route {base.route.shape[1]}", flush=True)
    return err, (k_ms, p_ms, b_ms, b_by)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over two same-shape tensors (0 if they are empty)."""
    if a.numel() == 0:
        return 0.0
    return float((a.cpu() - b.cpu()).abs().max())


def card_vs_cpu(scene, cfg: EnvConfig, obs_shape, seed: int):
    """A float32 rollout of 4 envs x 6 steps on the card and on the CPU
    with the same injected draws (made on the CPU); raises unless the
    route cursors and NPC patrol cursors are equal and positions and
    values agree within 1e-3. Returns (max |dxy|, max |dvalue|)."""
    n, n_steps = 4, 6
    f32_cfg = ModelConfig(dtype="float32")
    cpu = torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(seed)
    cpu_scene = scene.to(cpu)
    reset_draws = draw_reset(cpu_scene, cfg, n, gen)
    env_draws = [draw_step(cpu_scene, cfg, n, gen) for _ in range(n_steps)]
    noise = torch.randn((n_steps, n, 2), generator=gen)
    outs = []
    for d in (scene.device, cpu):
        sc = cpu_scene if d == cpu else scene
        net = init_policy(f32_cfg, obs_shape, seed=seed, device=d)
        st, met, ren = reset_batch(sc, cfg, torch.arange(n, device=d),
                                   draws=to_device(reset_draws, d))
        st, _, _, ro, _ = collect_rollout(
            sc, cfg, net, st, met, ren, None, n_steps,
            action_noise=noise.to(d),
            env_draws=[to_device(e, d) for e in env_draws])
        outs.append((st, ro))
    (gs, g), (cs, c) = outs
    if not torch.equal(g.render.head.cpu(), c.render.head):
        raise AssertionError("route cursors differ between card and CPU")
    if not torch.equal(gs.traffic.veh_head.cpu(), cs.traffic.veh_head):
        raise AssertionError("NPC patrol cursors differ between card and CPU")
    pos_err = max(max_abs_diff(g.render.xy, c.render.xy),
                  max_abs_diff(g.render.npc_pose[..., :2],
                               c.render.npc_pose[..., :2]),
                  max_abs_diff(g.render.walker_pose[..., :2],
                               c.render.walker_pose[..., :2]))
    val_err = max_abs_diff(g.values, c.values)
    print(f"  card vs CPU {cfg.obs_mode} rollout ({n} envs x {n_steps} "
          f"steps, {cfg.n_npc_vehicles} vehicles, {cfg.n_npc_walkers} "
          f"walkers, float32): max |dxy| {pos_err:.3e} m, max |dvalue| "
          f"{val_err:.3e}", flush=True)
    if pos_err > 1e-3 or val_err > 1e-3:
        raise AssertionError("card and CPU rollouts disagree")


def eval_steps_run(ev, max_steps: int) -> int:
    """The steps ``evaluate_policy`` ran: it stops once every env's first
    episode has ended, at the longest first episode."""
    if bool(ev["done"].all()):
        return int(ev["length"].max())
    return max_steps


def drive_path(scene, cfg: EnvConfig, net, gen, routes, lib):
    """The path's entry points with every launch count set to 0 just
    before: evaluation (``EVAL_ENVS`` envs x ``EVAL_STEPS`` steps on route
    ``EVAL_ROUTE``), then a rollout of ``ROLL_ENVS`` x ``ROLL_STEPS``.
    Raises on non-finite outputs, unless ``lib``'s kernel ran once per
    render, or if another kernel ran. Returns (launches, the rollout's
    start state)."""
    libs = (bev_cuda.LIB, bev6_cuda.LIB)
    for other in libs:
        other.launches = 0
    t = time.time()
    ev = evaluate_policy(scene, cfg, net, gen, route_id=EVAL_ROUTE,
                         n_envs=EVAL_ENVS, max_steps=EVAL_STEPS)
    torch.cuda.synchronize()
    if not torch.isfinite(ev["reward"]).all():
        raise AssertionError("non-finite evaluation reward")
    eval_steps = eval_steps_run(ev, EVAL_STEPS)
    print(f"  evaluate_policy {cfg.obs_mode} route {EVAL_ROUTE}, {EVAL_ENVS} "
          f"envs x {EVAL_STEPS} steps (stopped after {eval_steps}): "
          f"{int(ev['done'].sum())} episodes ended, mean score_route "
          f"{float(ev['score_route'].float().mean()):.3f}, collisions "
          f"{int(ev['collision'].sum())}", flush=True)
    progress(f"evaluate {cfg.obs_mode}", t)
    eval_launches = lib.launches

    t = time.time()
    n_envs, n_steps = ROLL_ENVS, ROLL_STEPS
    route_ids = routes[torch.arange(n_envs, device=routes.device)
                       % len(routes)]
    st, met, ren = reset_batch(scene, cfg, route_ids, gen)
    torch.cuda.synchronize()
    t_roll = time.time()
    st2, _, _, ro, stats = collect_rollout(scene, cfg, net, st, met, ren,
                                           gen, n_steps)
    torch.cuda.synchronize()
    dt_roll = time.time() - t_roll
    launches = lib.launches
    roll_launches = launches - eval_launches
    for name, v in (("values", ro.values), ("logp", ro.logp),
                    ("rewards", ro.env_rewards)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite rollout {name}")
    if ro.values.shape != (n_steps + 1, n_envs):
        raise AssertionError(f"rollout values shape {tuple(ro.values.shape)}")
    if eval_launches != eval_steps or roll_launches != n_steps + 1:
        raise AssertionError(
            f"kernel launches {eval_launches} + {roll_launches} != renders "
            f"issued {eval_steps} + {n_steps + 1}"
        )
    if any(o.launches for o in libs if o is not lib):
        raise AssertionError("a kernel of the other path was launched")
    print(f"  collect_rollout {cfg.obs_mode} {n_envs} envs x {n_steps} "
          f"steps: {n_envs * n_steps / dt_roll:.1f} env-steps/s (cold), "
          f"{int(stats['n_episodes'])} episodes ended, kernel launches "
          f"{roll_launches} (1 per step + bootstrap)", flush=True)
    progress(f"rollout {cfg.obs_mode}", t)
    return launches, (st, met, ren)


def breakdown(scene, cfg: EnvConfig, net, gen, start, render_fn):
    """CUDA-event ms of each part of one rollout step at the rollout's
    batch, then a warm rollout's env-steps/s."""
    t = time.time()
    st, met, ren = start
    obs = render_fn(scene, cfg, ren)

    def act():
        return policy_mod.act(net, obs, met, gen)

    action = act()[1]
    sim_time = (st.step + 1).to(torch.float32) * cfg.dt
    parts = {
        "render (fetch + kernel)": cuda_ms(
            lambda: render_fn(scene, cfg, ren)),
        "policy act": cuda_ms(act),
        "env step": cuda_ms(
            lambda: step_batch(scene, cfg, st, action, gen)),
    }
    if cfg.n_npc_vehicles or cfg.n_npc_walkers:
        parts["of which traffic step"] = cuda_ms(
            lambda: step_traffic(scene, cfg, st.traffic, st.ego, sim_time,
                                 None, gen))
    n_envs, n_steps = ren.yaw.shape[0], ROLL_STEPS
    print(f"  {cfg.obs_mode} rollout step at {n_envs} envs: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    t_roll = time.time()
    collect_rollout(scene, cfg, net, st, met, ren, gen, n_steps)
    torch.cuda.synchronize()
    print(f"  warm collect_rollout {cfg.obs_mode} {n_envs} envs x {n_steps} "
          f"steps: {n_envs * n_steps / (time.time() - t_roll):.1f} "
          f"env-steps/s", flush=True)
    progress(f"breakdown {cfg.obs_mode}", t)
    return parts


def profiled_kernels(fn):
    """Runs ``fn`` once under the profiler; returns the names and ms of
    the device kernels it launched, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    kernels = sorted((e["ts"], e["name"], e["dur"] * 1e-3) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    return [(name, ms) for _, name, ms in kernels]


def encoder_layout(net6, width: int, dev) -> None:
    """One forward and one backward (the weight gradients) of the bev6
    policy's conv encoder at ``LAYOUT_ENVS`` envs of ``width`` px, each
    profiled after a warm-up. The encoder runs channels-last
    (``models/processors.py``), so cuDNN needs none of its NCHW/NHWC
    transposes: raises unless 0 kernels are named after them. Prints that
    count and the conv kernels in launch order (the forward's first and
    the backward's last are conv1's)."""
    t = time.time()
    enc = net6.obs_enc
    params = list(enc.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    c = enc.convs[0].in_channels
    obs = torch.rand((LAYOUT_ENVS, c, width, width), generator=gen,
                     device=dev)
    box = {}

    def forward():
        box["loss"] = enc(obs).square().mean()

    def backward():
        torch.autograd.grad(box["loss"], params)

    forward()                   # warm-up: cuDNN's engine choice
    backward()
    kernels = {"forward": profiled_kernels(forward),
               "backward": profiled_kernels(backward)}
    n_transposes = 0
    for what, ks in kernels.items():
        convs = [(n, ms) for n, ms in ks
                 if any(word in n for word in CONV_KERNEL_WORDS)
                 and not any(word in n for word in CONV_HELPER_WORDS)]
        n_t = sum(any(k in n for k in TRANSPOSE_KERNELS) for n, _ in ks)
        n_transposes += n_t
        print(f"  encoder {what} at {LAYOUT_ENVS} envs ({c} channels): "
              f"{len(ks)} kernels, {sum(ms for _, ms in ks):.3f} ms, "
              f"layout transposes {n_t}; conv kernels in launch order: "
              + " | ".join(f"{n[:100]} {ms:.3f} ms" for n, ms in convs),
              flush=True)
        if not convs:
            raise AssertionError(f"no conv kernel in the encoder's {what}")
        conv1 = convs[0] if what == "forward" else convs[-1]
        print(f"  conv1 {what}: {conv1[0]}", flush=True)
    print(f"[chip_smoke] encoder layout transposes: {n_transposes}",
          flush=True)
    if n_transposes:
        raise AssertionError(f"{n_transposes} NCHW/NHWC transposes around "
                             "the channels-last encoder's convs")
    progress("encoder layout", t)


def demos_to(demos: DemoBatch, dev) -> DemoBatch:
    """The same demos on device ``dev``."""
    return DemoBatch(map_state(lambda a: a.to(dev), demos.render),
                     demos.metrics.to(dev), demos.actions.to(dev),
                     demos.valid.to(dev))


class PartTimer:
    """Inside ``with``, the functions the learner's update calls record
    CUDA events around every call (the device time from the call's first
    launch to its last, host launch gaps included), and the last result of
    each is kept."""

    PARTS = ((learner_mod, "collect_rollout", "rollout"),
             (wdgail_mod, "validation_wd", "validation_wd (2 calls)"),
             (wdgail_mod, "disc_update", "disc_update"),
             (wdgail_mod, "relabel_rewards", "relabel_rewards"),
             (learner_mod, "compute_returns", "compute_returns"),
             (ppo_mod, "ppo_update", "ppo_update"))

    def __init__(self):
        self.events, self.last, self._saved = {}, {}, []

    def _wrap(self, fn, label):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(label, []).append((start, end))
            self.last[label] = out
            return out
        return timed

    def __enter__(self):
        for mod, attr, label in self.PARTS:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, label))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved.clear()

    def ms(self):
        """{part: CUDA-event ms summed over its calls}, then cleared."""
        torch.cuda.synchronize()
        out = {k: sum(s.elapsed_time(e) for s, e in v)
               for k, v in self.events.items()}
        self.events.clear()
        return out


def check_finite(what: str, metrics: dict, nets) -> None:
    """Raises unless every metric and every weight of ``nets`` (name, net)
    is finite."""
    bad = [k for k, v in metrics.items()
           if not bool(torch.isfinite(v.to(torch.float32)))]
    bad += [f"{name}.{k}" for name, net in nets
            for k, v in net.state_dict().items()
            if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"{what}: non-finite {bad}")


class RunProbe:
    """Inside ``with``, the calls ``train.run`` makes to generate demos,
    build the expert buffers, evaluate and update are timed (host clock,
    synchronised), with B1's launches counted per call; each update also
    gets its ``PartTimer`` breakdown and the checks of ``check_update``.
    Every call's record is kept in ``calls``."""

    def __init__(self, tcfg, timer: "PartTimer"):
        self.tcfg, self.timer = tcfg, timer
        self.calls, self._saved = [], []

    def _wrap(self, owner, attr, kind):
        fn = getattr(owner, attr)

        def probed(*args, **kwargs):
            torch.cuda.synchronize()
            before, t = bev_cuda.LIB.launches, time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec = {"kind": kind, "s": time.time() - t, "out": out,
                   "b1": bev_cuda.LIB.launches - before, "args": args,
                   "kwargs": kwargs}
            if kind == "update":
                rec["parts"] = self.timer.ms()
            self.calls.append(rec)
            report_call(rec, self.tcfg)
            return out

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, probed)

    def __enter__(self):
        self._wrap(train_mod, "generate_demos", "demos")
        self._wrap(train_mod, "build_expert_buffer", "buffer")
        self._wrap(train_mod, "evaluate_policy", "eval")
        self._wrap(learner_mod.WDGAILLearner, "update", "update")
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def of(self, kind):
        return [c for c in self.calls if c["kind"] == kind]


def report_call(rec, tcfg):
    """Prints one probed call of ``train.run`` and raises on a failed
    check: a training or held-out route without a valid demo row, an
    update whose B1 launches are not one per render, B2 launched, or a
    non-finite metric or weight."""
    kind, out = rec["kind"], rec["out"]
    if kind == "demos":
        routes = [int(r) for r in rec["args"][3]]
        n_steps = rec["args"][4]
        rows = out.valid.sum(0).tolist()
        step = out.render.step.cpu().numpy()
        ends = [int(np.argmax(step[1:, e] == 0)) + 1
                if (step[1:, e] == 0).any() else -1
                for e in range(len(routes))]
        print(f"  generate_demos {len(routes)} envs x {n_steps} steps: "
              f"{rec['s']:.3f} s, {rec['s'] * 1e3 / n_steps:.3f} ms per "
              f"step; valid rows per route "
              + ", ".join(f"{r}: {v}" for r, v in zip(routes, rows))
              + "; first episode ends at steps "
              + ", ".join(f"{r}: {e}" for r, e in zip(routes, ends)),
              flush=True)
        empty = [r for r, v in zip(routes, rows) if v == 0]
        if empty:
            raise AssertionError(f"routes {empty} have no valid demo row: "
                                 f"raise DEMO_STEPS")
    elif kind == "buffer":
        print(f"  build_expert_buffer: {out.size} rows, {rec['s']:.3f} s, "
              f"B1 launches {rec['b1']}", flush=True)
    elif kind == "eval":
        steps = eval_steps_run(out, rec["kwargs"]["max_steps"])
        print(f"  evaluate_policy (held-out route {tcfg.eval_route}): "
              f"{rec['s']:.3f} s, stopped after {steps} steps (its episode "
              f"ended), B1 launches {rec['b1']}, score_route "
              f"{float(out['score_route'][0]):.3f}", flush=True)
        if rec["b1"] != steps:
            raise AssertionError(f"evaluation: B1 launches {rec['b1']} != "
                                 f"renders issued {steps}")
    else:
        state, metrics = out
        steps = tcfg.steps_per_env
        total = tcfg.n_envs * steps
        learner = rec["args"][0]
        n_epochs = wdgail_mod.warmup_epochs(tcfg, state.update_i)
        n_mb_disc = min(learner.expert.size, total) // tcfg.gail_batch_size
        n_mb_ppo = tcfg.ppo_epoch * (total // tcfg.mini_batch_size)
        parts = rec["parts"]
        check_finite(f"update {state.update_i}", metrics,
                     (("policy", state.policy), ("critic", state.disc)))
        if rec["b1"] != steps + 1:
            raise AssertionError(f"update {state.update_i}: B1 launches "
                                 f"{rec['b1']} != renders issued "
                                 f"{steps + 1}")
        if bev6_cuda.LIB.launches:
            raise AssertionError("B2 was launched on the bev training path")
        disc_mb = parts["disc_update"] / (n_epochs * n_mb_disc)
        print(f"  update {state.update_i} ({tcfg.n_envs} envs x {steps} "
              f"steps, {n_epochs} critic epochs x {n_mb_disc} minibatches, "
              f"{n_mb_ppo} PPO minibatches): wall {rec['s']:.3f} s; B1 "
              f"launches {rec['b1']}; " + ", ".join(
                  f"{k} {v:.1f} ms" for k, v in parts.items())
              + f"; disc_update {disc_mb:.3f} ms per minibatch, ppo_update "
              f"{parts['ppo_update'] / n_mb_ppo:.3f} ms per minibatch",
              flush=True)
        print("  update {} metrics: {}".format(state.update_i, ", ".join(
            f"{k} {float(v):.5g}" for k, v in sorted(metrics.items()))),
            flush=True)


def train_path(env_cfg: EnvConfig, model_cfg: ModelConfig, tcfg, preset,
               dev):
    """The training path at the reference preset through ``train.run``
    with ``use_sharding=True`` inside the world-1 NCCL group (the sharded
    learner, its collectives and the gathered checkpoint): the scripted
    expert's demos (``DEMO_STEPS`` steps on the training routes and on the
    held-out route), the expert and validation buffers, ``TRAIN_UPDATES``
    updates with the packed observation store, the evaluation on the
    held-out route, the metrics log and the checkpoints, in a temporary
    directory. Every launch count is set to 0 just before
    ``run`` and read just after. Raises unless B1 ran once per render of
    each update, B2 never, every loss, aux value and parameter is finite,
    a stored minibatch equals its re-render, the last ``update_*``
    checkpoint restores into a fresh template on the card bit for bit
    (generator state included) and ``metrics.jsonl`` holds one row per
    update with the reference's tag keys. Returns B1's launches."""
    timer = PartTimer()
    with tempfile.TemporaryDirectory() as tmp:
        log_dir, ckpt_dir = f"{tmp}/log", f"{tmp}/ckpt"
        for lib in (bev_cuda.LIB, bev6_cuda.LIB):
            lib.launches = 0
        with RunProbe(tcfg, timer) as probe, timer:
            state, _ = train_mod.run(
                env_cfg, model_cfg, tcfg, preset["scene"], DEMO_STEPS,
                max_updates=TRAIN_UPDATES, log_dir=log_dir,
                ckpt_dir=ckpt_dir, use_sharding=True, device=dev)
        torch.cuda.synchronize()
        launches = bev_cuda.LIB.launches
        if bev6_cuda.LIB.launches:
            raise AssertionError("B2 was launched on the bev training path")
        updates = probe.of("update")
        if len(updates) != TRAIN_UPDATES:
            raise AssertionError(f"{len(updates)} updates ran")
        if not isinstance(updates[-1]["args"][0], ShardedWDGAILLearner):
            raise AssertionError("train.run did not take the sharded "
                                 "learner")
        per = {k: sum(c["b1"] for c in probe.of(k))
               for k in ("buffer", "update", "eval")}
        expert, expert_val = (c["out"] for c in probe.of("buffer"))
        print(f"  B1 launches in train.run: {launches} = expert buffers "
              f"{per['buffer']} ({expert.size} + {expert_val.size} rows, "
              f"{EXPERT_CHUNK}-row chunks) + updates {per['update']} + "
              f"evaluation {per['eval']}", flush=True)
        if launches != sum(per.values()):
            raise AssertionError("B1 launched outside the probed calls")
        check_stored_minibatch(timer.last["rollout"][3], env_cfg, tcfg,
                               updates[-1]["args"][0].scene)
        check_checkpoint(updates[-1]["args"][0], state, ckpt_dir, log_dir)
    return launches


def check_stored_minibatch(ro, env_cfg: EnvConfig, tcfg, scene):
    """The packed store against a re-render of one minibatch through B1:
    raises unless 0 values differ."""
    dev = scene.device
    n, total = tcfg.n_envs, tcfg.n_envs * tcfg.steps_per_env
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    idx = torch.randperm(total, generator=g, device=dev)[
        :tcfg.mini_batch_size]
    stored = fetch_rollout_obs(scene, env_cfg, ro, idx // n, idx % n)
    remat = fetch_rollout_obs(scene, env_cfg,
                              dataclasses.replace(ro, obs=None),
                              idx // n, idx % n)
    torch.cuda.synchronize()
    diff = int((stored != remat).sum())
    print(f"  stored vs re-rendered minibatch ({tcfg.mini_batch_size} "
          f"samples): {diff} of {stored.numel()} values differ, packed "
          f"store {tuple(ro.obs.shape)} {ro.obs.dtype}", flush=True)
    if diff != 0:
        raise AssertionError("the packed store and a re-render differ")


def check_checkpoint(learner, state, ckpt_dir: str, log_dir: str):
    """The newest ``update_*`` checkpoint restored into a fresh
    ``LearnerState`` template on the card must equal the run's last state
    bit for bit (every tensor, the generator's state, the counters); the
    metrics log must hold one row per update with every key of the
    reference's tag schema."""
    t = time.time()
    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    template = learner.init_state()
    restored, elapsed = ckpt_mod.restore_checkpoint(latest, template)
    want = ckpt_mod.to_saved(state)
    got = ckpt_mod.to_saved(restored)
    n_tensors, bad = 0, []

    def walk(a, b, path):
        nonlocal n_tensors
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        elif isinstance(a, torch.Tensor):
            n_tensors += 1
            if a.dtype != b.dtype or not torch.equal(a, b):
                bad.append(path)
        elif a != b:
            bad.append(path)

    walk(want, got, "")
    rows = [json.loads(line) for line in open(f"{log_dir}/metrics.jsonl")]
    missing = [sorted(set(TAG_MAP) - set(r)) for r in rows]
    print(f"  checkpoint {latest.rsplit('/', 1)[-1]} restored on the card: "
          f"{n_tensors} tensors, {len(bad)} differ (generator state "
          f"included), elapsed {elapsed:.1f} s; metrics.jsonl {len(rows)} "
          f"rows (steps {[r['step'] for r in rows]}), tag keys missing "
          f"{missing}; {time.time() - t:.2f} s", flush=True)
    if bad:
        raise AssertionError(f"restored checkpoint differs at {bad[:5]}")
    if ([r["step"] for r in rows] != list(range(1, TRAIN_UPDATES + 1))
            or any(missing)):
        raise AssertionError("metrics.jsonl does not hold one row per "
                             "update with the tag schema's keys")


def demo_draws_to(d: DemoDraws, dev) -> DemoDraws:
    """The same demo draws on device ``dev``."""
    return DemoDraws(*(
        [to_device(e, dev) for e in v] if isinstance(v, list)
        else to_device(v, dev) for v in d))


def demos_card_vs_cpu(seed: int, dev):
    """``generate_demos`` with noise, ``obey_signals=True``, the bev6 path
    with 3 NPC vehicles and 3 walkers, 2 envs x ``CMP_DEMO_STEPS`` steps
    on the smoke scene, on the card and on the CPU with the same draws
    (made on the CPU): the only run of the expert's signal and hazard caps
    on the card. Raises unless actions, metrics and positions agree within
    ``DEMO_TOL`` and ``valid`` is equal."""
    smoke = make_presets()["smoke"]
    cfg = train_mod.demo_config(dataclasses.replace(
        smoke["env"], obs_mode="bev6", n_npc_vehicles=3, n_npc_walkers=3))
    n, n_steps = 2, CMP_DEMO_STEPS
    cpu = torch.device("cpu")
    cpu_scene = make_benchmark_scene(**smoke["scene"], device=cpu)
    gen = torch.Generator()
    gen.manual_seed(seed)
    draws = draw_demos(cpu_scene, cfg, n, n_steps, gen)
    outs = []
    for d in (dev, cpu):
        sc = cpu_scene if d == cpu else cpu_scene.to(d)
        torch.cuda.synchronize()
        t = time.time()
        demos = generate_demos(sc, cfg, None, [0, 1], n_steps,
                               obey_signals=True,
                               draws=demo_draws_to(draws, d))
        torch.cuda.synchronize()
        outs.append((demos, time.time() - t))
    (g, g_s), (c, c_s) = outs
    errs = {name: max_abs_diff(getattr(g, name), getattr(c, name))
            for name in ("actions", "metrics")}
    errs["xy"] = max_abs_diff(g.render.xy, c.render.xy)
    same_valid = torch.equal(g.valid.cpu(), c.valid)
    print(f"  card vs CPU generate_demos (bev6, 3 + 3 NPCs, noise, "
          f"obey_signals, {n} envs x {n_steps} steps): max |d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limit {DEMO_TOL}); valid equal {same_valid}; card "
          f"{g_s * 1e3 / n_steps:.3f} ms per step, CPU "
          f"{c_s * 1e3 / n_steps:.3f} ms per step", flush=True)
    if max(errs.values()) > DEMO_TOL or not same_valid:
        raise AssertionError("card and CPU demos disagree")


def check_losses(what: str, got: dict, want: dict) -> float:
    """Raises unless every value of ``got`` (card) is within the CPU
    tests' tolerance of ``want`` (CPU); returns the worst relative
    difference."""
    worst = 0.0
    for k, v in want.items():
        a, b = float(got[k]), float(v)
        if abs(a - b) > LOSS_ATOL + LOSS_RTOL * abs(b):
            raise AssertionError(f"card vs CPU {what}: {k} {a} vs {b}")
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst


def train_card_vs_cpu(seed: int):
    """One float32 update at the smoke preset (64 px, convs 8-16, 4 envs x
    ``SMOKE_STEPS_PER_ENV`` steps) on the card and on the CPU from the same
    weights, reset and draws (made on the CPU), with the same expert rows
    (the scripted expert's); raises unless the losses and aux agree within
    the CPU tests' tolerance and the new weights within ``PARAM_ATOL``.
    Returns the card's inputs and result, which the sharded phase's world-1
    learner repeats."""
    smoke = make_presets()["smoke"]
    env_cfg, model_cfg = smoke["env"], smoke["model"]
    tcfg = dataclasses.replace(
        smoke["train"], num_steps=SMOKE_STEPS_PER_ENV * smoke["train"].n_envs)
    n, steps = tcfg.n_envs, tcfg.steps_per_env
    total = n * steps
    w = env_cfg.bev_width
    obs_shape = (3, w, w)
    cpu = torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(seed)
    cpu_scene = make_benchmark_scene(**smoke["scene"], device=cpu)
    # the scripted expert's demos on route 0, made on the CPU; the expert
    # buffers take their first ``total`` valid rows
    demos = generate_demos(cpu_scene, train_mod.demo_config(env_cfg), gen,
                           [0], SMOKE_DEMO_STEPS, with_noise=False)
    e_size = total
    n_mb = min(e_size, total) // tcfg.gail_batch_size
    reset = draw_reset(cpu_scene, env_cfg, n, gen)
    gnss = draw_gnss(n, cpu, gen)
    n_epochs = wdgail_mod.warmup_epochs(tcfg, 1)
    draws = UpdateDraws(
        action_noise=torch.randn((steps, n, 2), generator=gen),
        env_draws=[draw_step(cpu_scene, env_cfg, n, gen)
                   for _ in range(steps)],
        disc=[wdgail_mod.draw_disc_epoch(n_mb, tcfg.gail_batch_size,
                                         e_size, total, cpu, gen)
              for _ in range(n_epochs)],
        ppo_perms=ppo_mod.draw_perms(
            tcfg.ppo_epoch, total,
            total // tcfg.mini_batch_size * tcfg.mini_batch_size, cpu, gen),
        val_pre=wdgail_mod.draw_validation(e_size, total, cpu, gen),
        val_post=wdgail_mod.draw_validation(e_size, total, cpu, gen),
    )
    pparams = init_flax_params(model_cfg, obs_shape, seed)
    dparams = init_critic_flax_params(model_cfg, obs_shape, seed + 1)
    outs = []
    for d in (torch.device("cuda"), cpu):
        sc = cpu_scene if d == cpu else cpu_scene.to(d)
        expert = build_expert_buffer(sc, env_cfg, demos_to(demos, d),
                                     size=e_size)
        learner = WDGAILLearner(sc, env_cfg, model_cfg, tcfg, expert,
                                policy_params=pparams, disc_params=dparams)
        state = learner.init_state(reset_draws=to_device(reset, d),
                                   reset_gnss=gnss.to(d))
        dd = update_draws_to(draws, d)
        state, metrics = learner.update(state, dd)
        outs.append((expert, state, metrics))
    (ge, gs, gm), (ce, cs, cm) = outs
    if not torch.equal(ge.obs.cpu(), ce.obs):
        raise AssertionError("the expert's packed obs differ between card "
                             "and CPU")
    worst_rel = check_losses("update", gm, cm)
    worst_param = 0.0
    for name, g, c in (("policy", gs.policy, cs.policy),
                       ("critic", gs.disc, cs.disc)):
        csd = c.state_dict()
        for k, v in g.state_dict().items():
            worst_param = max(worst_param, max_abs_diff(v, csd[k]))
    print(f"  card vs CPU update (smoke preset, {n} envs x {steps} steps, "
          f"{n_epochs} critic epochs, float32): {len(cm)} metrics, worst "
          f"relative difference {worst_rel:.3e}; max |dparam| "
          f"{worst_param:.3e} (limit {PARAM_ATOL}); disc/dis_gp "
          f"{float(gm['disc/dis_gp']):.5g} vs {float(cm['disc/dis_gp']):.5g}",
          flush=True)
    if worst_param > PARAM_ATOL:
        raise AssertionError("card and CPU updates disagree on the weights")
    return dict(scene=cpu_scene, cfgs=(env_cfg, model_cfg, tcfg), expert=ge,
                params=(pparams, dparams), reset=reset, gnss=gnss,
                draws=draws, state=gs, metrics=gm)


def update_draws_to(draws: UpdateDraws, dev) -> UpdateDraws:
    """The same update draws on device ``dev``."""
    return dataclasses.replace(
        draws, action_noise=draws.action_noise.to(dev),
        env_draws=[to_device(e, dev) for e in draws.env_draws],
        disc=[to_device(e, dev) for e in draws.disc],
        ppo_perms=draws.ppo_perms.to(dev), val_pre=draws.val_pre.to(dev),
        val_post=draws.val_post.to(dev))


# --- the tree bc phase ------------------------------------------------------

class GenTimer:
    """Inside ``with``, the exporter's calls of the env step, the full
    render, the three cameras and the PNG writer are timed on the host
    clock, synchronised at both ends of each call."""

    PARTS = (("step_batch", "env step"), ("render_bev_full", "full render"),
             ("_cameras", "three cameras"), ("write_png", "PNG writes"))

    def __init__(self):
        self.s, self._saved = {}, []

    def _wrap(self, fn, label):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[label] = self.s.get(label, 0.0) + time.time() - t
            return out
        return timed

    def __enter__(self):
        for attr, label in self.PARTS:
            fn = getattr(gen_mod, attr)
            self._saved.append((attr, fn))
            setattr(gen_mod, attr, self._wrap(fn, label))
        return self

    def __exit__(self, *exc):
        for attr, fn in self._saved:
            setattr(gen_mod, attr, fn)
        self._saved.clear()


class CappedEval:
    """Inside ``with``, the ``evaluate_policy`` that ``train.run`` and
    ``tools/evaluation.py`` call runs at most ``TREE_EVAL_STEPS`` steps
    (a depth cut: a BC policy may drive its episode to the 2,400-step
    cap); each call's result and the steps it ran are kept."""

    OWNERS = (train_mod, evaluation_mod)

    def __init__(self):
        self.calls, self._saved = [], []

    def _wrap(self, fn):
        def capped(*args, **kwargs):
            kwargs["max_steps"] = min(kwargs["max_steps"], TREE_EVAL_STEPS)
            out = fn(*args, **kwargs)
            self.calls.append((out, eval_steps_run(out,
                                                   kwargs["max_steps"])))
            return out
        return capped

    def __enter__(self):
        for owner in self.OWNERS:
            fn = owner.evaluate_policy
            self._saved.append((owner, fn))
            owner.evaluate_policy = self._wrap(fn)
        return self

    def __exit__(self, *exc):
        for owner, fn in self._saved:
            owner.evaluate_policy = fn
        self._saved.clear()


def export_tree(scene, tree: str, dev):
    """(a) ``gen_trajectories`` on the reference scene: ``TREE_ROUTES``
    routes x ``TREE_STEPS`` steps, cameras on, dynamic weather. Prints ms
    per step by part; raises unless every route wrote ``TREE_STEPS``
    steps."""
    t = time.time()
    with GenTimer() as gt:
        summary = gen_mod.gen_trajectories(
            out_dir=tree, n_routes=TREE_ROUTES, max_steps=TREE_STEPS,
            with_cameras=True, weather="dynamic", device=dev, scene=scene)
    wall = time.time() - t
    steps = [e["steps"] for e in summary]
    n = sum(steps)
    rest = wall - sum(gt.s.values())
    size = sum(f.stat().st_size for f in pathlib.Path(tree).rglob("*")
               if f.is_file())
    print(f"  gen_trajectories {TREE_ROUTES} routes x {TREE_STEPS} steps "
          f"(cameras, dynamic weather): {wall:.3f} s, "
          f"{wall * 1e3 / n:.3f} ms per step = " + ", ".join(
              f"{k} {v * 1e3 / n:.3f}" for k, v in gt.s.items())
          + f", expert + noise + the rest {rest * 1e3 / n:.3f}; steps per "
          f"route {steps}; tree {size / 2**20:.1f} MiB", flush=True)
    if steps != [TREE_STEPS] * TREE_ROUTES:
        raise AssertionError(f"an exported episode ended early: {steps}")


def bc_from_tree(tree: str, out: str, dev):
    """(c) ``learn_bc --experts-dir`` on the tree at ``ModelConfig()``
    for ``BC_EPOCHS`` epochs: ms per epoch (host clock, synchronised) and
    the losses. Raises on a non-finite loss."""
    rec = []
    epoch, evaluate = bc_mod.bc_epoch, bc_mod.bc_eval

    def timed(fn, kind):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.time()
            res = fn(*args, **kwargs)
            loss = res[1] if kind == "train" else res
            rec.append((kind, time.time() - t, float(loss)))
            return res
        return call

    bc_mod.bc_epoch = timed(epoch, "train")
    bc_mod.bc_eval = timed(evaluate, "eval")
    try:
        t = time.time()
        best_net, best_loss = learn_bc_mod.main(
            ["--experts-dir", tree, "--epochs", str(BC_EPOCHS), "--out",
             out, "--device", str(dev)])
        wall = time.time() - t
    finally:
        bc_mod.bc_epoch, bc_mod.bc_eval = epoch, evaluate
    train = [r for r in rec if r[0] == "train"]
    evals = [r for r in rec if r[0] == "eval"]
    print(f"  learn_bc --experts-dir ({len(train)} epochs, ModelConfig()): "
          f"{wall:.3f} s with the tree's load and the scene; "
          f"{np.mean([r[1] for r in train]) * 1e3:.1f} ms per epoch, eval "
          f"{np.mean([r[1] for r in evals]) * 1e3:.1f} ms; train losses "
          f"{[round(r[2], 4) for r in train]}, eval losses "
          f"{[round(r[2], 4) for r in evals]}, best {best_loss:.4f}",
          flush=True)
    if not all(np.isfinite(r[2]) for r in rec):
        raise AssertionError("non-finite BC loss")
    return best_net


def train_from_tree(env_cfg, model_cfg, preset, tree, init, tmp, dev,
                    best_net):
    """(d) ``train.run`` from the tree, warm-started from BC's best, one
    update of ``TREE_UPDATE_STEPS`` steps per env. Raises unless the
    policy the update starts from equals BC's best (0 tensors differ), B1
    ran once per render, and every metric and weight is finite."""
    tcfg = dataclasses.replace(
        preset["train"], num_steps=TREE_UPDATE_STEPS * preset["train"].n_envs)
    seen = []
    update = learner_mod.WDGAILLearner.update

    def probe(self, state, *args, **kwargs):
        seen.append({k: v.clone() for k, v in
                     state.policy.state_dict().items()})
        torch.cuda.synchronize()
        before, t = bev_cuda.LIB.launches, time.time()
        out = update(self, state, *args, **kwargs)
        torch.cuda.synchronize()
        seen.append((time.time() - t, bev_cuda.LIB.launches - before))
        return out

    learner_mod.WDGAILLearner.update = probe
    b1_before = bev_cuda.LIB.launches
    try:
        with CappedEval() as evals:
            t = time.time()
            state, metrics = train_mod.run(
                env_cfg, model_cfg, tcfg, preset["scene"], 0, max_updates=1,
                log_dir=f"{tmp}/train_log", demo_tree=tree,
                init_params=init, device=dev)
            wall = time.time() - t
    finally:
        learner_mod.WDGAILLearner.update = update
    ((_, eval_steps),) = evals.calls
    b1 = bev_cuda.LIB.launches - b1_before
    before, (upd_s, upd_b1) = seen
    best = best_net.state_dict()
    differ = [k for k, v in before.items() if not torch.equal(v, best[k])]
    check_finite("update from the tree", {
        k: torch.as_tensor(v) for k, v in metrics.items()},
        (("policy", state.policy), ("critic", state.disc)))
    print(f"  train.run --demo-tree --init-params ({tcfg.n_envs} envs x "
          f"{tcfg.steps_per_env} steps, 1 update): {wall:.3f} s, update "
          f"{upd_s:.3f} s, B1 launches in the update {upd_b1}; warm-started "
          f"policy vs BC's best: {len(differ)} of {len(best)} tensors "
          f"differ; held-out evaluation {eval_steps} steps (cap "
          f"{TREE_EVAL_STEPS}), eval/length {metrics['eval/length']:.0f}, "
          f"eval/reward {metrics['eval/reward']:.4f}, disc/dis_loss "
          f"{float(metrics['disc/dis_loss']):.5g}", flush=True)
    if differ:
        raise AssertionError(f"the warm start differs from BC's best at "
                             f"{differ[:3]}")
    if upd_b1 != tcfg.steps_per_env + 1 or b1 != upd_b1 + eval_steps:
        raise AssertionError(f"B1 launches {upd_b1} in the update, {b1} in "
                             f"the run != renders issued "
                             f"{tcfg.steps_per_env + 1} + {eval_steps}")


def evaluate_bc(init: str, scene, dev):
    """(e) ``tools/evaluation.evaluate`` of BC's best, one episode on
    route 3 (at most ``TREE_EVAL_STEPS`` steps): steps and seconds;
    raises unless B1 ran once per step."""
    before = bev_cuda.LIB.launches
    torch.cuda.synchronize()
    with CappedEval() as evals:
        t = time.time()
        (res,) = evaluation_mod.evaluate(init, route=EVAL_ROUTE, episodes=1,
                                         device=dev, scene=scene)
        torch.cuda.synchronize()
        wall = time.time() - t
    ((_, steps),) = evals.calls
    b1 = bev_cuda.LIB.launches - before
    print(f"  evaluation.evaluate (BC's best, route {EVAL_ROUTE}): {steps} "
          f"steps (cap {TREE_EVAL_STEPS}) in {wall:.3f} s "
          f"({wall * 1e3 / steps:.2f} ms per step), episode length "
          f"{res['length']} (0: not ended), reward {res['reward']:.4f}, "
          f"completed {res['completed']}, B1 launches {b1}", flush=True)
    if b1 != steps:
        raise AssertionError(f"evaluation: B1 launches {b1} != steps "
                             f"{steps}")


def full_render_vs_kernels(scene, env_cfg, env6_cfg, gen):
    """(b) ``render_bev_full`` at the rollout's ``ROLL_ENVS`` envs with a
    filled ring (bev6 traffic, ``RING_STEPS`` steps) against B1 (masks
    0-2 decoded as the tree loader's planes are) and B2 (masks 0-2, 14, 6
    and 10). Raises unless 0 values differ; returns the differing count
    and the full render's CUDA-graph-free ms."""
    cfg = dataclasses.replace(env6_cfg, full_bev=True)
    routes = torch.arange(ROLL_ENVS, device=scene.device) % scene.n_routes
    st, _, ren = reset_batch(scene, cfg, routes, gen)
    for _ in range(RING_STEPS):
        action = torch.stack([
            torch.rand(ROLL_ENVS, generator=gen, device=scene.device) - 0.5,
            torch.rand(ROLL_ENVS, generator=gen, device=scene.device)], 1)
        st, out = step_batch(scene, cfg, st, action, gen)
        ren = out.render
    hist = st.history

    def full():
        return render_bev_full(scene, cfg, ren.xy, ren.yaw, ren.route_id,
                               ren.head, hist)

    masks = full()[0].to(torch.float32) * INV_255
    b1 = bev_cuda.render_bev_cuda_batch(scene, env_cfg, ren)
    b2 = bev6_cuda.render_bev6_cuda_batch(scene, cfg, ren)
    d1 = int((b1 != masks[:, :3]).sum())
    d2 = int((b2 != masks[:, [0, 1, 2, 14, 6, 10]]).sum())
    drawn = [int((masks[:, c] > 0).flatten(1).any(1).sum())
             for c in (6, 10, 14, 5, 9, 13)]
    ms = cuda_ms(full, iters=3, warmup=1)
    print(f"  render_bev_full {ROLL_ENVS} envs x {cfg.bev_width} px, ring "
          f"filled by {RING_STEPS} steps (bev6, {cfg.n_npc_vehicles} + "
          f"{cfg.n_npc_walkers} NPCs): {ms:.3f} ms; vs B1 planes 0-2: {d1} "
          f"of {b1.numel()} values differ; vs B2 (0-2, 14, 6, 10): {d2} of "
          f"{b2.numel()}; envs drawing vehicles / walkers / lights now "
          f"{drawn[:3]}, 5 ticks back {drawn[3:]}", flush=True)
    if d1 or d2:
        raise AssertionError("the full render's planes differ from B1/B2")
    if not all(drawn[:3]):
        raise AssertionError("the full render drew no actor or light")
    return d1 + d2, ms


def tree_card_vs_cpu(tmp: str, dev):
    """(f) ``gen_trajectories`` on the smoke scene, ``CMP_ROUTES`` routes
    x ``CMP_STEPS`` steps with cameras and dynamic weather, on the card
    and on the CPU with the same draws (made on the CPU). Raises unless
    the masks and rendered BEV are equal, cameras within one level and
    ``episode.json`` within ``DEMO_TOL``."""
    smoke = make_presets()["smoke"]
    cpu = torch.device("cpu")
    cpu_scene = make_benchmark_scene(**smoke["scene"], device=cpu)
    cfg = EnvConfig(train=False, full_bev=True)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    draws = [draw_demos(cpu_scene, cfg, 1, CMP_STEPS, gen)
             for _ in range(CMP_ROUTES)]
    secs = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        sc = cpu_scene if d == cpu else cpu_scene.to(d)
        t = time.time()
        gen_mod.gen_trajectories(
            out_dir=f"{tmp}/{name}", traj_name="t", n_routes=CMP_ROUTES,
            max_steps=CMP_STEPS, with_cameras=True, weather="dynamic",
            device=d, scene=sc,
            draws=[demo_draws_to(x, d) for x in draws])
        torch.cuda.synchronize()
        secs[name] = time.time() - t
    bev_diff = cam_diff = cam_max = 0
    json_err = 0.0
    card, cpu_root = (pathlib.Path(tmp) / n / "t" for n in ("card", "cpu"))
    for f in sorted(card.rglob("*.png")):
        a = read_png(f).astype(np.int32)
        b = read_png(cpu_root / f.relative_to(card)).astype(np.int32)
        if f.parent.name in ("birdview", "birdview_masks"):
            bev_diff += int((a != b).sum())
        else:
            cam_diff += int((a != b).sum())
            cam_max = max(cam_max, int(np.abs(a - b).max()))
    for f in sorted(card.rglob("episode.json")):
        a, b = (json.loads(p.read_text()) for p in
                (f, cpu_root / f.relative_to(card)))
        if a.keys() != b.keys() or any(a[k].keys() != b[k].keys()
                                       for k in a):
            raise AssertionError(f"{f}: card and CPU steps differ")
        for k in a:
            json_err = max(json_err, float(np.abs(
                np.array(list(a[k].values()))
                - np.array(list(b[k].values()))).max()))
    print(f"  card vs CPU gen_trajectories (smoke scene, {CMP_ROUTES} "
          f"routes x {CMP_STEPS} steps, cameras, dynamic weather): masks "
          f"and birdview {bev_diff} values differ, cameras {cam_diff} "
          f"(max {cam_max} levels), episode.json max |d| {json_err:.3e} "
          f"(limit {DEMO_TOL}); card {secs['card']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s", flush=True)
    if bev_diff or cam_max > 1 or json_err > DEMO_TOL:
        raise AssertionError("card and CPU trees disagree")


def tree_bc_path(scene, env_cfg, env6_cfg, model_cfg, preset, gen, dev):
    """The demo-file and BC recipe at the reference preset: (a) export a
    tree, (c) BC from it, (d) WDGAIL from it warm-started from BC, (e) the
    evaluation CLI's function, each timed; every launch count is set to
    0 just before (a) and read after (e). Then the comparisons: (b) the
    full render against B1/B2 and (f) a card-vs-CPU tree. Returns B1's
    launches on the path."""
    with tempfile.TemporaryDirectory() as tmp:
        tree, bc_out = f"{tmp}/gail_experts", f"{tmp}/bc"
        for lib in (bev_cuda.LIB, bev6_cuda.LIB):
            lib.launches = 0
        t = time.time()
        export_tree(scene, tree, dev)
        progress("tree bc (a) export", t)
        t = time.time()
        best_net = bc_from_tree(tree, bc_out, dev)
        progress("tree bc (c) learn_bc", t)
        t = time.time()
        train_from_tree(env_cfg, model_cfg, preset, tree, f"{bc_out}/best",
                        tmp, dev, best_net)
        progress("tree bc (d) train --demo-tree", t)
        t = time.time()
        evaluate_bc(f"{bc_out}/best", scene, dev)
        progress("tree bc (e) evaluation", t)
        torch.cuda.synchronize()
        launches = bev_cuda.LIB.launches
        if bev6_cuda.LIB.launches:
            raise AssertionError("B2 was launched on the tree bc path")
        print(f"  B1 launches on the tree bc path: {launches}", flush=True)
        if not launches:
            raise AssertionError("B1 was not launched on the tree bc path")
        t = time.time()
        full_render_vs_kernels(scene, env_cfg, env6_cfg, gen)
        progress("tree bc (b) full render vs kernels", t)
        t = time.time()
        tree_card_vs_cpu(tmp, dev)
        progress("tree bc (f) card vs CPU", t)
    return launches


def synced_s(t0: float) -> float:
    """Host-clock seconds since ``t0``, after the card has finished."""
    torch.cuda.synchronize()
    return time.time() - t0


def registry_envs(dev, w: int):
    """(a) ``registry.make`` on the card for one id of each family, then
    ``reset`` and ``REGISTRY_STEPS`` steps of each ``DrivingEnv`` (one
    world, its BEV through B1 at every step). Returns the envs by id."""
    envs = {}
    for env_id in REGISTRY_IDS:
        over = ENDLESS_ROWS if env_id == "Endless-v0" else {}
        t = time.time()
        env = registry.make(env_id, device=dev, **over)
        build = synced_s(t)
        env.reset()
        t = time.time()
        for _ in range(REGISTRY_STEPS):
            obs, met, rew, _, info = env.step([0.0, 0.5])
            if not (np.isfinite(met).all() and np.isfinite(rew)):
                raise AssertionError(f"{env_id}: non-finite step output")
        ms = synced_s(t) / REGISTRY_STEPS * 1e3
        if obs.shape != (3, w, w) or not env.observation_space.contains(obs):
            raise AssertionError(f"{env_id}: observation {obs.shape} out "
                                 f"of its space")
        cfg = env.cfg
        print(f"  make({env_id!r}) on the card: build {build:.3f} s "
              f"({env.scene.n_routes} routes, {len(env.tasks)} tasks, "
              f"{cfg.n_npc_vehicles} vehicles + {cfg.n_npc_walkers} "
              f"walkers); reset + {REGISTRY_STEPS} steps at {ms:.3f} ms "
              f"per step (task route {env.task['route_id']}, "
              f"{env.task['weather']}, sun {info['sun_altitude_angle']:.1f}"
              f", lights {info['vehicle_lights_on']})", flush=True)
        envs[env_id] = env
    return envs


def vec_env_run(dev):
    """(b) ``VecEnv`` at ``VEC_ENVS`` envs on the NoCrash regular scene
    for ``VEC_STEPS`` steps through an ``EnvMonitor``; env-steps/s with
    the host copies, and one step's host copy alone."""
    env = registry.make("NoCrash-v1", device=dev)
    venv = VecEnv(env.scene, env.cfg, VEC_ENVS, seed=SEED)
    actions = np.tile(np.float32([0.0, 0.6]), (VEC_ENVS, 1))
    with tempfile.TemporaryDirectory() as tmp:
        mon = EnvMonitor(tmp, VEC_ENVS)
        venv.reset()
        t = time.time()
        for _ in range(VEC_STEPS):
            obs, met, rew, dones, infos = venv.step(actions)
            mon.record_step(dones, infos)
        dt = synced_s(t)
        mon.close()
        rows = sum(len(p.read_text().splitlines()) - 1
                   for p in pathlib.Path(tmp, "env_info").glob("*.csv"))
    if not (np.isfinite(obs).all() and np.isfinite(met).all()
            and np.isfinite(rew).all()):
        raise AssertionError("non-finite vector env output")
    if obs.shape != (VEC_ENVS, 3, env.cfg.bev_width, env.cfg.bev_width):
        raise AssertionError(f"vector env observation {obs.shape}")
    o = torch.rand(obs.shape, device=dev)
    m = torch.rand((VEC_ENVS, 4), device=dev)
    copy_ms = cuda_ms(lambda: host_outputs(o, m), iters=10)
    print(f"  VecEnv {VEC_ENVS} envs x {VEC_STEPS} steps (NoCrash regular, "
          f"20 + 50 NPCs per env): {VEC_ENVS * VEC_STEPS / dt:.1f} "
          f"env-steps/s with the host copies, {dt / VEC_STEPS * 1e3:.3f} "
          f"ms per step; one step's copy of {obs.nbytes / 1e6:.2f} MB of "
          f"observation and the metrics alone {copy_ms:.3f} ms; "
          f"{rows} episode rows logged", flush=True)


def tier(name: str, scene, cfg, net, expert: bool):
    """``run_tier`` for one episode of ``SUITE_STEPS`` steps with the
    policy ``net`` on the bev6 BEV (every step's render through B2) or
    the expert; raises unless B2 ran once per step (none for the
    expert). Returns the result."""
    cfg = dataclasses.replace(
        nocrash_bench.tier_config(cfg, "bev6", expert),
        max_time=SUITE_STEPS * 0.1)
    before = bev6_cuda.LIB.launches
    t = time.time()
    res = nocrash_bench.run_tier(scene, cfg, net, 2021, 1, SUITE_STEPS,
                                 expert=expert)
    dt = synced_s(t)
    launches = bev6_cuda.LIB.launches - before
    steps = sum(res["steps_run"])
    if launches != (0 if expert else steps):
        raise AssertionError(f"{name}: {launches} B2 launches for {steps} "
                             f"steps")
    if not np.isfinite(res["mean_driving_score"]):
        raise AssertionError(f"{name}: non-finite driving score")
    print(f"  run_tier {name} ({'expert' if expert else 'bev6 policy'}, "
          f"{scene.n_routes} routes, {cfg.n_npc_vehicles} + "
          f"{cfg.n_npc_walkers} NPCs): success {res['success_rate']}%, "
          f"driving score {res['mean_driving_score']}, {steps} steps at "
          f"{dt / steps * 1e3:.3f} ms per step, B2 launches {launches}",
          flush=True)
    return res


def leaderboard_benchmark(scene, dev):
    """(e) ``benchmark_policy.benchmark`` on the reference scene with the
    bev policy (B1 once per step) and with the expert."""
    for expert in (False, True):
        before = bev_cuda.LIB.launches
        out = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(out):
            rows = benchmark_policy.benchmark(
                max_steps=SUITE_STEPS, expert=expert, device=dev,
                scene=scene)
        dt = synced_s(t)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        launches = bev_cuda.LIB.launches - before
        steps = max(r["steps"] for r in rows)
        if launches != (0 if expert else steps):
            raise AssertionError(f"benchmark: {launches} B1 launches for "
                                 f"{steps} steps")
        if len(rows) != scene.n_routes or not np.isfinite(
                line["mean_driving_score"]):
            raise AssertionError("benchmark rows")
        print(f"  benchmark_policy ({'expert' if expert else 'bev policy'}"
              f", {len(rows)} routes x {steps} steps): mean driving score "
              f"{line['mean_driving_score']}, completed "
              f"{sum(r['completed_rate'] for r in rows):.0f}, collisions "
              f"{sum(r['collision_rate'] for r in rows):.0f}, "
              f"{dt / steps * 1e3:.3f} ms per step, B1 launches {launches}",
              flush=True)


def endless_run(dev):
    """(g) The expert on the short-row endless suite at
    ``obs_mode="state"`` for at most ``ENDLESS_STEPS`` steps of
    ``ENDLESS_ENVS`` envs on row 0: it stops once an env has switched rows
    and passed row 0's length, and raises if none has. Returns the scene
    and the last render state."""
    env = registry.make("Endless-v0", device=dev, **ENDLESS_ROWS)
    scene = env.scene
    cfg = dataclasses.replace(env.cfg, train=False, obs_mode="state")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = ENDLESS_ENVS
    st, _, _ = reset_batch(scene, cfg, torch.zeros(n, dtype=torch.int32,
                                                   device=dev), gen)
    ap = make_autopilot((n,), dev)
    row0 = float(scene.route_len_m[0])
    best = torch.zeros(n, device=dev)
    switched = torch.zeros(n, dtype=torch.bool, device=dev)
    t = time.time()
    for i in range(ENDLESS_STEPS):
        ap, act = autopilot_act(scene, ap, st, obey_signals=True)
        rid0 = st.route_id
        st, out = step_batch(scene, cfg, st, act, gen)
        ap = reset_autopilot_where(out.done, ap)
        switched |= (st.route_id != rid0) & ~out.done
        best = torch.maximum(best, out.info["route_completed_in_m"])
        if bool((switched & (best > row0)).any()):
            break
    dt = synced_s(t)
    ok = switched & (best > row0)
    print(f"  endless expert ({n} envs, rows of {ENDLESS_ROWS['row_m']} m, "
          f"{cfg.n_npc_vehicles} + {cfg.n_npc_walkers} NPCs): {i + 1} "
          f"steps at {dt / (i + 1) * 1e3:.3f} ms per step, "
          f"{int(switched.sum())} envs switched rows, best completed "
          f"{float(best.max()):.1f} m of row 0's {row0:.1f} m, "
          f"{int(ok.sum())} past it", flush=True)
    if not bool(ok.any()):
        raise AssertionError("no endless env switched rows and passed the "
                             "first row's length")
    return scene, out.render, switched


def suites_card_vs_cpu(dev):
    """(h) ``run_latched`` with the expert (``run_tier``'s loop) on
    ``nocrash_suite(n_routes=2)`` at the regular tier for
    ``CMP_TIER_STEPS`` steps, and ``DrivingEnv`` for ``CMP_ENV_STEPS``
    steps, on the card and on the CPU with the same draws (made on the
    CPU): latched booleans equal, scores within ``DEMO_TOL``;
    observations 0 values differ, metrics and reward within
    ``DEMO_TOL``."""
    cpu = torch.device("cpu")
    scene_c, cfg, _ = nocrash_suite(n_routes=2, device="cpu")
    scene_g = scene_c.to(dev)
    n = scene_c.n_routes
    cfg_e = dataclasses.replace(nocrash_bench.tier_config(cfg, "bev6", True),
                                max_time=CMP_TIER_STEPS * 0.1)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    reset_d = draw_reset(scene_c, cfg_e, n, gen)
    gnss = draw_gnss(n, cpu, gen)
    steps_d = [draw_step(scene_c, cfg_e, n, gen)
               for _ in range(CMP_TIER_STEPS)]
    outs = []
    for sc in (scene_g, scene_c):
        d = sc.device
        latched, steps = run_latched(
            sc, cfg_e, torch.arange(n, dtype=torch.int32, device=d),
            nocrash_bench.LATCH_KEYS, CMP_TIER_STEPS, None, expert=True,
            reset_draws=to_device(reset_d, d), reset_gnss=gnss.to(d),
            env_draws=[to_device(e, d) for e in steps_d])
        outs.append(({k: v.cpu() for k, v in latched.items()}, steps))
    (g, g_steps), (c, c_steps) = outs
    flags_equal = all(torch.equal(g[k], c[k]) for k in
                      ("done", "route_completed", "collision"))
    score_err = max_abs_diff(g["score_composed"], c["score_composed"])
    print(f"  card vs CPU run_tier expert (NoCrash regular, {n} routes, "
          f"{CMP_TIER_STEPS} steps): steps {g_steps} / {c_steps}, latched "
          f"flags equal {flags_equal}, max |d score| {score_err:.3e}, "
          f"scores {g['score_composed'].tolist()}", flush=True)
    if not flags_equal or g_steps != c_steps or score_err > DEMO_TOL:
        raise AssertionError("card and CPU tiers disagree")

    cfg_d = dataclasses.replace(cfg, train=False)
    gen.manual_seed(SEED + 1)
    reset_d = draw_reset(scene_c, cfg_d, 1, gen)
    gnss = draw_gnss(1, cpu, gen)
    steps_d = [draw_step(scene_c, cfg_d, 1, gen)
               for _ in range(CMP_ENV_STEPS)]
    rng = np.random.default_rng(SEED)
    actions = np.stack([rng.uniform(-0.2, 0.2, CMP_ENV_STEPS),
                        rng.uniform(0.4, 1.0, CMP_ENV_STEPS)], 1)
    runs = []
    for sc in (scene_g, scene_c):
        d = sc.device
        env = DrivingEnv(sc, cfg_d, route_id=1, shuffle_tasks=False)
        obs, met = env.reset(to_device(reset_d, d), gnss.to(d))
        seq = [(obs, met, 0.0)]
        for t in range(CMP_ENV_STEPS):
            obs, met, rew, _, _ = env.step(actions[t],
                                           to_device(steps_d[t], d))
            seq.append((obs, met, rew))
        runs.append(seq)
    px = sum(int((a[0] != b[0]).sum()) for a, b in zip(*runs))
    err = max(max(float(np.abs(a[1] - b[1]).max()), abs(a[2] - b[2]))
              for a, b in zip(*runs))
    print(f"  card vs CPU DrivingEnv (NoCrash regular, route 1, "
          f"{CMP_ENV_STEPS} steps, {cfg_d.bev_width} px): {px} observation "
          f"values differ, max |d metrics|, |d reward| {err:.3e}",
          flush=True)
    if px or err > DEMO_TOL:
        raise AssertionError("card and CPU DrivingEnvs disagree")


def dense_b2(scene, env6_cfg):
    """(f) B2 at the NoCrash dense tier's 100 vehicles and 250 walkers
    per env (351 boxes) on the rollout's 256 envs: against its plain
    version at 0 values, timed beside the 20/50 time, with its shared
    memory. Returns (max abs difference, the times)."""
    cfg = dataclasses.replace(env6_cfg, n_npc_vehicles=100,
                              n_npc_walkers=250)
    for v, wk in ((env6_cfg.n_npc_vehicles, env6_cfg.n_npc_walkers),
                  (100, 250)):
        print(f"  bev6_raster shared memory per block at {v} vehicles + "
              f"{wk} walkers: {bev6_cuda.shared_bytes(scene, v, wk)} bytes "
              f"(48 KB without a raised limit)", flush=True)
    ren = bev6_states(scene, cfg, ROLL_ENVS, SEED + 6)
    err = check_kernel6(scene, cfg, ren)
    inp = bev6_plain.bev6_inputs(scene, cfg, ren)
    pro = bev6_cuda.bev6_prologue(scene, cfg, ren)
    err_t, times = time_kernel(
        "bev6_raster dense", scene, cfg, ren, inp,
        bev_tiles.kernel_tables(scene, ren, inp), pro,
        lambda: bev6_cuda.render_bev6_cuda(scene, cfg, ren, *pro),
        lambda: bev6_cuda.render_bev6_cuda_batch(scene, cfg, ren),
        lambda: bev6_plain.render_bev6_plain(cfg, inp, scene.bnd_dmax))
    return max(err, err_t), times


def suites_path(scene, env_cfg, env6_cfg, dev):
    """The gym-style API and the policy benchmarks at the reference
    widths: (a) the registry, (b) the vector env, (c) the four NoCrash
    tiers and (d) the four CoRL task types through ``run_tier`` (the bev6
    policy at ``ModelConfig()``, then the expert), (e) the leaderboard
    benchmark, (g) the endless expert; every launch count is set to 0
    just before (a) and read after (g). Then the comparisons: the switched
    endless envs' render against B1's plain version, (f) B2 at the dense
    tier, (h) card vs CPU. Returns (B1 launches, B2 launches, B2's max
    abs difference at dense, its dense times)."""
    w = env_cfg.bev_width
    for lib in (bev_cuda.LIB, bev6_cuda.LIB):
        lib.launches = 0
    t = time.time()
    made = registry_envs(dev, w)
    progress("suites (a) registry", t)
    t = time.time()
    vec_env_run(dev)
    progress("suites (b) vector env", t)
    net6 = init_policy(ModelConfig(), (6, w, w), seed=SEED, device=dev)
    t = time.time()
    # the suites (a) made are not built again
    for name, env_id in NOCRASH_IDS.items():
        env = made.get(env_id) or registry.make(env_id, device=dev)
        density = (env.cfg.n_npc_vehicles, env.cfg.n_npc_walkers)
        if density != NOCRASH_TRAFFIC["Town01"][name]:
            raise AssertionError(f"{env_id}: not the {name} densities")
        tier(f"NoCrash {name}", env.scene, env.cfg, net6, False)
        if name == "regular":
            regular = env
    tier("NoCrash regular", regular.scene, regular.cfg, None, True)
    progress("suites (c) NoCrash", t)
    t = time.time()
    for name, env_id in CORL_IDS.items():
        env = made.get(env_id) or registry.make(env_id, device=dev)
        tier(f"CoRL {name}", env.scene, env.cfg, net6, False)
    tier("CoRL navigation_dynamic", env.scene, env.cfg, None, True)
    progress("suites (d) CoRL2017", t)
    t = time.time()
    leaderboard_benchmark(scene, dev)
    progress("suites (e) leaderboard benchmark", t)
    t = time.time()
    end_scene, end_ren, switched = endless_run(dev)
    progress("suites (g) endless", t)
    torch.cuda.synchronize()
    b1, b2 = bev_cuda.LIB.launches, bev6_cuda.LIB.launches
    print(f"  launches on the suites path: B1 {b1}, B2 {b2}", flush=True)
    if not b1 or not b2:
        raise AssertionError("a kernel was not launched on the suites path")

    t = time.time()
    if not bool((end_ren.route_id[switched] != 0).all()):
        raise AssertionError("a switched endless env renders row 0")
    compare("bev_raster", bev_cuda.render_bev_cuda_batch(end_scene, env_cfg,
                                                          end_ren),
            bev_plain.render_bev_batch(end_scene, env_cfg, end_ren),
            f"endless rows padded to {end_scene.route_xy.shape[1]} points, "
            f"{int(switched.sum())} envs on their next row")
    err, times = dense_b2(scene, env6_cfg)
    progress("suites (f) B2 at the dense tier", t)
    t = time.time()
    suites_card_vs_cpu(dev)
    progress("suites (h) card vs CPU", t)
    return b1, b2, err, times


# --- the options phase ------------------------------------------------------
def state_updates(scene, model_cfg: ModelConfig, tcfg, dev):
    """(a) One ``algo="ppo"`` update at ``obs_mode="state"`` with
    ``ModelConfig()`` at the preset's ``n_envs`` x ``STATE_STEPS`` steps
    and at ``STATE_BIG_ENVS`` x ``STATE_BIG_STEPS`` (16 PPO epochs of
    128-sample minibatches): wall s, its rollout / PPO split (CUDA
    events), the float32 store's bytes. Raises on a non-finite metric or
    weight or a store of the wrong shape. Returns the last policy."""
    env = EnvConfig(train=True, obs_mode="state")
    for n, steps in ((tcfg.n_envs, STATE_STEPS),
                     (STATE_BIG_ENVS, STATE_BIG_STEPS)):
        t_cfg = dataclasses.replace(tcfg, algo="ppo", bcgail=False,
                                    n_envs=n, num_steps=steps * n)
        learner = WDGAILLearner(scene, env, model_cfg, t_cfg, None)
        state = learner.init_state()
        timer = PartTimer()
        t0 = time.time()
        with timer:
            state, metrics = learner.update(state)
        wall = synced_s(t0)
        parts = timer.ms()
        check_finite(f"state update at {n} envs", metrics,
                     (("policy", state.policy),))
        obs = timer.last["rollout"][3].obs
        if (obs.dtype != torch.float32
                or tuple(obs.shape) != (steps + 1, n, STATE_OBS_DIM)):
            raise AssertionError(f"state store {tuple(obs.shape)} "
                                 f"{obs.dtype}")
        n_mb = t_cfg.ppo_epoch * (n * steps // t_cfg.mini_batch_size)
        print(f"  state ppo update ({n} envs x {steps} steps, {n_mb} "
              f"PPO minibatches): wall {wall:.3f} s; rollout "
              f"{parts['rollout']:.1f} ms ({parts['rollout'] / steps:.3f}"
              f" ms per step), ppo_update {parts['ppo_update']:.1f} ms "
              f"({parts['ppo_update'] / n_mb:.3f} ms per minibatch); stored "
              f"obs {tuple(obs.shape)} float32, {obs.numel() * 4} bytes; "
              f"env_reward_mean {float(metrics['env_reward_mean']):.5g}",
              flush=True)
    return state.policy


def state_demos_and_eval(scene, net, tcfg, dev):
    """(a) ``generate_demos`` (``STATE_DEMO_STEPS`` steps on the training
    routes) and ``build_expert_buffer`` at ``"state"`` (the float32 rows),
    then ``evaluate_policy`` of the state policy on the held-out route.
    The cut demos end no episode, so every row stands in as valid. Raises
    unless the buffer's rows equal their re-derived observations and the
    evaluation is finite."""
    env = EnvConfig(train=True, obs_mode="state")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    routes = list(tcfg.routes)
    t0 = time.time()
    demos = generate_demos(scene, train_mod.demo_config(env), gen, routes,
                           STATE_DEMO_STEPS)
    s_demo = synced_s(t0)
    demos = dataclasses.replace(demos, valid=torch.ones_like(demos.valid))
    t0 = time.time()
    buf = build_expert_buffer(scene, env, demos)
    s_buf = synced_s(t0)
    idx = torch.arange(0, buf.size, 7, device=dev)
    again = fetch_expert_obs(scene, env, dataclasses.replace(buf, obs=None),
                             idx)
    if (buf.obs.dtype != torch.float32
            or not torch.equal(buf.obs[idx], again)):
        raise AssertionError("the state expert buffer's rows differ from "
                             "their observations")
    t0 = time.time()
    ev = evaluate_policy(scene, env, net, gen, route_id=EVAL_ROUTE,
                         n_envs=EVAL_ENVS, max_steps=STATE_EVAL_STEPS)
    s_eval = synced_s(t0)
    if not torch.isfinite(ev["reward"]).all():
        raise AssertionError("non-finite state evaluation reward")
    steps = eval_steps_run(ev, STATE_EVAL_STEPS)
    print(f"  state generate_demos {len(routes)} envs x {STATE_DEMO_STEPS} "
          f"steps: {s_demo * 1e3 / STATE_DEMO_STEPS:.3f} ms per step; "
          f"build_expert_buffer {buf.size} rows x {STATE_OBS_DIM} float32 "
          f"in {s_buf:.3f} s; evaluate_policy {EVAL_ENVS} envs x {steps} "
          f"steps: {s_eval * 1e3 / steps:.3f} ms per step, score_route "
          f"{float(ev['score_route'].float().mean()):.3f}", flush=True)


def state_card_vs_cpu(scene, seed: int):
    """(b) ``state_observation_batch`` on ``ROLL_ENVS`` route poses of the
    reference scene, a float32 state rollout at the smoke preset (4 envs
    x ``SMOKE_STEPS_PER_ENV`` steps) and one ``ppo_update`` from the CPU's
    rollout, on the card and on the CPU with the same inputs and draws
    (made on the CPU). Raises unless the observations agree within
    ``STATE_OBS_ATOL``, the rollouts' observations, values and log-probs
    within 1e-6, the update's losses within the CPU tests' tolerance and
    its weights within ``PARAM_ATOL``. The update starts from one rollout
    on both devices: the toy env's advantages are ~1e-3, so their
    normalisation turns the two rollouts' ulp-level differences of values
    and returns into relative ones 1e3 times larger, which Adam carries
    to a few weights past ``PARAM_ATOL``. The whole learner update on
    each device's own rollout is run too: its losses are held to the
    same tolerance and its weights' difference is printed."""
    cpu = torch.device("cpu")
    env = EnvConfig(train=True, obs_mode="state")
    ren = route_poses(scene, ROLL_ENVS, seed)
    rng = np.random.default_rng(seed)
    met = torch.from_numpy(np.stack([
        rng.normal(0.0, 2e-4, ROLL_ENVS), rng.normal(0.0, 2e-4, ROLL_ENVS),
        rng.uniform(0.0, 8.0, ROLL_ENVS), rng.integers(1, 7, ROLL_ENVS)],
        1).astype(np.float32))
    got = state_observation_batch(scene, env, ren, met.to(scene.device))
    want = state_observation_batch(scene.to(cpu), env,
                                   map_state(lambda a: a.cpu(), ren), met)
    obs_err = max_abs_diff(got, want)

    smoke = make_presets()["smoke"]
    model_cfg = smoke["model"]
    tcfg = dataclasses.replace(
        smoke["train"], algo="ppo", bcgail=False,
        num_steps=SMOKE_STEPS_PER_ENV * smoke["train"].n_envs)
    n, steps = tcfg.n_envs, tcfg.steps_per_env
    total = n * steps
    gen = torch.Generator()
    gen.manual_seed(seed)
    cpu_scene = make_benchmark_scene(**smoke["scene"], device=cpu)
    reset = draw_reset(cpu_scene, env, n, gen)
    gnss = draw_gnss(n, cpu, gen)
    noise = torch.randn((steps, n, 2), generator=gen)
    env_draws = [draw_step(cpu_scene, env, n, gen) for _ in range(steps)]
    perms = ppo_mod.draw_perms(
        tcfg.ppo_epoch, total,
        total // tcfg.mini_batch_size * tcfg.mini_batch_size, cpu, gen)
    shape = (STATE_OBS_DIM,)
    pparams = init_flax_params(model_cfg, shape, seed)
    dparams = init_critic_flax_params(model_cfg, shape, seed + 1)
    whole = []
    for d in (scene.device, cpu):
        sc = cpu_scene if d == cpu else cpu_scene.to(d)
        learner = WDGAILLearner(sc, env, model_cfg, tcfg, None,
                                policy_params=pparams, disc_params=dparams)
        state = learner.init_state(reset_draws=to_device(reset, d),
                                   reset_gnss=gnss.to(d))
        state, metrics = learner.update(state, UpdateDraws(
            action_noise=noise.to(d),
            env_draws=[to_device(e, d) for e in env_draws],
            ppo_perms=perms.to(d)))
        whole.append((metrics, state.policy.state_dict()))
    whole_rel = check_losses("whole state update", whole[0][0], whole[1][0])
    whole_param = max(max_abs_diff(v, whole[1][1][k])
                      for k, v in whole[0][1].items())
    routes = torch.tensor(tcfg.routes)[torch.arange(n) % len(tcfg.routes)]
    ros = []
    for d in (scene.device, cpu):
        sc = cpu_scene if d == cpu else cpu_scene.to(d)
        net = policy_from_flax(pparams, model_cfg, shape, d)
        st, m, r = reset_batch(sc, env, routes.to(d),
                               draws=to_device(reset, d),
                               gnss_noise=gnss.to(d))
        ros.append(collect_rollout(
            sc, env, net, st, m, r, None, steps, True,
            action_noise=noise.to(d),
            env_draws=[to_device(e, d) for e in env_draws])[3])
    roll_err = max(max_abs_diff(a, b) for a, b in (
        (ros[0].obs, ros[1].obs), (ros[0].values, ros[1].values),
        (ros[0].logp, ros[1].logp)))
    ro = ros[1]
    returns = compute_returns(ro.gail_rewards, ro.env_rewards, ro.values,
                              ro.masks, tcfg.gamma, tcfg.gae_lambda,
                              gail_coef=0.0, env_coef=1.0)
    outs = []
    for d in (scene.device, cpu):
        sc = cpu_scene if d == cpu else cpu_scene.to(d)
        net = policy_from_flax(pparams, model_cfg, shape, d)
        opt = ppo_mod.make_policy_optimizer(tcfg)
        ro_d = dataclasses.replace(ro, render=map_state(
            lambda a: a.to(d), ro.render), **{
            f.name: getattr(ro, f.name).to(d) for f in dataclasses.fields(ro)
            if f.name != "render"})
        _, aux = ppo_mod.ppo_update(
            sc, env, tcfg, net, opt, opt.init(list(net.parameters())), ro_d,
            returns.to(d), None, torch.zeros((), device=d), None,
            perms=perms.to(d))
        outs.append((aux, net.state_dict()))
    (gm, gsd), (cm, csd) = outs
    worst_rel = check_losses("state ppo_update", gm, cm)
    worst_param = max(max_abs_diff(v, csd[k]) for k, v in gsd.items())
    print(f"  card vs CPU state obs ({ROLL_ENVS} envs, reference scene): "
          f"max |d| {obs_err:.3e} (limit {STATE_OBS_ATOL}); whole state "
          f"update (smoke preset, {n} envs x {steps} steps, float32): "
          f"{len(whole[1][0])} metrics, worst relative difference "
          f"{whole_rel:.3e}, max |dparam| {whole_param:.3e} (not held); "
          f"its rollout: max |d| of obs, values, logp {roll_err:.3e}; "
          f"ppo_update from one rollout: {len(cm)} losses, worst relative "
          f"difference {worst_rel:.3e}, max |dparam| {worst_param:.3e} "
          f"(limit {PARAM_ATOL})", flush=True)
    if (obs_err > STATE_OBS_ATOL or roll_err > 1e-6
            or worst_param > PARAM_ATOL):
        raise AssertionError("card and CPU disagree on the state path")


def adversaries(graph, routes):
    """Per route, one scripted adversary (``tests/test_scenario_actors.py``
    's): a 26-point side street from 25 m right of a route point onto
    that point, driven at 6 m/s, where it parks across the ego lane. The
    point is the first at least ``SA_AHEAD_M`` along the route that ends
    ``SA_STRAIGHT_M`` of straight road (headings within 1 degree), so that
    the ego meets the adversary ahead of it and not inside a turn."""
    out = {}
    for r, rd in enumerate(routes):
        d = trace_route(graph, rd.waypoints)
        i = int(np.searchsorted(d.s, SA_AHEAD_M))
        while True:
            back = d.s[i] - d.s[:i + 1] <= SA_STRAIGHT_M
            turn = np.angle(np.exp(1j * (d.yaw[:i + 1][back] - d.yaw[i])))
            if np.abs(turn).max() < np.radians(1.0):
                break
            i += 1
        yaw = float(d.yaw[i])
        right = np.array([-np.sin(yaw), np.cos(yaw)])
        out[r] = [(d.xy[i] + np.linspace(25.0, 0.0, 26)[:, None] * right,
                   6.0)]
    return out


def scenario_expert(scene, cfg: EnvConfig, dev):
    """(c) The compliant expert (``obey_signals=True``) on every route of
    the scenario scene for at most ``SA_EXPERT_STEPS`` steps, one env per
    route, over each env's first episode: it stops once every env has
    ended it or has come within ``SA_GAP`` m of its adversary
    ``SA_HOLD`` steps before. Raises on a vehicle collision, an env that
    never came within ``SA_GAP`` m, or slots that did not park."""
    n = scene.n_routes
    K = cfg.n_npc_vehicles
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    st, _, _ = reset_batch(scene, cfg, torch.arange(n, device=dev), gen)
    parked = st.traffic.veh.xy[:, K + 1:]
    if not (bool((parked.abs() > 1e5).all())
            and bool((st.traffic.veh_target_speed[:, K + 1:] == 0).all())):
        raise AssertionError("the spare scenario slots are not parked")
    ap = make_autopilot((n,), dev)
    ended = torch.zeros(n, dtype=torch.bool, device=dev)
    hit = torch.zeros_like(ended)
    gap = torch.full((n,), 1e9, device=dev)
    near_at = torch.full((n,), -1, dtype=torch.int64, device=dev)
    t0 = time.time()
    for t in range(SA_EXPERT_STEPS):
        d = torch.linalg.norm(st.traffic.veh.xy[:, K] - st.ego.xy, dim=-1)
        gap = torch.where(ended, gap, torch.minimum(gap, d))
        near_at = torch.where((near_at < 0) & (gap < SA_GAP), t, near_at)
        ap, act = autopilot_act(scene, ap, st, TARGET_SPEED, True)
        st, out = step_batch(scene, cfg, st, act, gen)
        ap = reset_autopilot_where(out.done, ap)
        hit |= ~ended & (out.info["n_collisions_vehicle"] > 0)
        ended |= out.done
        if bool((ended | ((near_at >= 0) & (t - near_at >= SA_HOLD))).all()):
            break
    steps = t + 1
    dt = synced_s(t0)
    print(f"  scenario expert (obey_signals, {n} routes, {K} + "
          f"{cfg.n_scenario_actors} scenario slots, 1 live per route): "
          f"{steps} steps at {dt / steps * 1e3:.3f} ms per step; vehicle "
          f"collisions {int(hit.sum())}; least gap to the adversary per "
          f"route {[round(float(g), 2) for g in gap]} m; episodes ended "
          f"{int(ended.sum())}", flush=True)
    if bool(hit.any()) or not bool((gap < SA_GAP).all()):
        raise AssertionError("the expert hit an adversary or never came "
                             f"within {SA_GAP} m of one")


def scenario_path(net6, env6_cfg: EnvConfig, dev):
    """(c) ``leaderboard_suite(scenario_actors=...)`` on the card with one
    adversary per route and ``SA_SLOTS`` scenario slots (2 parked): the
    expert (``scenario_expert``), then the bev6 policy for
    ``SUITE_STEPS`` steps (B2 once per step, 1 + ``SA_SLOTS`` vehicle
    boxes); (d) B2 at ``ROLL_ENVS`` envs with 20 NPC vehicles, the
    scenario slots and 50 walkers against its plain version at 0 values,
    timed, with its shared memory. Every launch count is set to 0 just
    before the suite and read after the policy's run. Returns (B2
    launches, max abs difference, times)."""
    for lib in (bev_cuda.LIB, bev6_cuda.LIB):
        lib.launches = 0
    t = time.time()
    graph = make_grid_town(nx=4, ny=4, block=100.0, seed=2021)
    actors = adversaries(graph, generate_routes(
        graph, n_routes=10, min_length=400.0, seed=2021))
    scene, cfg, _ = leaderboard_suite(scenario_actors=actors, device=dev)
    if cfg.n_scenario_actors != 1:
        raise AssertionError("one scenario actor per route expected")
    cfg = dataclasses.replace(cfg, train=False, obs_mode="state",
                              n_scenario_actors=SA_SLOTS)
    print(f"  leaderboard_suite(scenario_actors=...): {scene.n_routes} "
          f"routes, patrol rows {scene.patrol_xy.shape[0]} (the adversaries "
          f"last), built in {synced_s(t):.3f} s", flush=True)
    scenario_expert(scene, cfg, dev)
    cfg6 = dataclasses.replace(cfg, obs_mode="bev6",
                               max_time=SUITE_STEPS * 0.1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.time()
    latched, steps = run_latched(
        scene, cfg6, torch.arange(scene.n_routes, device=dev),
        benchmark_policy.LATCH_KEYS, SUITE_STEPS, gen, net=net6)
    dt = synced_s(t0)
    b2 = bev6_cuda.LIB.launches
    if b2 != steps or bev_cuda.LIB.launches:
        raise AssertionError(f"scenario bev6 policy: {b2} B2 launches for "
                             f"{steps} steps")
    print(f"  scenario bev6 policy ({scene.n_routes} routes, "
          f"{1 + SA_SLOTS} vehicle boxes per env): {steps} steps at "
          f"{dt / steps * 1e3:.3f} ms per step, B2 launches {b2}, "
          f"collisions {int(latched['collision'].sum())}", flush=True)

    # (d) B2 with 20 NPCs + the scenario slots (1 live, 2 parked) + 50
    cfg_d = dataclasses.replace(env6_cfg, n_scenario_actors=SA_SLOTS)
    k = cfg_d.n_npc_vehicles + SA_SLOTS
    print(f"  bev6_raster shared memory per block at {k} vehicles + "
          f"{cfg_d.n_npc_walkers} walkers: "
          f"{bev6_cuda.shared_bytes(scene, k, cfg_d.n_npc_walkers)} bytes",
          flush=True)
    ren = bev6_states(scene, cfg_d, ROLL_ENVS, SEED + 7)
    sa = ren.npc_pose[:, cfg_d.n_npc_vehicles:, :2]
    if not (bool((sa[:, 1:].abs() > 1e5).all())
            and bool((sa[:, 0].abs() < 1e4).all())):
        raise AssertionError("the render states lack a live and two "
                             "parked scenario slots")
    err = check_kernel6(scene, cfg_d, ren)
    inp = bev6_plain.bev6_inputs(scene, cfg_d, ren)
    pro = bev6_cuda.bev6_prologue(scene, cfg_d, ren)
    err_t, times = time_kernel(
        "bev6_raster scenario", scene, cfg_d, ren, inp,
        bev_tiles.kernel_tables(scene, ren, inp), pro,
        lambda: bev6_cuda.render_bev6_cuda(scene, cfg_d, ren, *pro),
        lambda: bev6_cuda.render_bev6_cuda_batch(scene, cfg_d, ren),
        lambda: bev6_plain.render_bev6_plain(cfg_d, inp, scene.bnd_dmax))
    return b2, max(err, err_t), times


def sat_margins(scene, xy: np.ndarray, yaw: np.ndarray) -> np.ndarray:
    """(N,) float64 separating-axis margin of each ego pose against the
    scene's obstacles (the least over obstacles of the largest gap over
    the 4 axes): > 0 apart, < 0 overlapping."""
    p = scene.ob_pose.cpu().numpy().astype(np.float64)
    ext = scene.ob_extent.cpu().numpy().astype(np.float64)
    he = np.array([DEFAULT_VEHICLE.half_length, DEFAULT_VEHICLE.half_width])

    def axes(a):
        c, s = np.cos(a), np.sin(a)
        return np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)

    ego_ax, ob_ax = axes(yaw.astype(np.float64)), axes(p[:, 2])
    n, o = len(yaw), len(p)
    all_ax = np.concatenate([np.broadcast_to(ego_ax[:, None], (n, o, 2, 2)),
                             np.broadcast_to(ob_ax[None], (n, o, 2, 2))], 2)
    d = p[None, :, :2] - xy.astype(np.float64)[:, None]
    proj = np.abs(np.einsum("noac,noc->noa", all_ax, d))
    r_ego = np.abs(np.einsum("noac,nbc->noab", all_ax, ego_ax)) @ he
    r_ob = np.einsum("noab,ob->noa", np.abs(np.einsum(
        "noac,obc->noab", all_ax, ob_ax)), ext)
    return (proj - r_ego - r_ob).max(-1).min(-1)


def obstacle_path(dev):
    """(e) The reference scene with ``grid_building_obstacles(4, 4, 100)``
    (9 buildings): a hard right turn at throttle 0.8 on ``ROLL_ENVS``
    envs for ``OB_STEPS`` steps (every env must score a layout collision
    with its first episode's penalty <= 65, as in
    ``tests/test_obstacles.py``; the car leaves the road, 10.5 m short of
    the buildings, before it can reach one, so the count of envs in
    which the obstacle test fired is printed, not held), the
    expert on every route for ``OB_EXPERT_STEPS`` steps (none), then card
    vs CPU: ``obstacle_collision`` on ``OB_POSES`` random poses away from
    contact (equal booleans) and the three cameras with the buildings in
    view (within 1 level)."""
    t = time.time()
    graph = make_grid_town(nx=4, ny=4, block=100.0, seed=2021)
    routes = generate_routes(graph, n_routes=10, min_length=400.0,
                             seed=2021)
    cpu_scene = build_scene(graph, routes, obstacles=grid_building_obstacles(
        nx=4, ny=4, block=100.0))
    scene = cpu_scene.to(dev)
    print(f"  obstacle scene: {scene.ob_n} buildings, built in "
          f"{synced_s(t):.3f} s", flush=True)
    if scene.ob_n != 9:
        raise AssertionError(f"{scene.ob_n} buildings, 9 expected")
    cfg = EnvConfig(train=False, obs_mode="state")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = ROLL_ENVS
    st, _, _ = reset_batch(scene, cfg, torch.arange(n, device=dev)
                           % scene.n_routes, gen)
    action = torch.tensor([[0.55, 0.8]], device=dev).expand(n, 2)
    layout = torch.zeros(n, dtype=torch.bool, device=dev)
    ob_hit, ended = torch.zeros_like(layout), torch.zeros_like(layout)
    penalty = torch.zeros(n, device=dev)
    t0 = time.time()
    for t in range(OB_STEPS):
        st, out = step_batch(scene, cfg, st, action, gen)
        live = ~ended
        ob_hit |= live & obstacle_collision(scene, DEFAULT_VEHICLE, st.ego)
        layout |= live & (out.info["n_collisions_layout"] > 0)
        penalty = torch.where(live, out.info["score_penalty"], penalty)
        ended |= out.done
        if bool(ended.all()):
            break
    steps = t + 1
    dt = synced_s(t0)
    print(f"  hard right at throttle 0.8 ({n} envs, every first episode "
          f"ended after {steps} steps): {dt / steps * 1e3:.3f} ms per "
          f"step; layout collisions in "
          f"{int(layout.sum())} envs, the obstacle test fired in "
          f"{int(ob_hit.sum())}; worst first-episode penalty "
          f"{float(penalty.max()):.3f} (x100)", flush=True)
    if not bool(layout.all()) or float(penalty.max()) > 65.0 + 1e-3:
        raise AssertionError("the hard right turn did not score a layout "
                             "collision with penalty <= 65 in every env")

    k = scene.n_routes
    st, _, _ = reset_batch(scene, cfg, torch.arange(k, device=dev), gen)
    ap = make_autopilot((k,), dev)
    clean = torch.zeros(k, dtype=torch.bool, device=dev)
    t0 = time.time()
    for _ in range(OB_EXPERT_STEPS):
        ap, act = autopilot_act(scene, ap, st)
        st, out = step_batch(scene, cfg, st, act, gen)
        ap = reset_autopilot_where(out.done, ap)
        clean |= out.info["n_collisions_layout"] > 0
    dt = synced_s(t0)
    print(f"  expert on the obstacle scene ({k} routes x {OB_EXPERT_STEPS} "
          f"steps): {dt / OB_EXPERT_STEPS * 1e3:.3f} ms per step; layout "
          f"collisions {int(clean.sum())}", flush=True)
    if bool(clean.any()):
        raise AssertionError("the expert hit a building on its route")

    rng = np.random.default_rng(SEED)
    half = float(cpu_scene.ob_extent[0, 0])
    xy = (rng.choice([50.0, 150.0, 250.0], (OB_POSES, 2))
          + rng.uniform(-1.0, 1.0, (OB_POSES, 2)) * (half + 12.0)
          ).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, OB_POSES).astype(np.float32)
    away = np.abs(sat_margins(cpu_scene, xy, yaw)) > 1e-3
    hits = []
    for sc in (scene, cpu_scene):
        d = sc.device
        ego = VehicleState(xy=torch.from_numpy(xy).to(d),
                           yaw=torch.from_numpy(yaw).to(d),
                           speed=torch.zeros(OB_POSES, device=d))
        hits.append(obstacle_collision(sc, DEFAULT_VEHICLE, ego).cpu()
                    .numpy())
    n_diff = int((hits[0][away] != hits[1][away]).sum())
    bare = dataclasses.replace(cpu_scene, ob_n=0)
    level = drawn = 0
    for i, off in enumerate(camera.CAMERAS.values()):
        r, h = i, 40 + 30 * i
        xy_c = cpu_scene.route_xy[r, h][None]
        yaw_c = cpu_scene.route_yaw[r, h][None]
        got = camera.render_camera(scene, xy_c.to(dev), yaw_c.to(dev), off)
        want = camera.render_camera(cpu_scene, xy_c, yaw_c, off)
        level = max(level, int((got.cpu().int() - want.int()).abs().max()))
        drawn += int((want != camera.render_camera(bare, xy_c, yaw_c, off))
                     .any(-1).sum())
    print(f"  card vs CPU obstacles: SAT on {OB_POSES} poses "
          f"({int(away.sum())} away from contact, {int(hits[1].sum())} "
          f"hits): {n_diff} differ; {len(camera.CAMERAS)} camera frames, "
          f"{drawn} pixels of buildings: max |d| {level} level", flush=True)
    if n_diff or level > 1 or not drawn:
        raise AssertionError("card and CPU disagree on the obstacles")


def options_path(scene, model_cfg: ModelConfig, env6_cfg: EnvConfig,
                 preset, dev):
    """The options of ported modules: (a) the state-vector path, (b) its
    card-vs-CPU checks, (c, d) scenario actors and B2 at their slots, (e)
    static obstacles. Returns (B2 launches of (c), B2's max abs
    difference and times at the scenario slots)."""
    t = time.time()
    net = state_updates(scene, model_cfg, preset["train"], dev)
    state_demos_and_eval(scene, net, preset["train"], dev)
    progress("options (a) state path", t)
    t = time.time()
    state_card_vs_cpu(scene, SEED + 8)
    progress("options (b) state card vs CPU", t)
    t = time.time()
    w = env6_cfg.bev_width
    net6 = init_policy(model_cfg, (6, w, w), seed=SEED, device=dev)
    b2, err, times = scenario_path(net6, env6_cfg, dev)
    progress("options (c, d) scenario actors, B2", t)
    t = time.time()
    obstacle_path(dev)
    progress("options (e) obstacles", t)
    return b2, err, times


# --- the sharded phase -----------------------------------------------------

def host_line() -> str:
    """The host's CPU and its CPU count: the host-bound steps' times follow
    them. The CPU is named by the identity fields of ``/proc/cpuinfo``
    (the card's hosts mask the model name: family, model and clock say
    more)."""
    fields = {}
    for line in open("/proc/cpuinfo"):
        key, _, val = line.partition(":")
        fields.setdefault(key.strip(), val.strip())
    model = "; ".join(f"{k} {fields[k]}" for k in (
        "model name", "vendor_id", "cpu family", "model", "stepping",
        "cpu MHz") if k in fields)
    return f"{model}; {os.cpu_count()} CPUs"


def sharded_vs_plain(ref: dict, dev):
    """(b) The reference phase's card update at the smoke preset repeated
    by a world-1 ``ShardedWDGAILLearner`` in the NCCL group, from the same
    weights, reset, expert rows and draws: its metrics and weights against
    the plain learner's, within the CPU tests' tolerances (a mean over one
    rank is a copy and a division by 1). The plain update is repeated too:
    the difference between two runs of it on the card is the floor."""
    env_cfg, model_cfg, tcfg = ref["cfgs"]
    pparams, dparams = ref["params"]
    line = []
    for cls in (WDGAILLearner, ShardedWDGAILLearner):
        learner = cls(ref["scene"].to(dev), env_cfg, model_cfg, tcfg,
                      ref["expert"], policy_params=pparams,
                      disc_params=dparams)
        state = learner.init_state(reset_draws=to_device(ref["reset"], dev),
                                   reset_gnss=ref["gnss"].to(dev))
        state, metrics = learner.update(
            state, update_draws_to(ref["draws"], dev))
        worst_rel = check_losses(f"{cls.__name__} update", metrics,
                                 ref["metrics"])
        worst_param = 0.0
        for got, want in ((state.policy, ref["state"].policy),
                          (state.disc, ref["state"].disc)):
            wsd = want.state_dict()
            for k, v in got.state_dict().items():
                worst_param = max(worst_param, max_abs_diff(v, wsd[k]))
        line.append(f"{cls.__name__} {len(metrics)} metrics, worst "
                    f"relative difference {worst_rel:.3e}, max |dparam| "
                    f"{worst_param:.3e}")
        if worst_param > PARAM_ATOL:
            raise AssertionError(f"{cls.__name__} repeated the update with "
                                 f"other weights")
    print(f"  the reference phase's card update (smoke preset, same draws) "
          f"repeated on the card: " + "; ".join(line)
          + f" (the world-1 learner in the NCCL group; limit {PARAM_ATOL})",
          flush=True)


def gps_path(scene, dev):
    """(d) The GPS expert with one env per route on the card for
    ``GPS_STEPS`` steps: ms per step, each env's route progress (at least
    ``GPS_MIN_M`` m each); then its first ``GPS_CMP_STEPS`` steps on the
    card and on the CPU from the same reset and draws (made on the CPU),
    actions within ``DEMO_TOL``."""
    cfg = EnvConfig(train=False)
    n = scene.n_routes
    routes = torch.arange(n, dtype=torch.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    st, _, _ = reset_batch(scene, cfg, routes.to(dev), gen)
    ap = make_gps_autopilot(n, dev)
    best = torch.zeros(n, device=dev)
    t = time.time()
    for _ in range(GPS_STEPS):
        ap, act = gps_autopilot_act(scene, ap, st, gen)
        st, out = step_batch(scene, cfg, st, act, gen)
        best = torch.maximum(best, out.info["route_completed_in_m"])
    dt = synced_s(t)
    prog = [round(float(v), 1) for v in best]
    print(f"  GPS expert ({n} envs, one per route, {GPS_STEPS} steps): "
          f"{dt / GPS_STEPS * 1e3:.3f} ms per step; route progress per env "
          f"{prog} m (least {GPS_MIN_M} m)", flush=True)
    if min(prog) < GPS_MIN_M:
        raise AssertionError("a GPS expert env made too little progress")

    cpu = torch.device("cpu")
    cpu_scene = scene.to(cpu)
    g = torch.Generator()
    g.manual_seed(SEED + 1)
    reset = draw_reset(cpu_scene, cfg, n, g)
    gnss = draw_gnss(n, cpu, g)
    steps = [(draw_step(cpu_scene, cfg, n, g), draw_gps_noise(n, cpu, g))
             for _ in range(GPS_CMP_STEPS)]
    acts = []
    for d, sc in ((dev, scene), (cpu, cpu_scene)):
        st, _, _ = reset_batch(sc, cfg, routes.to(d), None,
                               draws=to_device(reset, d),
                               gnss_noise=gnss.to(d))
        ap, seq = make_gps_autopilot(n, d), []
        for sd, noise in steps:
            ap, act = gps_autopilot_act(sc, ap, st, noise=noise.to(d))
            st, _ = step_batch(sc, cfg, st, act, None,
                               **to_device(sd, d)._asdict())
            seq.append(act.cpu())
        acts.append(torch.stack(seq))
    err = max_abs_diff(*acts)
    print(f"  card vs CPU GPS expert ({n} envs x {GPS_CMP_STEPS} steps, "
          f"closed loop): max |d action| {err:.3e} (limit {DEMO_TOL})",
          flush=True)
    if err > DEMO_TOL:
        raise AssertionError("card and CPU GPS experts disagree")


def start_ranks(tmp: str):
    """(c) ``SHARD_WORLD`` processes of this script, one per gloo rank,
    all on the one card; each writes ``rank<r>.json`` and a log. The
    caller waits for them with ``rank_results``; if it exits first, they
    are stopped at its exit."""
    torch.cuda.empty_cache()
    procs = []
    for r in range(SHARD_WORLD):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank",
             str(r), tmp], stdout=log, stderr=subprocess.STDOUT), log))
    atexit.register(stop_procs, procs)
    return procs


def stop_procs(procs) -> None:
    """Kills every process of ``procs`` still running and closes the
    logs."""
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def wait_file(path: str, parent: int) -> None:
    """Sleeps until ``path`` exists; exits if the process ``parent`` that
    writes it is gone."""
    while not os.path.exists(path):
        if os.getppid() != parent:
            raise SystemExit(1)
        time.sleep(0.05)


def _digests(state) -> dict:
    """sha256 of every replicated leaf of a ``LearnerState``: both nets,
    both Adam states (moments and counts), the reward statistics, the BC
    weight and the update counter."""
    saved = ckpt_mod.to_saved(state)
    out = {}

    def walk(v, path):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(v[k], f"{path}/{k}")
        elif isinstance(v, list):
            for i, x in enumerate(v):
                walk(x, f"{path}[{i}]")
        elif isinstance(v, torch.Tensor):
            out[path] = hashlib.sha256(
                v.reshape(-1).contiguous().view(torch.uint8).numpy()
                .tobytes()).hexdigest()
        else:
            out[path] = repr(v)

    for f in ("policy", "policy_opt", "disc", "disc_opt", "reward_rms",
              "gail_gamma", "update_i"):
        walk(saved[f], f)
    return out


def sharded_rank(rank: int, tmp: str) -> int:
    """One rank of (c): a ``ShardedWDGAILLearner`` at the reference widths
    (``SHARD_WORLD`` envs, one per rank, ``SHARD_STEPS`` steps, an expert
    buffer of the scripted expert's first ``SHARD_DEMO_STEPS`` steps on 2
    routes, every row kept) over gloo with CUDA tensors: two updates and
    the replicated leaves' digests, then (rank 1) the first policy weight
    moved by 1 and one more update. Counts each ``all_reduce`` and its
    bytes, B1's launches in the updates, and times ``all_reduce`` of a
    buffer the policy's size once the main process has written
    ``GO_FILE`` (it runs the earlier phases meanwhile)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    parent, t0 = os.getppid(), time.time()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=SHARD_WORLD)
    try:
        preset = make_presets()["reference"]
        env_cfg, model_cfg = preset["env"], preset["model"]
        tcfg = dataclasses.replace(
            preset["train"], n_envs=SHARD_WORLD,
            num_steps=SHARD_WORLD * SHARD_STEPS, mini_batch_size=SHARD_MB,
            ppo_epoch=SHARD_PPO_EPOCHS, gail_batch_size=SHARD_MB,
            gail_pre_epoch=2, gail_epoch=1, gail_thre=2, routes=(0, 1),
            gail_norm_reward=True)
        scene = make_benchmark_scene(**preset["scene"], device=dev)
        demos = generate_demos(scene, train_mod.demo_config(env_cfg),
                               train_mod._generator(dev, train_mod.DEMO_SEED),
                               [0, 1], SHARD_DEMO_STEPS)
        demos = dataclasses.replace(demos,
                                    valid=torch.ones_like(demos.valid))
        expert = build_expert_buffer(scene, env_cfg, demos)
        learner = ShardedWDGAILLearner(scene, env_cfg, model_cfg, tcfg,
                                       expert)
        state = learner.init_state()
        policy_bytes = sum(p.numel() * 4 for p in state.policy.parameters())
        calls = []
        real = dist.all_reduce

        def counted(t, *args, **kwargs):
            calls.append(t.numel() * t.element_size())
            return real(t, *args, **kwargs)

        dist.all_reduce = counted
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        bev_cuda.LIB.launches = 0
        out = dict(rank=rank, setup_s=setup_s, policy_bytes=policy_bytes,
                   expert_rows=learner.expert.size, metrics=[], update_s=[],
                   calls=[])
        for i in range(3):
            if i == 2:
                out["digests2"] = _digests(state)
                if rank == 1:
                    with torch.no_grad():
                        next(state.policy.parameters()).add_(1.0)
                out["digests_bad"] = _digests(state)
            n_calls, t = len(calls), time.time()
            state, metrics = learner.update(state)
            torch.cuda.synchronize()
            out["update_s"].append(time.time() - t)
            out["calls"].append(calls[n_calls:])
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["digests_bad2"] = _digests(state)
        out["b1"] = bev_cuda.LIB.launches
        dist.all_reduce = real
        # the main process times nothing until every rank has written this
        open(os.path.join(tmp, f"{UPDATED_FILE}{rank}"), "w").close()
        # time the all-reduce only once the main process waits for it (and
        # give up if it has gone)
        wait_file(os.path.join(tmp, GO_FILE), parent)
        buf = torch.zeros(policy_bytes // 4, device=dev)
        ms = []
        for i in range(7):
            torch.cuda.synchronize()
            t = time.time()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            if i >= 2:
                ms.append((time.time() - t) * 1e3)
        out["ar_ms"] = ms
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def wait_updated(procs, tmp: str) -> None:
    """Waits until every rank of (c) has written ``UPDATED_FILE`` after its
    updates, or has exited, or ``SHARD_TIMEOUT_S`` has passed: no rank
    then shares the card and the host with a timed phase (it waits for
    ``GO_FILE``, asleep). Prints the wait."""
    t = time.time()
    while time.time() - t < SHARD_TIMEOUT_S and any(
            p.poll() is None and not os.path.exists(
                os.path.join(tmp, f"{UPDATED_FILE}{r}"))
            for r, (p, _) in enumerate(procs)):
        time.sleep(0.05)
    print(f"  waited {time.time() - t:.2f} s for the world-{SHARD_WORLD} "
          f"ranks' updates to end", flush=True)


def rank_results(procs, tmp: str):
    """Waits for the ranks (at most ``SHARD_TIMEOUT_S`` s), kills any that
    is left, and returns their results; raises if a rank failed."""
    deadline = time.time() + SHARD_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_procs(procs)
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    for r in bad:
        tail = open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
        print(f"  rank {r} exited {procs[r][0].returncode}:\n{tail}",
              flush=True)
    if bad:
        raise AssertionError(f"sharded ranks {bad} failed")
    return [json.load(open(os.path.join(tmp, f"rank{r}.json")))
            for r in range(len(procs))]


def check_ranks(res) -> int:
    """(c)'s checks: after two updates every replicated leaf bitwise equal
    on both ranks, the metrics equal, the perturbed weight still apart
    after an update (the gradients are averaged, not the weights); prints
    the all-reduces per update, their bytes and ms. Returns B1's launches
    of both ranks."""
    r0, r1 = res
    if r0["digests2"] != r1["digests2"]:
        diff = [k for k in r0["digests2"]
                if r0["digests2"][k] != r1["digests2"][k]]
        raise AssertionError(f"replicas differ after two updates: {diff[:5]}")
    if r0["metrics"][:2] != r1["metrics"][:2]:
        raise AssertionError("the ranks' metrics differ")
    bad = [k for k in r0["digests_bad"]
           if r0["digests_bad"][k] != r1["digests_bad"][k]]
    apart = [k for k in bad if r0["digests_bad2"][k] != r1["digests_bad2"][k]]
    pb = r0["policy_bytes"]
    per = [sum(1 for b in c if b == pb) for c in r0["calls"]]
    ms = sorted(r0["ar_ms"])
    print(f"  world {SHARD_WORLD} over gloo with CUDA tensors on one card "
          f"(reference widths, {SHARD_WORLD} envs x {SHARD_STEPS} steps, "
          f"expert {r0['expert_rows']} + {r1['expert_rows']} rows): set-up "
          f"{r0['setup_s']:.1f} / {r1['setup_s']:.1f} s, updates "
          f"{[round(x, 3) for x in r0['update_s']]} s; all-reduces per "
          f"update {[len(c) for c in r0['calls']]}, of the policy's "
          f"gradients {per} ({pb} bytes each, median {ms[len(ms) // 2]:.3f} "
          f"ms, {pb / ms[len(ms) // 2] / 1e6:.2f} GB/s); replicated leaves "
          f"equal after 2 updates: {len(r0['digests2'])} of "
          f"{len(r0['digests2'])}; metrics equal on both ranks; rank 1's "
          f"perturbed weight {bad} still apart after an update: "
          f"{apart == bad}; B1 launches {r0['b1']} + {r1['b1']}", flush=True)
    if len(bad) != 1 or apart != bad:
        raise AssertionError("the perturbed replica did not stay apart")
    if max(per) > 40 or not min(per):
        raise AssertionError(f"policy all-reduces per update {per}")
    if r0["b1"] != 3 * (SHARD_STEPS + 1) or r1["b1"] != r0["b1"]:
        raise AssertionError("B1 was not launched once per render in the "
                             "ranks' updates")
    return r0["b1"] + r1["b1"]


def sharded_path(scene, ref: dict, dev, procs, tmp: str) -> int:
    """The sharded phase: (b) the world-1 learner against the plain one,
    (d) the GPS expert, then (c): the gloo ranks (started before the
    reference phase, so that their set-up and updates run beside it) are
    told to time their all-reduce, waited for and checked. Returns B1's
    launches of (c)'s updates."""
    try:
        t = time.time()
        sharded_vs_plain(ref, dev)
        progress("sharded (b) world 1 vs plain", t)
        t = time.time()
        gps_path(scene, dev)
        progress("sharded (d) GPS expert", t)
    finally:
        t = time.time()
        open(os.path.join(tmp, GO_FILE), "w").close()
        res = rank_results(procs, tmp)
    launches = check_ranks(res)
    progress("sharded (c) world 2 (waited)", t)
    return launches


class CollectiveTimer:
    """Inside ``with``, every ``all_mean`` call that the PPO and critic
    steps and the metrics make over a process group records CUDA events
    around it (the flat copy, the ``all_reduce`` and the split; the two
    advantage moments' ``pmean`` calls are not counted)."""

    MODS = (ppo_mod, wdgail_mod, learner_mod)

    def __init__(self):
        self.events, self._saved = [], []

    def __enter__(self):
        for mod in self.MODS:
            fn = mod.all_mean
            self._saved.append((mod, fn))

            def timed(tensors, group, fn=fn):
                if group is None:
                    return fn(tensors, group)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(tensors, group)
                end.record()
                self.events.append((start, end))
                return out
            mod.all_mean = timed
        return self

    def __exit__(self, *exc):
        for mod, fn in self._saved:
            mod.all_mean = fn
        self._saved.clear()

    def take(self):
        """(calls, CUDA-event ms summed over them), then cleared."""
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        n = len(self.events)
        self.events.clear()
        return n, ms


def shard_cost() -> int:
    """``--shard-cost``: what the world-1 ``ShardedWDGAILLearner`` in an
    NCCL group adds to a reference-preset update (10 envs x 720 steps),
    against the plain ``WDGAILLearner``, side by side in one process. Both
    take the train bev phase's expert buffer (the scripted expert's
    ``DEMO_STEPS`` steps on ``TRAIN_ROUTES``) and start from the same
    weights and reset; after one warm-up update each, updates run in the
    order plain, sharded, sharded, plain: wall s and the ``PartTimer``
    split of each, and for the sharded ones the calls and CUDA-event ms of
    ``all_mean`` inside the update (``CollectiveTimer``). Then
    ``all_mean`` of tensors shaped like the policy's and the critic's
    gradients alone, ms per call (CUDA events)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[shard_cost] device {torch.cuda.get_device_name(0)} | "
          f"nvidia-smi: {smi} | host {host_line()}", flush=True)
    cuda_build.build_all(KERNEL_SOURCES, {})
    preset = make_presets()["reference"]
    env_cfg, model_cfg = preset["env"], preset["model"]
    tcfg = dataclasses.replace(preset["train"], routes=TRAIN_ROUTES,
                               eval_route=TRAIN_EVAL_ROUTE)
    scene = make_benchmark_scene(**preset["scene"], device=dev)
    t = time.time()
    demos = generate_demos(scene, train_mod.demo_config(env_cfg),
                           train_mod._generator(dev, train_mod.DEMO_SEED),
                           tcfg.routes, DEMO_STEPS)
    expert = build_expert_buffer(scene, env_cfg, demos,
                                 max_size=train_mod.EXPERT_MAX_ROWS)
    print(f"  expert buffer {expert.size} rows ({synced_s(t):.1f} s)",
          flush=True)
    group_dir = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method=f"file://{group_dir.name}"
                            "/store", rank=0, world_size=1)
    try:
        runs = {}
        for cls in (WDGAILLearner, ShardedWDGAILLearner):
            learner = cls(scene, env_cfg, model_cfg, tcfg, expert)
            runs[cls] = [learner, learner.init_state()]
        timer, coll = PartTimer(), CollectiveTimer()
        total = tcfg.n_envs * tcfg.steps_per_env
        n_mb_ppo = tcfg.ppo_epoch * (total // tcfg.mini_batch_size)
        walls = {WDGAILLearner: [], ShardedWDGAILLearner: []}
        order = (WDGAILLearner, ShardedWDGAILLearner, WDGAILLearner,
                 ShardedWDGAILLearner, ShardedWDGAILLearner, WDGAILLearner)
        with timer, coll:
            for i, cls in enumerate(order):
                learner, state = runs[cls]
                torch.cuda.synchronize()
                t = time.time()
                state, _ = learner.update(state)
                wall = synced_s(t)
                runs[cls][1] = state
                parts = timer.ms()
                n_coll, coll_ms = coll.take()
                n_epochs = wdgail_mod.warmup_epochs(tcfg, state.update_i)
                n_mb_disc = n_epochs * (min(learner.expert.size, total)
                                        // tcfg.gail_batch_size)
                tag = "warm-up" if i < 2 else "timed"
                if i >= 2:
                    walls[cls].append(wall)
                print(f"  {cls.__name__} update {state.update_i} ({tag}): "
                      f"wall {wall:.3f} s; " + ", ".join(
                          f"{k} {v:.1f} ms" for k, v in parts.items())
                      + f"; disc_update {parts['disc_update'] / n_mb_disc:.3f}"
                      f" ms per minibatch ({n_mb_disc}), ppo_update "
                      f"{parts['ppo_update'] / n_mb_ppo:.3f} ms per "
                      f"minibatch ({n_mb_ppo}); all_mean {n_coll} calls, "
                      f"{coll_ms:.1f} ms", flush=True)
        group = dist.group.WORLD
        for name, net in (("policy", runs[WDGAILLearner][1].policy),
                          ("critic", runs[WDGAILLearner][1].disc)):
            grads = [torch.randn_like(p) for p in net.parameters()]
            nbytes = sum(g.numel() * 4 for g in grads)
            ms = cuda_ms(lambda: all_mean(grads, group), iters=20)
            print(f"  all_mean of the {name}'s gradients alone "
                  f"({len(grads)} tensors, {nbytes} bytes): {ms:.3f} ms per "
                  f"call", flush=True)
        plain, sharded = walls[WDGAILLearner], walls[ShardedWDGAILLearner]
        print(f"[shard_cost] reference-preset update, timed: plain "
              f"{[round(x, 3) for x in plain]} s, world-1 sharded "
              f"{[round(x, 3) for x in sharded]} s; sharded - plain "
              f"{sum(sharded) / len(sharded) - sum(plain) / len(plain):.3f}"
              f" s | {smi}", flush=True)
    finally:
        dist.destroy_process_group()
        group_dir.cleanup()
    return 0


# --- the town phase ----------------------------------------------------------
def town_tree(root: str):
    """Writes the synthetic reference tree under ``root``; its mask pack
    goes to an H5 file when ``h5py`` imports here, else it is handed to
    the port's pack reader in memory (``h5_maps.put_pack``). Returns the
    reader used."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        has_h5py = False
    else:
        has_h5py = True
    layers, offset = synthetic_town.write_tree(
        root, "Town01", TOWN_ROUTES, min_length=TOWN_ROUTE_M[0],
        max_length=TOWN_ROUTE_M[1], write_h5=has_h5py)
    if not has_h5py:
        h5_maps.put_pack("Town01", layers, offset)
    reader = h5_maps.pack_reader("Town01")
    print(f"  town tree: h5py {'imports' if has_h5py else 'is missing'}; "
          f"pack reader {reader}; {TOWN_ROUTES} routes, road layer "
          f"{layers['road'].shape}", flush=True)
    return reader


def serrated_scene(scene):
    """``scene`` with its road boundary traced from the pack's road layer
    with every edge pixel of alternate ``SERRATE_PX``-pixel checks cut
    away: a toothed road whose cells hold far more boundary edges."""
    from scipy import ndimage

    pack = h5_maps.read_pack("Town01", ("road",))
    road = pack["road"] > 0
    edge = road & ~ndimage.binary_erosion(road)
    yy, xx = np.mgrid[:road.shape[0], :road.shape[1]]
    cut = edge & ((yy // SERRATE_PX + xx // SERRATE_PX) % 2 == 0)
    ab, dmax = mask_geo.mask_boundary_edges(
        road & ~cut, pack.world_offset, pack.ppm, max_err_px=0.49)
    gy, gx = scene.cell_bnd.shape[:2]
    cb, cbn = seg_mod.build_bnd_cells(
        ab, scene.cell_grid_lo.cpu().numpy(), gy, gx, scene.cell_size, dmax)
    dev = scene.device
    return dataclasses.replace(
        scene, cell_bnd=torch.from_numpy(cb).to(dev),
        cell_bnd_n=torch.from_numpy(cbn).to(dev), bnd_dmax=dmax)


def town_states(scene, cfg: EnvConfig, n: int, seed: int):
    """bev6 render states of ``n`` envs after 10 rollout steps with the
    town's traffic (walkers on the sidewalk paths); envs 0-31 moved 2 m
    before stop lines (the town has no stop signs) with 4 vehicles and 6
    walkers in view, and envs 32-63 not of the stop-sign kind on tile
    corners (``ops/bev6.py::place_in_view``)."""
    dev = scene.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st, met, ren = reset_batch(scene, cfg, torch.arange(
        n, device=dev) % scene.n_routes, gen)
    net = init_policy(ModelConfig(), (6, cfg.bev_width, cfg.bev_width),
                      seed=seed, device=dev)
    _, _, ren, _, _ = collect_rollout(scene, cfg, net, st, met, ren, gen, 10)
    ren = bev6_plain.place_in_view(scene, ren, range(0, 32, 2),
                                   np.random.default_rng(seed), 4, 6,
                                   view=(6.0, 20.0, 12.0))
    return tile_states(scene, cfg, ren, range(32, 64), seed + 1)


def town_kernels(scene, env_cfg: EnvConfig, env6_cfg: EnvConfig):
    """B1 and B2 against their plain versions on the town tables (256
    envs x 192 px; B2 at 20 + 50 and 100 + 250 actors, walkers on the
    sidewalk paths), timed on them, and on the serrated table whose blocks
    need more than 48 KB of shared memory. Returns (B1's max abs
    difference, B2's, B1's town times, B2's town times at 20 + 50)."""
    w = env_cfg.bev_width
    print(f"  town tables: Mb {scene.cell_bnd.shape[2]}, Ml "
          f"{scene.cell_lane.shape[2]}, Mt {scene.cell_tl.shape[2]}, Mh "
          f"{scene.cell_hard.shape[2]}, sidewalk paths "
          f"{scene.walk_xy.shape[0]} x {scene.walk_xy.shape[1]}; shared "
          f"bytes per block: B1 {bev6_cuda.shared_bytes_bev(scene)}, B2 at "
          f"20 + 50 {bev6_cuda.shared_bytes(scene, 20, 50)}, at 100 + 250 "
          f"{bev6_cuda.shared_bytes(scene, 100, 250)}", flush=True)
    err = check_kernel(scene, env_cfg, ROLL_ENVS, SEED + 40)
    ren = route_poses(scene, ROLL_ENVS, SEED + 41)
    inp = bev_plain.bev_inputs(scene, ren)
    cs = (torch.cos(ren.yaw), torch.sin(ren.yaw))
    err_t, b1_times = time_kernel(
        "bev_raster town", scene, env_cfg, ren, inp, None, cs,
        lambda: bev_cuda.render_bev_cuda(scene, env_cfg, ren, *cs),
        lambda: bev_cuda.render_bev_cuda_batch(scene, env_cfg, ren),
        lambda: bev_plain.render_bev_plain(env_cfg, inp, scene.bnd_dmax))
    err = max(err, err_t)
    err6, b2_times = 0.0, None
    # one rollout at the dense tier; its first 20 vehicles and 50 walkers
    # are the regular tier's states
    dense = town_states(scene, dataclasses.replace(
        env6_cfg, n_npc_vehicles=100, n_npc_walkers=250), ROLL_ENVS,
        SEED + 42)
    for v, wk in ((env6_cfg.n_npc_vehicles, env6_cfg.n_npc_walkers),
                  (100, 250)):
        cfg = dataclasses.replace(env6_cfg, n_npc_vehicles=v,
                                  n_npc_walkers=wk)
        ren6 = dataclasses.replace(
            dense, npc_pose=dense.npc_pose[:, :v].contiguous(),
            walker_pose=dense.walker_pose[:, :wk].contiguous())
        err6 = max(err6, check_kernel6(scene, cfg, ren6))
        if b2_times is not None:
            # the dense tier: checked above, and one launch timed
            pro6 = bev6_cuda.bev6_prologue(scene, cfg, ren6)
            ms = graph_ms(lambda: bev6_cuda.render_bev6_cuda(
                scene, cfg, ren6, *pro6))
            print(f"  bev6_raster town {v} + {wk} {ROLL_ENVS} envs x "
                  f"{cfg.bev_width} px: kernel {ms:.4f} ms (graph)",
                  flush=True)
            continue
        inp6 = bev6_plain.bev6_inputs(scene, cfg, ren6)
        pro6 = bev6_cuda.bev6_prologue(scene, cfg, ren6)
        err_t, b2_times = time_kernel(
            f"bev6_raster town {v} + {wk}", scene, cfg, ren6, inp6,
            bev_tiles.kernel_tables(scene, ren6, inp6), pro6,
            lambda: bev6_cuda.render_bev6_cuda(scene, cfg, ren6, *pro6),
            lambda: bev6_cuda.render_bev6_cuda_batch(scene, cfg, ren6),
            lambda: bev6_plain.render_bev6_plain(cfg, inp6, scene.bnd_dmax))
        err6 = max(err6, err_t)

    big = serrated_scene(scene)
    cfg = dataclasses.replace(env6_cfg, n_npc_vehicles=100,
                              n_npc_walkers=250)
    b1_bytes = bev6_cuda.shared_bytes_bev(big)
    b2_bytes = bev6_cuda.shared_bytes(big, 100, 250)
    print(f"  serrated town table: Mb {big.cell_bnd.shape[2]}; shared bytes "
          f"per block: B1 {b1_bytes}, B2 at 100 + 250 {b2_bytes} (no opt-in "
          f"up to {bev_cuda.DEFAULT_SHARED_BYTES})", flush=True)
    if min(b1_bytes, b2_bytes) <= bev_cuda.DEFAULT_SHARED_BYTES:
        raise AssertionError("the serrated table does not need more than "
                             "48 KB per block")
    err = max(err, check_kernel(big, env_cfg, SERRATED_ENVS, SEED + 43))
    ren6 = map_state(lambda a: a[:SERRATED_ENVS], dense)
    err6 = max(err6, check_kernel6(big, cfg, ren6))
    pro6 = bev6_cuda.bev6_prologue(big, cfg, ren6)
    ms = graph_ms(lambda: bev6_cuda.render_bev6_cuda(big, cfg, ren6, *pro6))
    ren = route_poses(big, SERRATED_ENVS, SEED + 45)
    cs = (torch.cos(ren.yaw), torch.sin(ren.yaw))
    ms1 = graph_ms(lambda: bev_cuda.render_bev_cuda(big, env_cfg, ren, *cs))
    print(f"  serrated table at {SERRATED_ENVS} envs x {w} px: B1 "
          f"{ms1:.4f} ms, B2 at 100 + 250 {ms:.4f} ms per launch (graph)",
          flush=True)
    return err, err6, b1_times, b2_times


def town_path(env_cfg: EnvConfig, env6_cfg: EnvConfig, dev):
    """The reconstructed-town path on the synthetic tree: the scene
    through ``make_town_scene`` (build seconds, table maxima, shared
    bytes), B1 and B2 against their plain versions on its tables
    (``town_kernels``), card vs CPU with sidewalk walkers, then with every
    launch count set to 0: ``train.run`` at the town01 preset
    (``ModelConfig()`` widths, 10 envs, 192 px) for one update and the
    evaluation on held-out route 3, and ``run_tier`` on the town's NoCrash
    suite with the bev6 policy. Returns (B1 launches, B2 launches, B1's
    and B2's max abs differences)."""
    preset = make_presets()["town01"]
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "reference")
        t = time.time()
        reader = town_tree(root)
        with synthetic_town.reference_tree(root, os.path.join(tmp, "cache")):
            t_scene = time.time()
            scene = make_town_scene("Town01", device=dev)
            torch.cuda.synchronize()
            print(f"  make_town_scene Town01 ({reader} pack): "
                  f"{time.time() - t_scene:.3f} s, {scene.n_routes} routes, "
                  f"route_xy {tuple(scene.route_xy.shape)}, cell_bnd "
                  f"{tuple(scene.cell_bnd.shape)}, cell_hard "
                  f"{tuple(scene.cell_hard.shape)}, walk_xy "
                  f"{tuple(scene.walk_xy.shape)}", flush=True)
            progress("town scene", t)
            t = time.time()
            err, err6, _, _ = town_kernels(scene, env_cfg, env6_cfg)
            progress("town kernels", t)
            # a float32 bev6 rollout, 20 vehicles and 50 walkers on the
            # sidewalk paths, card vs CPU with the same injected draws
            t = time.time()
            card_vs_cpu(scene, dataclasses.replace(
                env6_cfg, gnss_noise_deg=0.0, random_restart_prob=0.0),
                (6, env6_cfg.bev_width, env6_cfg.bev_width), SEED + 46)
            progress("town card vs CPU", t)

            for lib in (bev_cuda.LIB, bev6_cuda.LIB):
                lib.launches = 0
            t = time.time()
            tcfg = dataclasses.replace(
                preset["train"],
                num_steps=preset["train"].n_envs * TOWN_STEPS)
            env_cfg_t = dataclasses.replace(
                preset["env"], max_time=TOWN_DEMO_STEPS * preset["env"].dt)
            timer = PartTimer()
            with RunProbe(tcfg, timer) as probe, timer:
                train_mod.run(env_cfg_t, preset["model"], tcfg,
                              preset["scene"], TOWN_DEMO_STEPS,
                              max_updates=1, log_dir=os.path.join(tmp, "log"),
                              device=dev)
            if len(probe.of("update")) != 1:
                raise AssertionError("train.run at town01 ran no update")
            b1 = bev_cuda.LIB.launches
            print(f"  train.run town01: B1 launches {b1}", flush=True)
            progress("town train.run", t)
            t = time.time()
            scene_n, cfg_n, _ = nocrash_suite(
                town="Town01", background_traffic="regular", device=dev)
            print(f"  nocrash_suite Town01 regular: {scene_n.n_routes} "
                  f"routes planned from bare start/goal pairs, "
                  f"{synced_s(t):.3f} s", flush=True)
            w = env_cfg.bev_width
            net6 = init_policy(ModelConfig(), (6, w, w), seed=SEED,
                               device=dev)
            tier("NoCrash Town01 regular", scene_n, cfg_n, net6, False)
            b2 = bev6_cuda.LIB.launches
            progress("town run_tier", t)
        h5_maps.drop_pack("Town01")
    if not b1 or not b2:
        raise AssertionError("a kernel was not launched on the town path")
    return b1, b2, err, err6


def scale_argv():
    """The tool's argv of the scale phase (``SCALE_ENVS`` envs, ``--mb``
    and ``--gail-batch`` scaled from the tool's 8,192 and 4,096 at 4,096
    envs)."""
    return ["--obs-mode", "bev6", "--n-envs", str(SCALE_ENVS),
            "--steps-per-env", str(SCALE_STEPS),
            "--mb", str(8192 * SCALE_ENVS // 4096),
            "--gail-batch", str(4096 * SCALE_ENVS // 4096),
            "--updates", "1", "--demo-steps", str(SCALE_DEMO_STEPS),
            "--phases"]


def scale_bench(tmp: str) -> int:
    """The scale phase's process (``--scale <tmp>``), started beside the
    reference phase: runs the tool's ``main(scale_argv())`` on the card
    with every launch count set to 0 just before and read just after. Its
    one gate: the learner's ``init_state``, once the set-up (scene, demos,
    expert buffer) is done, waits for ``GO_FILE``, which the main process
    writes once the reference phase has ended, so the timed updates and
    phases share the card and the host with nothing. Raises unless the
    last update's metrics and weights are finite. Writes ``scale.json``:
    the record, the tool's output, B1's and B2's launches, the peak device
    memory, the last update's metrics, and the set-up's, the gate's and
    the timed part's seconds."""
    parent = os.getppid()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # its host work is launches: leave the cores to the reference phase
    torch.set_num_threads(1)
    init_state, update = WDGAILLearner.init_state, WDGAILLearner.update
    times, last = {}, {}

    def gated_init_state(self, *args, **kwargs):
        times["gate"] = time.time()
        wait_file(os.path.join(tmp, GO_FILE), parent)
        times["go"] = time.time()
        return init_state(self, *args, **kwargs)

    def kept_update(self, *args, **kwargs):
        last["state"], last["metrics"] = update(self, *args, **kwargs)
        return last["state"], last["metrics"]

    for lib in (bev_cuda.LIB, bev6_cuda.LIB):
        lib.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    t = time.time()
    WDGAILLearner.init_state = gated_init_state
    WDGAILLearner.update = kept_update
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            record = scale_mod.main(scale_argv())
        torch.cuda.synchronize()
    finally:
        WDGAILLearner.init_state, WDGAILLearner.update = init_state, update
    t_end = time.time()
    state = last["state"]
    check_finite("the scale bench's last update", last["metrics"],
                 [("policy", state.policy), ("critic", state.disc)])
    res = dict(record=record, stdout=out.getvalue(), stderr=err.getvalue(),
               b1=bev_cuda.LIB.launches, b2=bev6_cuda.LIB.launches,
               peak=torch.cuda.max_memory_allocated(),
               metrics={k: float(v) for k, v in last["metrics"].items()},
               setup_s=times["gate"] - t, gate_s=times["go"] - times["gate"],
               timed_s=t_end - times["go"])
    with open(os.path.join(tmp, "scale.json"), "w") as f:
        json.dump(res, f)
    return 0


def start_scale(tmp: str):
    """Starts ``scale_bench`` in a process of this script; it is stopped
    at this process's exit if still running."""
    log = open(os.path.join(tmp, "scale.log"), "w")
    proc = [(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--scale", tmp],
        stdout=log, stderr=subprocess.STDOUT), log)]
    atexit.register(stop_procs, proc)
    return proc


def scale_results(proc, tmp: str) -> dict:
    """Lets the scale process time its updates (``GO_FILE``), waits for it
    (at most ``SCALE_TIMEOUT_S`` s, then kills it) and returns its
    ``scale.json``; raises if it failed. Prints how long its set-up ran
    beside the reference phase, how long this process waited for it
    beyond its timed part, and so what running it here after the
    reference phase would have cost more."""
    t = time.time()
    open(os.path.join(tmp, GO_FILE), "w").close()
    p = proc[0][0]
    try:
        p.wait(timeout=SCALE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_procs(proc)
    waited = time.time() - t
    if p.returncode != 0:
        tail = open(os.path.join(tmp, "scale.log")).read()[-3000:]
        print(f"  scale bench exited {p.returncode}:\n{tail}", flush=True)
        raise AssertionError("the scale bench failed")
    res = json.load(open(os.path.join(tmp, "scale.json")))
    extra = waited - res["timed_s"]
    print(f"  scale bench: set-up {res['setup_s']:.2f} s beside the "
          f"reference phase, then {res['gate_s']:.2f} s at its gate; "
          f"waited {waited:.2f} s for it, {extra:.2f} s beyond its timed "
          f"{res['timed_s']:.2f} s: the overlap saved about "
          f"{res['setup_s'] - extra:.2f} s", flush=True)
    return res


def scale_path(res: dict, scene, net6, dev):
    """The scale phase's checks on ``scale_bench``'s result: its stderr
    echoed; raises unless the final record has the tool's keys and a
    finite positive ``value``, every phase printed its time, the expert
    buffer fills a critic minibatch, B1 never ran and B2 ran once per
    render: the expert buffer's chunks, and the rollout's steps and
    bootstrap in both updates and in the four calls of the rollout phase.
    Then the bev6 rollout step at ``SCALE_BREAKDOWN_ENVS`` envs
    (``breakdown``), beside the host-speed marker's 256. Returns B2's
    launches."""
    err, record = res["stderr"], res["record"]
    b1, b2 = res["b1"], res["b2"]
    print(f"  wdgail_scale_bench {' '.join(scale_argv())}", flush=True)
    for line in err.splitlines():
        print(f"    {line}", flush=True)
    last = json.loads(res["stdout"].strip().splitlines()[-1])
    if tuple(last) != SCALE_KEYS or last != record:
        raise AssertionError(f"scale bench record {last}")
    if not (np.isfinite(last["value"]) and last["value"] > 0):
        raise AssertionError(f"scale bench value {last['value']}")
    ms = {}
    for line in err.splitlines():
        name, _, rest = line.partition(": ")
        if name.startswith("phase ") and rest.endswith(" ms"):
            ms[name[len("phase "):]] = float(rest[:-3].replace(",", ""))
    if tuple(ms) != SCALE_PHASES:
        raise AssertionError(f"scale bench phases {tuple(ms)}")
    rows = int(err.split("expert buffer: ")[1].split()[0])
    if rows < SCALE_ENVS:
        raise AssertionError(f"the expert buffer's {rows} rows fill no "
                             f"{SCALE_ENVS}-row critic minibatch: raise "
                             "SCALE_DEMO_STEPS")
    want = -(-rows // EXPERT_CHUNK) + (2 + 4) * (SCALE_STEPS + 1)
    if b1 or b2 != want:
        raise AssertionError(f"scale bench launches B1 {b1}, B2 {b2} "
                             f"(expected 0 and {want})")
    total = sum(ms.values())
    print(f"  scale bench {SCALE_ENVS} envs x {SCALE_STEPS} steps (bev6): "
          f"{last['value']} steps/s, {last['sec_per_update']} s per update; "
          "phases " + ", ".join(
              f"{k} {v:.0f} ms ({v / total:.1%})" for k, v in ms.items())
          + f"; rollout {ms['rollout'] / SCALE_STEPS:.3f} ms per env step; "
          f"expert buffer {rows} rows; peak memory "
          f"{res['peak'] / 2**30:.2f} GiB; launches B1 {b1}, B2 {b2}; the "
          "last update's " + ", ".join(
              f"{k} {v:.6g}" for k, v in res["metrics"].items()
              if "loss" in k), flush=True)

    cfg = EnvConfig(train=True, obs_mode="bev6")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    routes = torch.tensor(make_presets()["reference"]["train"].routes,
                          device=dev)
    start = reset_batch(scene, cfg, routes[
        torch.arange(SCALE_BREAKDOWN_ENVS, device=dev) % len(routes)], gen)
    breakdown(scene, cfg, net6, gen, start,
              bev6_cuda.render_bev6_cuda_batch)
    return b2


def scale_kernels(scene):
    """B1 and B2 against their plain versions at the batches the tool
    launches them at (``SCALE_LAUNCH_ENVS``): the first n of one set of
    distinct jittered route poses, in the tool's configuration (no
    traffic), one launch per batch. Raises unless every value is equal;
    returns the max abs differences (B1, B2)."""
    ren = route_poses(scene, max(SCALE_LAUNCH_ENVS), SEED + 6)
    errs = []
    for kernel, plain, cfg in (
            (bev_cuda.render_bev_cuda_batch, bev_plain.render_bev_batch,
             EnvConfig(train=True, obs_mode="bev")),
            (bev6_cuda.render_bev6_cuda_batch, bev6_plain.render_bev6_batch,
             EnvConfig(train=True, obs_mode="bev6"))):
        name = "bev_raster" if cfg.obs_mode == "bev" else "bev6_raster"
        want = plain(scene, cfg, ren)
        err = 0.0
        for n in SCALE_LAUNCH_ENVS:
            got = kernel(scene, cfg, map_state(lambda a: a[:n], ren))
            err = max(err, compare(name, got, want[:n],
                                   f"W={cfg.bev_width} n={n} (one launch)"))
            del got
        del want
        errs.append(err)
    return tuple(errs)


def kernel_line(name, source, replaces, launches, err, times):
    k_ms, p_ms, b_ms, b_by = times
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] device {kind} | nvidia-smi: {smi}", flush=True)
    host = host_line()
    print(f"[chip_smoke] host {host}", flush=True)
    progress("device", t)

    t = time.time()
    logs = {}
    cuda_build.build_all(KERNEL_SOURCES, logs)
    for src in KERNEL_SOURCES:
        lines = [ln.strip() for ln in logs.get(src, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {src} ptxas: " + (" | ".join(lines) or
                                    "(built before this run)"), flush=True)
    progress("build", t)

    preset = make_presets()["reference"]
    env_cfg, model_cfg = preset["env"], preset["model"]
    env6_cfg = dataclasses.replace(env_cfg, obs_mode="bev6",
                                   n_npc_vehicles=N_VEHICLES,
                                   n_npc_walkers=N_WALKERS)
    w = env_cfg.bev_width
    t = time.time()
    scene = make_benchmark_scene(**preset["scene"], device=dev)
    torch.cuda.synchronize()
    print(f"  scene: {scene.n_routes} routes, cell_bnd "
          f"{tuple(scene.cell_bnd.shape)}, cell_lane "
          f"{tuple(scene.cell_lane.shape)}, cell_tl "
          f"{tuple(scene.cell_tl.shape)}, patrol_xy "
          f"{tuple(scene.patrol_xy.shape)}", flush=True)
    progress("scene", t)

    # --- each kernel vs its plain version on the card ---
    t = time.time()
    err = max(check_kernel(scene, env_cfg, ROLL_ENVS, SEED),
              check_kernel(scene, EnvConfig(bev_width=100), ROLL_ENVS,
                           SEED + 1))
    ren = route_poses(scene, ROLL_ENVS, SEED + 2)
    inp = bev_plain.bev_inputs(scene, ren)
    cs = (torch.cos(ren.yaw), torch.sin(ren.yaw))
    err_t, b1_times = time_kernel(
        "bev_raster", scene, env_cfg, ren, inp, None, cs,
        lambda: bev_cuda.render_bev_cuda(scene, env_cfg, ren, *cs),
        lambda: bev_cuda.render_bev_cuda_batch(scene, env_cfg, ren),
        lambda: bev_plain.render_bev_plain(env_cfg, inp, scene.bnd_dmax))
    err = max(err, err_t)
    progress("kernel_vs_plain bev", t)

    t = time.time()
    ren6 = bev6_states(scene, env6_cfg, ROLL_ENVS, SEED + 3)
    # envs 32-63 also on tile corners of the width checked
    cfg100 = dataclasses.replace(env6_cfg, bev_width=100)
    err6 = max(
        check_kernel6(scene, env6_cfg, tile_states(
            scene, env6_cfg, ren6, range(32, 64), SEED + 4)),
        check_kernel6(scene, cfg100, tile_states(
            scene, cfg100, ren6, range(32, 64), SEED + 5)))
    inp6 = bev6_plain.bev6_inputs(scene, env6_cfg, ren6)
    pro6 = bev6_cuda.bev6_prologue(scene, env6_cfg, ren6)
    err_t, b2_times = time_kernel(
        "bev6_raster", scene, env6_cfg, ren6, inp6,
        bev_tiles.kernel_tables(scene, ren6, inp6), pro6,
        lambda: bev6_cuda.render_bev6_cuda(scene, env6_cfg, ren6, *pro6),
        lambda: bev6_cuda.render_bev6_cuda_batch(scene, env6_cfg, ren6),
        lambda: bev6_plain.render_bev6_plain(env6_cfg, inp6,
                                             scene.bnd_dmax))
    err6 = max(err6, err_t)
    progress("kernel_vs_plain bev6", t)

    # --- the world-2 ranks of the sharded phase start now: their set-up
    # and updates run beside the reference phase (whose card-vs-CPU checks
    # are correctness gates; their times are not end-to-end metrics), and
    # the timed phases wait for their updates to end ---
    shard_dir = tempfile.TemporaryDirectory()
    procs = start_ranks(shard_dir.name)
    # --- so does the scale phase's set-up (scene, demos, expert buffer);
    # its timed updates run once the reference phase has ended ---
    scale_dir = tempfile.TemporaryDirectory()
    scale_proc = start_scale(scale_dir.name)

    # --- end to end against the CPU (plain renderers, float32 model) ---
    t = t_part = time.time()
    quiet = dict(gnss_noise_deg=0.0, random_restart_prob=0.0)
    card_vs_cpu(scene, dataclasses.replace(env_cfg, **quiet), (3, w, w),
                SEED)
    card_vs_cpu(scene, dataclasses.replace(env6_cfg, **quiet), (6, w, w),
                SEED + 1)
    progress("reference rollouts", t_part)
    t_part = time.time()
    ref = train_card_vs_cpu(SEED + 2)
    progress("reference update", t_part)
    t_part = time.time()
    demos_card_vs_cpu(SEED + 3, dev)
    progress("reference demos", t_part)
    progress("reference", t)
    wait_updated(procs, shard_dir.name)

    # --- the full-pipeline scale bench: the whole update in bev6 ---
    t = time.time()
    scale_res = scale_results(scale_proc, scale_dir.name)
    scale_dir.cleanup()
    progress("scale bench", t)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    routes = torch.tensor(preset["train"].routes, device=dev)

    # --- the bev path: evaluation, rollout, breakdown ---
    net = init_policy(model_cfg, (3, w, w), seed=SEED, device=dev)
    launches, start = drive_path(scene, env_cfg, net, gen, routes,
                                 bev_cuda.LIB)
    marker = breakdown(scene, env_cfg, net, gen, start,
                       bev_cuda.render_bev_cuda_batch)["env step"]
    print(f"[chip_smoke] host speed marker: bev env step at {ROLL_ENVS} "
          f"envs {marker:.3f} ms", flush=True)

    # --- the bev6 path with traffic: evaluation, rollout, breakdown ---
    net6 = init_policy(model_cfg, (6, w, w), seed=SEED, device=dev)
    launches6, start6 = drive_path(scene, env6_cfg, net6, gen, routes,
                                   bev6_cuda.LIB)
    breakdown(scene, env6_cfg, net6, gen, start6,
              bev6_cuda.render_bev6_cuda_batch)
    encoder_layout(net6, w, dev)

    # --- the training path: train.run on the bev path, sharded over a
    # world-1 NCCL group (kept for the sharded phase's world-1 check) ---
    t = time.time()
    group_dir = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method=f"file://{group_dir.name}"
                            "/store", rank=0, world_size=1)
    tcfg = dataclasses.replace(preset["train"], routes=TRAIN_ROUTES,
                               eval_route=TRAIN_EVAL_ROUTE)
    launches += train_path(env_cfg, model_cfg, tcfg, preset, dev)
    progress("train bev", t)

    # --- the demo-file and BC recipe: export, BC, WDGAIL, evaluation ---
    t = time.time()
    launches += tree_bc_path(scene, env_cfg, env6_cfg, model_cfg, preset,
                             gen, dev)
    progress("tree bc", t)

    # --- the gym-style API, the suites and the policy benchmarks ---
    t = time.time()
    b1, b2, err_dense, _ = suites_path(scene, env_cfg, env6_cfg, dev)
    launches += b1
    launches6 += b2
    err6 = max(err6, err_dense)
    progress("suites", t)

    # --- the options: state obs, scenario actors (B2), obstacles ---
    t = time.time()
    b2, err_sa, _ = options_path(scene, model_cfg, env6_cfg, preset, dev)
    launches6 += b2
    err6 = max(err6, err_sa)
    progress("options", t)

    # --- more than one rank: world 1 vs plain, world 2, the GPS expert ---
    t = time.time()
    launches += sharded_path(scene, ref, dev, procs, shard_dir.name)
    dist.destroy_process_group()
    group_dir.cleanup()
    shard_dir.cleanup()
    progress("sharded", t)

    # --- the reconstructed towns: the synthetic tree's Town01, B1 and B2
    # on its tables, train.run at the town01 preset, its NoCrash tier ---
    t = time.time()
    b1, b2, err_t, err6_t = town_path(env_cfg, env6_cfg, dev)
    launches += b1
    launches6 += b2
    err, err6 = max(err, err_t), max(err6, err6_t)
    progress("town", t)

    # --- the scale bench's checks, the bev6 step at 4,096 envs, and the
    # kernels at the batches the tool launches them at ---
    t = time.time()
    launches6 += scale_path(scale_res, scene, net6, dev)
    err_t, err6_t = scale_kernels(scene)
    err, err6 = max(err, err_t), max(err6, err6_t)
    progress("scale", t)

    torch.cuda.synchronize()
    print(json.dumps({"kernels": [
        kernel_line("bev_raster", "gail_carla_tpu_torch/csrc/bev_raster.cu",
                    "gail_carla_tpu/ops/bev_pallas.py:29", launches, err,
                    b1_times),
        kernel_line("bev6_raster",
                    "gail_carla_tpu_torch/csrc/bev6_raster.cu",
                    "gail_carla_tpu/ops/bev6_pallas.py:30", launches6, err6,
                    b2_times),
    ]}), flush=True)
    print(f"[chip_smoke] total {time.time() - T0:.2f}s | host {host} | "
          f"bev env step at {ROLL_ENVS} envs {marker:.3f} ms", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--shard-cost"]:
        sys.exit(shard_cost())
    if sys.argv[1:2] == ["--scale"]:
        sys.exit(scale_bench(sys.argv[2]))
    try:
        sys.exit(main())
    finally:
        # a phase that fails inside the world-1 NCCL group must not leave
        # the group's watchdog holding the process at exit
        if dist.is_initialized():
            dist.destroy_process_group()
