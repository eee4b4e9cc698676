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
  ``bev6_raster`` (the TPU kernel ``ops/bev6_pallas.py``);
- the ``"train bev"`` path: ``train.run`` at the reference preset: the
  scripted expert's demos with noise (``generate_demos``) on the 9
  training routes and the held-out route, the expert and validation
  buffers, two updates (10 envs x 720 steps, the packed observation
  store, critic epochs 6 then 5 with the gradient penalty, 16 PPO epochs
  of 128-sample minibatches), the evaluation on the held-out route, the
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
  ``DEMO_TOL``.

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

It prints one progress line per phase (with ``ptxas``'s registers,
shared memory and spills of each build), a per-step time breakdown of
each path, a JSON line of kernel measurements, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without a CUDA device it exits
non-zero before printing a result.

float32 matrix products and convolutions run in full float32: TF32 is
switched off for both (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gail_carla_tpu_torch import cuda_build
from gail_carla_tpu_torch import train as train_mod
from gail_carla_tpu_torch.algo import bc as bc_mod
from gail_carla_tpu_torch.algo import learner as learner_mod
from gail_carla_tpu_torch.algo import ppo as ppo_mod
from gail_carla_tpu_torch.algo import wdgail as wdgail_mod
from gail_carla_tpu_torch.algo.buffers import (
    EXPERT_CHUNK,
    build_expert_buffer, fetch_rollout_obs, map_state, pack_bev_obs,
    unpack_bev_obs,
)
from gail_carla_tpu_torch.algo.evaluate import evaluate_policy
from gail_carla_tpu_torch.algo.expert import (
    DemoBatch, DemoDraws, draw_demos, generate_demos,
)
from gail_carla_tpu_torch.algo.learner import UpdateDraws, WDGAILLearner
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig
from gail_carla_tpu_torch.convert import (
    init_critic_flax_params, init_flax_params, init_policy,
)
from gail_carla_tpu_torch.models import policy as policy_mod
from gail_carla_tpu_torch.ops import bev as bev_plain
from gail_carla_tpu_torch.ops import bev6 as bev6_plain
from gail_carla_tpu_torch.ops import bev6_cuda, bev_cuda, bev_tiles
from gail_carla_tpu_torch.ops.bev import INV_255, ROUTE_HALF_W
from gail_carla_tpu_torch.ops.bev_full import TL_LINE_HALF_W, render_bev_full
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import (
    RenderState, draw_gnss, draw_reset, draw_step, reset_batch, step_batch,
)
from gail_carla_tpu_torch.sim.traffic import step_traffic
from gail_carla_tpu_torch.tools import evaluation as evaluation_mod
from gail_carla_tpu_torch.tools import gen_trajectories as gen_mod
from gail_carla_tpu_torch.tools import learn_bc as learn_bc_mod
from gail_carla_tpu_torch.train import make_presets
from gail_carla_tpu_torch.utils import checkpoint as ckpt_mod
from gail_carla_tpu_torch.utils.logging import TAG_MAP
from gail_carla_tpu_torch.utils.png import read_png

KERNEL_SOURCES = ("bev_raster.cu", "bev6_raster.cu")
# NoCrash "regular" Town01 traffic (gail_carla_tpu/envs/suites.py:40-46)
N_VEHICLES, N_WALKERS = 20, 50
# depth of each path: evaluation on the held-out route, then a rollout
EVAL_ROUTE, EVAL_ENVS, EVAL_STEPS = 3, 16, 200
ROLL_ENVS, ROLL_STEPS = 256, 32
# the training phase: train.run at the reference preset (TrainConfig(
# n_envs=10): 720 steps per env), cut to TRAIN_UPDATES updates and
# DEMO_STEPS expert steps per route (the preset's 4,000 cut: on the CPU
# with the same seeds every training route's first episode ends by step
# 1,487 and route 3's by 1,166; the card draws another stream, hence the
# margin)
TRAIN_UPDATES, DEMO_STEPS = 2, 1600
# the card-vs-CPU update's expert demos: route 0 of the smoke scene ends
# its first episode near step 520
SMOKE_DEMO_STEPS = 600
# card-vs-CPU demos: actions, metrics and positions (closed loop, 200
# steps, float32 sin/cos of the two devices)
DEMO_TOL = 1e-4
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
TREE_ROUTES, TREE_STEPS = 10, 32
BC_EPOCHS = 3
TREE_UPDATE_STEPS = 64
TREE_EVAL_STEPS = 300
RING_STEPS = 22
CMP_ROUTES, CMP_STEPS = 2, 20
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
    corners for this width (``ops/bev6.py::place_in_view``)."""
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
    """The training path at the reference preset through ``train.run``:
    the scripted expert's demos (``DEMO_STEPS`` steps on the training
    routes and on the held-out route), the expert and validation buffers,
    ``TRAIN_UPDATES`` updates with the packed observation store, the
    evaluation on the held-out route, the metrics log and the checkpoints,
    in a temporary directory. Every launch count is set to 0 just before
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
                ckpt_dir=ckpt_dir, device=dev)
        torch.cuda.synchronize()
        launches = bev_cuda.LIB.launches
        if bev6_cuda.LIB.launches:
            raise AssertionError("B2 was launched on the bev training path")
        updates = probe.of("update")
        if len(updates) != TRAIN_UPDATES:
            raise AssertionError(f"{len(updates)} updates ran")
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
    with 3 NPC vehicles and 3 walkers, 2 envs x 200 steps on the smoke
    scene, on the card and on the CPU with the same draws (made on the
    CPU): the only run of the expert's signal and hazard caps on the card.
    Raises unless actions, metrics and positions agree within
    ``DEMO_TOL`` and ``valid`` is equal."""
    smoke = make_presets()["smoke"]
    cfg = train_mod.demo_config(dataclasses.replace(
        smoke["env"], obs_mode="bev6", n_npc_vehicles=3, n_npc_walkers=3))
    n, n_steps = 2, 200
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


def train_card_vs_cpu(seed: int):
    """One float32 update at the smoke preset (64 px, convs 8-16, 4 envs x
    ``SMOKE_STEPS_PER_ENV`` steps) on the card and on the CPU from the same
    weights, reset and draws (made on the CPU), with the same expert rows
    (the scripted expert's); raises unless the losses and aux agree within
    the CPU tests' tolerance and the new weights within ``PARAM_ATOL``."""
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
        dd = dataclasses.replace(
            draws, action_noise=draws.action_noise.to(d),
            env_draws=[to_device(e, d) for e in draws.env_draws],
            disc=[to_device(e, d) for e in draws.disc],
            ppo_perms=draws.ppo_perms.to(d), val_pre=draws.val_pre.to(d),
            val_post=draws.val_post.to(d))
        state, metrics = learner.update(state, dd)
        outs.append((expert, state, metrics))
    (ge, gs, gm), (ce, cs, cm) = outs
    if not torch.equal(ge.obs.cpu(), ce.obs):
        raise AssertionError("the expert's packed obs differ between card "
                             "and CPU")
    worst_rel = 0.0
    for k, v in cm.items():
        a, b = float(gm[k]), float(v)
        if abs(a - b) > LOSS_ATOL + LOSS_RTOL * abs(b):
            raise AssertionError(f"card vs CPU update: {k} {a} vs {b}")
        worst_rel = max(worst_rel, abs(a - b) / max(abs(b), 1e-30))
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

    # --- end to end against the CPU (plain renderers, float32 model) ---
    t = time.time()
    quiet = dict(gnss_noise_deg=0.0, random_restart_prob=0.0)
    card_vs_cpu(scene, dataclasses.replace(env_cfg, **quiet), (3, w, w),
                SEED)
    card_vs_cpu(scene, dataclasses.replace(env6_cfg, **quiet), (6, w, w),
                SEED + 1)
    train_card_vs_cpu(SEED + 2)
    demos_card_vs_cpu(SEED + 3, dev)
    progress("reference", t)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    routes = torch.tensor(preset["train"].routes, device=dev)

    # --- the bev path: evaluation, rollout, breakdown ---
    net = init_policy(model_cfg, (3, w, w), seed=SEED, device=dev)
    launches, start = drive_path(scene, env_cfg, net, gen, routes,
                                 bev_cuda.LIB)
    breakdown(scene, env_cfg, net, gen, start,
              bev_cuda.render_bev_cuda_batch)

    # --- the bev6 path with traffic: evaluation, rollout, breakdown ---
    net6 = init_policy(model_cfg, (6, w, w), seed=SEED, device=dev)
    launches6, start6 = drive_path(scene, env6_cfg, net6, gen, routes,
                                   bev6_cuda.LIB)
    breakdown(scene, env6_cfg, net6, gen, start6,
              bev6_cuda.render_bev6_cuda_batch)

    # --- the training path: train.run on the bev path ---
    t = time.time()
    launches += train_path(env_cfg, model_cfg, preset["train"], preset,
                           dev)
    progress("train bev", t)

    # --- the demo-file and BC recipe: export, BC, WDGAIL, evaluation ---
    t = time.time()
    launches += tree_bc_path(scene, env_cfg, env6_cfg, model_cfg, preset,
                             gen, dev)
    progress("tree bc", t)

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
    print(f"[chip_smoke] total {time.time() - T0:.2f}s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
