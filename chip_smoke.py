"""Chip smoke test of the PyTorch/CUDA port (gail_carla_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``gail_carla_tpu_torch/csrc`` into
``gail_carla_tpu_torch/_build/``, holds each kernel against its plain
PyTorch version on the card, then drives the policy path at the full
width of the ``reference`` preset (the 4x4 grid town with 10 routes, 192 px
BEV, convs 32-64-128-256, hidden 512, bfloat16 convs, random weights from a
numpy seed): deterministic evaluation on the held-out route and a rollout,
each through the entry points a user calls. It prints one progress line
per phase, a JSON line of kernel measurements, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a CUDA device it exits non-zero before
printing a result.

float32 matrix products and convolutions run in full float32: TF32 is
switched off for both (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gail_carla_tpu_torch import cuda_build
from gail_carla_tpu_torch.algo.evaluate import evaluate_policy
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig
from gail_carla_tpu_torch.convert import init_policy
from gail_carla_tpu_torch.models import policy as policy_mod
from gail_carla_tpu_torch.ops import bev as bev_plain
from gail_carla_tpu_torch.ops import bev_cuda
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import RenderState, reset_batch, step_batch
from gail_carla_tpu_torch.train import make_presets

KERNEL_SOURCES = ("bev_raster.cu",)
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
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


def bev_bound_ms(inp: bev_plain.BevInputs, w: int):
    """Least time the card could take for one render of these inputs:
    the larger of the flops this data needs (live segments only, ~12 per
    pixel and segment) over the float32 peak, and the bytes (each input
    read once, the output written once) over the memory rate."""
    counts = inp.counts.to(torch.int64)
    segs = counts[:, 0].sum() + counts[:, 1].sum()
    segs = int(segs) + inp.route.shape[0] * inp.route.shape[1]
    flops = 12.0 * w * w * segs
    nbytes = sum(t.numel() * t.element_size() for t in (
        inp.pose, inp.counts, inp.bnd, inp.lane, inp.lane_val, inp.lane_w,
        inp.route)) + inp.pose.shape[0] * 3 * w * w * 4
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def check_kernel(scene, cfg: EnvConfig, n: int, seed: int):
    """Kernel vs plain version on the same fetched inputs; raises unless
    every value is equal, and returns the max abs difference."""
    inp = bev_plain.bev_inputs(scene, route_poses(scene, n, seed))
    a = bev_cuda.render_bev_cuda(cfg, inp, scene.bnd_dmax)
    b = bev_plain.render_bev_plain(cfg, inp, scene.bnd_dmax)
    torch.cuda.synchronize()
    if a.shape != (n, 3, cfg.bev_width, cfg.bev_width):
        raise AssertionError(f"kernel output shape {tuple(a.shape)}")
    diff = int((a != b).sum())
    err = float((a - b).abs().max())
    print(f"  bev_raster W={cfg.bev_width} n={n}: {diff} of {a.numel()} "
          f"values differ, max abs err {err}", flush=True)
    if diff != 0:
        raise AssertionError(f"kernel and plain version differ at {diff} "
                             f"values (W={cfg.bev_width})")
    return err


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
    cuda_build.build_all(KERNEL_SOURCES)
    progress("build", t)

    preset = make_presets()["reference"]
    env_cfg, model_cfg = preset["env"], preset["model"]
    t = time.time()
    scene = make_benchmark_scene(**preset["scene"], device=dev)
    torch.cuda.synchronize()
    print(f"  scene: {scene.n_routes} routes, cell_bnd "
          f"{tuple(scene.cell_bnd.shape)}, cell_lane "
          f"{tuple(scene.cell_lane.shape)}", flush=True)
    progress("scene", t)

    # --- kernel vs plain version on the card ---
    t = time.time()
    err = max(check_kernel(scene, env_cfg, 64, SEED),
              check_kernel(scene, EnvConfig(bev_width=100), 64, SEED + 1))
    inp = bev_plain.bev_inputs(scene, route_poses(scene, 256, SEED + 2))
    w = env_cfg.bev_width
    k_ms = cuda_ms(lambda: bev_cuda.render_bev_cuda(
        env_cfg, inp, scene.bnd_dmax))
    p_ms = cuda_ms(lambda: bev_plain.render_bev_plain(
        env_cfg, inp, scene.bnd_dmax), iters=3, warmup=1)
    b_ms, b_by = bev_bound_ms(inp, w)
    print(f"  bev_raster 256 envs x {w} px: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    progress("kernel_vs_plain", t)

    # --- end to end against the CPU (plain renderer, float32 model) ---
    t = time.time()
    ref_cfg = EnvConfig(gnss_noise_deg=0.0, random_restart_prob=0.0)
    f32_cfg = ModelConfig(dtype="float32")
    noise = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (6, 4, 2)).astype(np.float32))
    outs = []
    for d in (dev, torch.device("cpu")):
        sc = scene.to(d)
        net = init_policy(f32_cfg, seed=SEED, device=d)
        st, met, ren = reset_batch(sc, ref_cfg, torch.arange(4, device=d))
        _, _, _, ro, _ = collect_rollout(sc, ref_cfg, net, st, met, ren,
                                         None, 6, action_noise=noise.to(d))
        outs.append(ro)
    g, c = outs
    if not torch.equal(g.render.head.cpu(), c.render.head):
        raise AssertionError("route cursors differ between card and CPU")
    pos_err = float((g.render.xy.cpu() - c.render.xy).abs().max())
    val_err = float((g.values.cpu() - c.values).abs().max())
    print(f"  card vs CPU rollout (4 envs x 6 steps, float32): max |dxy| "
          f"{pos_err:.3e} m, max |dvalue| {val_err:.3e}", flush=True)
    if pos_err > 1e-3 or val_err > 1e-3:
        raise AssertionError("card and CPU rollouts disagree")
    progress("reference", t)

    net = init_policy(model_cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # --- the main path: evaluation, then a rollout ---
    bev_cuda.LIB.launches = 0
    t = time.time()
    ev = evaluate_policy(scene, env_cfg, net, gen, route_id=3, n_envs=16,
                         max_steps=200)
    torch.cuda.synchronize()
    if not torch.isfinite(ev["reward"]).all():
        raise AssertionError("non-finite evaluation reward")
    print(f"  evaluate_policy route 3, 16 envs x 200 steps: "
          f"{int(ev['done'].sum())} episodes ended, mean score_route "
          f"{float(ev['score_route'].float().mean()):.3f}", flush=True)
    progress("evaluate", t)
    eval_launches = bev_cuda.LIB.launches

    t = time.time()
    n_envs, n_steps = 256, 32
    routes = torch.tensor(preset["train"].routes, device=dev)
    route_ids = routes[torch.arange(n_envs, device=dev) % len(routes)]
    st, met, ren = reset_batch(scene, env_cfg, route_ids, gen)
    torch.cuda.synchronize()
    t_roll = time.time()
    _, _, _, ro, stats = collect_rollout(scene, env_cfg, net, st, met, ren,
                                         gen, n_steps)
    torch.cuda.synchronize()
    dt_roll = time.time() - t_roll
    launches = bev_cuda.LIB.launches
    roll_launches = launches - eval_launches
    for name, v in (("values", ro.values), ("logp", ro.logp),
                    ("rewards", ro.env_rewards)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite rollout {name}")
    if ro.values.shape != (n_steps + 1, n_envs):
        raise AssertionError(f"rollout values shape {tuple(ro.values.shape)}")
    if eval_launches != 200 or roll_launches != n_steps + 1:
        raise AssertionError(
            f"kernel launches {eval_launches} + {roll_launches} != renders "
            f"issued 200 + {n_steps + 1}"
        )
    print(f"  collect_rollout {n_envs} envs x {n_steps} steps: "
          f"{n_envs * n_steps / dt_roll:.1f} env-steps/s, "
          f"{int(stats['n_episodes'])} episodes ended, bev_raster launches "
          f"{roll_launches} (1 per step + bootstrap)", flush=True)
    progress("rollout", t)

    # --- where a rollout step's time goes, at the rollout's batch ---
    t = time.time()
    obs = bev_cuda.render_bev_cuda_batch(scene, env_cfg, ren)

    def act():
        return policy_mod.act(net, obs, met, gen)

    action = act()[1]
    parts = {
        "render (fetch + kernel)": cuda_ms(
            lambda: bev_cuda.render_bev_cuda_batch(scene, env_cfg, ren)),
        "policy act": cuda_ms(act),
        "env step": cuda_ms(
            lambda: step_batch(scene, env_cfg, st, action, gen)),
    }
    print(f"  rollout step at {n_envs} envs: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    t_roll = time.time()
    collect_rollout(scene, env_cfg, net, st, met, ren, gen, n_steps)
    torch.cuda.synchronize()
    print(f"  warm collect_rollout {n_envs} envs x {n_steps} steps: "
          f"{n_envs * n_steps / (time.time() - t_roll):.1f} env-steps/s",
          flush=True)
    progress("breakdown", t)

    torch.cuda.synchronize()
    print(json.dumps({"kernels": [{
        "name": "bev_raster",
        "route": "cuda",
        "source": "gail_carla_tpu_torch/csrc/bev_raster.cu",
        "replaces": "gail_carla_tpu/ops/bev_pallas.py:29",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]}), flush=True)
    print(f"[chip_smoke] total {time.time() - T0:.2f}s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
