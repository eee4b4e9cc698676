"""The traced run's readings: one update or chunk under ``torch.profiler``
(device time per kernel, the union of device intervals, the idle gaps and
what the host was doing in each), and the layers timed alone after the
window (the ``_time_phases`` pattern of the port's scale bench: each part
called by itself, synchronised, on the host clock)."""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

import torch

from bench_port import flops
from bench_port.harness import feed as feed_mod

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn, device):
    """Runs ``fn`` once under the profiler; returns the trace's reading:
    kernels [(name, seconds, grid)], busy_s, window_s, breakdown."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read_trace(events, wall)


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(events, wall: float) -> dict:
    dev, cpu = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat == "cpu_op":
            cpu.append(e)
    kernels = [(e["name"], e["dur"] * 1e-6,
                tuple(e.get("args", {}).get("grid", ()) or ()))
               for e in dev if e.get("cat") == "kernel"]
    busy = union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    if cpu:
        lo = min(e["ts"] for e in cpu)
        hi = max(max(e["ts"] + e["dur"] for e in cpu), busy[-1][1]
                 if busy else 0)
        window_us = hi - lo
    else:
        lo, window_us = (busy[0][0] if busy else 0), wall * 1e6
    # idle gaps, named by the innermost host op running at their middle
    gaps = []
    edges = [lo] + [x for ab in busy for x in ab] + [lo + window_us]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    cpu.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in cpu]
    by_host = collections.Counter()
    for a, b in gaps:
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid)
        name, best = "host outside any op", None
        for e in cpu[max(0, k - 400):k]:
            if e["ts"] <= mid <= e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best):
                name, best = e["name"], e["dur"]
        by_host[name] += (b - a) * 1e-6
    by_kernel = collections.Counter()
    for name, s, _ in kernels:
        by_kernel[name] += s
    return {
        "kernels": kernels,
        "busy_s": busy_us * 1e-6,
        "window_s": window_us * 1e-6,
        "breakdown": {
            "device_ops": [[n, s] for n, s in by_kernel.most_common(10)],
            "idle_gaps": [[n, s] for n, s in by_host.most_common(10)],
        },
    }


def render_roofline(trace, kernel: str, channels: int, width: int,
                    n_vehicles=0, n_walkers=0, n_lights=0):
    """Share (%) of the bytes bound in the time of every launch of the
    render kernel named ``kernel`` (the env count is the launch's grid.y);
    None if none ran."""
    bound = took = 0.0
    for name, s, grid in trace["kernels"]:
        if is_kernel(name, kernel) and len(grid) >= 2:
            bound += flops.render_bytes(grid[1], channels, width, n_vehicles,
                                        n_walkers, n_lights) / flops.PEAK_BYTES
            took += s
    return flops.roofline_share(bound, took) if took else None


def timed(fn, device, reps: int = 1) -> float:
    """Seconds per call of ``fn`` over ``reps`` calls, synchronised."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps


def is_kernel(name: str, kernel: str) -> bool:
    """``name`` (demangled, or mangled: ``raster_kernelILb1EE``) is
    ``kernel`` (``raster_kernel<true>`` or ``<false>``)."""
    if kernel in name:
        return True
    base, _, arg = kernel.partition("<")
    mangled = {"true>": "ILb1E", "false>": "ILb0E"}.get(arg)
    return base in name and mangled is not None and mangled in name


def kernel_name(obs_mode: str) -> str:
    """The CUDA kernel of the cell's renderer (csrc/bev_raster_common.cuh:
    B2 is ``raster_kernel<true>``, B1 ``raster_kernel<false>``)."""
    return "raster_kernel<true>" if obs_mode == "bev6" else \
        "raster_kernel<false>"


def train_context(cell, su, seed, device, n_up, window_s) -> dict:
    """The readings of a training cell's traced run: one more update
    profiled, then each part of the update timed alone."""
    from gail_carla_tpu_torch.algo import ppo as ppo_mod
    from gail_carla_tpu_torch.algo import wdgail as wdgail_mod
    from gail_carla_tpu_torch.algo.rollout import collect_rollout
    from gail_carla_tpu_torch.ops.gae import compute_returns
    from bench_port.harness.train_cell import FOLLOWED, update_draws

    learner = su.learner
    tcfg, env_cfg, scene = learner.tcfg, learner.env_cfg, learner.scene
    i = FOLLOWED + n_up + 1     # after set-up's updates and the window's
    f = feed_mod.train_feed(su.fscene, su.fcfg, su.ftcfg,
                            learner.expert.size, i, seed)

    def one_update():
        su.state, _ = learner.update(su.state, update_draws(f))

    trace = profile(one_update, device)
    st = su.state
    f = feed_mod.train_feed(su.fscene, su.fcfg, su.ftcfg,
                            learner.expert.size, i + 1, seed)
    out = {}

    def f_roll():
        out["roll"] = collect_rollout(
            scene, env_cfg, st.policy, st.env_states, st.metrics, st.render,
            None, tcfg.steps_per_env, learner.store_obs,
            action_noise=f.action_noise, env_draws=f.env_draws)

    phases = {"rollout": timed(f_roll, device)}
    rollout = out["roll"][3]
    phases["critic_epoch"] = timed(lambda: wdgail_mod.disc_update(
        scene, env_cfg, tcfg, st.disc, learner.disc_optimizer, st.disc_opt,
        rollout, learner.expert, None, 1, f.disc[:1]), device)

    def f_rel():
        out["gail"] = wdgail_mod.relabel_rewards(scene, env_cfg, st.disc,
                                                 rollout)

    phases["relabel"] = timed(f_rel, device)
    rollout.gail_rewards = out["gail"]
    returns = compute_returns(rollout.gail_rewards, rollout.env_rewards,
                              rollout.values, rollout.masks, tcfg.gamma,
                              tcfg.gae_lambda)
    phases["ppo"] = timed(lambda: ppo_mod.ppo_update(
        scene, env_cfg, tcfg, st.policy, learner.policy_optimizer,
        st.policy_opt, rollout, returns, None, st.gail_gamma, None,
        perms=f.ppo_perms), device)
    tr = cell.workload["traffic"]
    c = cell.config
    shape = (6 if c["obs_mode"] == "bev6" else 3, c["bev_width"],
             c["bev_width"])
    # updates >= gail_thre run gail_epoch critic epochs (the window's)
    per_update = flops.update_flops(
        c["model"], shape, tr["n_envs"], tr["steps_per_env"],
        learner.expert.size, tr["gail_batch"], tr["gail_epoch"],
        tr["ppo_epoch"], tr["mini_batch"])
    return {"entry": "train", "phases": phases, "trace": trace,
            "cell": cell, "kernel": kernel_name(c["obs_mode"]),
            "channels": shape[0], "width": c["bev_width"],
            "n_vehicles": tr["n_npc_vehicles"],
            "n_walkers": tr["n_npc_walkers"],
            "n_lights": int(su.fscene.tl_stop.shape[0]),
            "mfu": 100.0 * per_update * n_up / window_s / flops.PEAK_BF16}
