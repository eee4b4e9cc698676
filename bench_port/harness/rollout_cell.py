"""A rollout cell: the window drives ``algo/rollout.py::collect_rollout``
(entry ``rollout``, ``store_obs=False``) in chunks of steps, the envs'
state carried from chunk to chunk, as closed-loop evaluation and the
acting half of training step the policy in traffic.

Set-up builds the scene, the policy from the seed and the envs' reset,
and runs one chunk. The window runs chunks for ``--seconds``; of a few
chunks drawn from the seed it keeps a sample of envs' state at the
chunk's start and what the chunk produced for them. After it, the
reference follows those envs through those chunks from the program's
state, step by step (``reference/check.py``)."""
from __future__ import annotations

import dataclasses
import time

import torch

from bench_port import flops
from bench_port.harness import feed as feed_mod
from bench_port.harness import weights as wmod
from bench_port.harness.driver import sync
from bench_port.harness.train_cell import configs, cpu, obs_shape, render_fn
from bench_port.plain_reference import check
from bench_port.plain_reference.frozen import config as fconf
from bench_port.plain_reference.frozen.sim import env as f_env
from bench_port.plain_reference.nets import make_nets, strict_float32


RATE, UNIT = "rollout_steps_per_s", "chunks"
WARM_CHUNKS = 1     # chunks set-up runs (every shape the window uses)
SIM_ENVS = 128      # envs the reference follows through each kept chunk
CHUNKS = 3          # chunks kept for the reference, drawn from the seed
CHUNK_POOL = 6      # among the window's first CHUNK_POOL
PHASE_REPS = 10     # calls of the act and of the env step timed alone


@dataclasses.dataclass
class Kept:
    chunk: int
    state0: object      # the sample envs' WorldState at the chunk's start
    rollout: object     # their rollout leaves


@dataclasses.dataclass
class Setup:
    scene: object
    env_cfg: object
    policy: object
    fscene: object
    fcfg: object
    st: object
    metrics: torch.Tensor
    render: object
    sample_envs: torch.Tensor
    render0: object
    metrics0: torch.Tensor
    check_chunks: set


def setup(cell, seed: int, device) -> Setup:
    from gail_carla_tpu_torch import config as pconf
    from gail_carla_tpu_torch.convert import policy_from_flax
    from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
    from gail_carla_tpu_torch.sim.env import reset_batch

    c, tr = cell.config, cell.workload["traffic"]
    env_cfg, model_cfg, _ = configs(cell, pconf)
    fcfg, _, _ = configs(cell, fconf)
    scene = make_benchmark_scene(**c["scene"], device=device)
    fscene = feed_mod.frozen_scene(c["scene"], device)
    params = wmod.to_host(wmod.make_params(c["model"], obs_shape(cell),
                                           False, seed, device))
    policy = policy_from_flax(params, model_cfg, obs_shape(cell), device)
    n = tr["n_envs"]
    rids = feed_mod.route_ids(tr["routes"], n, device)
    rdraws, gnss = feed_mod.reset_draws(fscene, fcfg, n, seed)
    st, metrics, render = reset_batch(scene, env_cfg, rids, draws=rdraws,
                                      gnss_noise=gnss)
    g = feed_mod.generator(device, seed, "sample")
    envs = torch.randperm(n, generator=g, device=device)[:SIM_ENVS]
    picks = torch.randperm(CHUNK_POOL, generator=g, device=device)
    su = Setup(scene, env_cfg, policy, fscene, fcfg, st, metrics, render,
               envs, cpu(feed_mod.take_envs(render, envs)),
               metrics[envs].cpu(),
               {1 + int(x) for x in picks[:CHUNKS]})
    for _ in range(WARM_CHUNKS):
        run_chunk(cell, su, seed, 0)
    return su


def run_chunk(cell, su: Setup, seed: int, chunk: int, keep=None):
    from gail_carla_tpu_torch.algo.rollout import collect_rollout

    tr = cell.workload["traffic"]
    n, T = tr["n_envs"], tr["steps_per_chunk"]
    dev = su.metrics.device
    place = ("chunk", chunk)
    noise = feed_mod.action_noise(dev, T, n, seed, place)
    draws = feed_mod.StepDrawSeq(su.fscene, su.fcfg, n, T, seed, place)
    st0 = su.st
    if keep is not None:
        st0_kept = cpu(feed_mod.take_envs(st0, su.sample_envs))
    su.st, su.metrics, su.render, ro, _ = collect_rollout(
        su.scene, su.env_cfg, su.policy, st0, su.metrics, su.render, None,
        T, False, action_noise=noise, env_draws=draws)
    if keep is not None:
        e = su.sample_envs
        keep.append(Kept(chunk, st0_kept, cpu(dataclasses.replace(
            ro, render=feed_mod.take_envs(ro.render, (slice(None), e)),
            metrics=ro.metrics[:, e], actions=ro.actions[:, e],
            logp=ro.logp[:, e], values=ro.values[:, e],
            env_rewards=ro.env_rewards[:, e], masks=ro.masks[:, e],
            gail_rewards=ro.gail_rewards[:, e]))))
    return ~(torch.isfinite(ro.values).all() & torch.isfinite(
        ro.actions).all())


def window(cell, su: Setup, seed: int, seconds: float, device):
    """(chunks, env-steps, seconds, chunks with non-finite outputs, the
    sampled chunks kept for the reference)."""
    tr = cell.workload["traffic"]
    kept, bad = [], []
    chunk = 0
    t0 = time.perf_counter()
    while True:
        chunk += 1
        bad.append(run_chunk(cell, su, seed, chunk,
                             kept if chunk in su.check_chunks else None))
        sync(device)
        dt = time.perf_counter() - t0
        if dt >= seconds:
            break
    missing = su.check_chunks - {k.chunk for k in kept}
    if missing:
        raise RuntimeError(f"the window ended before chunks {missing}: "
                           "the check's pool is longer than the window")
    steps = chunk * tr["n_envs"] * tr["steps_per_chunk"]
    return chunk, steps, dt, int(torch.stack(bad).sum()), kept


def reference_numbers(cell, su: Setup, kept, seed: int, device,
                      control: bool) -> dict:
    strict_float32()
    c, tr = cell.config, cell.workload["traffic"]
    n, T = tr["n_envs"], tr["steps_per_chunk"]
    fscene, fcfg = su.fscene, su.fcfg
    params = wmod.make_params(c["model"], obs_shape(cell), False, seed,
                              device)
    pol, _ = make_nets(c["model"], obs_shape(cell), params, None, device)
    other_pol = (make_nets(c["model"], obs_shape(cell), params, None, device,
                           "fp8")[0] if control else None)
    std = torch.exp(torch.tensor(c["model"]["logstd"], device=device))
    envs = su.sample_envs.to(device)
    rfn = render_fn(cell)
    # the start: the reference's own reset of the sample envs
    rids = feed_mod.route_ids(tr["routes"], n, device)[envs]
    rdraws, gnss = feed_mod.reset_draws(fscene, fcfg, n, seed)
    _, m_ref, r_ref = f_env.reset_batch(
        fscene, fcfg, rids, draws=feed_mod.take_envs(rdraws, envs),
        gnss_noise=gnss[envs])
    r0 = check.map_tensors(lambda t: t.to(device), check.frozen(su.render0))
    bad = int(check.step_bad(r0, su.metrics0.to(device), r_ref, m_ref).sum())
    total = envs.numel()
    value_gap = action_gap = 0.0
    for k in kept:
        ro = check.map_tensors(lambda t: t.to(device), k.rollout)
        st0 = check.map_tensors(lambda t: t.to(device), check.frozen(k.state0))
        S = envs.numel()
        flat = check.map_tensors(
            lambda x: x.reshape(((T + 1) * S,) + x.shape[2:]),
            check.frozen(ro.render))
        obs = check.obs_rows(fscene, fcfg, flat, ro.metrics.reshape(-1, 4),
                             rfn)
        v, mu, v_scale = check.policy_outputs(pol, fcfg, obs,
                                                 ro.metrics.reshape(-1, 4))
        v, mu = v.reshape(T + 1, S), mu.reshape(T + 1, S, 2)[:T]
        noise = feed_mod.action_noise(device, T, n, seed,
                                      ("chunk", k.chunk))[:, envs]
        if control:
            v2, mu2, _ = check.policy_outputs(other_pol, fcfg, obs,
                                                 ro.metrics.reshape(-1, 4))
            v2, mu2 = v2.reshape(T + 1, S), mu2.reshape(T + 1, S, 2)[:T]
        else:
            v2, mu2 = ro.values, ro.actions - std * noise
        value_gap = max(value_gap, check.rel_to(v2.reshape(-1),
                                                v.reshape(-1), v_scale))
        action_gap = max(action_gap, float(((mu2 - mu).abs() / std).max()))
        draws = feed_mod.StepDrawSeq(fscene, fcfg, n, T, seed,
                                     ("chunk", k.chunk), envs=envs)
        ref = check.follow_sim(fscene, fcfg, st0, ro.actions, draws)
        other = (check.follow_sim(fscene, fcfg, st0, ro.actions, draws, True)
                 if control else check.trace_of_rollout(ro))
        b, m = check.sim_mismatches(other, ref)
        bad += b
        total += m
    return {"value_gap": value_gap, "action_gap": action_gap,
            "sim_mismatch": bad / total}


def traced_context(cell, su: Setup, seed, device, chunks, window_s) -> dict:
    from bench_port.harness import traced
    from gail_carla_tpu_torch.algo.buffers import obs_batch
    from gail_carla_tpu_torch.models import policy as policy_mod
    from gail_carla_tpu_torch.sim.env import step_batch

    c, tr = cell.config, cell.workload["traffic"]
    n, T = tr["n_envs"], tr["steps_per_chunk"]
    trace = traced.profile(lambda: run_chunk(cell, su, seed, chunks + 1),
                           device)
    dev = su.metrics.device
    place = ("chunk", chunks + 2)
    noise = feed_mod.action_noise(dev, T, n, seed, place)
    draws = feed_mod.StepDrawSeq(su.fscene, su.fcfg, n, T, seed, place)[0]
    obs = obs_batch(su.scene, su.env_cfg, su.render, su.metrics)
    reps = PHASE_REPS
    out = {}

    def act():
        out["a"] = policy_mod.act(su.policy, obs, su.metrics, noise=noise[0])

    phases = {"act": traced.timed(act, device, reps)}
    action = out["a"][1]
    phases["env_step"] = traced.timed(lambda: step_batch(
        su.scene, su.env_cfg, su.st, action, None, **draws._asdict()),
        device, reps)
    per_chunk = flops.chunk_flops(c["model"], obs_shape(cell), n, T)
    return {"entry": "rollout", "phases": phases, "trace": trace,
            "kernel": traced.kernel_name(c["obs_mode"]),
            "width": c["bev_width"], "n_vehicles": tr["n_npc_vehicles"],
            "n_walkers": tr["n_npc_walkers"],
            "n_lights": int(su.fscene.tl_stop.shape[0]),
            "mfu": 100.0 * per_chunk * chunks / window_s / flops.PEAK_BF16}


def release(su: Setup) -> None:
    su.scene = su.policy = su.st = su.metrics = su.render = None
