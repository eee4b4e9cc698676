"""A training cell: the window drives ``WDGAILLearner.update`` (entry
``train``).

Set-up builds one learner from the seed (scene, expert rows, weights, the
envs' reset) and drives it through its first ``FOLLOWED`` updates with
the window's own call and feed, recording what the last of them produced
(``StageTap``, ``StepTap``) and the gradients of every optimizer step
before it. Those updates also warm every shape the window uses. The
window then runs whole updates for ``--seconds``. After it, the program
is freed and the reference follows the recorded update step by step
(``plain_reference/follow.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch
from torch.overrides import TorchFunctionMode

from bench_port.harness import feed as feed_mod
from bench_port.harness import weights as wmod
from bench_port.harness.driver import say, sync
from bench_port.plain_reference import check, follow
from bench_port.plain_reference.frozen import config as fconf
from bench_port.plain_reference.frozen.ops import bev as f_bev
from bench_port.plain_reference.frozen.ops import bev6 as f_bev6
from bench_port.plain_reference.frozen.sim import env as f_env
from bench_port.plain_reference.nets import strict_float32


RATE, UNIT = "train_steps_per_s", "updates"
# set-up runs updates 1 to FOLLOWED and records the last of them, which
# the reference follows: the window's form of update (one critic epoch
# from update ``gail_thre`` on) with the state that update 1 carried
FOLLOWED = 2
SIM_ENVS = 256          # envs the reference's simulator follows
RENDER_ROWS = 1024      # stored frames compared with the plain renderer
# the update's losses whose finiteness the window checks
WINDOW_LOSSES = ("ppo/value_loss", "disc/dis_total_loss")


def configs(cell, config_cls):
    """(EnvConfig, ModelConfig, TrainConfig) of the cell, of the program's
    classes or of the frozen reference's (``config_cls`` the module)."""
    c, tr = cell.config, cell.workload["traffic"]
    env = config_cls.EnvConfig(
        train=True, obs_mode=c["obs_mode"], bev_width=c["bev_width"],
        n_npc_vehicles=tr["n_npc_vehicles"], n_npc_walkers=tr["n_npc_walkers"])
    # "nets" is the harness's key (bench_port/nets/); a key that only a
    # configuration's own nets read reaches the program's ModelConfig,
    # which raises if the program lacks it, and not the frozen one
    m = {k: tuple(v) if isinstance(v, list) else v
         for k, v in c["model"].items() if k != "nets"}
    if config_cls is fconf:
        names = {f.name for f in dataclasses.fields(fconf.ModelConfig)}
        m = {k: v for k, v in m.items() if k in names}
    model = config_cls.ModelConfig(**m)
    if cell.workload["entry"] != "train":
        return env, model, None
    tcfg = config_cls.TrainConfig(
        n_envs=tr["n_envs"], num_steps=tr["n_envs"] * tr["steps_per_env"],
        mini_batch_size=tr["mini_batch"], ppo_epoch=tr["ppo_epoch"],
        gail_batch_size=tr["gail_batch"],
        gail_pre_epoch=tr["gail_pre_epoch"], gail_epoch=tr["gail_epoch"],
        gail_thre=tr["gail_thre"], routes=tuple(c["routes"]))
    return env, model, tcfg


def obs_shape(cell):
    c = cell.config
    return (6 if c["obs_mode"] == "bev6" else 3, c["bev_width"],
            c["bev_width"])


def render_fn(cell):
    return (f_bev6.render_bev6_batch if cell.config["obs_mode"] == "bev6"
            else f_bev.render_bev_batch)


class StepTap(TorchFunctionMode):
    """While installed, keeps of every optimizer step of the learner's
    nets what the program took: the loss, the weights before the step
    (``keep_params``) and the gradients, on the host. A step is a call of
    ``torch.autograd.grad`` whose inputs are exactly a net's parameters;
    the tap reads torch's own call and no name inside the program."""

    def __init__(self, nets: dict, keep_params: bool = True):
        super().__init__()
        self.params = {k: list(net.parameters()) for k, net in nets.items()}
        self.ids = {k: [id(p) for p in ps] for k, ps in self.params.items()}
        self.keep_params = keep_params
        self.steps = {k: [] for k in nets}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.autograd.grad:
            inputs = kwargs["inputs"] if "inputs" in kwargs else args[1]
            if isinstance(inputs, torch.Tensor):
                inputs = (inputs,)
            ids = [id(t) for t in inputs]
            for k, want in self.ids.items():
                if ids == want:
                    loss = kwargs["outputs"] if "outputs" in kwargs else args[0]
                    if not isinstance(loss, torch.Tensor):
                        (loss,) = loss
                    self.steps[k].append(follow.Step(
                        loss=float(loss.detach()),
                        params=(cpu(self.params[k]) if self.keep_params
                                else None),
                        grads=cpu(list(out))))
        return out


class StageTap:
    """While installed, keeps what the learner's rollout, relabel and GAE
    return, at the names the learner calls them by (``learner.
    collect_rollout``, ``wdgail.relabel_rewards``, ``learner.
    compute_returns``)."""

    def __init__(self):
        from gail_carla_tpu_torch.algo import learner as learner_mod
        from gail_carla_tpu_torch.algo import wdgail

        self.got = {}
        self.sites = [(learner_mod, "collect_rollout", "rollout"),
                      (wdgail, "relabel_rewards", "gail_raw"),
                      (learner_mod, "compute_returns", "returns")]

    def __enter__(self):
        self.saved = [(o, name, getattr(o, name)) for o, name, _ in
                      self.sites]
        for (o, name, key), (_, _, fn) in zip(self.sites, self.saved):
            setattr(o, name, self._keep(key, fn))
        return self

    def _keep(self, key, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            self.got[key] = out
            return out
        return wrapped

    def __exit__(self, *exc):
        for o, name, fn in self.saved:
            setattr(o, name, fn)


def update_draws(f):
    from gail_carla_tpu_torch.algo.learner import UpdateDraws

    return UpdateDraws(action_noise=f.action_noise, env_draws=f.env_draws,
                       disc=f.disc, ppo_perms=f.ppo_perms, val_pre=f.val_pre,
                       val_post=f.val_post)


def cpu(x):
    return check.map_tensors(lambda t: t.detach().to("cpu", copy=True), x)


def sample_leaves(ro, envs):
    """The rollout leaves (T+1 or T, N, ...) of the sample envs, on the
    host."""
    e = (slice(None), envs)
    return cpu(dataclasses.replace(
        ro, render=feed_mod.take_envs(ro.render, e), metrics=ro.metrics[e],
        obs=None, actions=ro.actions[e], logp=ro.logp[e],
        values=ro.values[e], env_rewards=ro.env_rewards[e],
        masks=ro.masks[e], gail_rewards=ro.gail_rewards[e]))


@dataclasses.dataclass
class Setup:
    """The program's learner and state after set-up, and what the
    reference needs of set-up."""

    learner: object
    state: object
    fscene: object
    fcfg: object
    ftcfg: object
    expert: object
    record: object      # follow.UpdateRecord of update FOLLOWED, on the host
    state0: object      # the sample envs' state at update 1's start
    rollouts: list      # their leaves of each set-up update's rollout
    sample_envs: torch.Tensor
    render0: object
    metrics0: torch.Tensor


def setup(cell, seed: int, device) -> Setup:
    from gail_carla_tpu_torch import config as pconf
    from gail_carla_tpu_torch.algo.buffers import build_expert_buffer
    from gail_carla_tpu_torch.algo.learner import WDGAILLearner
    from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
    from gail_carla_tpu_torch.sim.env import RenderState

    c, tr = cell.config, cell.workload["traffic"]
    env_cfg, model_cfg, tcfg = configs(cell, pconf)
    fcfg, _, ftcfg = configs(cell, fconf)
    scene = make_benchmark_scene(**c["scene"], device=device)
    fscene = feed_mod.frozen_scene(c["scene"], device)
    demo = feed_mod.expert_rows(fscene, c["routes"], tr["expert_rows"],
                                fcfg.max_steps, seed)
    demo.render_cls = RenderState
    expert = build_expert_buffer(scene, env_cfg, demo,
                                 max_size=tr["expert_rows"])
    shape = obs_shape(cell)
    pol_p = wmod.to_host(wmod.make_params(c["model"], shape, False, seed,
                                          device))
    crit_p = wmod.to_host(wmod.make_params(c["model"], shape, True, seed,
                                           device))
    learner = WDGAILLearner(scene, env_cfg, model_cfg, tcfg, expert,
                            store_obs=tr["store_obs"], policy_params=pol_p,
                            disc_params=crit_p)
    n = tcfg.n_envs
    rids = feed_mod.route_ids(c["routes"], n, device)
    rdraws, gnss = feed_mod.reset_draws(fscene, fcfg, n, seed)
    state = learner.init_state(route_ids=rids, reset_draws=rdraws,
                               reset_gnss=gnss)
    g = feed_mod.generator(device, seed, "sample")
    envs = torch.randperm(n, generator=g, device=device)[:SIM_ENVS]
    render0 = cpu(feed_mod.take_envs(state.render, envs))
    metrics0 = state.metrics[envs].cpu()
    state0 = cpu(feed_mod.take_envs(state.env_states, envs))
    nets = {"policy": state.policy, "critic": state.disc}
    rollouts, prior = [], {k: [] for k in nets}
    for i in range(1, FOLLOWED + 1):
        f = feed_mod.train_feed(fscene, fcfg, ftcfg, expert.size, i, seed)
        with StageTap() as stages, StepTap(nets, i == FOLLOWED) as steps:
            state, _ = learner.update(state, update_draws(f))
        ro = stages.got["rollout"][3]
        rollouts.append(sample_leaves(ro, envs))
        if i < FOLLOWED:
            for k in nets:
                prior[k] += [s.grads for s in steps.steps[k]]
            del stages, ro
    record = follow.UpdateRecord(
        render=cpu(ro.render), metrics=cpu(ro.metrics), obs=cpu(ro.obs),
        actions=cpu(ro.actions), logp=cpu(ro.logp), values=cpu(ro.values),
        env_rewards=cpu(ro.env_rewards), masks=cpu(ro.masks),
        gail_raw=cpu(stages.got["gail_raw"]),
        returns=cpu(stages.got["returns"]), steps=steps.steps,
        after={k: cpu(list(v.parameters())) for k, v in nets.items()},
        prior_grads=prior)
    # drop what the taps hold of the program (the rollout, on the device)
    # before the window
    del stages, steps, ro
    gc.collect()
    return Setup(learner, state, fscene, fcfg, ftcfg, demo, record, state0,
                 rollouts, envs.cpu(), render0, metrics0)


def window(cell, su: Setup, seed: int, seconds: float, device):
    """(updates, env-steps, seconds, updates with non-finite losses,
    None)."""
    tcfg = su.learner.tcfg
    i = FOLLOWED                # set-up ran the updates up to it
    losses = []
    t0 = time.perf_counter()
    n_up = 0
    while True:
        i += 1
        f = feed_mod.train_feed(su.fscene, su.fcfg, su.ftcfg,
                                su.learner.expert.size, i, seed)
        su.state, m = su.learner.update(su.state, update_draws(f))
        losses.append(torch.stack([m[k] for k in WINDOW_LOSSES]))
        sync(device)
        n_up += 1
        dt = time.perf_counter() - t0
        if dt >= seconds:
            break
    bad = int((~torch.isfinite(torch.stack(losses))).any(1).sum())
    return n_up, n_up * tcfg.n_envs * tcfg.steps_per_env, dt, bad, None


def reference_numbers(cell, su: Setup, kept, seed: int, device,
                      control: bool):
    """The numbers that decide ``correct``: the program against the
    reference or, with ``control``, the control against the reference.
    The control's run also prints the readings of the faults planted in
    the reference put in the program's place."""
    strict_float32()
    shape = obs_shape(cell)
    c = cell.config
    init = (wmod.make_params(c["model"], shape, False, seed, device),
            wmod.make_params(c["model"], shape, True, seed, device))
    fscene, fcfg, ftcfg = su.fscene, su.fcfg, su.ftcfg
    r = su.record
    rec = dataclasses.replace(r, **{
        f: check.map_tensors(lambda t: t.to(device), getattr(r, f))
        for f in ("render", "metrics", "obs", "actions", "logp", "values",
                  "env_rewards", "masks", "gail_raw", "returns")})
    feed = feed_mod.train_feed(fscene, fcfg, ftcfg, su.expert.xy.shape[0],
                               FOLLOWED, seed)
    rfn = render_fn(cell)
    T1, N = rec.metrics.shape[:2]
    w = fcfg.bev_width
    n = {}
    if rec.obs is not None:
        obs = rec.obs
        if not control:
            g = feed_mod.generator(device, seed, "render_rows")
            rows = torch.randperm(T1 * N, generator=g,
                                  device=device)[:RENDER_ROWS]
            t, e = rows // N, rows % N
            rs = check.map_tensors(lambda x: x[t, e], check.frozen(rec.render))
            mine = check.obs_rows(fscene, fcfg, rs, rec.metrics[t, e], rfn)
            n["render_diff"] = float((mine != obs[t, e]).sum())
    else:
        flat = check.map_tensors(lambda x: x.reshape((T1 * N,) + x.shape[2:]),
                                 check.frozen(rec.render))
        obs = check.obs_rows(fscene, fcfg, flat, rec.metrics.reshape(-1, 4),
                             rfn).reshape(T1, N, w, w)
    logstd = torch.tensor(c["model"]["logstd"], device=device)
    numbers, readings = follow.follow_update(
        fscene, fcfg, ftcfg, c["model"], shape, init, su.expert, rec, feed,
        obs, logstd, control)
    n.update(numbers)
    for k, v in readings.items():
        say(f"reading {k}: {v!r}")
    del rec, obs
    gc.collect()
    n["sim_mismatch"] = sim_share(cell, su, seed, device, control)
    return n


def sim_share(cell, su: Setup, seed: int, device, control: bool) -> float:
    """Share of the sample envs' steps (and first resets) whose outcome
    differs between the program (or the control) and the reference, from
    update 1's start through every set-up update: the envs' state carried
    from one update to the next is the program's own."""
    fscene, fcfg = su.fscene, su.fcfg
    envs = su.sample_envs.to(device)
    c = cell.config
    N = cell.workload["traffic"]["n_envs"]
    rids = feed_mod.route_ids(c["routes"], N, device)[envs]
    rdraws, gnss = feed_mod.reset_draws(fscene, fcfg, N, seed)
    _, m_ref, r_ref = f_env.reset_batch(
        fscene, fcfg, rids, draws=feed_mod.take_envs(rdraws, envs),
        gnss_noise=gnss[envs])
    r0 = check.map_tensors(lambda t: t.to(device), check.frozen(su.render0))
    bad = int(check.step_bad(r0, su.metrics0.to(device), r_ref, m_ref).sum())
    st0 = check.map_tensors(lambda t: t.to(device), check.frozen(su.state0))
    ros = [check.map_tensors(lambda t: t.to(device), ro)
           for ro in su.rollouts]
    draws = [d for i, ro in enumerate(ros, 1) for d in feed_mod.StepDrawSeq(
        fscene, fcfg, N, ro.actions.shape[0], seed, ("update", i),
        envs=envs)]
    actions = torch.cat([ro.actions for ro in ros])
    ref = check.follow_sim(fscene, fcfg, st0, actions, draws)
    if control:
        other = check.follow_sim(fscene, fcfg, st0, actions, draws, True)
    else:
        traces = [check.trace_of_rollout(ro) for ro in ros]
        other = check.SimTrace(*(sum((getattr(t, f) for t in traces), [])
                                 for f in ("render", "metrics", "reward",
                                           "done")))
    b, k = check.sim_mismatches(other, ref)
    return (bad + b) / (envs.numel() + k)


def release(su: Setup) -> None:
    su.learner = su.state = None


def traced_context(cell, su, seed, device, n_up, window_s) -> dict:
    from bench_port.harness import traced

    return traced.train_context(cell, su, seed, device, n_up, window_s)
