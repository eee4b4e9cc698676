"""The one traffic generator. Every input of a cell comes from ``--seed``
and the parameters of its workload file: the envs' reset draws, each
step's draws (the action noise, the auto-resets', the GNSS noise, the
walkers' crossing coins), the training update's draws (critic and PPO
rows, the penalty's mixing weights, the validation rows) and the expert
rows. A draw is made on the device from a generator seeded by the run's
seed and the draw's place (update, chunk, step), so a run can make any
draw again after its window, for the reference, without keeping it.

The shapes of the draws follow the frozen reference's draw functions
(``reference/frozen``), on the benchmark's own copy of the scene.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from collections.abc import Sequence

import torch

from bench_port.harness.spec import BENCH_DIR
from bench_port.plain_reference.frozen.algo import ppo as f_ppo
from bench_port.plain_reference.frozen.algo import wdgail as f_wdgail
from bench_port.plain_reference.frozen.scene.scene import make_benchmark_scene
from bench_port.plain_reference.frozen.sim import env as f_env

CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def stream_seed(seed: int, *place) -> int:
    """A 63-bit generator seed for the draw at ``place`` of run ``seed``."""
    key = "/".join(str(x) for x in (seed,) + place).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *place) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *place))
    return g


def frozen_scene(scene_kw: dict, device):
    """The benchmark's own copy of the cell's scene (the frozen scene
    compiler), cached on disk inside the checkout after its first build:
    the grid town takes seconds to compile on the host."""
    key = hashlib.sha256(json.dumps(scene_kw, sort_keys=True).encode())
    path = os.path.join(CACHE_DIR, f"scene-{key.hexdigest()[:16]}.pt")
    if os.path.exists(path):
        scene = torch.load(path, weights_only=False)
    else:
        scene = make_benchmark_scene(**scene_kw, device="cpu")
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(scene, tmp)
        os.replace(tmp, path)
    return scene.to(device)


def route_ids(routes, n: int, device) -> torch.Tensor:
    """Envs on ``routes`` in turn."""
    return torch.tensor([routes[i % len(routes)] for i in range(n)],
                        dtype=torch.int32, device=device)


def reset_draws(fscene, fcfg, n: int, seed: int):
    """(ResetDraws, GNSS noise) of the envs' first reset."""
    g = generator(fscene.device, seed, "reset")
    return (f_env.draw_reset(fscene, fcfg, n, g),
            f_env.draw_gnss(n, fscene.device, g))


class StepDrawSeq(Sequence):
    """The ``StepDraws`` of the steps of one chunk or update, made when a
    step asks for them, so that a chunk holds one step's draws at a time;
    ``envs`` keeps those of some envs only (the reference's sample)."""

    def __init__(self, fscene, fcfg, n: int, n_steps: int, seed: int,
                 place, envs=None):
        self.args = (fscene, fcfg, n)
        self.n_steps, self.seed, self.place = n_steps, seed, place
        self.envs = envs

    def __len__(self):
        return self.n_steps

    def __getitem__(self, t):
        if not 0 <= t < self.n_steps:
            raise IndexError(t)
        fscene, fcfg, n = self.args
        g = generator(fscene.device, self.seed, *self.place, "step", t)
        d = f_env.draw_step(fscene, fcfg, n, g)
        return d if self.envs is None else take_envs(d, self.envs)


def take_envs(x, envs):
    """Rows ``envs`` of every tensor of a draw (NamedTuple) or state
    (dataclass) whose first axis is the env axis."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[envs]
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: take_envs(getattr(x, f.name), envs)
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(take_envs(v, envs) for v in x))
    return x


def action_noise(device, n_steps: int, n: int, seed: int, place):
    g = generator(device, seed, *place, "noise")
    return torch.randn((n_steps, n, 2), generator=g, device=device)


@dataclasses.dataclass
class TrainFeed:
    """The draws of one training update (fields as ``UpdateDraws``)."""

    action_noise: torch.Tensor
    env_draws: Sequence
    disc: list
    ppo_perms: torch.Tensor
    val_pre: torch.Tensor
    val_post: torch.Tensor


def train_feed(fscene, fcfg, tcfg, expert_size: int, i_update: int,
               seed: int) -> TrainFeed:
    """Every draw of update ``i_update`` (1-based) of a training cell;
    ``tcfg`` is the frozen TrainConfig of the cell."""
    dev = fscene.device
    n, t = tcfg.n_envs, tcfg.steps_per_env
    total = n * t
    place = ("update", i_update)
    g = generator(dev, seed, *place, "learner")
    n_mb_disc = min(expert_size, total) // tcfg.gail_batch_size
    disc = [f_wdgail.draw_disc_epoch(n_mb_disc, tcfg.gail_batch_size,
                                     expert_size, total, dev, g)
            for _ in range(f_wdgail.warmup_epochs(tcfg, i_update))]
    n_mb = total // tcfg.mini_batch_size
    perms = f_ppo.draw_perms(tcfg.ppo_epoch, total,
                             n_mb * tcfg.mini_batch_size, dev, g)
    return TrainFeed(
        action_noise=action_noise(dev, t, n, seed, place),
        env_draws=StepDrawSeq(fscene, fcfg, n, t, seed, place),
        disc=disc,
        ppo_perms=perms,
        val_pre=f_wdgail.draw_validation(expert_size, total, dev, g),
        val_post=f_wdgail.draw_validation(expert_size, total, dev, g),
    )


@dataclasses.dataclass
class ExpertRows:
    """Expert transitions made from the seed, in the shape of a demo
    batch: ``flatten()`` gives (render state, metrics, actions, valid),
    the render state of the class the caller passes."""

    xy: torch.Tensor
    yaw: torch.Tensor
    route_id: torch.Tensor
    head: torch.Tensor
    step: torch.Tensor
    metrics: torch.Tensor
    actions: torch.Tensor
    render_cls: type = None

    def render(self, cls):
        m, dev = self.xy.shape[0], self.xy.device
        i32 = torch.int32
        return cls(xy=self.xy, yaw=self.yaw, route_id=self.route_id,
                   head=self.head, step=self.step,
                   stop_idx=torch.full((m,), -1, dtype=i32, device=dev),
                   npc_pose=torch.zeros((m, 0, 3), device=dev),
                   walker_pose=torch.zeros((m, 0, 3), device=dev))

    def flatten(self):
        valid = torch.ones(self.xy.shape[0], dtype=torch.bool,
                           device=self.xy.device)
        return (self.render(self.render_cls), self.metrics, self.actions,
                valid)


def expert_rows(fscene, routes, n_rows: int, max_steps: int,
                seed: int) -> ExpertRows:
    """``n_rows`` on-route ego poses of the training ``routes``: a route
    point clear of the route's last 20, up to 1 m off the route sideways
    and 0.05 rad off its heading; the target and command of the next plan
    point ahead, as the GNSS navigation gives them; a speed in [0, 6) m/s;
    an expert's steer (normal, sd 0.1, within +-0.5) and throttle in
    [0.3, 0.8); a sim step in [0, max_steps)."""
    dev = fscene.device
    g = generator(dev, seed, "expert")
    u = torch.rand((7, n_rows), generator=g, device=dev)
    nrm = torch.randn((2, n_rows), generator=g, device=dev)
    routes_t = torch.as_tensor(routes, dtype=torch.int64, device=dev)
    rid = routes_t[(u[0] * len(routes)).long().clamp_max(len(routes) - 1)]
    n_pts = fscene.route_n[rid].to(torch.float32)
    head = (u[1] * (n_pts - 20).clamp_min(1)).long()
    base_xy = fscene.route_xy[rid, head]
    base_yaw = fscene.route_yaw[rid, head]
    side = (u[2] * 2 - 1) * 1.0
    normal = torch.stack([-torch.sin(base_yaw), torch.cos(base_yaw)], -1)
    xy = base_xy + side[:, None] * normal
    yaw = base_yaw + 0.05 * nrm[0]
    # the next plan point ahead of the pose (the last if none is ahead)
    d = fscene.plan_xy[rid] - xy[:, None, :]
    ahead_x = d[..., 0] * torch.cos(yaw)[:, None] + d[..., 1] * torch.sin(
        yaw)[:, None]
    pn = fscene.plan_n[rid].long()
    k_idx = torch.arange(d.shape[1], device=dev)[None, :]
    ok = (ahead_x > 0) & (k_idx < pn[:, None])
    dist = torch.where(ok, torch.linalg.vector_norm(d, dim=-1),
                       torch.full_like(ahead_x, float("inf")))
    k = torch.where(ok.any(1), dist.argmin(1), pn - 1)
    cmd = fscene.plan_cmd[rid, (k - 1).clamp_min(0)].to(torch.float32)
    target = fscene.plan_gps[rid, k]
    speed = u[3] * 6.0
    metrics = torch.stack([target[:, 0], target[:, 1], speed, cmd], 1)
    actions = torch.stack([(0.1 * nrm[1]).clamp(-0.5, 0.5),
                           0.3 + 0.5 * u[4]], 1)
    step = (u[5] * max_steps).to(torch.int32)
    return ExpertRows(xy=xy, yaw=yaw, route_id=rid.to(torch.int32),
                      head=head.to(torch.int32), step=step,
                      metrics=metrics, actions=actions)
