"""The comparisons that decide ``correct``: the simulator followed step by
step from the program's own state, the policy's outputs at the program's
render states, and the gaps between two sets of numbers. Plain PyTorch on
the frozen reference; nothing of the program is imported (the program's
states arrive as objects and are read field by field)."""
from __future__ import annotations

import dataclasses
import math

import torch

from bench_port.plain_reference.frozen.agents.controllers import (
    AutopilotState, PIDState,
)
from bench_port.plain_reference.frozen.algo.buffers import (
    pack_bev_obs, unpack_bev_obs,
)
from bench_port.plain_reference.frozen.sim import env as f_env
from bench_port.plain_reference.frozen.sim.dynamics import VehicleState
from bench_port.plain_reference.frozen.sim.state import (
    HistoryState, TrafficState, WorldState,
)

FROZEN = {c.__name__: c for c in (
    WorldState, TrafficState, VehicleState, AutopilotState, PIDState,
    HistoryState, f_env.RenderState)}

# what counts as the same next state (float32 on both sides): 1 cm, 1 mrad,
# 1 mm/s, 1e-7 degrees of GPS (1.1 cm), 1e-6 of route per step of reward
POS_TOL, YAW_TOL, SPEED_TOL, GPS_TOL, REWARD_TOL = 1e-2, 1e-3, 1e-3, 1e-7, 1e-6


def frozen(x):
    """A state of the program as the frozen reference's classes (the same
    fields, read by name)."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    cls = FROZEN[type(x).__name__]
    return cls(**{f.name: frozen(getattr(x, f.name))
                  for f in dataclasses.fields(x)})


def map_tensors(fn, x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: map_tensors(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_tensors(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(map_tensors(fn, v) for v in x)
    return x


def round_bf16(x):
    """The control's simulator state: every float rounded to bfloat16."""
    return map_tensors(
        lambda t: t.to(torch.bfloat16).to(t.dtype)
        if t.is_floating_point() else t, x)


def wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def pose_bad(a, b):
    """(N,) any pose of (N, ..., 3) off by more than the tolerances."""
    if a.shape[-2] == 0:
        return torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    d_xy = torch.linalg.vector_norm(a[..., :2] - b[..., :2], dim=-1)
    d_yaw = wrap(a[..., 2] - b[..., 2]).abs()
    return ((d_xy > POS_TOL) | (d_yaw > YAW_TOL)).flatten(1).any(1)


def step_bad(render_a, metrics_a, render_b, metrics_b, reward_a=None,
             reward_b=None, done_a=None, done_b=None):
    """(N,) bool: the envs whose observed state differs between a and b."""
    a, b = render_a, render_b
    bad = torch.linalg.vector_norm(a.xy - b.xy, dim=-1) > POS_TOL
    bad |= wrap(a.yaw - b.yaw).abs() > YAW_TOL
    for f in ("route_id", "head", "step", "stop_idx"):
        bad |= getattr(a, f) != getattr(b, f)
    bad |= pose_bad(a.npc_pose, b.npc_pose)
    bad |= pose_bad(a.walker_pose, b.walker_pose)
    bad |= (metrics_a[:, :2] - metrics_b[:, :2]).abs().amax(1) > GPS_TOL
    bad |= (metrics_a[:, 2] - metrics_b[:, 2]).abs() > SPEED_TOL
    bad |= metrics_a[:, 3] != metrics_b[:, 3]
    if reward_a is not None:
        bad |= (reward_a - reward_b).abs() > REWARD_TOL
        bad |= done_a != done_b
    return bad


@dataclasses.dataclass
class SimTrace:
    """Per step t of a followed chunk: the render state and metrics after
    the step (index t + 1 of a rollout), its reward and done flag."""

    render: list
    metrics: list
    reward: list
    done: list


def follow_sim(fscene, fcfg, state, actions, step_draws,
               control: bool = False) -> SimTrace:
    """The frozen simulator from ``state`` through ``actions`` (T, N, 2),
    with each step's draws; the control rounds its state to bfloat16
    after every step."""
    tr = SimTrace([], [], [], [])
    for t in range(actions.shape[0]):
        state, out = f_env.step_batch(fscene, fcfg, state, actions[t], None,
                                      **step_draws[t]._asdict())
        if control:
            state = round_bf16(state)
        tr.render.append(out.render)
        tr.metrics.append(out.metrics)
        tr.reward.append(out.reward)
        tr.done.append(out.done)
    return tr


def trace_of_rollout(rollout) -> SimTrace:
    """The program's rollout (``algo/buffers.py::Rollout`` leaves (T+1, N,
    ...)) as the steps' outcomes."""
    T = rollout.actions.shape[0]
    rs = frozen(rollout.render)
    return SimTrace(
        render=[map_tensors(lambda x, t=t: x[t + 1], rs) for t in range(T)],
        metrics=[rollout.metrics[t + 1] for t in range(T)],
        reward=[rollout.env_rewards[t] for t in range(T)],
        done=[rollout.masks[t + 1] == 0 for t in range(T)],
    )


def sim_mismatches(a: SimTrace, b: SimTrace):
    """(steps that differ, steps compared) over every env and step."""
    bad = n = 0
    for t in range(len(a.render)):
        x = step_bad(a.render[t], a.metrics[t], b.render[t], b.metrics[t],
                     a.reward[t], b.reward[t], a.done[t], b.done[t])
        bad += int(x.sum())
        n += x.numel()
    return bad, n


def obs_rows(fscene, fcfg, render, metrics, render_fn, chunk: int = 512):
    """Packed uint8 (M, W, W) observations of M render states, rendered by
    the frozen plain renderer ``render_fn`` ``chunk`` rows at a time."""
    m = render.xy.shape[0]
    out = torch.empty((m, fcfg.bev_width, fcfg.bev_width), dtype=torch.uint8,
                      device=render.xy.device)
    for lo in range(0, m, chunk):
        sl = slice(lo, min(lo + chunk, m))
        rs = map_tensors(lambda x: x[sl], render)
        out[sl] = pack_bev_obs(fcfg, render_fn(fscene, fcfg, rs))
    return out


class HeadTerms:
    """While installed, keeps for every row that ``layer`` (an
    ``nn.Linear``) sees the size of the terms its output ``k`` sums,
    ‖W[k] ⊙ h‖₂: the scale that round-off in ``h`` acts on."""

    def __init__(self, layer, k: int = 0):
        self.layer, self.k, self.rows = layer, k, []

    def __enter__(self):
        def hook(mod, args, out):
            self.rows.append(torch.linalg.vector_norm(
                args[0].detach() * mod.weight[self.k].detach(), dim=1))
        self.handle = self.layer.register_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()

    def scale(self) -> torch.Tensor:
        return torch.cat(self.rows)


@torch.no_grad()
def policy_outputs(net, fcfg, obs_packed, metrics, chunk: int = 2048):
    """(values, means, the value's term scale) of the policy on packed
    observations."""
    vals, means = [], []
    with HeadTerms(net.out) as terms:
        for lo in range(0, obs_packed.shape[0], chunk):
            sl = slice(lo, lo + chunk)
            v, mu, _ = net(unpack_bev_obs(fcfg, obs_packed[sl]),
                           metrics[sl])
            vals.append(v)
            means.append(mu)
    return torch.cat(vals), torch.cat(means), terms.scale()


def inverse_softplus(r: torch.Tensor) -> torch.Tensor:
    """The critic's raw output D of a relabelled reward softplus(D)."""
    r = r.double()
    return (r + torch.log(-torch.expm1(-r))).float()


def rel_to(a, b, scale):
    """The root mean square of a - b over that of ``scale``, the size of
    the terms that b sums (the gap relative to b itself swings from seed
    to seed with b's own size, which cancellation makes small; PERF.md)."""
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt()
                 / scale.float().pow(2).mean().sqrt().clamp_min(1e-12))


def rel_rms(a, b):
    """The root mean square of a - b over that of b (the widest single
    gap swings from seed to seed with the rows drawn; PERF.md)."""
    a, b = a.float(), b.float()
    rms = b.pow(2).mean().sqrt().clamp_min(1e-12)
    return float((a - b).pow(2).mean().sqrt() / rms)


def moving_leaves(ref_grad):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's; the rest move under Adam by round-off alone."""
    n = torch.stack([torch.linalg.vector_norm(x.float()) for x in ref_grad])
    return n >= 1e-3 * n.median()

