# Frozen copy of gail_carla_tpu_torch/sim/terminals.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Terminal (done) handlers, batched: port of
``gail_carla_tpu/sim/terminals.py`` (``carla_gym/core/task_actor/
ego_vehicle/terminal/*``), selected by EnvConfig.terminal_mode:

- "leaderboard": done on route completion / blocked / deviation /
  collision / timeout, terminal reward 0;
- "valeo": stuck counter, adaptive lateral distance, red light / stop
  sign / collision with -speed terminal reward, exploration suggest;
- "valeo_nodetpx": valeo plus the pixel-level walker collision;
- "leaderboard_dagger": leaderboard plus red-light/stop-sign termination.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CriteriaFlags(NamedTuple):
    c_route: torch.Tensor
    c_blocked: torch.Tensor
    c_deviation: torch.Tensor
    c_collision: torch.Tensor
    c_run_red: torch.Tensor
    c_run_stop: torch.Tensor
    c_collision_px: torch.Tensor
    c_stuck: torch.Tensor
    c_lat_dist: torch.Tensor
    timeout: torch.Tensor


class TerminalOut(NamedTuple):
    done: torch.Tensor
    terminal_reward: torch.Tensor
    suggest_steps: torch.Tensor
    suggest_go: torch.Tensor
    suggest_stop: torch.Tensor
    suggest_turn: torch.Tensor


def _no_suggest(like: torch.Tensor):
    z = torch.zeros_like(like, dtype=torch.int32)
    f = torch.zeros_like(like, dtype=torch.bool)
    return z, f, f, f


def leaderboard(f: CriteriaFlags, ego_speed) -> TerminalOut:
    done = f.c_route | f.c_blocked | f.c_deviation | f.c_collision | f.timeout
    return TerminalOut(done, torch.zeros_like(ego_speed), *_no_suggest(done))


def valeo(f: CriteriaFlags, ego_speed, exploration_suggest: bool = True,
          with_px: bool = False) -> TerminalOut:
    c_col = f.c_collision | (f.c_collision_px & with_px)
    infraction = f.c_run_red | c_col | f.c_run_stop
    done = f.c_stuck | f.c_lat_dist | infraction | f.c_blocked | f.timeout
    terminal_reward = torch.where(done, -1.0, 0.0) + torch.where(
        infraction, -torch.abs(ego_speed), 0.0
    )
    steps = torch.where(done, 100, 0).to(torch.int32)
    if not exploration_suggest:
        steps = torch.zeros_like(steps)
    go = (f.c_stuck | f.c_blocked) & done
    return TerminalOut(done, terminal_reward, steps, go, infraction,
                       f.c_lat_dist)


def leaderboard_dagger(f: CriteriaFlags, ego_speed,
                       terminate_on_red: bool = True,
                       terminate_on_stop: bool = True) -> TerminalOut:
    done = f.c_route | f.c_blocked | f.c_deviation | f.c_collision | f.timeout
    if terminate_on_red:
        done = done | f.c_run_red
    if terminate_on_stop:
        done = done | f.c_run_stop
    infraction = f.c_run_red | f.c_collision | f.c_run_stop
    terminal_reward = torch.where(infraction, -torch.abs(ego_speed), 0.0)
    return TerminalOut(done, terminal_reward, *_no_suggest(done))


def compute_terminal(mode: str, f: CriteriaFlags, ego_speed,
                     exploration_suggest: bool = True) -> TerminalOut:
    if mode == "leaderboard":
        return leaderboard(f, ego_speed)
    if mode == "valeo":
        return valeo(f, ego_speed, exploration_suggest, with_px=False)
    if mode == "valeo_nodetpx":
        return valeo(f, ego_speed, exploration_suggest, with_px=True)
    if mode == "leaderboard_dagger":
        return leaderboard_dagger(f, ego_speed)
    raise ValueError(f"unknown terminal mode {mode!r}")
