# Frozen copy of gail_carla_tpu_torch/sim/signals.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Traffic-light phases and signal queries, batched over envs.

Port of ``gail_carla_tpu/sim/signals.py``: phase is a pure function of
sim time, so no signal state lives in the world state. Queries take the
ego pose with a leading env axis (N, ...) and return (N, T) per-light or
(N,) per-env results.
"""
from __future__ import annotations

import torch

from bench_port.plain_reference.frozen.sim.transforms import (
    norm2, py_mod, vec_global_to_ref,
)

GREEN, YELLOW, RED = 0, 1, 2

GREEN_S = 10.0
YELLOW_S = 2.0
CYCLE_S = 2.0 * (GREEN_S + YELLOW_S)


def light_states(scene, sim_time: torch.Tensor) -> torch.Tensor:
    """(N, T) int32 state of every light at each env's ``sim_time`` (N,)."""
    offset = py_mod(scene.tl_junction.to(torch.float32) * 7.0, CYCLE_S)
    phase = py_mod(sim_time[:, None] + offset[None, :], CYCLE_S)
    # group 0: green [0, 10), yellow [10, 12), red [12, 24)
    s0 = torch.where(
        phase < GREEN_S, GREEN,
        torch.where(phase < GREEN_S + YELLOW_S, YELLOW, RED),
    )
    # group 1: red while group 0 runs, then green/yellow
    s1 = torch.where(
        phase < GREEN_S + YELLOW_S, RED,
        torch.where(phase < 2 * GREEN_S + YELLOW_S, GREEN, YELLOW),
    )
    return torch.where(scene.tl_group[None, :] == 0, s0, s1).to(torch.int32)


def stopline_center(scene):
    return 0.5 * (scene.tl_stop[:, 0] + scene.tl_stop[:, 1])


def affecting_light(scene, ego_xy, ego_yaw, states, offset: float = 0.0,
                    dist_threshold: float = 18.0,
                    lateral_slack: float = 0.1):
    """TrafficLightHandler.get_light_state (traffic_light.py:113-156): the
    nearest light whose stop line lies ahead of (ego + offset*fwd),
    heading-aligned and laterally within the line span.

    Returns (state (N,), loc_in_ev (N, 2), idx (N,)) with state == -1 and
    idx == -1 where no light affects the vehicle."""
    fwd = torch.stack([torch.cos(ego_yaw), torch.sin(ego_yaw)], dim=-1)
    base = ego_xy + offset * fwd
    center = stopline_center(scene)
    rel = center[None, :, :] - base[:, None, :]            # (N, T, 2)
    local = vec_global_to_ref(rel, ego_yaw[:, None])
    dist = norm2(rel)

    aligned = torch.cos(scene.tl_yaw[None, :] - ego_yaw[:, None]) > 0.0
    ahead = local[..., 0] > 0.0
    a = scene.tl_stop[:, 0]
    b = scene.tl_stop[:, 1]
    ab = b - a
    rb = base[:, None, :] - a[None]
    t = (rb[..., 0] * ab[:, 0] + rb[..., 1] * ab[:, 1]) / (
        (ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1]) + 1e-9
    )
    in_lane = (t > -lateral_slack) & (t < 1.0 + lateral_slack)

    T = dist.shape[1]
    live = torch.arange(T, device=dist.device) < scene.tl_n
    valid = aligned & ahead & in_lane & (dist < dist_threshold) & live
    big = 1e9
    masked = torch.where(valid, dist, big)
    idx = torch.argmin(masked, dim=1)
    found = masked.gather(1, idx[:, None])[:, 0] < big
    state = torch.where(found, states.gather(1, idx[:, None])[:, 0], -1)
    loc = torch.where(
        found[:, None],
        local[torch.arange(local.shape[0], device=idx.device), idx],
        0.0,
    )
    idx = torch.where(found, idx, -1)
    return state.to(torch.int32), loc, idx.to(torch.int32)


def segments_intersect(p1, p2, q1, q2):
    """2D segment intersection via orientation tests (replaces shapely in
    run_red_light.py:56-64)."""

    def orient(a, b, c):
        return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
            b[..., 1] - a[..., 1]
        ) * (c[..., 0] - a[..., 0])

    d1 = orient(q1, q2, p1)
    d2 = orient(q1, q2, p2)
    d3 = orient(p1, p2, q1)
    d4 = orient(p1, p2, q2)
    return ((d1 * d2) < 0) & ((d3 * d4) < 0)


def point_in_stop_box(point, center, extent):
    """Stop-sign trigger test: the reference inflates the box to a square
    of the max extent and tests it axis-aligned (run_stop_sign.py:130-157).
    """
    m = torch.maximum(extent[..., 0], extent[..., 1])
    d = torch.abs(point - center)
    return (d[..., 0] < m) & (d[..., 1] < m)
