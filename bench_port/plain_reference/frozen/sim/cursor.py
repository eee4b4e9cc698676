# Frozen copy of gail_carla_tpu_torch/sim/cursor.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Route-cursor and leaderboard-plan progression, batched over envs.

Port of ``gail_carla_tpu/sim/cursor.py``:
- ``advance_cursor``: task_vehicle.py:103-128 window-5 forward walk;
- ``route_transform``: task_vehicle.py:217-227;
- ``advance_plan``: the gnss target tracker + command carry rule
  (navigation/gnss.py:96-116).

JAX clamps out-of-range gather indices and ``dynamic_slice`` starts;
torch does not (on CUDA an index past the end is a device-side assert),
so every index into a route row is clamped explicitly here.
"""
from __future__ import annotations

import torch

from bench_port.plain_reference.frozen.config import EnvConfig
from bench_port.plain_reference.frozen.sim.transforms import norm2, vec_global_to_ref

# 1 degree of the reference's equatorial Web-Mercator == R*pi/180 metres.
METERS_PER_DEG = 111319.4907932736

# Route-cursor search window: task_vehicle.py:103 uses windows_size=5 and
# evaluates segments i = 0..5 inclusive.
CURSOR_WINDOW = 6


def take_row(table: torch.Tensor, rid: torch.Tensor, idx: torch.Tensor):
    """``table[rid, idx]`` per env with ``idx`` clamped into the row, as a
    JAX gather clamps it. ``rid`` and ``idx`` are (N,)."""
    idx = idx.clamp(0, table.shape[1] - 1).long()
    return table[rid.long(), idx]


def take_window(table: torch.Tensor, rid: torch.Tensor, start: torch.Tensor,
                size: int):
    """``jax.lax.dynamic_slice(table, (rid, start, ...), (1, size, ...))``
    for each env: the start is clamped so that the window stays inside
    the row. Returns (N, size, ...)."""
    start = torch.minimum(
        start.clamp_min(0), torch.full_like(start, table.shape[1] - size)
    )
    offs = torch.arange(size, device=table.device)
    return table[rid.long()[:, None], (start[:, None] + offs).long()]


def advance_cursor(scene, route_id, head, last_head_prev, ego_xy):
    """Walk the route head forward past every segment whose direction has
    positive dot with the vehicle offset, within a fixed window."""
    n = scene.route_n[route_id.long()]
    offs = torch.arange(CURSOR_WINDOW, device=head.device)
    win = take_window(scene.route_xy, route_id, head, CURSOR_WINDOW + 1)
    p0 = win[:, :-1]
    p1 = win[:, 1:]
    wp_dir = p1 - p0
    wp_veh = ego_xy[:, None, :] - p0
    dot = wp_dir[..., 0] * wp_veh[..., 0] + wp_dir[..., 1] * wp_veh[..., 1]
    valid = (head[:, None] + offs) < (n[:, None] - 1)
    adv = torch.where((dot > 0) & valid, offs + 1, 0).amax(dim=1)
    new_head = torch.minimum(head + adv, n - 1).to(torch.int32)
    dist = (take_row(scene.route_s, route_id, new_head)
            - take_row(scene.route_s, route_id, head))
    last_head = torch.where(adv > 0, head, last_head_prev)
    return new_head, last_head, dist


def route_transform(scene, rid, head, last_head):
    """Pose of the last passed route point, heading toward the current
    head."""
    loc0 = take_row(scene.route_xy, rid, last_head)
    loc1 = take_row(scene.route_xy, rid, head)
    d = loc1 - loc0
    dist = norm2(d)
    yaw = torch.where(
        dist < 0.1,
        take_row(scene.route_yaw, rid, head),
        torch.atan2(d[:, 1], d[:, 0]),
    )
    return loc0, yaw


def advance_plan(scene, cfg: EnvConfig, gnss_noise, ego_xy, ego_yaw, rid,
                 plan_idx):
    """gnss.py:96-116: advance the leaderboard-plan target when the noisy
    GNSS fix says it is within 12 m and behind; derive the command with the
    lane-change carry rule. ``gnss_noise`` (N, 2) holds standard normal
    draws (``cursor.py:72`` draws them inside)."""
    noise = gnss_noise * cfg.gnss_noise_deg * METERS_PER_DEG
    noisy_xy = ego_xy + noise
    pn = scene.plan_n[rid.long()]
    nxt = take_row(scene.plan_xy, rid, torch.minimum(plan_idx + 1, pn - 1))
    local = vec_global_to_ref(nxt - noisy_xy, ego_yaw)
    advance = (norm2(local) < cfg.target_advance_dist) & (local[:, 0] < 0.0)
    idx = torch.minimum(plan_idx + advance.to(torch.int32), pn - 2)

    opt0 = take_row(scene.plan_cmd, rid, idx.clamp_min(0))
    opt1 = take_row(scene.plan_cmd, rid, torch.minimum(idx + 1, pn - 1))
    is_lc0 = (opt0 == 5) | (opt0 == 6)
    is_lc1 = (opt1 == 5) | (opt1 == 6)
    command = torch.where(is_lc0 & (~is_lc1), opt1, opt0)
    target_gps = take_row(
        scene.plan_gps, rid, torch.minimum(idx + 1, pn - 1)
    )
    return idx.to(torch.int32), command, target_gps
