# Frozen copy of gail_carla_tpu_torch/ops/bev6.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""The 6-channel BEV observation (``obs_mode="bev6"``): the plain PyTorch
version, batch-native.

Port of ``gail_carla_tpu/ops/bev6.py``. Channels: (road, route, lane)
exactly as ``ops/bev.py``, plus
- signals: stop-line capsules valued by the current light phase (80
  green, 170 yellow, 255 red, chauffeurnet.py:192-199) and the active
  un-completed stop sign's box at 255, times the float32 reciprocal of
  255;
- vehicles: the NPC vehicles' current boxes;
- walkers: the walkers' current boxes.

This module is the reference of the CUDA kernel (``ops/bev6_cuda.py``).
The plain version follows the JAX package's XLA path: it draws every
light of the town and every stop sign (inactive ones with a negative half
extent). The kernel fetches the ego cell's culled light table and the one
active stop-sign box itself; the two agree bit for bit because the culled
tables keep every light a pixel of the cell's view can touch
(``segments.py::build_tl_cells``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_port.plain_reference.frozen.config import EnvConfig
from bench_port.plain_reference.frozen.ops import bev_tiles
from bench_port.plain_reference.frozen.ops.bev import (
    INV_255, PLAIN_CHUNK, BevInputs, bev_inputs, capsule_dist2_all,
    pixel_world_coords, render_bev_plain,
)
from bench_port.plain_reference.frozen.ops.bev_full import (
    TL_LINE_HALF_W, WALKER_HALF, boxes_mask,
)
from bench_port.plain_reference.frozen.sim import signals
from bench_port.plain_reference.frozen.sim.dynamics import DEFAULT_VEHICLE

# box table columns: x, y, cos yaw, sin yaw, half length, half width,
# channel (0 signals, 1 vehicles, 2 walkers), padding
BOX_COLS = 8
CH_SIGNAL, CH_VEHICLE, CH_WALKER = 0.0, 1.0, 2.0


@dataclasses.dataclass
class Bev6Inputs:
    """Per-env tables one 6-channel render reads."""

    base: BevInputs          # road, route and lane tables (ops/bev.py)
    boxes: torch.Tensor      # (N, K+W, 8) vehicles, then walkers
    n_veh: int               # K
    tl_all: torch.Tensor     # (T, 4) stop lines of the town
    tl_val_all: torch.Tensor  # (N, T) f32 phase values, 0 past tl_n
    stop_boxes: torch.Tensor  # (N, S, 8) stop signs, half -1 if inactive


def light_values(scene, cfg: EnvConfig, step):
    """(N, T) value each light's stop line is drawn with at each env's
    sim time: 80 / 170 / 255 by phase, 0 for the table's padding."""
    states = signals.light_states(scene, step.to(torch.float32) * cfg.dt)
    val = torch.where(
        states == signals.GREEN, 80.0,
        torch.where(states == signals.YELLOW, 170.0, 255.0),
    )
    live = torch.arange(states.shape[1], device=val.device) < scene.tl_n
    return torch.where(live[None, :], val, 0.0)


def _actor_boxes(pose, half_len: float, half_wid: float, ch: float):
    """(N, M, 8) box rows of actor poses (N, M, 3) = x, y, yaw."""
    yaw = pose[..., 2]
    fill = torch.ones_like(yaw)
    return torch.stack([
        pose[..., 0], pose[..., 1], torch.cos(yaw), torch.sin(yaw),
        fill * half_len, fill * half_wid, fill * ch, torch.zeros_like(yaw),
    ], dim=-1)


def bev6_inputs(scene, cfg: EnvConfig, render_state) -> Bev6Inputs:
    """Fetch every env's tables for one 6-channel render of the plain
    version."""
    base = bev_inputs(scene, render_state)
    n = base.pose.shape[0]
    dev = base.pose.device

    # every stop sign, drawn as a square of its larger extent when it is
    # the env's active un-completed one (stop_idx), else not at all
    S = scene.ss_center.shape[0]
    ss_half = torch.maximum(scene.ss_extent[:, 0], scene.ss_extent[:, 1])
    active = torch.arange(S, device=dev)[None, :] == render_state.stop_idx[
        :, None]
    half = torch.where(active, ss_half[None, :], -1.0)
    ss = torch.stack([
        scene.ss_center[:, 0], scene.ss_center[:, 1],
        torch.cos(scene.ss_yaw), torch.sin(scene.ss_yaw),
    ], dim=-1)
    zero = torch.zeros_like(half)
    stop_boxes = torch.cat([
        ss[None].expand(n, S, 4), half[..., None], half[..., None],
        (zero + CH_SIGNAL)[..., None], zero[..., None],
    ], dim=-1)

    boxes = torch.cat([
        _actor_boxes(render_state.npc_pose, DEFAULT_VEHICLE.half_length,
                     DEFAULT_VEHICLE.half_width, CH_VEHICLE),
        _actor_boxes(render_state.walker_pose, WALKER_HALF[0],
                     WALKER_HALF[1], CH_WALKER),
    ], dim=1)
    return Bev6Inputs(
        base=base,
        boxes=boxes.contiguous(),
        n_veh=render_state.npc_pose.shape[1],
        tl_all=scene.tl_stop.reshape(-1, 4),
        tl_val_all=light_values(scene, cfg, render_state.step),
        stop_boxes=stop_boxes,
    )


def _inside(px, boxes):
    """(n, P) bool: pixels inside any of the box rows (n, M, 8)."""
    return boxes_mask(px, boxes[..., :2], boxes[..., 2], boxes[..., 3],
                      boxes[..., 4], boxes[..., 5])


def render_bev6_plain(cfg: EnvConfig, inp: Bev6Inputs,
                      dmax: float) -> torch.Tensor:
    """(N, 6, W, W) float32 in [0, 1] from fetched tables, in chunks of
    ``PLAIN_CHUNK`` envs."""
    w = cfg.bev_width
    n = inp.base.pose.shape[0]
    k = inp.n_veh
    out = torch.empty((n, 6, w, w), dtype=torch.float32,
                      device=inp.base.pose.device)
    out[:, :3] = render_bev_plain(cfg, inp.base, dmax)
    for lo in range(0, n, PLAIN_CHUNK):
        sl = slice(lo, min(lo + PLAIN_CHUNK, n))
        pose = inp.base.pose[sl]
        px = pixel_world_coords(cfg, pose[:, :2], pose[:, 2], pose[:, 3])
        # signals: the highest phase value among the stop lines within
        # the stroke, then the active stop sign at 255
        d2 = capsule_dist2_all(px, inp.tl_all)
        on_line = d2 <= TL_LINE_HALF_W ** 2
        sig = torch.amax(
            torch.where(on_line, inp.tl_val_all[sl, None, :], 0.0), dim=-1
        )
        stop = _inside(px, inp.stop_boxes[sl])
        sig = torch.maximum(sig, torch.where(stop, 255.0, 0.0)) * INV_255
        boxes = inp.boxes[sl]
        veh = _inside(px, boxes[:, :k]).to(torch.float32)
        wk = _inside(px, boxes[:, k:]).to(torch.float32)
        out[sl, 3:] = torch.stack([sig, veh, wk], dim=1).reshape(-1, 3, w, w)
    return out


def render_bev6_batch(scene, cfg: EnvConfig, render_state) -> torch.Tensor:
    """(N, 6, W, W) observation of a RenderState batch, plain version."""
    return render_bev6_plain(cfg, bev6_inputs(scene, cfg, render_state),
                             scene.bnd_dmax)


def render_bev6_batch_auto(scene, cfg: EnvConfig, render_state):
    """The CUDA kernel for a render state on the card, the plain version
    for one on the CPU. There is no fallback between the two."""
    return render_bev6_batch(scene, cfg, render_state)


def place_in_view(scene, render_state, envs, rng, n_vehicles: int,
                  n_walkers: int, view=None, tiles: EnvConfig | None = None):
    """A copy of a RenderState batch placed to check a renderer with.
    Each env j of ``envs`` (indices) is moved, at a random sim step so that
    every light phase shows, and its first ``n_vehicles`` NPC vehicles and
    ``n_walkers`` walkers with it. ``rng`` is a numpy Generator.

    Without ``tiles``, so that every bev6 channel is drawn: env j stands
    2 m before a random stop line, facing it (even j), or beside a random
    stop sign made its active one (odd j), and its actors stand at
    ego-frame offsets inside ``view`` = (behind, ahead, to each side)
    metres, any heading.

    With ``tiles`` (an EnvConfig), to stress the BEV kernels' cell lookup,
    tiles and culling (``ops/bev_tiles.py``) in a view of its width: env j
    faces along a multiple of 90 degrees and stands on a corner of the
    spatial-hash cell grid (j % 4 == 0), or with an end of a boundary edge
    (1), an end of a stop line (2) or the centre of a stop sign made its
    active one (3) on a tile-corner pixel; its actors are centred on
    tile-corner pixels, half of them at multiples of 90 degrees. A
    tile-corner pixel is the first or last row and column of a tile at an
    inner corner where four tiles meet."""
    envs = np.asarray(list(envs), dtype=np.int64)
    rs = render_state
    xy = rs.xy.cpu().numpy().copy()
    yaw = rs.yaw.cpu().numpy().copy()
    stop_idx = rs.stop_idx.cpu().numpy().copy()
    step = rs.step.cpu().numpy().copy()
    npc = rs.npc_pose.cpu().numpy().copy()
    walker = rs.walker_pose.cpu().numpy().copy()
    n_vehicles = min(n_vehicles, npc.shape[1])
    n_walkers = min(n_walkers, walker.shape[1])
    if tiles is None:
        _place_at_signals(scene, envs, rng, view, xy, yaw, stop_idx, step,
                          npc[:, :n_vehicles], walker[:, :n_walkers])
    else:
        _place_on_tile_corners(scene, tiles, envs, rng, xy, yaw, stop_idx,
                               step, npc[:, :n_vehicles],
                               walker[:, :n_walkers])
    dev = rs.xy.device
    return dataclasses.replace(
        rs, xy=torch.from_numpy(xy).to(dev), yaw=torch.from_numpy(yaw).to(dev),
        step=torch.from_numpy(step).to(dev),
        stop_idx=torch.from_numpy(stop_idx).to(dev),
        npc_pose=torch.from_numpy(npc).to(dev),
        walker_pose=torch.from_numpy(walker).to(dev),
    )


def _place_at_signals(scene, envs, rng, view, xy, yaw, stop_idx, step,
                      *actors):
    stop = scene.tl_stop.cpu().numpy()
    tl_yaw = scene.tl_yaw.cpu().numpy()
    ss_c = scene.ss_center.cpu().numpy()
    for j in envs:
        if j % 2 == 0:
            i = rng.integers(0, scene.tl_n)
            yaw[j] = tl_yaw[i] + rng.normal(0.0, 0.2)
            xy[j] = stop[i].mean(0) - 2.0 * np.array(
                [np.cos(yaw[j]), np.sin(yaw[j])])
            stop_idx[j] = -1
        else:
            i = rng.integers(0, scene.ss_n)
            yaw[j] = rng.uniform(-np.pi, np.pi)
            xy[j] = ss_c[i] + rng.normal(0.0, 1.5, 2)
            stop_idx[j] = i
        step[j] = rng.integers(0, 240)
    behind, ahead, side = view
    m = len(envs)
    c, s = np.cos(yaw[envs, None]), np.sin(yaw[envs, None])
    for pose in actors:
        count = pose.shape[1]
        lx = rng.uniform(-behind, ahead, (m, count))
        ly = rng.uniform(-side, side, (m, count))
        pose[envs] = np.stack([
            xy[envs, :1] + lx * c - ly * s, xy[envs, 1:] + lx * s + ly * c,
            rng.uniform(-np.pi, np.pi, (m, count))], -1)


def _place_on_tile_corners(scene, cfg: EnvConfig, envs, rng, xy, yaw,
                           stop_idx, step, *actors):
    fwd_off, right_off, scale = bev_tiles.view_params(cfg)
    tx, ty = bev_tiles.tile_grid(cfg.bev_width)
    rows, cols = bev_tiles.TILE_ROWS, bev_tiles.TILE_COLS
    lo = scene.cell_grid_lo.cpu().numpy().astype(np.float64)
    gy, gx = scene.cell_road.shape[:2]
    bnd = scene.cell_bnd.cpu().numpy().reshape(-1, scene.cell_bnd.shape[2],
                                               4)
    bnd_n = scene.cell_bnd_n.cpu().numpy().reshape(-1)
    stop = scene.tl_stop.cpu().numpy()
    ss_c = scene.ss_center.cpu().numpy()

    def corner_pixel():
        row = rows * int(rng.integers(1, max(ty, 2)))
        col = cols * int(rng.integers(1, max(tx, 2)))
        return row - int(rng.integers(0, 2)), col - int(rng.integers(0, 2))

    def pixel_offset(c, s, row, col):
        """World offset of pixel (row, col) from the ego at heading c, s."""
        return np.array([
            fwd_off * c + right_off * s - col * scale * s - row * scale * c,
            fwd_off * s - right_off * c + col * scale * c - row * scale * s,
        ])

    for j in envs:
        yaw[j] = np.float32(0.5 * np.pi * int(rng.integers(0, 4)))
        c, s = np.cos(yaw[j]), np.sin(yaw[j])
        kind = j % 4
        stop_idx[j] = -1
        step[j] = rng.integers(0, 240)
        if kind == 0:
            pos = lo + scene.cell_size * np.array(
                [rng.integers(1, gx), rng.integers(1, gy)])
        else:
            if kind == 1:
                cell = rng.choice(np.flatnonzero(bnd_n > 0))
                seg = bnd[cell, rng.integers(0, bnd_n[cell])]
                target = seg[2 * int(rng.integers(0, 2)):][:2]
            elif kind == 2:
                target = stop[rng.integers(0, scene.tl_n),
                              rng.integers(0, 2)]
            else:
                stop_idx[j] = rng.integers(0, scene.ss_n)
                target = ss_c[stop_idx[j]]
            pos = target - pixel_offset(c, s, *corner_pixel())
        xy[j] = pos
        for pose in actors:
            for a in range(pose.shape[1]):
                pose[j, a, :2] = pos + pixel_offset(c, s, *corner_pixel())
                pose[j, a, 2] = (0.5 * np.pi * int(rng.integers(0, 4))
                                 if a % 2 == 0 else rng.uniform(-np.pi, np.pi))
