"""Rollout and expert-demo buffers: port of
``gail_carla_tpu/algo/buffers.py``.

Two observation policies, both on the device (state-vector observations,
``obs_mode="state"``, are stored as float32 (T, N, D) rows instead):

- ``obs`` stored BIT-PACKED, one uint8 per pixel (T, N, W, W): rendered
  once while acting, unpacked per minibatch (an expert buffer read from
  a PNG tree holds (M, C, W, W) uint8 planes instead). Every BEV channel
  is discrete (road/route/vehicle/walker binary, lane in {0, 120, 255},
  signal in {0, 80, 170, 255}), so the 3- or 6-channel image packs
  losslessly into 8 bits per pixel.
- ``obs = None``: minibatches re-render from the compact RenderState
  (kernel B1 or B2 on the card).

Unpacking reproduces the renderers' floats bit for bit: it multiplies the
level by ``ops/bev.py::INV_255`` as they do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops.bev import INV_255, render_bev_batch_auto
from gail_carla_tpu_torch.ops.bev6 import render_bev6_batch_auto
from gail_carla_tpu_torch.ops.state_obs import (
    STATE_OBS_DIM, state_observation_batch,
)
from gail_carla_tpu_torch.utils.trace import span

# rows rendered per pass when an expert buffer materialises its obs
EXPERT_CHUNK = 512


@dataclasses.dataclass
class Rollout:
    """(T, N, ...) on-policy buffer; row [T] of metrics/render/values/obs
    holds the bootstrap step."""

    render: object               # RenderState, leaves (T+1, N, ...)
    metrics: torch.Tensor        # (T+1, N, 4)
    obs: Optional[torch.Tensor]  # (T+1, N, W, W) packed uint8,
    #                              (T+1, N, D) float32 state, or None
    actions: torch.Tensor        # (T, N, 2)
    logp: torch.Tensor           # (T, N)
    values: torch.Tensor         # (T+1, N)
    env_rewards: torch.Tensor    # (T, N)
    masks: torch.Tensor          # (T+1, N); masks[t+1] = 0 if step t ended
    gail_rewards: torch.Tensor   # (T, N), filled by the relabel pass

    @property
    def T(self):
        return self.actions.shape[0]

    @property
    def N(self):
        return self.actions.shape[1]


@dataclasses.dataclass
class ExpertBuffer:
    """Flat (M, ...) expert transitions (compacted to valid steps)."""

    render: object               # RenderState, leaves (M, ...)
    metrics: torch.Tensor        # (M, 4)
    obs: Optional[torch.Tensor]  # (M, W, W) packed / (M, C, W, W) u8
    #                              / (M, D) float32 state
    actions: torch.Tensor        # (M, 2)

    @property
    def size(self):
        return self.actions.shape[0]


def map_state(fn: Callable, state):
    """``fn`` applied to every field of a dataclass state (RenderState)."""
    return type(state)(**{f.name: fn(getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def obs_batch(scene, cfg: EnvConfig, render_state, metrics):
    """The policy observation of a render-state batch and its metrics: the
    3-channel BEV (``obs_mode="bev"``), the 6-channel one (``"bev6"``) or
    the state vector (``"state"``, which reads the metrics)."""
    with span("rollout.obs"):
        if cfg.obs_mode == "state":
            return state_observation_batch(scene, cfg, render_state, metrics)
        if cfg.obs_mode == "bev6":
            return render_bev6_batch_auto(scene, cfg, render_state)
        return render_bev_batch_auto(scene, cfg, render_state)


def _u8(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.uint8)


def pack_bev_obs(cfg: EnvConfig, obs: torch.Tensor) -> torch.Tensor:
    """(..., C, W, W) float BEV obs -> (..., W, W) uint8, one byte/pixel.

    Bit layout: 0 road, 1 route, 2-3 lane code {0,120,255},
    4-5 signal code {0,80,170,255}, 6 vehicles, 7 walkers (bev6 only).
    Thresholds sit between the discrete levels."""
    road = _u8(obs[..., 0, :, :] > 0.5)
    route = _u8(obs[..., 1, :, :] > 0.5)
    lane = obs[..., 2, :, :] * 255.0
    lane_c = _u8(lane > 60.0) + _u8(lane > 190.0)
    packed = road | (route << 1) | (lane_c << 2)
    if cfg.obs_mode == "bev6":
        sig = obs[..., 3, :, :] * 255.0
        sig_c = _u8(sig > 40.0) + _u8(sig > 125.0) + _u8(sig > 212.0)
        veh = _u8(obs[..., 4, :, :] > 0.5)
        wk = _u8(obs[..., 5, :, :] > 0.5)
        packed = packed | (sig_c << 4) | (veh << 6) | (wk << 7)
    return packed


def _levels(code: torch.Tensor, levels) -> torch.Tensor:
    """The float level of each 2-bit code (code 0 is 0), times INV_255."""
    out = torch.zeros(code.shape, dtype=torch.float32, device=code.device)
    for c, v in enumerate(levels, start=1):
        out = torch.where(code == c, v, out)
    return out * INV_255


def unpack_bev_obs(cfg: EnvConfig, packed: torch.Tensor) -> torch.Tensor:
    """(..., W, W) uint8 -> (..., C, W, W) float32, bit-identical to the
    renderer's output."""
    road = (packed & 1).to(torch.float32)
    route = ((packed >> 1) & 1).to(torch.float32)
    lane = _levels((packed >> 2) & 3, (120.0, 255.0))
    chans = [road, route, lane]
    if cfg.obs_mode == "bev6":
        sig = _levels((packed >> 4) & 3, (80.0, 170.0, 255.0))
        veh = ((packed >> 6) & 1).to(torch.float32)
        wk = ((packed >> 7) & 1).to(torch.float32)
        chans += [sig, veh, wk]
    return torch.stack(chans, dim=-3)


def store_encode(cfg: EnvConfig, obs: torch.Tensor) -> torch.Tensor:
    """Encode a float obs batch for in-buffer storage: bit-packed for the
    BEV modes, the float32 vectors themselves for ``"state"``."""
    if cfg.obs_mode == "state":
        return obs
    return pack_bev_obs(cfg, obs)


def _decode(cfg: EnvConfig, obs_stored: torch.Tensor) -> torch.Tensor:
    """Float obs of stored rows: (B, W, W) bit-packed, (B, C, W, W)
    per-channel uint8 planes (expert buffers read from a PNG tree,
    ``tools/expert_dataset.py``), or float state vectors, which pass
    through. The planes' ``/ 255.0`` in the JAX source is compiled by XLA
    into a multiply by the float32 reciprocal, which is what this
    computes."""
    if obs_stored.dtype != torch.uint8:
        return obs_stored
    if obs_stored.dim() == 4:
        return obs_stored.to(torch.float32) * INV_255
    return unpack_bev_obs(cfg, obs_stored)


def fetch_rollout_obs(scene, cfg: EnvConfig, rollout: Rollout, t_idx, n_idx):
    """(B, C, W, W) or (B, D) float obs for flat minibatch indices (t, n)."""
    if rollout.obs is not None:
        return _decode(cfg, rollout.obs[t_idx, n_idx])
    return obs_batch(scene, cfg,
                     map_state(lambda a: a[t_idx, n_idx], rollout.render),
                     rollout.metrics[t_idx, n_idx])


def fetch_expert_obs(scene, cfg: EnvConfig, buf: ExpertBuffer, idx):
    if buf.obs is not None:
        return _decode(cfg, buf.obs[idx])
    return obs_batch(scene, cfg, map_state(lambda a: a[idx], buf.render),
                     buf.metrics[idx])


def build_expert_buffer(
    scene,
    cfg: EnvConfig,
    demos,                      # algo.expert.DemoBatch
    materialize_obs: bool = True,
    size: Optional[int] = None,
    max_size: Optional[int] = None,
) -> ExpertBuffer:
    """Compact a DemoBatch to its valid steps (once, at startup). Pads by
    repeating valid rows so the result has the requested size. The packed
    obs are rendered ``EXPERT_CHUNK`` rows at a time into one buffer on the
    demos' device (state vectors: the float32 (size, D) rows)."""
    render, metrics, actions, valid = demos.flatten()
    idx = np.nonzero(valid.cpu().numpy())[0]
    if len(idx) == 0:
        raise ValueError("expert generated no valid (completed) episodes")
    if size is None:
        size = len(idx)
    if max_size is not None:
        size = min(size, max_size)
    sel = torch.from_numpy(idx[np.arange(size) % len(idx)]).to(
        actions.device)

    render_sel = map_state(lambda a: a[sel], render)
    metrics_sel = metrics[sel]
    obs = None
    if materialize_obs:
        w = cfg.bev_width
        if cfg.obs_mode == "state":
            obs = torch.empty((size, STATE_OBS_DIM), device=actions.device)
        else:
            obs = torch.empty((size, w, w), dtype=torch.uint8,
                              device=actions.device)
        for lo in range(0, size, EXPERT_CHUNK):
            chunk = slice(lo, lo + EXPERT_CHUNK)
            obs[chunk] = store_encode(cfg, obs_batch(
                scene, cfg, map_state(lambda a: a[chunk], render_sel),
                metrics_sel[chunk]))
    return ExpertBuffer(render=render_sel, metrics=metrics_sel, obs=obs,
                        actions=actions[sel])
