"""File-backed expert dataset: reads a ``gail_experts/`` PNG tree.

Port of ``gail_carla_tpu/tools/expert_dataset.py`` (``algo/wdgail.py:
192-241``, ExpertDataset): ``episode.json`` gives actions and metrics,
``birdview_masks/{step:04d}_00.png`` the policy observation. Trees come
from ``tools/gen_trajectories.py`` of either package or from the
reference's CARLA pipeline; ``utils/png.py`` reads them and raises on a
PNG kind it does not read.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from gail_carla_tpu_torch.algo.buffers import ExpertBuffer
from gail_carla_tpu_torch.sim.env import RenderState
from gail_carla_tpu_torch.utils.png import read_png

# 6-channel obs: the current-frame (history tap -1) planes of the 15-mask
# stack as (file m, RGB plane): lights ch 14 = file 04 plane B, vehicles
# ch 6 = file 02 plane R, walkers ch 10 = file 03 plane G
CURRENT_PLANES = ((4, 2), (2, 0), (3, 1))


def _tree_root(root: Path, first_route: int) -> Path:
    """The reference passes ``gail_experts/<trajectory>`` as the root
    (wdail_carla.py:159); the parent (``gen_trajectories --out``) is
    accepted too, by descending into its sole trajectory directory."""
    if (root / f"route_{first_route:02d}").is_dir():
        return root
    subdirs = [d for d in sorted(root.iterdir())
               if d.is_dir() and (d / f"route_{first_route:02d}").is_dir()]
    return subdirs[0] if len(subdirs) == 1 else root


def load_expert_tree(dataset_directory: str, routes: Sequence[int],
                     n_eps: int = 1, start: int = 0, n_channels: int = 3):
    """Returns numpy (obs u8 (M, C, W, W), metrics (M, 4), actions (M, 2)).

    ``n_channels=3`` loads mask file 00 (road, route, lane: the
    reference's policy obs, wdgail.py:233-236); ``n_channels=6`` adds the
    current-frame signal, vehicle and walker planes of the 15-channel
    stack, in ``ops/bev6.py``'s channel order. Steps whose mask file is
    missing are skipped, as the JAX loader does."""
    root = _tree_root(Path(dataset_directory), routes[0])
    obs_l, met_l, act_l = [], [], []
    for route_idx in routes:
        for ep_idx in range(start, start + n_eps):
            ep_dir = root / f"route_{route_idx:02d}" / f"ep_{ep_idx:02d}"
            df = json.loads((ep_dir / "episode.json").read_text())
            acts, mets = df["actions"], df["metrics"]
            for i in range(len(acts)):
                masks = ep_dir / "birdview_masks"
                png = masks / f"{i:04d}_00.png"
                if not png.exists():
                    continue
                chw = np.transpose(read_png(png), (2, 0, 1))
                if n_channels == 6:
                    chw = np.concatenate([chw] + [
                        read_png(masks / f"{i:04d}_{m:02d}.png")[None, ..., c]
                        for m, c in CURRENT_PLANES], axis=0)
                obs_l.append(chw)
                act_l.append(np.asarray(acts[str(i)], np.float32)[:2])
                met_l.append(np.asarray(mets[str(i)], np.float32)[:4])
    if not obs_l:
        raise FileNotFoundError(
            f"no expert steps found under {dataset_directory}")
    return (np.stack(obs_l).astype(np.uint8), np.stack(met_l),
            np.stack(act_l))


def expert_buffer_from_tree(dataset_directory: str, routes: Sequence[int],
                            n_eps: int = 1, start: int = 0,
                            n_channels: int = 3,
                            device="cpu") -> ExpertBuffer:
    """An ``ExpertBuffer`` of file demos on ``device``: obs are the (M, C,
    W, W) uint8 planes (``algo/buffers.py::fetch_expert_obs`` decodes
    them), render states are dummies, so nothing re-renders."""
    obs, metrics, actions = load_expert_tree(dataset_directory, routes,
                                             n_eps, start, n_channels)
    m = obs.shape[0]
    zi = dict(dtype=torch.int32, device=device)
    render = RenderState(
        xy=torch.zeros((m, 2), device=device),
        yaw=torch.zeros((m,), device=device),
        route_id=torch.zeros((m,), **zi),
        head=torch.zeros((m,), **zi),
        step=torch.zeros((m,), **zi),
        stop_idx=torch.full((m,), -1, **zi),
        npc_pose=torch.zeros((m, 0, 3), device=device),
        walker_pose=torch.zeros((m, 0, 3), device=device),
    )
    return ExpertBuffer(render=render,
                        metrics=torch.from_numpy(metrics).to(device),
                        obs=torch.from_numpy(obs).to(device),
                        actions=torch.from_numpy(actions).to(device))
