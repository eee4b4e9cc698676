"""The benchmark's cells cut to a size the CPU runs in seconds (a 3 x 3
grid town, 32 px, small float32 nets, a few envs), for the tests that
drive a whole run without a card. The limits stay the cells' own."""
from __future__ import annotations

import argparse
import copy

import torch

from bench_port.harness.spec import load_cell

TINY_MODEL = {"hidden_size": 32, "head_size": 16, "conv_channels": [8, 16],
              "disc_hidden": 16, "dtype": "float32"}
TINY_SCENE = {"n_routes": 2, "nx": 3, "ny": 3, "block": 80.0,
              "min_length": 150.0}
TINY_TRAIN = {"n_envs": 2, "steps_per_env": 4, "ppo_epoch": 2,
              "mini_batch": 4, "gail_batch": 4, "expert_rows": 8}
TINY_ROLLOUT = {"n_envs": 2, "steps_per_chunk": 3, "n_npc_vehicles": 2,
                "n_npc_walkers": 3, "routes": [0, 1]}
# the harness's sample sizes, cut to the tiny cells
TINY_CHECK = {"train_cell": {"SIM_ENVS": 2, "RENDER_ROWS": 4},
              "rollout_cell": {"SIM_ENVS": 2, "CHUNKS": 1, "CHUNK_POOL": 1,
                               "PHASE_REPS": 1}}


def tiny_cell(name: str):
    cell = copy.deepcopy(load_cell(name))
    cfg = cell.config
    cfg["bev_width"] = 32
    cfg["model"].update(TINY_MODEL)
    cfg["scene"] = dict(TINY_SCENE)
    cfg["routes"] = [0, 1]
    w = cell.workload
    w["traffic"].update(TINY_TRAIN if w["entry"] == "train"
                        else TINY_ROLLOUT)
    return cell


def run_tiny(name: str, seed: int = 7, seconds: float = 0.01,
             control: int = 0) -> int:
    cell = tiny_cell(name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=0, control=control)
    from bench_port.harness import rollout_cell, train_cell
    from bench_port.harness.main import run_entry

    mods = {"train_cell": train_cell, "rollout_cell": rollout_cell}
    saved = {(m, k): getattr(mods[m], k) for m, kv in TINY_CHECK.items()
             for k in kv}
    for m, kv in TINY_CHECK.items():
        for k, v in kv.items():
            setattr(mods[m], k, v)
    try:
        return run_entry(cell, args, torch.device("cpu"))
    finally:
        for (m, k), v in saved.items():
            setattr(mods[m], k, v)
