"""Metrics logging with the reference's TensorBoard scalar schema: port
of ``gail_carla_tpu/utils/logging.py``.

``tools/utli.py`` defines three fixed scalar families (PPO losses, 13
discriminator diagnostics, train/eval rewards). The same tag names are
emitted so that dashboards transfer: JSONL always (``metrics.jsonl``, one
row per ``write``: ``step``, ``wall_time`` and every metric that converts
to a float), TensorBoard when ``torch.utils.tensorboard`` imports.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

# tag mapping: our metrics dict key -> reference TB tag (tools/utli.py:9-101)
TAG_MAP = {
    "ppo/value_loss": "loss/value_loss",
    "ppo/action_loss": "loss/action_loss",
    "ppo/dist_entropy": "loss/dist_entropy",
    "ppo/bc_loss": "loss/bc_loss",
    "ppo/gail_action_loss": "loss/gail_loss",
    "ppo/gail_gamma": "loss/gail_gamma",
    "ppo/steer_std": "loss/steer_std",
    "ppo/throttle_std": "loss/throttle_std",
    "disc/dis_total_loss": "dis_loss/dis_total_loss",
    "disc/policy_reward": "dis_loss/policy_mean_reward",
    "disc/expert_reward": "dis_loss/expert_mean_reward",
    "disc/dis_loss": "dis_loss/dis_loss",
    "disc/dis_gp": "dis_loss/dis_gp",
    "disc/expert_loss": "dis_loss/expert_loss",
    "disc/policy_loss": "dis_loss/policy_loss",
    "disc/pre_val_wd": "dis_loss/disc_pre_loss",
    "disc/pre_val_expert": "dis_loss/expert_pre_reward",
    "disc/pre_val_policy": "dis_loss/policy_pre_reward",
    "disc/post_val_wd": "dis_loss/disc_after_loss",
    "disc/post_val_expert": "dis_loss/expert_after_reward",
    "disc/post_val_policy": "dis_loss/policy_after_reward",
    "ep_reward_mean": "results/train_reward",
    "ep_length_mean": "results/train_len",
    "gail_reward_mean": "results/gail_reward",
    "eval/reward": "results/eval_reward",
    "eval/length": "results/eval_steps",
}


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is not installed
                pass
            else:
                self._tb = SummaryWriter(log_dir)
        self._t0 = time.time()

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "wall_time": time.time() - self._t0}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k in ("step", "wall_time"):
                    continue
                self._tb.add_scalar(TAG_MAP.get(k, k), v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
