"""Per-env episode CSV logs: port of ``gail_carla_tpu/utils/monitor.py``
(EnvMonitor, ``tools/envs.py:49-100``): one CSV per env under
``<log_dir>/env_info/<env_id>.csv`` with a row per finished episode,
tagged with the episode counter and the training epoch (EnvEpoch
class-global broadcast, tools/envs.py:13-22). Fed by ``VecEnv``'s
``dones`` and ``infos``.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List


class EnvEpoch:
    """Class-global epoch broadcast, like the reference's."""

    _epoch = 0

    @classmethod
    def set_epoch(cls, epoch: int):
        cls._epoch = epoch

    @classmethod
    def get_epoch(cls) -> int:
        return cls._epoch


class EnvMonitor:
    FIELDS = [
        "ep_count", "i_epoch", "route_id", "episode_reward",
        "episode_length", "route_completed", "collision", "blocked",
        "route_deviation", "timeout", "score_composed",
    ]

    def __init__(self, log_dir: str, num_envs: int):
        self.dir = os.path.join(log_dir, "env_info")
        os.makedirs(self.dir, exist_ok=True)
        self._ep_count = [0] * num_envs
        self._writers = []
        self._files = []
        for i in range(num_envs):
            f = open(os.path.join(self.dir, f"{i}.csv"), "a", newline="")
            w = csv.DictWriter(f, fieldnames=self.FIELDS)
            if f.tell() == 0:
                w.writeheader()
            self._files.append(f)
            self._writers.append(w)

    def record_step(self, dones, infos: List[Dict]):
        """Feed per-step vec-env outputs; writes a row for each done env."""
        for i, (done, info) in enumerate(zip(dones, infos)):
            if not done:
                continue
            self._ep_count[i] += 1
            row = {
                "ep_count": self._ep_count[i],
                "i_epoch": EnvEpoch.get_epoch(),
            }
            for k in self.FIELDS[2:]:
                v = info.get(k, "")
                # bools as 0/1, everything else as given
                row[k] = int(v) if isinstance(v, (bool, int)) else v
            self._writers[i].writerow(row)
            self._files[i].flush()

    def close(self):
        for f in self._files:
            f.close()
