# Frozen copy of gail_carla_tpu_torch/ops/state_obs.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""State-vector observation (``obs_mode="state"``), the BEV-free path:
port of ``gail_carla_tpu/ops/state_obs.py``.

Feature layout (D = 2*K + 4):
- the next K route waypoints in the ego frame (K=10, 2 m apart)  [2K]
- heading error to the route point under the cursor                [1]
- signed lateral distance to it                                    [1]
- speed                                                            [1]
- command / 4                                                      [1]
"""
from __future__ import annotations

import torch

from bench_port.plain_reference.frozen.config import EnvConfig
from bench_port.plain_reference.frozen.sim.cursor import take_row, take_window
from bench_port.plain_reference.frozen.sim.transforms import cast_angle, vec_global_to_ref

K_WAYPOINTS = 10
STATE_OBS_DIM = 2 * K_WAYPOINTS + 4


def state_observation_batch(scene, cfg: EnvConfig, render_state,
                            metrics: torch.Tensor) -> torch.Tensor:
    """(..., D) float32 observations of a render-state batch with any
    leading shape and its (..., 4) metrics. The 20-point route window is
    clamped into the row as ``dynamic_slice`` clamps it."""
    lead = render_state.yaw.shape
    rid = render_state.route_id.reshape(-1)
    head = render_state.head.reshape(-1)
    xy = render_state.xy.reshape(-1, 2)
    yaw = render_state.yaw.reshape(-1)
    met = metrics.reshape(-1, 4)

    pts = take_window(scene.route_xy, rid, head, 2 * K_WAYPOINTS)[:, ::2]
    local = vec_global_to_ref(pts - xy[:, None, :], yaw[:, None])

    yaw0 = take_row(scene.route_yaw, rid, head)
    heading_err = cast_angle(yaw - yaw0)
    d = xy - take_row(scene.route_xy, rid, head)
    lateral = -torch.sin(yaw0) * d[:, 0] + torch.cos(yaw0) * d[:, 1]

    obs = torch.cat([
        local.reshape(-1, 2 * K_WAYPOINTS) * 0.05,
        heading_err[:, None],
        lateral[:, None],
        met[:, 2:3] * 0.1,
        met[:, 3:4] / 4.0,
    ], dim=1)
    return obs.reshape(lead + (STATE_OBS_DIM,))
