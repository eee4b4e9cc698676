"""Full observation dictionary: port of
``gail_carla_tpu/sim/observations.py``, batched over a leading env axis.

The parity surface for the reference's ObsManager family
(``carla_gym/core/obs_manager/``), beyond the policy's hot path (BEV mask
0 + metrics 4-vector). Returns the nested dict CarlaMultiAgentEnv's obs
carries per hero (obs_configs in carla_env.py:17-62), each leaf with the
env axis in front of the JAX function's per-env shape:

- actor_state.speed / velocity / control / route  (.../actor_state/*.py)
- navigation.gnss (gnss/imu/target_gps/command)    (.../navigation/gnss.py)
- navigation.waypoint_plan (next K route steps)    (waypoint_plan.py)
- object_finder.vehicle / pedestrian               (object_finder/*.py)
- birdview (rendered + 15-channel masks) when cfg.full_bev

Route windows are taken with ``take_window``, whose start clamp is the
one ``jax.lax.dynamic_slice`` applies: near a row's end the window is the
row's last K points, not a padded one.
"""
from __future__ import annotations

import math

import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops.bev_full import render_bev_full
from gail_carla_tpu_torch.sim.cursor import (
    route_transform, take_row, take_window,
)
from gail_carla_tpu_torch.sim.state import WorldState
from gail_carla_tpu_torch.sim.transforms import (
    cast_angle, location_to_gps, norm2, vec_global_to_ref,
)

# the object finders' radius: actors nearer than this are flagged
FINDER_RADIUS = 15.0


def _to_ego(pts: torch.Tensor, ego_xy: torch.Tensor, ego_yaw: torch.Tensor):
    """(N, K, 2) world points in each env's ego frame."""
    return vec_global_to_ref(pts - ego_xy[:, None, :], ego_yaw[:, None])


def _finder(ego_xy, ego_yaw, xy, yaw, speed, n_out: int):
    """The ``n_out`` nearest actors of (N, K) in each ego frame, nearest
    first (a stable sort, as ``jnp.argsort``), padded with empty slots when
    K < ``n_out``."""
    n, k = yaw.shape
    dev = yaw.device
    if k == 0:
        return {
            "binary_mask": torch.zeros((n, n_out), dtype=torch.bool,
                                       device=dev),
            "location": torch.zeros((n, n_out, 2), device=dev),
            "rotation": torch.zeros((n, n_out), device=dev),
            "absolute_velocity": torch.zeros((n, n_out, 2), device=dev),
        }
    local = _to_ego(xy, ego_xy, ego_yaw)
    dist = norm2(local)
    order = torch.argsort(dist, dim=1, stable=True)[:, :n_out]
    pad = n_out - order.shape[1]

    def sel(a):
        idx = order.reshape(order.shape + (1,) * (a.ndim - 2))
        return torch.gather(a, 1, idx.expand(order.shape + a.shape[2:]))

    def padded(a):
        fill = torch.zeros((n, pad) + a.shape[2:], dtype=a.dtype,
                           device=dev)
        return torch.cat([a, fill], dim=1)

    vel_g = speed[..., None] * torch.stack([torch.cos(yaw), torch.sin(yaw)],
                                           dim=-1)
    return {
        "binary_mask": padded(sel(dist) < FINDER_RADIUS),
        "location": padded(sel(local)),
        "rotation": padded(cast_angle(sel(yaw) - ego_yaw[:, None])),
        "absolute_velocity": padded(sel(vel_g)),
    }


def observe_full(
    scene,
    cfg: EnvConfig,
    state: WorldState,
    k_waypoints: int = 20,      # waypoint_plan 'steps' (carla_env.py:59)
    max_detection: int = 10,    # object_finder configs (valeo_action.py:17)
):
    """The nested observation dict of N envs (see the module docstring)."""
    ego = state.ego
    rid, head = state.route_id, state.head
    n = head.shape[0]
    dev = head.device
    speed = torch.abs(ego.speed)
    zeros = torch.zeros((n, 1), device=dev)

    def col(v):
        return v[:, None]

    # --- actor_state.speed (speed.py:11-45) ---
    obs_speed = {
        "speed": col(speed),
        "speed_xy": col(speed),
        "forward_speed": col(ego.speed),
    }

    # --- actor_state.velocity (velocity.py:8-43): ego-frame vel/acc ---
    vel = ego.speed[:, None] * torch.stack(
        [torch.cos(ego.yaw), torch.sin(ego.yaw)], dim=-1
    )
    obs_velocity = {
        "vel_xy": vec_global_to_ref(vel, ego.yaw),
        "acc_xy": torch.zeros((n, 2), device=dev),  # no accel kept
        "ang_z": zeros,
    }

    # --- actor_state.control (control.py:7-37) ---
    obs_control = {
        "throttle": zeros,
        "steer": col(state.last_steer),
        "brake": zeros,
        "gear": torch.ones((n, 1), device=dev),
        "speed_limit": torch.full((n, 1), 8.33, device=dev),  # 30 km/h
    }

    # --- actor_state.route (route.py:8-71) ---
    tf_xy, tf_yaw = route_transform(scene, rid, head, state.last_head)
    d_vec = ego.xy - tf_xy
    lateral = (-torch.sin(tf_yaw) * d_vec[:, 0]
               + torch.cos(tf_yaw) * d_vec[:, 1])
    route_locs = take_window(scene.route_xy, rid, head, 5)
    obs_route = {
        "lateral_dist": col(torch.abs(lateral)),
        "angle_diff": col(cast_angle(ego.yaw - tf_yaw)),
        "route_locs": _to_ego(route_locs, ego.xy, ego.yaw).reshape(n, -1),
        "dist_remaining": col(scene.route_len_m[rid.long()]
                              - take_row(scene.route_s, rid, head)),
    }

    # --- navigation.gnss (gnss.py:76-123) ---
    gps = location_to_gps(ego.xy)
    pn = scene.plan_n[rid.long()]
    tgt_idx = torch.minimum((state.plan_idx + 1).clamp_min(0), pn - 1)
    compass = cast_angle(ego.yaw + math.pi / 2.0)  # CARLA compass
    obs_gnss = {
        "gnss": torch.cat([gps, zeros], dim=1),
        "imu": torch.cat([torch.zeros((n, 6), device=dev), col(compass)],
                         dim=1),
        "target_gps": torch.cat(
            [take_row(scene.plan_gps, rid, tgt_idx), zeros], dim=1
        ),
        "command": col(take_row(scene.plan_cmd, rid, tgt_idx)),
    }

    # --- navigation.waypoint_plan (waypoint_plan.py:9-71) ---
    k = k_waypoints
    obs_plan = {
        "location": _to_ego(take_window(scene.route_xy, rid, head, k),
                            ego.xy, ego.yaw),
        "command": take_window(scene.route_cmd, rid, head, k),
        "road_id": torch.zeros((n, k), dtype=torch.int32, device=dev),
        "lane_id": torch.zeros((n, k), dtype=torch.int32, device=dev),
        "is_junction": torch.zeros((n, k), dtype=torch.bool, device=dev),
    }

    # --- object_finder.vehicle / pedestrian (K nearest in ego frame) ---
    t = state.traffic
    obs_vehicles = _finder(ego.xy, ego.yaw, t.veh.xy, t.veh.yaw,
                           t.veh.speed, max_detection)
    obs_walkers = _finder(ego.xy, ego.yaw, t.walker_xy, t.walker_yaw,
                          t.walker_speed, max_detection)
    obs_walkers["on_sidewalk"] = torch.zeros((n, max_detection),
                                             dtype=torch.bool, device=dev)

    obs = {
        "speed": obs_speed,
        "velocity": obs_velocity,
        "control": obs_control,
        "route_plan": obs_plan,
        "route_state": obs_route,
        "gnss": obs_gnss,
        "surrounding_vehicles": obs_vehicles,
        "surrounding_pedestrians": obs_walkers,
    }

    if cfg.full_bev and state.history is not None:
        masks, rendered, col_px = render_bev_full(
            scene, cfg, ego.xy, ego.yaw, rid, head, state.history
        )
        obs["birdview"] = {
            "rendered": rendered,
            "masks": masks,
            "collision_px": col_px,
        }
    return obs
