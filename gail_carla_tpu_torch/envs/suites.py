"""Task suites: port of ``gail_carla_tpu/envs/suites.py`` (the
reference's ``carla_gym/envs/suites/*``).

Each suite builds (TorchScene, EnvConfig, task list) on ``device``. A task
is a dict {weather, route_id, n_npc_vehicles, n_npc_walkers} like the
reference's task dicts (``nocrash_env.py:60-76``). The host side is the
JAX package's numpy code with the same ``default_rng(seed)`` draws, so
the scenes equal the JAX suites' array for array.

With a ``town`` argument, suites run on the reconstructed reference towns
(scene/town_import.py) and the reference's per-town route packs (NoCrash /
CoRL2017 ``scenario_descriptions/**/routes.xml``, bare start/goal pairs
planned through the town's graph); without one, on procedural grid towns
where route *shape* filtering (turn count) replaces the packs. NPC traffic
runs at the reference's full per-tier densities (nocrash_env.py:29-55,
e.g. Town01 dense = 100 vehicles / 250 walkers); on a town with sidewalk
paths the walkers follow them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.device import resolve_device
from gail_carla_tpu_torch.scene import h5_maps
from gail_carla_tpu_torch.scene.road_option import RoadOption
from gail_carla_tpu_torch.scene.routes import RouteDef, generate_routes
from gail_carla_tpu_torch.scene.scene import (
    TorchScene, _build_patrols, build_scene,
)
from gail_carla_tpu_torch.scene.town import make_grid_town
from gail_carla_tpu_torch.scene.trace import DenseRoute, _downsample

WEATHER_GROUPS = {
    "new": ["SoftRainSunset", "WetSunset"],
    "train": ["ClearNoon", "WetNoon", "HardRainNoon", "ClearSunset"],
    "train_eval": ["WetNoon", "ClearSunset"],
}

# nocrash_env.py:29-55, per town
NOCRASH_TRAFFIC = {
    "Town01": {
        "empty": (0, 0),
        "regular": (20, 50),
        "dense": (100, 250),
        "leaderboard": (120, 120),
    },
    "Town02": {
        "empty": (0, 0),
        "regular": (15, 50),
        "dense": (70, 150),
        "leaderboard": (70, 70),
    },
}

# the reference's route packs (a checkout at h5_maps.REFERENCE_DATA)
SCENARIO_DESCRIPTIONS = os.path.join(
    h5_maps.REFERENCE_DATA, "carla_gym", "envs", "scenario_descriptions")

CORL_TASK_DIRS = {
    "straight": "Straight", "one_curve": "OneCurve",
    "navigation": "Navigation", "navigation_dynamic": "Navigation",
}
# corl2017_env.py:41-46
CORL_DYNAMIC_TRAFFIC = {"Town01": (20, 50), "Town02": (15, 50)}


def _tasks(weathers, route_ids, n_veh, n_wal) -> List[Dict]:
    return [
        {
            "weather": w,
            "route_id": int(r),
            "n_npc_vehicles": n_veh,
            "n_npc_walkers": n_wal,
        }
        for w in weathers
        for r in route_ids
    ]


def leaderboard_suite(
    n_routes: int = 10, weather_group: str = "train", seed: int = 2021,
    nx: int = 4, ny: int = 4, block: float = 100.0,
    town: str = None, route_file: str = "routes_training.xml",
    scenario_actors=None, device="cuda",
) -> Tuple[TorchScene, EnvConfig, List[Dict]]:
    """leaderboard_env.py: LeaderBoard routes, zombie counts zeroed
    (leaderboard_env.py:34-49). With ``town`` set (e.g. "Town01") the
    scene is the reconstructed reference town with that town's block of
    ``route_file`` as the task routes, the reference's actual benchmark
    (training routes 0-9 == the LeaderBoard Town01 pack). Without it, the
    procedural grid town.

    ``scenario_actors`` maps route_id -> [(polyline_xy, speed), ...],
    scripted per-route adversaries (the actors.json counterpart the
    reference's ScenarioActorHandler ticks); they fill the last
    ``n_scenario_actors = scene.sa_max`` vehicle slots. Generated scenes
    only, as in the JAX suite."""
    if town is not None and scenario_actors is not None:
        raise ValueError(
            "scenario_actors are a task field for generated scenes")
    dev = resolve_device(device)
    if town is not None:
        from gail_carla_tpu_torch.scene.town_import import make_town_scene

        scene = make_town_scene(town, route_file, device=dev)
        n_routes = scene.n_routes
    else:
        graph = make_grid_town(nx=nx, ny=ny, block=block, seed=seed)
        routes = generate_routes(graph, n_routes=n_routes,
                                 min_length=400.0, seed=seed)
        scene = build_scene(graph, routes,
                            scenario_actors=scenario_actors).to(dev)
    cfg = EnvConfig(
        train=True, terminal_mode="leaderboard",
        n_scenario_actors=int(scene.sa_max),
    )
    tasks = _tasks(WEATHER_GROUPS[weather_group], range(n_routes), 0, 0)
    return scene, cfg, tasks


def nocrash_suite(
    background_traffic: str = "regular", weather_group: str = "train",
    n_routes: int = 10, seed: int = 2021,
    town: str = None, route_description: str = "lbc", device="cuda",
) -> Tuple[TorchScene, EnvConfig, List[Dict]]:
    """nocrash_env.py: with ``town`` ("Town01"/"Town02") the scene is the
    reconstructed real town and the routes are the shipped NoCrash pack
    (``scenario_descriptions/NoCrash/<route_description>/<town>/
    routes.xml``, start/goal pairs planned through the completed lane
    graph; nocrash_env.py:57-59). Without it, the procedural 3x3 grid
    town. Traffic densities follow nocrash_env.py:29-55 per town at the
    reference's FULL counts (Town01 dense = 100/250)."""
    dev = resolve_device(device)
    if town is not None:
        from gail_carla_tpu_torch.scene.town_import import make_town_scene

        pack = os.path.join(SCENARIO_DESCRIPTIONS, "NoCrash",
                            route_description, town, "routes.xml")
        scene = make_town_scene(town, pack, device=dev)
        n_routes = scene.n_routes
    else:
        graph = make_grid_town(nx=3, ny=3, block=90.0, seed=seed)
        routes = generate_routes(graph, n_routes=n_routes,
                                 min_length=300.0, seed=seed)
        scene = build_scene(graph, routes).to(dev)
    n_veh, n_wal = NOCRASH_TRAFFIC[town or "Town01"][background_traffic]
    cfg = EnvConfig(
        train=True, terminal_mode="leaderboard",
        n_npc_vehicles=n_veh, n_npc_walkers=n_wal,
    )
    tasks = _tasks(
        WEATHER_GROUPS[weather_group], range(n_routes), n_veh, n_wal
    )
    return scene, cfg, tasks


def _walk_shaped_route(graph, rng, n_turns: int, min_len: float):
    """Walk the lane graph taking exactly ``n_turns`` LEFT/RIGHT junction
    connectors (STRAIGHT otherwise); waypoints pin every turn so the A*
    retrace reproduces the intended shape."""
    turn_opts = (int(RoadOption.LEFT), int(RoadOption.RIGHT))
    for _ in range(200):
        ek = int(rng.integers(len(graph.edges)))
        e = graph.edges[ek]
        if e.is_junction:
            continue
        waypoints = [
            [e.pts[0][0], e.pts[0][1], 0.0]
        ]
        length = e.length
        turns = 0
        cur = e
        ok = True
        while length < min_len or turns < n_turns:
            outs = graph.adjacency.get(cur.dst, [])
            if not outs:
                ok = False
                break
            cand_turn = [
                k for k in outs if int(graph.edges[k].option) in turn_opts
            ]
            cand_straight = [
                k for k in outs
                if int(graph.edges[k].option) not in turn_opts
            ]
            if turns < n_turns and cand_turn and length > 40.0:
                k = int(rng.choice(cand_turn))
                turns += 1
                cur = graph.edges[k]
                waypoints.append([cur.pts[-1][0], cur.pts[-1][1], 0.0])
            elif cand_straight:
                k = int(rng.choice(cand_straight))
                cur = graph.edges[k]
            elif cand_turn and turns < n_turns:
                k = int(rng.choice(cand_turn))
                turns += 1
                cur = graph.edges[k]
                waypoints.append([cur.pts[-1][0], cur.pts[-1][1], 0.0])
            else:
                ok = False
                break
            length += cur.length
            if length > min_len * 3:
                ok = turns >= n_turns
                break
        if not ok or turns != n_turns or length < min_len:
            continue
        waypoints.append([cur.pts[-1][0], cur.pts[-1][1], 0.0])
        return np.asarray(waypoints)
    return None


def corl2017_suite(
    task_type: str = "straight", weather_group: str = "train",
    seed: int = 2021, town: str = None, route_description: str = "lbc",
    device="cuda",
) -> Tuple[TorchScene, EnvConfig, List[Dict]]:
    """corl2017_env.py: straight / one_curve / navigation[_dynamic] tasks.
    With ``town`` set, routes come from the shipped per-shape pack
    (``scenario_descriptions/CoRL2017/<route_description>/<TaskDir>/
    <town>/routes.xml``, corl2017_env.py:28-46) planned through the
    reconstructed town; otherwise the procedural 4x4 grid town's shaped
    routes come from graph walks with a turn budget (0, 1 or 4 turns)."""
    assert task_type in (
        "straight", "one_curve", "navigation", "navigation_dynamic"
    )
    dev = resolve_device(device)
    if town is not None:
        from gail_carla_tpu_torch.scene.town_import import make_town_scene

        pack = os.path.join(SCENARIO_DESCRIPTIONS, "CoRL2017",
                            route_description, CORL_TASK_DIRS[task_type],
                            town, "routes.xml")
        scene = make_town_scene(town, pack, device=dev)
        dyn = task_type == "navigation_dynamic"
        n_veh, n_wal = CORL_DYNAMIC_TRAFFIC[town] if dyn else (0, 0)
        cfg = EnvConfig(
            train=True, terminal_mode="leaderboard",
            n_npc_vehicles=n_veh, n_npc_walkers=n_wal,
        )
        tasks = _tasks(WEATHER_GROUPS[weather_group],
                       range(scene.n_routes), n_veh, n_wal)
        return scene, cfg, tasks
    graph = make_grid_town(nx=4, ny=4, block=100.0, seed=seed)
    rng = np.random.default_rng(seed)
    n_turns = {"straight": 0, "one_curve": 1}.get(task_type, 4)
    picked: List[RouteDef] = []
    while len(picked) < 6:
        wps = _walk_shaped_route(graph, rng, n_turns, min_len=150.0)
        if wps is None:
            break
        picked.append(
            RouteDef(route_id=len(picked), town="GridTown", waypoints=wps)
        )
    if not picked:
        raise RuntimeError(f"no {task_type} routes found in the town")
    scene = build_scene(graph, picked).to(dev)
    dyn = task_type == "navigation_dynamic"
    n_veh, n_wal = (20, 16) if dyn else (0, 0)
    cfg = EnvConfig(
        train=True, terminal_mode="leaderboard",
        n_npc_vehicles=n_veh, n_npc_walkers=n_wal,
    )
    tasks = _tasks(
        WEATHER_GROUPS[weather_group], range(len(picked)), n_veh, n_wal
    )
    return scene, cfg, tasks


def endless_suite(
    n_npc_vehicles: int = 16, n_npc_walkers: int = 16,
    weather_group: str = "train", seed: int = 2021, n_rows: int = 8,
    row_m: float = 1000.0, max_time: float = 1200.0, device="cuda",
) -> Tuple[TorchScene, EnvConfig, List[Dict]]:
    """endless_env.py: no fixed route. The reference keeps appending
    random >= 1000 m targets during the episode (task_vehicle.py:67-82,
    143-145); here one long random lane walk is sliced into ~``row_m``
    metre rows that share boundary poses, ``scene.endless_next`` links
    them, and ``sim/env.py::chain_endless`` continues an env onto the next
    row when one is exhausted (``EnvConfig.endless_extension``). Timeout
    is success (terminal/valeo.py:92-96)."""
    dev = resolve_device(device)
    graph = make_grid_town(nx=4, ny=4, block=100.0, seed=seed)
    walk_xy, walk_yaw, walk_cmd = _build_patrols(
        graph, 1, length_m=n_rows * row_m + 200.0, seed=seed
    )[0]
    d = np.linalg.norm(np.diff(walk_xy, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    # slice at arc-length multiples of row_m; rows share boundary points
    bounds = [int(np.searchsorted(s, k * row_m)) for k in range(n_rows)]
    bounds.append(len(walk_xy) - 1)
    rows: List[DenseRoute] = []
    defs: List[RouteDef] = []
    for r in range(n_rows):
        lo, hi = bounds[r], bounds[r + 1]
        if hi - lo < 20:
            break
        xy = walk_xy[lo:hi + 1]
        cmd = walk_cmd[lo:hi + 1]
        yaw = walk_yaw[lo:hi + 1]
        rs = s[lo:hi + 1] - s[lo]
        plan_idx = _downsample(xy, cmd, sample_factor=50.0)
        rows.append(DenseRoute(
            xy=xy, yaw=yaw, cmd=cmd, s=rs,
            plan_xy=xy[plan_idx], plan_cmd=cmd[plan_idx],
        ))
        defs.append(RouteDef(
            route_id=r, town="GridTown",
            waypoints=np.array([[*xy[0], yaw[0]], [*xy[-1], yaw[-1]]]),
        ))
    scene = build_scene(graph, defs, dense=rows, route_pts_pad=512)
    nxt = np.arange(1, len(rows) + 1, dtype=np.int32)
    nxt[-1] = len(rows) - 1   # last row has no continuation
    scene = dataclasses.replace(scene, endless_next=torch.from_numpy(nxt))
    cfg = EnvConfig(
        train=True, terminal_mode="valeo", max_time=max_time,
        endless_extension=True,
        n_npc_vehicles=n_npc_vehicles, n_npc_walkers=n_npc_walkers,
    )
    tasks = _tasks(
        WEATHER_GROUPS[weather_group], range(len(rows)), n_npc_vehicles,
        n_npc_walkers,
    )
    return scene.to(dev), cfg, tasks
