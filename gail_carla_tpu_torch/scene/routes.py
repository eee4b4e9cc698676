"""Procedural route generation over a lane graph (numpy, host side).

Copy of ``gail_carla_tpu/scene/routes.py::generate_routes``; the XML
readers and writers that only the town importers use are not ported. A
route is an ordered list of keypoint poses; dense tracing happens in
``scene.trace``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from gail_carla_tpu_torch.scene.town import LaneGraph, astar, nearest_edge_point


@dataclasses.dataclass
class RouteDef:
    route_id: int
    town: str
    waypoints: np.ndarray      # (K, 3): x, y, yaw(rad)


def generate_routes(
    graph: LaneGraph,
    n_routes: int = 10,
    min_length: float = 400.0,
    max_waypoints: int = 10,
    seed: int = 2021,
    town: str = "GridTown",
) -> List[RouteDef]:
    """Random routes over a lane graph: pick a spawn, then chain random
    reachable targets until the route is at least ``min_length`` m.
    Plays the role of the shipped leaderboard route files (the reference
    trains on routes 0-9 of ``routes_training.xml``,
    ``params_variable.json:13``)."""
    rng = np.random.default_rng(seed)
    spawns = graph.spawn_points(spacing=40.0)
    routes: List[RouteDef] = []
    attempts = 0
    while len(routes) < n_routes and attempts < n_routes * 40:
        attempts += 1
        wps = [spawns[rng.integers(len(spawns))]]
        total = 0.0
        ok = True
        while total < min_length and len(wps) < max_waypoints:
            cand = spawns[rng.integers(len(spawns))]
            if np.linalg.norm(cand[:2] - wps[-1][:2]) < 50.0:
                continue
            ek_a, _ = nearest_edge_point(graph, wps[-1][:2])
            ek_b, _ = nearest_edge_point(graph, cand[:2])
            path = astar(graph, graph.edges[ek_a].dst, graph.edges[ek_b].src)
            if path is None:
                ok = False
                break
            total += sum(graph.edges[k].length for k in path)
            wps.append(cand)
        if ok and total >= min_length:
            routes.append(
                RouteDef(
                    route_id=len(routes), town=town,
                    waypoints=np.array(wps, dtype=np.float64),
                )
            )
    if len(routes) < n_routes:
        raise RuntimeError(
            f"could only generate {len(routes)}/{n_routes} routes"
        )
    return routes
