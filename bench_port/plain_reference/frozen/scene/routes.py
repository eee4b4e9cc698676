# Frozen copy of gail_carla_tpu_torch/scene/routes.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Route definitions: XML parsing/writing + procedural generation (numpy,
host side).

Copy of ``gail_carla_tpu/scene/routes.py``. File-format compatible with the
reference's leaderboard ``routes_*.xml`` (``data/routes_training.xml``:
``<routes><route id town><waypoint x y z yaw pitch roll/>...``), parsed
there by ``carla_gym/utils/config_utils.py:73-128``. A route is an ordered
list of keypoint poses; dense tracing happens in ``scene.trace``.
"""
from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from bench_port.plain_reference.frozen.scene.town import LaneGraph, astar, nearest_edge_point


@dataclasses.dataclass
class RouteDef:
    route_id: int
    town: str
    waypoints: np.ndarray      # (K, 3): x, y, yaw(rad)


def parse_routes_xml(path: str) -> List[RouteDef]:
    tree = ET.parse(path)
    routes = []
    for route in tree.iter("route"):
        wps = []
        for wp in route.iter("waypoint"):
            wps.append(
                [
                    float(wp.attrib["x"]),
                    float(wp.attrib["y"]),
                    math.radians(float(wp.attrib.get("yaw", 0.0))),
                ]
            )
        routes.append(
            RouteDef(
                route_id=int(route.attrib.get("id", len(routes))),
                town=route.attrib.get("town", ""),
                waypoints=np.array(wps, dtype=np.float64),
            )
        )
    return routes


def write_routes_xml(routes: List[RouteDef], path: str) -> None:
    root = ET.Element("routes")
    for r in routes:
        el = ET.SubElement(
            root, "route", id=str(r.route_id), town=r.town
        )
        for x, y, yaw in r.waypoints:
            ET.SubElement(
                el, "waypoint",
                x=f"{x}", y=f"{y}", z="0.0",
                yaw=f"{math.degrees(yaw)}", pitch="0.0", roll="0.0",
            )
    ET.ElementTree(root).write(path, encoding="unicode")


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
