"""A synthetic reference tree for the town importers.

The town importers (scene/town_import.py, scene/h5_maps.py) read the
reference's ``data/routes_*.xml``, its NoCrash / CoRL2017 route packs
under ``carla_gym/envs/scenario_descriptions/`` and its mask packs
``carla_gym/core/obs_manager/birdview/maps/<Town>.h5``. This repository
does not hold them. This tool writes a tree of the same layout from a
procedural grid town (``scene/town.py::make_grid_town``), so the whole
town path -- reconstruction, mask repair, the scene, the suites, training
-- runs without the reference:

- the mask pack: the 3x3 grid town's (90 m blocks) rasterized ``road``,
  ``lane_marking_all`` and ``lane_marking_white_broken`` layers (as
  ``tools/export_map.py`` writes them) plus a ``sidewalk`` ring, the road
  dilated by ``SIDEWALK_PX`` pixels, at 5 px/m;
- ``data/routes_training.xml``: ``n_routes`` routes of the town, each the
  grid route traced at 1 m and kept every ``EVERY``-th point (with yaw);
- NoCrash and CoRL2017 packs: bare start/goal pairs (no town attribute),
  which the importer plans through the reconstructed graph.

``reference_tree(root)`` points the port's module constants at such a
tree (and its caches at a directory of the caller's) for the duration of
a ``with`` block. ``h5py`` is imported only to write the pack file;
without it, ``write_tree(..., write_h5=False)`` returns the layers for
``scene/h5_maps.py::put_pack``.

Usage: python -m gail_carla_tpu_torch.tools.synthetic_town --out reference
(the port reads ``<repo>/reference`` by default).
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, List, Optional

import numpy as np

from gail_carla_tpu_torch.scene.routes import RouteDef, write_routes_xml

MAPS_SUBDIR = os.path.join("carla_gym", "core", "obs_manager", "birdview",
                           "maps")
SCENARIO_SUBDIR = os.path.join("carla_gym", "envs", "scenario_descriptions")
CORL_DIRS = ("Straight", "OneCurve", "Navigation")
PPM, SIDEWALK_PX = 5.0, 15
# every EVERY-th point of a traced route is a waypoint; the routes' seed
EVERY, SEED = 15, 2021


def grid_graph():
    """The 3x3 grid town at 90 m blocks."""
    from gail_carla_tpu_torch.scene.town import make_grid_town

    return make_grid_town(nx=3, ny=3, block=90.0, seed=SEED)


def synthetic_layers(graph):
    """(layers, world_offset): the H5 layers of ``graph`` (uint8, 255 on)
    and the pack's ``world_offset_in_meters``."""
    from scipy import ndimage

    from gail_carla_tpu_torch.scene.raster import rasterize_town

    raster = rasterize_town(graph, ppm=PPM)
    road = raster.road > 0
    sidewalk = ndimage.binary_dilation(road, iterations=SIDEWALK_PX) & ~road
    layers = {
        "road": road.astype(np.uint8) * 255,
        "lane_marking_all": (raster.lane > 0).astype(np.uint8) * 255,
        "lane_marking_white_broken":
            (raster.lane == 120).astype(np.uint8) * 255,
        "sidewalk": sidewalk.astype(np.uint8) * 255,
    }
    return layers, raster.world_offset


def training_routes(graph, town: str, n_routes: int,
                    min_length: float = 300.0,
                    max_length: Optional[float] = None) -> List[RouteDef]:
    """``n_routes`` grid routes as multi-waypoint reference routes: every
    ``EVERY``-th point of the 1 m trace (and its last), with yaw. With
    ``max_length``, single-leg routes whose trace is at most that long."""
    from gail_carla_tpu_torch.scene.routes import generate_routes
    from gail_carla_tpu_torch.scene.trace import trace_route

    if max_length is None:
        cands = generate_routes(graph, n_routes=n_routes,
                                min_length=min_length, seed=SEED)
    else:
        cands = generate_routes(graph, n_routes=40 * n_routes,
                                min_length=min_length, max_waypoints=2,
                                seed=SEED)
    out = []
    for r in cands:
        d = trace_route(graph, r.waypoints)
        if max_length is not None and d.length_m > max_length:
            continue
        idx = np.unique(np.r_[np.arange(0, len(d.xy), EVERY),
                              len(d.xy) - 1])
        wps = np.concatenate([d.xy[idx], d.yaw[idx, None]], axis=1)
        out.append(RouteDef(route_id=len(out), town=town,
                            waypoints=wps.astype(np.float64)))
        if len(out) == n_routes:
            break
    if len(out) < n_routes:
        raise ValueError(f"{len(out)} routes of {min_length}-{max_length} "
                         f"m in the grid, {n_routes} asked")
    return out


def start_goal_pairs(graph, n_pairs: int) -> List[RouteDef]:
    """Bare start/goal pairs (the NoCrash / CoRL2017 format): the first
    and last pose of ``n_pairs`` traced grid routes, no town attribute."""
    from gail_carla_tpu_torch.scene.routes import generate_routes
    from gail_carla_tpu_torch.scene.trace import trace_route

    out = []
    for r in generate_routes(graph, n_routes=n_pairs, min_length=200.0,
                             max_waypoints=2, seed=77):
        d = trace_route(graph, r.waypoints)
        wps = np.array([[*d.xy[0], d.yaw[0]], [*d.xy[-1], d.yaw[-1]]])
        out.append(RouteDef(route_id=r.route_id, town="", waypoints=wps))
    return out


def _write_h5(path: str, layers: Dict[str, np.ndarray],
              world_offset) -> None:
    import h5py

    with h5py.File(path, "w") as hf:
        for key, val in layers.items():
            hf.create_dataset(key, data=val, compression="gzip")
        hf.attrs["pixels_per_meter"] = PPM
        hf.attrs["world_offset_in_meters"] = world_offset


def write_tree(root: str, town: str = "Town01", n_routes: int = 10,
               n_pairs: int = 6, min_length: float = 300.0,
               max_length: Optional[float] = None, write_h5: bool = True):
    """Write the synthetic tree of ``town`` under ``root`` (training routes
    of ``min_length`` to ``max_length`` m); returns (layers,
    world_offset), the pack's contents. ``write_h5=False`` skips the pack
    file (hand the layers to ``h5_maps.put_pack`` instead)."""
    graph = grid_graph()
    layers, offset = synthetic_layers(graph)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    write_routes_xml(training_routes(graph, town, n_routes, min_length=
                                     min_length, max_length=max_length),
                     os.path.join(root, "data", "routes_training.xml"))
    pairs = start_goal_pairs(graph, n_pairs)
    sd = os.path.join(root, SCENARIO_SUBDIR)
    packs = [os.path.join(sd, "NoCrash", "lbc", town)]
    packs += [os.path.join(sd, "CoRL2017", "lbc", d, town)
              for d in CORL_DIRS]
    for d in packs:
        os.makedirs(d, exist_ok=True)
        write_routes_xml(pairs, os.path.join(d, "routes.xml"))
    if write_h5:
        maps = os.path.join(root, MAPS_SUBDIR)
        os.makedirs(maps, exist_ok=True)
        _write_h5(os.path.join(maps, f"{town}.h5"), layers, offset)
    return layers, offset


@contextlib.contextmanager
def reference_tree(root: str, cache_dir: Optional[str] = None):
    """Within the block, the port reads the reference tree at ``root``
    (its ``data/``, scenario packs and mask packs: ``REFERENCE_DATA``,
    ``MAPS_DIR``, ``SCENARIO_DESCRIPTIONS``) and, with ``cache_dir``, keeps
    its geometry and scene caches there; the constants are restored on
    exit."""
    from gail_carla_tpu_torch.envs import suites
    from gail_carla_tpu_torch.scene import h5_maps, town_import

    saved = [(h5_maps, "REFERENCE_DATA"), (h5_maps, "MAPS_DIR"),
             (h5_maps, "CACHE_DIR"), (town_import, "_DISK_CACHE_DIR"),
             (suites, "SCENARIO_DESCRIPTIONS")]
    old = [getattr(m, a) for m, a in saved]
    try:
        h5_maps.REFERENCE_DATA = root
        h5_maps.MAPS_DIR = os.path.join(root, MAPS_SUBDIR)
        suites.SCENARIO_DESCRIPTIONS = os.path.join(root, SCENARIO_SUBDIR)
        if cache_dir is not None:
            h5_maps.CACHE_DIR = os.path.join(cache_dir, "h5maps")
            town_import._DISK_CACHE_DIR = os.path.join(cache_dir, "scenes")
        yield root
    finally:
        for (m, a), v in zip(saved, old):
            setattr(m, a, v)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="reference",
                   help="root of the tree (the port reads <repo>/reference "
                        "by default)")
    p.add_argument("--town", default="Town01")
    args = p.parse_args(argv)
    if os.path.exists(os.path.join(args.out, "data")):
        p.error(f"{args.out} already holds a data/ directory")
    write_tree(args.out, args.town)
    print(args.out)


if __name__ == "__main__":
    main()
