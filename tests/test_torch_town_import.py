"""The port's town importers (``scene/town_import.py``) against the JAX
package's, on a synthetic reference tree (``tools/synthetic_town.py``:
the 3x3 grid town at 90 m blocks rasterized into a Town01 mask pack with a
sidewalk ring, a ``routes_training.xml`` of its routes and NoCrash /
CoRL2017 packs of bare start/goal pairs), since the reference's own data
is not in the repository. The route evidence, the reconstructed graph and
its lights, the dense routes and the scene's host tables come out equal
(0 difference: the same numpy code), for the route pack and for the bare
start/goal pack; the port's scene cache round-trips.

Both packages read the tree through the attributes they consult at call
time (``both_read_tree``); where JAX binds its reference path as a default
argument, its ``make_town_scene`` is wrapped with ``root=``. Nothing in
the JAX package changes. The JAX package is imported inside the tests
only (read-only reference)."""
import contextlib
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.scene import h5_maps, town_import
from gail_carla_tpu_torch.tools import synthetic_town

TOWN = "Town01"
N_ROUTES = 4
NOCRASH_PACK = os.path.join(synthetic_town.SCENARIO_SUBDIR, "NoCrash",
                            "lbc", TOWN, "routes.xml")


def write_test_tree(root: str) -> str:
    synthetic_town.write_tree(root, TOWN, N_ROUTES)
    return root


@contextlib.contextmanager
def both_read_tree(root: str, cache: str):
    """JAX and the port read the reference tree at ``root`` and keep their
    caches (fresh ones) under ``cache``."""
    from gail_carla_tpu.envs import suites as jax_suites
    from gail_carla_tpu.scene import h5_maps as jax_h5
    from gail_carla_tpu.scene import town_import as jax_ti

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_h5, "MAPS_DIR",
                   os.path.join(root, synthetic_town.MAPS_SUBDIR))
        mp.setattr(jax_h5, "CACHE_DIR", os.path.join(cache, "jax_h5"))
        mp.setattr(jax_ti, "_DISK_CACHE_DIR",
                   os.path.join(cache, "jax_scenes"))
        mp.setattr(jax_ti, "make_town_scene",
                   functools.partial(jax_ti.make_town_scene, root=root))
        mp.setattr(jax_suites, "SCENARIO_DESCRIPTIONS",
                   os.path.join(root, synthetic_town.SCENARIO_SUBDIR))
        for mod in (jax_h5, h5_maps):
            for name in ("_MEM_CACHE", "_ROAD_MASK_CACHE",
                         "_PLAN_MASK_CACHE"):
                mp.setattr(mod, name, {})
        for mod in (jax_ti, town_import):
            mp.setattr(mod, "_TOWN_SCENE_CACHE", {})
        with synthetic_town.reference_tree(root, cache):
            yield root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("town")
    root = write_test_tree(str(base / "reference"))
    with both_read_tree(root, str(base / "cache")):
        yield root


def graph_arrays(graph):
    """A LaneGraph as plain values: nodes, edges, adjacency, lights, stop
    signs."""
    out = {"nodes": np.asarray(graph.nodes),
           "lane_width": graph.lane_width,
           "adjacency": sorted((k, list(v))
                               for k, v in graph.adjacency.items())}
    for i, e in enumerate(graph.edges):
        out[f"edge{i}"] = (e.src, e.dst, int(e.option), e.is_junction,
                           tuple(e.mark_vals))
        out[f"edge{i}.pts"] = np.asarray(e.pts)
    for i, t in enumerate(graph.traffic_lights):
        out[f"light{i}"] = (np.asarray(t.stop_a), np.asarray(t.stop_b),
                            t.yaw, t.junction, t.group)
    for i, s in enumerate(graph.stop_signs):
        out[f"stop{i}"] = tuple(np.asarray(v) for v in
                                dataclasses.astuple(s))
    return out


def assert_equal_values(got, want, where=""):
    """Equal structure and values, arrays dtype and all."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_equal_values(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_values(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def dense_arrays(d):
    return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}


def assert_scene_matches_jax(port, jax_scene, where=""):
    """Every field of a port ``TorchScene`` equals the JAX ``StaticScene``'s
    (tensors bit for bit, static fields exactly)."""
    for f in dataclasses.fields(port):
        got = getattr(port, f.name)
        want = getattr(jax_scene, f.name)
        if isinstance(got, torch.Tensor):
            want = np.array(want)
            assert got.dtype == torch.from_numpy(want).dtype, f.name
            np.testing.assert_array_equal(got.cpu().numpy(), want,
                                          err_msg=f"{where} {f.name}")
        else:
            assert got == want, f"{where} {f.name}"


def test_town_graph_matches_jax(tree):
    """The route evidence, the task routes and the reconstructed,
    mask-repaired graph with its synthesized lights; each dense route, by
    the hybrid and the posed-leg reconstruction."""
    from gail_carla_tpu.scene import h5_maps as jax_h5
    from gail_carla_tpu.scene import town_import as jax_ti

    ev = town_import.collect_town_routes(TOWN)
    jev = jax_ti.collect_town_routes(TOWN, root=tree)
    bench = town_import.benchmark_routes(TOWN)
    jbench = jax_ti.benchmark_routes(TOWN, root=tree)
    assert len(ev) == len(bench) == N_ROUTES
    for got, want in ((ev, jev), (bench, jbench)):
        assert_equal_values([(r.route_id, r.town, r.waypoints) for r in got],
                            [(r.route_id, r.town, r.waypoints)
                             for r in want])
    geo = h5_maps.load_town_geometry(TOWN)
    jgeo = jax_h5.load_town_geometry(TOWN)
    graph = town_import.repair_graph_to_mask(town_import.build_town_graph(
        ev, geometry=geo, crossing_junctions=True), geo)
    jgraph = jax_ti.repair_graph_to_mask(jax_ti.build_town_graph(
        jev, geometry=jgeo, crossing_junctions=True), jgeo)
    assert len(graph.edges) > 10 and len(graph.traffic_lights) > 4
    assert_equal_values(graph_arrays(graph), graph_arrays(jgraph), "graph")
    for r, jr in zip(bench, jbench):
        assert_equal_values(
            dense_arrays(town_import.densify_route_hybrid(r.waypoints, graph,
                                                          geo)),
            dense_arrays(jax_ti.densify_route_hybrid(jr.waypoints, jgraph,
                                                     jgeo)),
            f"hybrid route {r.route_id}")
        assert_equal_values(
            dense_arrays(town_import.densify_route(r.waypoints)),
            dense_arrays(jax_ti.densify_route(jr.waypoints)),
            f"posed-leg route {r.route_id}")


@pytest.mark.parametrize("pack", ["routes_training.xml", "nocrash"])
def test_town_scene_matches_jax(tree, pack):
    """``make_town_scene`` on the town's multi-waypoint route pack and on
    the NoCrash pack of bare start/goal pairs (planned through the graph
    with ``trace_route``): every table of the scene, leaf by leaf, with the
    geometry's lane capsules, road and hard boundaries and the sidewalk
    walkers' paths and crossing offsets."""
    from gail_carla_tpu.scene import town_import as jax_ti

    route_file = (pack if pack.endswith(".xml")
                  else os.path.join(tree, NOCRASH_PACK))
    port = town_import.make_town_scene(TOWN, route_file, device="cpu")
    want = jax_ti.make_town_scene(TOWN, route_file)
    assert port.walk_xy is not None and port.walk_xy.shape[0] > 4
    assert not torch.equal(port.cell_hard_n, port.cell_bnd_n)
    assert_scene_matches_jax(port, want, pack)


def test_scene_disk_cache_round_trip(tree, tmp_path, monkeypatch):
    """The port's scene cache: a saved scene loads back equal on the CPU
    (host tensors), a corrupt file is a miss, and a second
    ``make_town_scene`` in a fresh process state is served from disk."""
    scene = town_import.make_town_scene(TOWN, device="cpu")
    path = str(tmp_path / "scene.pt")
    monkeypatch.setattr(town_import, "_DISK_CACHE_DIR", str(tmp_path))
    town_import._scene_cache_save(path, scene)
    loaded = town_import._scene_cache_load(path)
    for name, t in scene.tensors():
        got = getattr(loaded, name)
        assert got.device.type == "cpu" and got.dtype == t.dtype, name
        assert torch.equal(got, t), name
    assert loaded.walk_xy is not None and loaded.bnd_dmax == scene.bnd_dmax
    with open(path, "wb") as f:
        f.write(b"not a scene")
    assert town_import._scene_cache_load(path) is None
    assert town_import._scene_cache_load(str(tmp_path / "none.pt")) is None

    monkeypatch.setattr(town_import, "_TOWN_SCENE_CACHE", {})

    def no_build(*args):
        raise AssertionError("the scene was rebuilt, not loaded")

    town_import.make_town_scene(TOWN, device="cpu")    # writes the cache
    monkeypatch.setattr(town_import, "_TOWN_SCENE_CACHE", {})
    monkeypatch.setattr(town_import, "_build_town_scene", no_build)
    again = town_import.make_town_scene(TOWN, device="cpu")
    for name, t in scene.tensors():
        assert torch.equal(getattr(again, name), t), name
