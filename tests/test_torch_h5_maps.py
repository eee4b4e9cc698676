"""The port's mask-pack compiler (``scene/h5_maps.py``) against the JAX
package's, on the synthetic reference tree of
``tests/test_torch_town_import.py``: the town geometry (road, hard-surface
and sidewalk boundaries, lane capsules, sidewalk paths), the raw road mask
and the planning mask come out equal (0 difference); the npz cache and an
in-memory pack give the same geometry as the file; a pack that the map
exporter wrote, which has no ``sidewalk`` layer, raises in both. The JAX
package is imported inside the tests only (read-only reference)."""
import dataclasses
import os

import numpy as np
import pytest

from gail_carla_tpu_torch.scene import h5_maps
from test_torch_town_import import (  # noqa: F401 (tree: a fixture)
    TOWN, assert_equal_values, tree,
)


def geometry_values(geo):
    return {f.name: getattr(geo, f.name) for f in dataclasses.fields(geo)}


def test_town_geometry_matches_jax(tree):
    from gail_carla_tpu.scene import h5_maps as jax_h5

    geo = h5_maps.load_town_geometry(TOWN)
    assert len(geo.sidewalk_paths) > 4 and len(geo.hard_ab) > 0
    assert_equal_values(geometry_values(geo),
                        geometry_values(jax_h5.load_town_geometry(TOWN)))
    assert_equal_values(h5_maps.road_mask(TOWN), jax_h5.road_mask(TOWN))
    for args in ((), (1.2, 3.0), (0.8, 1e9)):
        assert_equal_values(h5_maps.hard_plan_mask(TOWN, *args),
                            jax_h5.hard_plan_mask(TOWN, *args), str(args))
    # JAX binds its maps directory as the default argument
    assert h5_maps.available_towns() == [TOWN]
    assert jax_h5.available_towns(h5_maps.MAPS_DIR) == [TOWN]
    assert h5_maps.load_town_geometry("Town07") is None
    assert h5_maps.road_mask("Town07") is None


def test_geometry_cache_and_memory_pack(tree, monkeypatch):
    """The npz written at the first load gives the geometry back in a
    fresh process state; the same layers held in memory (``put_pack``, for
    a machine without h5py) compile to the same geometry, under their own
    cache key."""
    geo = geometry_values(h5_maps.load_town_geometry(TOWN))
    monkeypatch.setattr(h5_maps, "_MEM_CACHE", {})
    monkeypatch.setattr(h5_maps, "_extract", None)     # a load must hit disk
    assert_equal_values(geometry_values(h5_maps.load_town_geometry(TOWN)),
                        geo, "npz")
    monkeypatch.undo()

    names = ("road", "lane_marking_all", "lane_marking_white_broken",
             "sidewalk")
    pack = h5_maps.read_pack(TOWN, names)
    assert pack.reader == "h5py" and sorted(pack.layers) == sorted(names)
    stamp = h5_maps.pack_stamp(TOWN)
    try:
        h5_maps.put_pack(TOWN, pack.layers, pack.world_offset)
        assert h5_maps.pack_reader(TOWN) == "memory"
        assert h5_maps.pack_stamp(TOWN) != stamp
        mem = geometry_values(h5_maps.load_town_geometry(TOWN, cache=False))
        assert_equal_values(mem, geo, "memory")
        assert_equal_values(h5_maps.road_mask(TOWN)[0], pack["road"] > 0)
    finally:
        h5_maps.drop_pack(TOWN)
    assert h5_maps.pack_reader(TOWN) == "h5py"


def test_exporter_pack_without_sidewalks_raises(tmp_path, monkeypatch):
    """``tools/export_map.py`` writes road and lane-marking layers only (as
    the JAX exporter does, byte for byte), so neither loader can compile
    its pack: both raise KeyError on the missing ``sidewalk`` layer."""
    from gail_carla_tpu.scene import h5_maps as jax_h5
    from gail_carla_tpu_torch.tools.export_map import export_map

    export_map(str(tmp_path / "GridTown.h5"), nx=2, ny=2, block=60.0)
    for mod in (h5_maps, jax_h5):
        monkeypatch.setattr(mod, "MAPS_DIR", str(tmp_path))
        monkeypatch.setattr(mod, "CACHE_DIR", str(tmp_path / "cache"))
        monkeypatch.setattr(mod, "_MEM_CACHE", {})
        monkeypatch.setattr(mod, "_ROAD_MASK_CACHE", {})
        with pytest.raises(KeyError, match="sidewalk"):
            mod.load_town_geometry("GridTown")
        assert not os.path.exists(tmp_path / "cache")
    assert h5_maps.road_mask("GridTown")[0].shape == \
        jax_h5.road_mask("GridTown")[0].shape


def test_town_fidelity_report_matches_jax(tree, monkeypatch):
    """``tools/town_fidelity.py`` on the synthetic town: the graph, route
    and stop-line measures equal JAX's report, and the BEV IoUs of the
    port's renders against the pack's textures equal JAX's."""
    from gail_carla_tpu.scene import town_import as jax_ti
    from gail_carla_tpu.tools import town_fidelity as jax_tf
    from gail_carla_tpu_torch.tools import town_fidelity

    monkeypatch.setattr(jax_tf, "H5_DIR", h5_maps.MAPS_DIR)
    # JAX binds its reference path as these functions' default root
    collect, bench = jax_ti.collect_town_routes, jax_ti.benchmark_routes
    monkeypatch.setattr(
        jax_ti, "collect_town_routes",
        lambda town, root=tree, min_waypoints=4: collect(town, root,
                                                         min_waypoints))
    monkeypatch.setattr(
        jax_ti, "benchmark_routes",
        lambda town, route_file="routes_training.xml", root=tree: bench(
            town, route_file, root))
    got = town_fidelity.town_report(TOWN, n_routes=1, device="cpu")
    want = jax_tf.town_report(TOWN, n_routes=1)
    assert got == want
    assert got["graph_on_road"] > 0.9 and got["bev_road_iou_min"] > 0.9
