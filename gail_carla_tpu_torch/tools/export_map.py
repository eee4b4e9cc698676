"""Town map exporter, the ``carla_gym/utils/birdview_map.py`` equivalent:
port of ``gail_carla_tpu/tools/export_map.py``.

The reference's offline tool boots CARLA per town and writes
``maps/TownXX.h5`` packs (``road`` / ``lane_marking_all`` /
``lane_marking_white_broken`` uint8 layers and the ``pixels_per_meter`` /
``world_offset_in_meters`` attributes) that ``chauffeurnet.py:72-85``
loads. This tool bakes the same pack from a procedural grid town
(``scene/town.py::make_grid_town``, ``scene/raster.py::rasterize_town``)
on the host. The simulator never reads it (it uses segment tables); it
is an interop and debugging artifact. ``h5py`` is imported when a pack is
written or checked, not with the module.

Usage: python -m gail_carla_tpu_torch.tools.export_map --out maps/GridTown.h5
"""
from __future__ import annotations

import argparse
import os

LAYERS = ("road", "lane_marking_all", "lane_marking_white_broken")


def export_map(out_path: str, nx: int = 4, ny: int = 4, block: float = 100.0,
               seed: int = 2021, ppm: float = 5.0) -> str:
    """Writes the pack of the ``nx`` x ``ny`` grid town at ``ppm`` pixels
    per metre to ``out_path``; returns the path."""
    import h5py
    import numpy as np

    from gail_carla_tpu_torch.scene.raster import rasterize_town
    from gail_carla_tpu_torch.scene.town import make_grid_town

    graph = make_grid_town(nx=nx, ny=ny, block=block, seed=seed)
    raster = rasterize_town(graph, ppm=ppm)
    layers = {
        "road": raster.road,
        "lane_marking_all": (raster.lane > 0).astype(np.uint8) * 255,
        "lane_marking_white_broken":
            (raster.lane == 120).astype(np.uint8) * 255,
    }
    with h5py.File(out_path, "w") as hf:
        for key in LAYERS:
            hf.create_dataset(key, data=layers[key], compression="gzip")
        hf.attrs["pixels_per_meter"] = float(ppm)
        hf.attrs["world_offset_in_meters"] = raster.world_offset
    return out_path


def check_h5_map(path: str, pixels_per_meter: float = 5.0) -> bool:
    """config_utils.check_h5_maps (config_utils.py:11-48): the pack holds
    the three layers and its ``pixels_per_meter`` matches."""
    import h5py
    import numpy as np

    with h5py.File(path, "r") as hf:
        ok = np.isclose(float(hf.attrs["pixels_per_meter"]),
                        pixels_per_meter)
        for key in LAYERS:
            ok = ok and key in hf
    return bool(ok)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="maps/GridTown.h5")
    p.add_argument("--nx", type=int, default=4)
    p.add_argument("--ny", type=int, default=4)
    p.add_argument("--block", type=float, default=100.0)
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    print(export_map(args.out, args.nx, args.ny, args.block))


if __name__ == "__main__":
    main()
