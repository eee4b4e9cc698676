"""Ground-truth town geometry from the reference's H5 mask packs (numpy,
host side).

Port of ``gail_carla_tpu/scene/h5_maps.py``. The reference ships its towns
pre-rendered as ``carla_gym/core/obs_manager/birdview/maps/Town0{1..6}.h5``
(uint8 layers at 5 px/m + ``world_offset_in_meters`` attrs; written by
``carla_gym/utils/birdview_map.py:20-143``, loaded by
``chauffeurnet.py:72-85``). The ``stopline`` layer is empty in every town,
so traffic-light stop lines are synthesized at junction entries
(scene/town_import.py).

This module compiles each pack into the analytic geometry the renderers
consume (scene/mask_geo.py):

- road boundary edges + interior depth (exact mask reproduction);
- lane-marking capsules with per-segment half-width and the reference's
  channel values: ``lane_marking_all`` renders 255 and
  ``lane_marking_white_broken`` overrides to 120 (chauffeurnet.py:188-189)
  -- broken-marking capsules get value 120 and are carved out of the 255
  set;
- sidewalk centreline paths (walker navigation);
- sidewalk boundary edges and the hard (curb-to-wall) surface's edges.

Every pack is read through ``read_pack``, the one function that imports
``h5py``. A pack may instead be held in memory (``put_pack``, for a
machine without ``h5py``); both give the same layers. Results are cached
as npz under ``<repo>/.cache/h5maps``, keyed by the pack's source (path,
size and mtime, or the bytes of an in-memory pack).

The reference's data is not part of this repository: place (or link) a
checkout of it at ``<repo>/reference`` (``REFERENCE_DATA``), or point
``MAPS_DIR`` at a directory of packs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gail_carla_tpu_torch.scene import mask_geo

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a checkout of the reference (its data/, scenario_descriptions/, maps/)
REFERENCE_DATA = os.path.join(_REPO, "reference")
MAPS_DIR = os.path.join(REFERENCE_DATA, "carla_gym", "core", "obs_manager",
                        "birdview", "maps")
CACHE_DIR = os.path.join(_REPO, ".cache", "h5maps")
PPM = 5.0
_VERSION = 5  # bump to invalidate caches (the JAX package's version)

# layers held in memory by put_pack: town -> (layers, world_offset, ppm)
_MEMORY_PACKS: Dict[str, Tuple[Dict[str, np.ndarray], np.ndarray, float]] = {}


@dataclasses.dataclass
class Pack:
    """The layers of one town's pack that a reader asked for (a layer the
    pack lacks is absent from ``layers``) and its attributes."""

    layers: Dict[str, np.ndarray]
    world_offset: np.ndarray        # (2,) float64
    ppm: float
    reader: str                     # "h5py" or "memory"

    def __contains__(self, name: str) -> bool:
        return name in self.layers

    def __getitem__(self, name: str) -> np.ndarray:
        return self.layers[name]


def _h5_path(town: str) -> str:
    return os.path.join(MAPS_DIR, f"{town}.h5")


def put_pack(town: str, layers: Dict[str, np.ndarray],
             world_offset, ppm: float = PPM) -> None:
    """Hold ``town``'s pack in memory: ``read_pack`` returns these layers
    instead of reading ``<MAPS_DIR>/<town>.h5``. ``layers`` maps the H5
    layer names to uint8 arrays [y_px, x_px], as the files hold them."""
    _MEMORY_PACKS[town] = (
        {k: np.asarray(v) for k, v in layers.items()},
        np.asarray(world_offset, np.float64), float(ppm),
    )


def drop_pack(town: str) -> None:
    """Forget an in-memory pack of ``town`` (``put_pack``)."""
    _MEMORY_PACKS.pop(town, None)


def pack_reader(town: str) -> Optional[str]:
    """Which reader ``read_pack(town)`` uses: "memory", "h5py", or None
    when there is no pack."""
    if town in _MEMORY_PACKS:
        return "memory"
    return "h5py" if os.path.exists(_h5_path(town)) else None


def pack_stamp(town: str) -> Optional[str]:
    """A digest of the pack's source, or None when there is no pack: the
    path, size and mtime of the file, or the bytes of an in-memory pack.
    The caches key on it, so a town of another tree never hits them."""
    reader = pack_reader(town)
    if reader is None:
        return None
    h = hashlib.sha256()
    if reader == "memory":
        layers, off, ppm = _MEMORY_PACKS[town]
        h.update(repr((town, off.tolist(), ppm)).encode())
        for name in sorted(layers):
            a = np.ascontiguousarray(layers[name])
            h.update(repr((name, a.shape, a.dtype.str)).encode())
            h.update(a.tobytes())
    else:
        path = os.path.abspath(_h5_path(town))
        st = os.stat(path)
        h.update(repr((path, st.st_size, st.st_mtime_ns)).encode())
    return h.hexdigest()[:16]


def read_pack(town: str, names: Sequence[str]) -> Pack:
    """The layers ``names`` of ``town``'s pack (those it has) and its
    attributes: from memory (``put_pack``), else from
    ``<MAPS_DIR>/<town>.h5`` through ``h5py``. Raises FileNotFoundError
    when there is no pack."""
    if town in _MEMORY_PACKS:
        layers, off, ppm = _MEMORY_PACKS[town]
        return Pack({k: layers[k] for k in names if k in layers},
                    off.copy(), ppm, "memory")
    path = _h5_path(town)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    import h5py

    with h5py.File(path, "r") as hf:
        return Pack(
            {k: np.asarray(hf[k]) for k in names if k in hf},
            np.asarray(hf.attrs["world_offset_in_meters"], np.float64),
            float(hf.attrs["pixels_per_meter"]), "h5py",
        )


def _close_hard_union(road: np.ndarray, sidewalk: np.ndarray, pack):
    """The hard (curb-to-wall) collision surface: the
    road|shoulder|parking|sidewalk union with narrow gaps CLOSED
    (morphological closing, 8 px ~ 1.6 m radius: bridges voids up to
    ~3.2 m across). Painted medians and grass strips between opposing
    carriageways render as voids in the H5 layers, but CARLA's collision
    sensor fires on physical meshes only (criteria/collision.py:49-112)
    and such strips carry none. Anything wide enough to survive the
    closing (city blocks, building footprints) stays a collision
    surface."""
    from scipy import ndimage

    hard = road | sidewalk
    for layer in ("shoulder", "parking"):
        if layer in pack:
            hard |= np.asarray(pack[layer]) > 0
    return ndimage.binary_closing(
        hard, structure=ndimage.generate_binary_structure(2, 1),
        iterations=8,
    )


@dataclasses.dataclass
class TownGeometry:
    town: str
    world_offset: np.ndarray        # (2,)
    # road surface (the policy's BEV channel 0 and the off-road test)
    bnd_ab: np.ndarray              # (B, 4) oriented boundary edges
    bnd_dmax: float                 # max interior depth, metres
    # lane markings (BEV channel 2)
    lane_ab: np.ndarray             # (S, 4)
    lane_val: np.ndarray            # (S,) 255 / 120
    lane_hw: np.ndarray             # (S,) half width, metres
    # sidewalks (walker navigation)
    sidewalk_paths: List[np.ndarray]   # [(K, 2) world metres]
    sidewalk_ab: np.ndarray         # (Bs, 4) oriented sidewalk boundary
    sidewalk_dmax: float
    # hard (curb-to-wall) surface: road|shoulder|parking|sidewalk union;
    # mounting a curb onto the sidewalk is not a collision in CARLA
    # (criteria/collision.py:49-112), so the layout-collision test runs
    # against this union, not the road alone
    hard_ab: Optional[np.ndarray] = None    # (Bh, 4)
    hard_dmax: float = 0.0


def available_towns(root: Optional[str] = None) -> List[str]:
    """The towns with a pack: the ``.h5`` files under ``root`` (default
    ``MAPS_DIR``) and, without ``root``, the in-memory packs."""
    names = set()
    d = MAPS_DIR if root is None else root
    if os.path.isdir(d):
        names.update(f[:-3] for f in os.listdir(d) if f.endswith(".h5"))
    if root is None:
        names.update(_MEMORY_PACKS)
    return sorted(names)


def _extract(town: str, max_err_px: float) -> TownGeometry:
    from scipy import ndimage

    pack = read_pack(town, ("road", "lane_marking_all",
                            "lane_marking_white_broken", "sidewalk",
                            "shoulder", "parking"))
    off = pack.world_offset
    if pack.ppm != PPM:
        raise ValueError(f"{town}: {pack.ppm} px/m, expected {PPM}")
    road = np.asarray(pack["road"]) > 0
    lane_all = np.asarray(pack["lane_marking_all"]) > 0
    white_broken = np.asarray(pack["lane_marking_white_broken"]) > 0
    sidewalk = np.asarray(pack["sidewalk"]) > 0
    hard = _close_hard_union(road, sidewalk, pack)

    bnd_ab, bnd_dmax = mask_geo.mask_boundary_edges(
        road, off, PPM, max_err_px=max_err_px
    )
    hard_ab, hard_dmax = mask_geo.mask_boundary_edges(
        hard, off, PPM, max_err_px=max_err_px
    )

    # chauffeurnet.py:186-189: c_lane = 255*all, then 120 where
    # white_broken -- carve a 1-px halo so max-accumulation reproduces
    # the override
    if white_broken.any():
        solid = lane_all & ~ndimage.binary_dilation(
            white_broken, iterations=1
        )
    else:
        solid = lane_all
    ab_s, val_s, hw_s = mask_geo.mask_stroke_capsules(
        solid, off, PPM, 255.0
    )
    ab_b, val_b, hw_b = mask_geo.mask_stroke_capsules(
        white_broken, off, PPM, 120.0
    )
    lane_ab = np.concatenate([ab_s, ab_b], axis=0)
    lane_val = np.concatenate([val_s, val_b], axis=0)
    lane_hw = np.concatenate([hw_s, hw_b], axis=0)

    sidewalk_paths = mask_geo.mask_ribbon_paths(sidewalk, off, PPM)
    if sidewalk.any():
        sw_ab, sw_dmax = mask_geo.mask_boundary_edges(
            sidewalk, off, PPM, max_err_px=max_err_px
        )
    else:
        sw_ab, sw_dmax = np.zeros((0, 4), np.float32), 0.0

    return TownGeometry(
        town=town, world_offset=off.astype(np.float32),
        bnd_ab=bnd_ab, bnd_dmax=bnd_dmax,
        lane_ab=lane_ab, lane_val=lane_val, lane_hw=lane_hw,
        sidewalk_paths=sidewalk_paths,
        sidewalk_ab=sw_ab, sidewalk_dmax=sw_dmax,
        hard_ab=hard_ab, hard_dmax=hard_dmax,
    )


_ROAD_MASK_CACHE = {}


def road_mask(town: str):
    """Raw ``road`` layer (bool) + world offset, for the mask-grid fallback
    planner (``mask_geo.plan_on_mask``). None if the pack is absent."""
    stamp = pack_stamp(town)
    if stamp is None:
        return None
    key = (town, stamp)
    if key not in _ROAD_MASK_CACHE:
        pack = read_pack(town, ("road",))
        _ROAD_MASK_CACHE[key] = (pack["road"] > 0, pack.world_offset)
    return _ROAD_MASK_CACHE[key]


_PLAN_MASK_CACHE = {}


def hard_plan_mask(town: str, clearance_m: float = 0.8,
                   road_slack_m: float = 2.0):
    """(mask, world_offset) for splicing route spans that cross the hard
    (curb-to-wall) surface boundary: the road|shoulder|parking|sidewalk
    union ERODED by ``clearance_m`` -- so any path planned on it keeps
    layout-collision clearance by construction -- intersected with a
    ``road_slack_m`` DILATION of the road layer, so the planned path also
    cannot drift off the ROAD mask beyond the benchmark's off-road
    tolerance. Falls back to the bare eroded union where the intersection
    is empty. None if the pack is absent."""
    stamp = pack_stamp(town)
    if stamp is None:
        return None
    key = (town, stamp, clearance_m, road_slack_m)
    if key not in _PLAN_MASK_CACHE:
        from scipy import ndimage

        pack = read_pack(town, ("road", "sidewalk", "shoulder", "parking"))
        off = pack.world_offset
        road = np.asarray(pack["road"]) > 0
        # the SAME closed union the collision surface scores against
        hard = _close_hard_union(road, np.asarray(pack["sidewalk"]) > 0,
                                 pack)
        er = ndimage.binary_erosion(
            hard, iterations=int(math.ceil(clearance_m * PPM))
        )
        if road_slack_m * PPM < hard.shape[0]:
            rd = ndimage.binary_dilation(
                road, iterations=int(round(road_slack_m * PPM))
            )
            m = er & rd
        else:               # unbounded slack: the bare eroded union
            m = er
        if not m.any():
            m = er
        _PLAN_MASK_CACHE[key] = (m, off)
    return _PLAN_MASK_CACHE[key]


_MEM_CACHE = {}


def load_town_geometry(
    town: str, max_err_px: float = 0.49, cache: bool = True
) -> Optional[TownGeometry]:
    """TownGeometry for ``town`` ('Town01'..'Town06'), or None if it has no
    pack. Disk-cached npz + in-process cache.

    ``max_err_px`` 0.49 is the largest contour-simplification error that
    keeps the boundary inside-test pixel-center faithful (0.35 is
    bit-exact) while cutting ~35% of the boundary edges, the dominant
    per-pixel loop of the BEV kernels."""
    stamp = pack_stamp(town)
    if stamp is None:
        return None
    key = (town, stamp, max_err_px)
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    path = os.path.join(
        CACHE_DIR, f"torch_{town}_v{_VERSION}_e{max_err_px:g}_{stamp}.npz"
    )
    if cache and os.path.exists(path):
        z = np.load(path)
        geo = TownGeometry(
            town=town, world_offset=z["world_offset"],
            bnd_ab=z["bnd_ab"], bnd_dmax=float(z["bnd_dmax"]),
            lane_ab=z["lane_ab"], lane_val=z["lane_val"],
            lane_hw=z["lane_hw"],
            sidewalk_paths=[
                z[f"sw_{i}"] for i in range(int(z["n_sw"]))
            ],
            sidewalk_ab=z["sidewalk_ab"],
            sidewalk_dmax=float(z["sidewalk_dmax"]),
            hard_ab=z["hard_ab"], hard_dmax=float(z["hard_dmax"]),
        )
        _MEM_CACHE[key] = geo
        return geo
    geo = _extract(town, max_err_px)
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        # write-then-rename so an interrupted process can't leave a
        # truncated npz behind for the next reader
        tmp = f"{path}.tmp.{os.getpid()}"
        np.savez_compressed(
            tmp,
            world_offset=geo.world_offset,
            bnd_ab=geo.bnd_ab, bnd_dmax=geo.bnd_dmax,
            lane_ab=geo.lane_ab, lane_val=geo.lane_val,
            lane_hw=geo.lane_hw,
            n_sw=len(geo.sidewalk_paths),
            sidewalk_ab=geo.sidewalk_ab, sidewalk_dmax=geo.sidewalk_dmax,
            hard_ab=geo.hard_ab, hard_dmax=geo.hard_dmax,
            **{
                f"sw_{i}": p for i, p in enumerate(geo.sidewalk_paths)
            },
        )
        os.replace(tmp + ".npz", path)
    _MEM_CACHE[key] = geo
    return geo
