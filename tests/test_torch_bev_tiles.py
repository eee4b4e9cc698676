"""The per-tile culling rule of the BEV kernels (``ops/bev_tiles.py``),
on the CPU.

The kernels draw each tile of the view from only the items that
``bev_keep``/``bev6_keep`` keep for it. ``render_bev_tiled`` and
``render_bev6_tiled`` below apply that rule in plain torch with the plain
renderers' arithmetic, and must equal ``render_bev_plain`` and
``render_bev6_plain`` at 0 differing values, on the procedural reference
scene, with envs from the simulator with traffic and envs placed on the
cell grid's corners and with boundary edges, stop lines, active stop
signs and actors on tile-corner pixels (``ops/bev6.py::place_in_view``
with ``tiles``), at a width the tiles divide (64) and a ragged one (100).
"""
import math

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops import bev, bev6, bev_tiles
from gail_carla_tpu_torch.ops.bev import (
    INV_255, PLAIN_CHUNK, ROUTE_HALF_W, boundary_dist_cross,
    capsule_dist2_all, pixel_world_coords,
)
from gail_carla_tpu_torch.ops.bev_full import TL_LINE_HALF_W
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.train import make_presets
from test_torch_bev6 import TRAFFIC, bev6_render_states


def _boxes_in(px, boxes, keep):
    """(n, P) bool: pixels inside any kept box row (n, B, 8); ``keep`` is
    (n, P, B). ``ops/bev_full.py::boxes_mask``'s arithmetic."""
    if boxes.shape[1] == 0:
        return torch.zeros(px.shape[:-1], dtype=torch.bool,
                           device=px.device)
    c = boxes[:, None, :, 2]
    s = boxes[:, None, :, 3]
    dx = px[..., :, None, 0] - boxes[:, None, :, 0]
    dy = px[..., :, None, 1] - boxes[:, None, :, 1]
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    inside = (torch.abs(lx) <= boxes[:, None, :, 4]) & (
        torch.abs(ly) <= boxes[:, None, :, 5])
    return (inside & keep).any(dim=-1)


def _road_route_lane(px, base, sl, keep, dmax: float):
    """(road, route, lane) of the pixels ``px`` (n, P, 2) over the kept
    items only: ``ops/bev.py::render_bev_plain``'s arithmetic."""
    d2, crn = boundary_dist_cross(px, base.bnd[sl])
    key = torch.where(keep["road"], d2 - 1e-3 * torch.abs(crn), math.inf)
    keymin, first = torch.min(key, dim=-1)
    cr_sel = torch.gather(crn, -1, first[..., None])[..., 0]
    road = (cr_sel > 0.0) & (keymin <= dmax * dmax)
    route_d2 = torch.where(keep["route"],
                           capsule_dist2_all(px, base.route[sl]), math.inf)
    route = torch.amin(route_d2, dim=-1) <= ROUTE_HALF_W ** 2
    d2 = capsule_dist2_all(px, base.lane[sl])
    lw = base.lane_w[sl, None, :]
    hit = (d2 <= lw * lw) & keep["lane"]
    lane = torch.amax(torch.where(hit, base.lane_val[sl, None, :], 0.0),
                      dim=-1) * INV_255
    return road.to(torch.float32), route.to(torch.float32), lane


def _tiled(cfg, base, keep, dmax: float, channels, extra=None):
    w = cfg.bev_width
    n = base.pose.shape[0]
    out = torch.empty((n, channels, w, w), dtype=torch.float32)
    tile = bev_tiles.pixel_tile(w, base.pose.device)
    for lo in range(0, n, PLAIN_CHUNK):
        sl = slice(lo, min(lo + PLAIN_CHUNK, n))
        pose = base.pose[sl]
        px = pixel_world_coords(cfg, pose[:, :2], pose[:, 2], pose[:, 3])
        kp = {name: k[sl][:, tile] for name, k in keep.items()}
        chans = list(_road_route_lane(px, base, sl, kp, dmax))
        if extra is not None:
            chans += extra(px, sl, kp)
        out[sl] = torch.stack(chans, dim=1).reshape(-1, channels, w, w)
    return out


def render_bev_tiled(cfg, inp, dmax: float) -> torch.Tensor:
    """(N, 3, W, W) as ``render_bev_plain`` draws it, with each tile's
    pixels drawn from the items ``bev_keep`` keeps for the tile."""
    return _tiled(cfg, inp, bev_tiles.bev_keep(cfg, inp, dmax), dmax, 3)


def render_bev6_tiled(cfg, inp, tables, dmax: float) -> torch.Tensor:
    """(N, 6, W, W) as ``render_bev6_plain`` draws it, with each tile's
    pixels drawn from the items ``bev6_keep`` keeps of the tables the
    kernel reads: the cell's culled stop lines and the active stop-sign
    box."""
    k = tables.n_veh

    def signal_actors(px, sl, kp):
        d2 = capsule_dist2_all(px, tables.tl[sl])
        on_line = (d2 <= TL_LINE_HALF_W ** 2) & kp["light"]
        sig = torch.amax(torch.where(on_line, tables.tl_val[sl, None, :],
                                     0.0), dim=-1)
        boxes = tables.boxes[sl]
        stop = _boxes_in(px, boxes[:, :1], kp["stop"])
        sig = torch.maximum(sig, torch.where(stop, 255.0, 0.0)) * INV_255
        veh = _boxes_in(px, boxes[:, 1:1 + k], kp["vehicles"])
        wk = _boxes_in(px, boxes[:, 1 + k:], kp["walkers"])
        return [sig, veh.to(torch.float32), wk.to(torch.float32)]

    keep = bev_tiles.bev6_keep(cfg, inp, tables, dmax)
    return _tiled(cfg, inp.base, keep, dmax, 6, signal_actors)


@pytest.fixture(scope="module")
def scene():
    return make_benchmark_scene(**make_presets()["reference"]["scene"],
                                device="cpu")


@pytest.fixture(scope="module")
def sim_states(scene):
    """12 envs after 20 simulator steps with 3 NPC vehicles and 2 walkers
    each."""
    return bev6_render_states(scene, 12, 0, seed=11)


def _inputs(scene, sim_states, width):
    """(cfg, Bev6Inputs, KernelTables): the first 9 envs placed on tile
    corners for this width, the last 3 as simulated."""
    cfg = EnvConfig(bev_width=width, **TRAFFIC)
    rs = bev6.place_in_view(scene, sim_states, range(9),
                            np.random.default_rng(width),
                            cfg.n_npc_vehicles, cfg.n_npc_walkers, tiles=cfg)
    inp = bev6.bev6_inputs(scene, cfg, rs)
    return cfg, inp, bev_tiles.kernel_tables(scene, rs, inp)


@pytest.mark.parametrize("mode", ["bev", "bev6"])
@pytest.mark.parametrize("width", [64, 100])
def test_tiled_render_matches_plain(scene, sim_states, mode, width):
    cfg, inp, tables = _inputs(scene, sim_states, width)
    dmax = scene.bnd_dmax
    if mode == "bev":
        want = bev.render_bev_plain(cfg, inp.base, dmax)
        got = render_bev_tiled(cfg, inp.base, dmax)
    else:
        want = bev6.render_bev6_plain(cfg, inp, dmax)
        got = render_bev6_tiled(cfg, inp, tables, dmax)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0
    # every channel is drawn, the signals at more than one value
    assert all(bool(want[:, c].any()) for c in range(want.shape[1]))
    if mode == "bev6":
        assert len(torch.unique(want[:, 3])) >= 3


@pytest.mark.parametrize("width", [64, 100])
def test_culled_items_reach_no_pixel(scene, sim_states, width):
    """The invariant the exactness rests on: every pixel-item pair that
    passes the plain version's threshold (road key <= dmax^2, capsule d2
    within its half width, pixel inside a box) is kept by the pixel's
    tile."""
    cfg, inp, tables = _inputs(scene, sim_states, width)
    dmax = scene.bnd_dmax
    keep = bev_tiles.bev6_keep(cfg, inp, tables, dmax)
    tile = bev_tiles.pixel_tile(width, "cpu")
    base = inp.base
    px = bev.pixel_world_coords(cfg, base.pose[:, :2], base.pose[:, 2],
                                base.pose[:, 3])
    d2, crn = bev.boundary_dist_cross(px, base.bnd)
    bnd_live = bev_tiles._live(base.counts[:, 0], base.bnd.shape[1])
    lane_live = bev_tiles._live(base.counts[:, 1], base.lane.shape[1])
    tl_live = bev_tiles._live(tables.n_tl, tables.tl.shape[1])
    boxes = tables.boxes
    dx = px[:, :, None, 0] - boxes[:, None, :, 0]
    dy = px[:, :, None, 1] - boxes[:, None, :, 1]
    c, s = boxes[:, None, :, 2], boxes[:, None, :, 3]
    inside = (torch.abs(dx * c + dy * s) <= boxes[:, None, :, 4]) & (
        torch.abs(-dx * s + dy * c) <= boxes[:, None, :, 5])
    k = tables.n_veh
    reached = {
        "road": bnd_live & (d2 - 1e-3 * torch.abs(crn) <= dmax * dmax),
        "route": bev.capsule_dist2_all(px, base.route) <= bev.ROUTE_HALF_W
        ** 2,
        "lane": lane_live & (bev.capsule_dist2_all(px, base.lane)
                             <= (base.lane_w * base.lane_w)[:, None, :]),
        "light": tl_live & (bev.capsule_dist2_all(px, tables.tl)
                            <= bev_tiles.TL_LINE_HALF_W ** 2),
        "stop": inside[..., :1],
        "vehicles": inside[..., 1:1 + k],
        "walkers": inside[..., 1 + k:],
    }
    for name, r in reached.items():
        assert bool(r.any()), name
        missed = r & ~keep[name][:, tile]
        assert int(missed.sum()) == 0, name


def test_culling_keeps_few_items_per_tile(scene, sim_states):
    """At the card's 192 px the tiles keep a small share of the live
    tables, so the kernels' per-pixel loops are short."""
    cfg, inp, tables = _inputs(scene, sim_states, 192)
    kept = bev_tiles.mean_kept(bev_tiles.bev6_keep(cfg, inp, tables,
                                                   scene.bnd_dmax))
    counts = inp.base.counts.to(torch.float32).mean(0)
    live = {"road": float(counts[0]), "lane": float(counts[1]),
            "route": float(inp.base.route.shape[1]),
            "light": float(tables.n_tl.to(torch.float32).mean()),
            "stop": 1.0, "vehicles": float(tables.n_veh),
            "walkers": float(inp.boxes.shape[1] - tables.n_veh)}
    assert set(kept) == set(live)
    for name in ("road", "lane", "route", "vehicles", "walkers"):
        assert kept[name] <= 0.5 * live[name], (name, kept, live)
    assert sum(kept.values()) <= 0.2 * sum(live.values()), (kept, live)
    assert kept["road"] > 0.0 and kept["vehicles"] > 0.0


def test_tile_grid_covers_ragged_views():
    """Every pixel of a W x W view lies in exactly one tile, and each
    tile's bounding circle holds every pixel of it."""
    for w in (64, 100, 192):
        cfg = EnvConfig(bev_width=w)
        tx, ty = bev_tiles.tile_grid(w)
        tile = bev_tiles.pixel_tile(w, "cpu")
        assert int(tile.max()) == tx * ty - 1
        pose = torch.tensor([[103.5, -7.25, 0.6, 0.8]])
        px = bev.pixel_world_coords(cfg, pose[:, :2], pose[:, 2],
                                    pose[:, 3])[0]
        centre = bev_tiles.tile_centres(cfg, pose).reshape(-1, 2)[tile]
        d = (px - centre).norm(dim=-1)
        assert float(d.max()) <= bev_tiles.tile_pad(cfg) - \
            bev_tiles.CULL_MARGIN + 1e-4
