# Frozen copy of gail_carla_tpu_torch/ops/bev_tiles.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Pixel tiles and per-tile culling of the BEV kernels
(``csrc/bev_raster.cu``, ``csrc/bev6_raster.cu``).

The kernels cut each env's W x W view into tiles of ``TILE_COLS`` x
``TILE_ROWS`` pixels, one warp per tile and one column per lane. Before a
warp draws its tile, it keeps of each table only the items that can reach
a pixel of the tile: those within ``reach + tile_pad(cfg)`` metres of the
centre of the tile's bounding circle, where ``tile_pad`` is the circle's
radius plus ``CULL_MARGIN``. The kernels take the tile height, the pad and
the reaches from here (``ops/bev_cuda.py``, ``ops/bev6_cuda.py``), so the
rule tested on the CPU is the rule the card runs.

The reach of an item is how far from it a pixel can still be changed by
it:
- road boundary edge: ``road_reach(dmax)``. The edge's tie key is
  ``key = d2 - 1e-3*|cross|`` with ``|cross| <= d``, so beyond that reach
  ``key > dmax^2`` at every pixel of the tile: the edge can neither
  displace a winner whose key is ``<= dmax^2`` (nor tie with it: the tie
  test is a strict ``<``), nor turn a 0 pixel into a 1, since a pixel is
  1 only where the winning key is ``<= dmax^2``. Keeping the survivors in
  table order keeps the first-wins rule among equal keys;
- route capsule: ``ROUTE_HALF_W`` (a pixel is on the route where its
  distance to some capsule is within it);
- lane capsule: its own half width (``|lane_w|``);
- stop line: ``TL_LINE_HALF_W``;
- oriented box: its half diagonal, and none (never kept) when a half
  extent is negative: a box draws nothing then.
A pixel's min or max over a table therefore comes out the same over the
tile's survivors as over the whole table. Distances are point-to-segment
distances in float32; ``CULL_MARGIN`` is far above their rounding at town
coordinates (about 1e-4 m at 1 km).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bench_port.plain_reference.frozen.config import EnvConfig
from bench_port.plain_reference.frozen.ops.bev import (
    ROUTE_HALF_W, BevInputs, fetch_tl_cell,
)
from bench_port.plain_reference.frozen.ops.bev_full import TL_LINE_HALF_W

TILE_COLS = 32       # one column per lane of a warp
TILE_ROWS = 16       # rows of a tile; a multiple of the kernels' 8-row pass
CULL_MARGIN = 0.05   # metres added to every reach


def tile_grid(w: int):
    """(tiles across, tiles down) of a W x W view; the last tile of each
    row and column is ragged unless the tile divides W."""
    return -(-w // TILE_COLS), -(-w // TILE_ROWS)


def view_params(cfg: EnvConfig):
    """(forward offset, right offset, metres per pixel step) of the view's
    top-left pixel frame, as ``ops/bev.py::pixel_world_coords`` takes
    them; the kernels' launch arguments."""
    w, ppm = cfg.bev_width, cfg.pixels_per_meter
    return (w - cfg.pixels_ev_to_bottom) / ppm, 0.5 * w / ppm, \
        w / (w - 1.0) / ppm


def tile_pad(cfg: EnvConfig) -> float:
    """Radius of a tile's bounding circle (half the diagonal between its
    corner pixels) plus ``CULL_MARGIN``, metres."""
    scale = view_params(cfg)[2]
    return (0.5 * scale * math.hypot(TILE_COLS - 1, TILE_ROWS - 1)
            + CULL_MARGIN)


def road_reach(dmax: float) -> float:
    """Distance beyond which a boundary edge's tie key exceeds dmax^2 at
    any cross: d^2 - 1e-3*d > dmax^2 for d above this root."""
    return 0.5 * (1e-3 + math.sqrt(1e-6 + 4.0 * dmax * dmax))


def tile_centres(cfg: EnvConfig, pose: torch.Tensor) -> torch.Tensor:
    """(N, tiles down, tiles across, 2) world centre of each tile's
    bounding circle for poses (N, 4) = x, y, cos, sin: the pixel frame of
    ``pixel_world_coords`` at the tile's middle row and column."""
    fwd_off, right_off, scale = view_params(cfg)
    tx, ty = tile_grid(cfg.bev_width)
    x, y, c, s = pose.unbind(-1)
    tl_x = (x + fwd_off * c) - right_off * (-s)
    tl_y = (y + fwd_off * s) - right_off * c
    dev = pose.device
    col = (torch.arange(tx, device=dev, dtype=torch.float32) * TILE_COLS
           + 0.5 * (TILE_COLS - 1))
    row = (torch.arange(ty, device=dev, dtype=torch.float32) * TILE_ROWS
           + 0.5 * (TILE_ROWS - 1))
    cx = ((tl_x[:, None, None] + col[None, None, :] * (scale * (-s))[
        :, None, None]) - row[None, :, None] * (scale * c)[:, None, None])
    cy = ((tl_y[:, None, None] + col[None, None, :] * (scale * c)[
        :, None, None]) - row[None, :, None] * (scale * s)[:, None, None])
    return torch.stack([cx, cy], dim=-1)


def seg_dist2(centre: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """(N, T, S) squared distance from each tile centre (N, T, 2) to each
    segment (N, S, 4) of the tile's env; a zero-length segment is its
    first point."""
    ax = segs[:, None, :, 0]
    ay = segs[:, None, :, 1]
    abx = segs[:, None, :, 2] - ax
    aby = segs[:, None, :, 3] - ay
    qx = centre[..., 0, None] - ax
    qy = centre[..., 1, None] - ay
    l2 = abx * abx + aby * aby
    t = torch.where(l2 > 0.0, (qx * abx + qy * aby) / l2, 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    dx = qx - t * abx
    dy = qy - t * aby
    return dx * dx + dy * dy


def _within(d2, reach, pad: float):
    lim = reach + pad
    return d2 <= lim * lim


def _live(n_live: torch.Tensor, m: int) -> torch.Tensor:
    """(N, 1, m) bool: rows below each env's live count."""
    return (torch.arange(m, device=n_live.device)[None, None, :]
            < n_live.to(torch.int64)[:, None, None])


def box_live(boxes: torch.Tensor) -> torch.Tensor:
    """(N, B) bool: box rows (N, B, 8) with no negative half extent (a box
    with one draws nothing)."""
    return (boxes[..., 4] >= 0.0) & (boxes[..., 5] >= 0.0)


def box_reach(boxes: torch.Tensor) -> torch.Tensor:
    """(N, B) half diagonal of each box row (N, B, 8)."""
    hl, hw = boxes[..., 4], boxes[..., 5]
    return torch.sqrt(hl * hl + hw * hw)


def bev_keep(cfg: EnvConfig, inp: BevInputs, dmax: float):
    """{"road", "route", "lane"}: (N, T, M) bool, the items of each table
    that each tile (T = tiles down x across, row-major) keeps."""
    pad = tile_pad(cfg)
    c = tile_centres(cfg, inp.pose).flatten(1, 2)
    return {
        "road": _live(inp.counts[:, 0], inp.bnd.shape[1])
        & _within(seg_dist2(c, inp.bnd), road_reach(dmax), pad),
        "route": _within(seg_dist2(c, inp.route), ROUTE_HALF_W, pad),
        "lane": _live(inp.counts[:, 1], inp.lane.shape[1])
        & _within(seg_dist2(c, inp.lane), inp.lane_w.abs()[:, None, :],
                  pad),
    }


@dataclasses.dataclass
class KernelTables:
    """The signal and box tables the bev6 kernel fetches for each env; the
    plain version (``ops/bev6.py``) draws every light and stop sign."""

    tl: torch.Tensor         # (N, Mt, 4) the ego cell's culled stop lines
    tl_val: torch.Tensor     # (N, Mt) f32 their phase values
    n_tl: torch.Tensor       # (N,) live stop lines
    boxes: torch.Tensor      # (N, 1+K+W, 8) active stop sign, K, W
    n_veh: int               # K


def kernel_tables(scene, render_state, inp) -> KernelTables:
    """What the bev6 kernel reads of a render whose plain tables are
    ``inp`` (``ops/bev6.py::Bev6Inputs``)."""
    n = inp.base.pose.shape[0]
    rows = torch.arange(n, device=inp.base.pose.device)
    tl, tl_idx, n_tl = fetch_tl_cell(scene, render_state.xy)
    s = inp.stop_boxes.shape[1]
    stop = inp.stop_boxes[rows, render_state.stop_idx.long().clamp(0, s - 1)]
    return KernelTables(
        tl=tl, tl_val=inp.tl_val_all[rows[:, None], tl_idx.long()],
        n_tl=n_tl, boxes=torch.cat([stop[:, None, :], inp.boxes], dim=1),
        n_veh=inp.n_veh,
    )


def bev6_keep(cfg: EnvConfig, inp, tables: KernelTables, dmax: float):
    """``bev_keep`` of the base tables of ``inp`` (a ``Bev6Inputs``) plus
    {"light", "stop", "vehicles", "walkers"} of the kernel's ``tables``."""
    keep = bev_keep(cfg, inp.base, dmax)
    pad = tile_pad(cfg)
    c = tile_centres(cfg, inp.base.pose).flatten(1, 2)
    keep["light"] = (_live(tables.n_tl, tables.tl.shape[1])
                     & _within(seg_dist2(c, tables.tl), TL_LINE_HALF_W, pad))
    b = tables.boxes
    centres = torch.cat([b[..., :2], b[..., :2]], dim=-1)
    boxes = box_live(b)[:, None, :] & _within(
        seg_dist2(c, centres), box_reach(b)[:, None, :], pad)
    k = tables.n_veh
    keep["stop"] = boxes[..., :1]
    keep["vehicles"] = boxes[..., 1:1 + k]
    keep["walkers"] = boxes[..., 1 + k:]
    return keep


def mean_kept(keep) -> dict:
    """Mean number of items each tile keeps, by table."""
    return {name: float(k.sum(-1).float().mean()) for name, k in keep.items()}


def pixel_tile(w: int, device) -> torch.Tensor:
    """(W*W,) row-major tile index of each pixel."""
    tx, _ = tile_grid(w)
    r = torch.arange(w, device=device)
    return ((r[:, None] // TILE_ROWS) * tx
            + r[None, :] // TILE_COLS).reshape(-1)
