# Frozen copy of gail_carla_tpu_torch/ops/bev_full.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""The full-parity BEV: the 15-channel mask stack and the rendered RGB
composite, batch-native.

Port of ``gail_carla_tpu/ops/bev_full.py`` (chauffeurnet.py:105-211):
masks = (road, route, lane, 4x vehicle history, 4x walker history, 4x
light/stop history) with history taps at ticks (-16, -11, -6, -1)
(carla_env.py:54), and the colour-composed "rendered" image of the demo
PNGs. Channel values match the reference: lane 255/120 (chauffeurnet.py:
186-189), traffic lights 80/170/255 and stop boxes 255 (chauffeurnet.py:
192-199), actor masks 255.

The plain renderers' exactness rules hold here too: cos and sin of each
yaw are taken once and passed in (``ops/bev.py::pixel_world_coords``),
segment distances go through ``ops/bev.py::capsule_dist2_all``, and the
float32 op order is the JAX version's. So the current-frame planes equal
``ops/bev6.py``'s channels and planes 0-2 ``ops/bev.py``'s.
"""
from __future__ import annotations

import torch

from bench_port.plain_reference.frozen.config import EnvConfig
from bench_port.plain_reference.frozen.ops.bev import (
    PLAIN_CHUNK, ROUTE_HALF_W, boundary_inside, capsule_dist2_all,
    fetch_bnd_cell, fetch_cell, pixel_world_coords, route_window_segs,
)
from bench_port.plain_reference.frozen.sim.dynamics import DEFAULT_VEHICLE, VehicleParams
from bench_port.plain_reference.frozen.sim.state import HISTORY_LEN, HistoryState

WALKER_HALF = (0.8, 0.8)  # chauffeurnet.py:266-269 min bbox after scaling
TL_LINE_HALF_W = 0.6      # 6 px stroke at 5 px/m (chauffeurnet.py:237)

# chauffeurnet.py:161-183 palette of the rendered image
COLOR_ROAD = (46, 52, 54)          # COLOR_ALUMINIUM_5
COLOR_ROUTE = (136, 138, 133)      # COLOR_ALUMINIUM_3
COLOR_LANE_SOLID = (255, 0, 255)
COLOR_LANE_BROKEN = (255, 140, 255)
COLOR_LIGHTS = ((80, (0, 255, 0)), (170, (255, 255, 0)), (255, (255, 0, 0)))
COLOR_VEHICLE = (0, 0, 255)
COLOR_WALKER = (0, 255, 255)
COLOR_EGO = (255, 255, 255)


def boxes_mask(px, centers, cos, sin, half_len, half_wid):
    """(..., P) bool: any pixel (..., P, 2) inside any oriented box
    (..., B) with centres (..., B, 2), heading cos/sin, and half extents
    (chauffeurnet's _get_mask_from_actor_list, a cv2.fillConvexPoly
    equivalent). A negative half extent draws nothing."""
    if centers.shape[-2] == 0:
        return torch.zeros(px.shape[:-1], dtype=torch.bool,
                           device=px.device)
    c = cos[..., None, :]
    s = sin[..., None, :]
    dx = px[..., :, None, 0] - centers[..., None, :, 0]
    dy = px[..., :, None, 1] - centers[..., None, :, 1]
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    inside = (torch.abs(lx) <= half_len[..., None, :]) & (
        torch.abs(ly) <= half_wid[..., None, :]
    )
    return inside.any(dim=-1)


def history_slot(hist: HistoryState, tap: int) -> torch.Tensor:
    """(N,) ring slot of history index ``tap`` (negative, like
    ``deque[tap]``), clamped to the oldest valid entry (chauffeurnet.py:
    216-217)."""
    tap_clamped = torch.clamp_min(-torch.clamp_min(hist.count, 1), tap)
    return torch.remainder(hist.idx + tap_clamped, HISTORY_LEN)


def push_history(hist: HistoryState, veh_pose, walker_pose, tl_state,
                 stop_active) -> HistoryState:
    """The ring with this tick's snapshot written at each env's ``idx``:
    poses (N, K, 3) and (N, W, 3), light states (N, T), active stop signs
    (N, S). The old tensors are left as they were."""
    rows = torch.arange(hist.idx.shape[0], device=hist.idx.device)
    at = (rows, hist.idx.long())
    return HistoryState(
        veh_pose=hist.veh_pose.index_put(at, veh_pose),
        walker_pose=hist.walker_pose.index_put(at, walker_pose),
        tl_state=hist.tl_state.index_put(at, tl_state.to(torch.int8)),
        stop_active=hist.stop_active.index_put(at, stop_active),
        idx=torch.remainder(hist.idx + 1, HISTORY_LEN).to(torch.int32),
        count=torch.clamp_max(hist.count + 1, HISTORY_LEN),
    )


def _at_slot(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(n, ...) entries of a ring (n, 20, ...) at each env's slot."""
    return arr[torch.arange(arr.shape[0], device=arr.device), slot.long()]


def _pose_boxes_mask(px, pose, half_len: float, half_wid: float):
    """Pixels inside any box of poses (n, M, 3) with fixed half extents."""
    yaw = pose[..., 2]
    return boxes_mask(px, pose[..., :2], torch.cos(yaw), torch.sin(yaw),
                      torch.full_like(yaw, half_len),
                      torch.full_like(yaw, half_wid))


def _paint(img, mask, color):
    col = torch.tensor(color, dtype=torch.uint8, device=img.device)
    return torch.where(mask[..., None], col, img)


def _render_chunk(scene, cfg: EnvConfig, xy, yaw, route_id, head,
                  hist: HistoryState, params: VehicleParams):
    c, s = torch.cos(yaw), torch.sin(yaw)
    px = pixel_world_coords(cfg, xy, c, s)
    _, _, lane_segs, lane_val, lane_w = fetch_cell(scene, xy)
    bnd_segs, _ = fetch_bnd_cell(scene, xy)
    route_segs = route_window_segs(scene, route_id, head)

    road = boundary_inside(px, bnd_segs, scene.bnd_dmax)
    route = torch.amin(capsule_dist2_all(px, route_segs),
                       dim=-1) <= ROUTE_HALF_W ** 2
    d2 = capsule_dist2_all(px, lane_segs)
    lw = lane_w[:, None, :]
    lane_u8 = torch.amax(
        torch.where(d2 <= lw * lw, lane_val[:, None, :], 0.0), dim=-1
    ).to(torch.uint8)

    # stop lines: one distance table for every tap, valued per tap
    T = scene.tl_stop.shape[0]
    on_line = capsule_dist2_all(
        px, scene.tl_stop.reshape(-1, 4)) <= TL_LINE_HALF_W ** 2
    on_line = on_line & (torch.arange(T, device=px.device) < scene.tl_n)
    S = scene.ss_center.shape[0]
    ss_half = torch.maximum(scene.ss_extent[:, 0], scene.ss_extent[:, 1])
    ss_c, ss_s = torch.cos(scene.ss_yaw), torch.sin(scene.ss_yaw)

    veh_ch, wk_ch, tl_ch = [], [], []
    for tap in cfg.history_idx:  # (-16, -11, -6, -1)
        slot = history_slot(hist, tap)
        veh_ch.append(_pose_boxes_mask(px, _at_slot(hist.veh_pose, slot),
                                       params.half_length,
                                       params.half_width))
        wk_ch.append(_pose_boxes_mask(
            px, _at_slot(hist.walker_pose, slot), *WALKER_HALF))
        ts = _at_slot(hist.tl_state, slot)[:, None, :]
        val = torch.where(ts == 0, 80, torch.where(ts == 1, 170, 255))
        tl = torch.amax(torch.where(on_line, val, 0), dim=-1)
        if S > 0:
            # only the active target stop sign is drawn (chauffeurnet
            # _get_stops)
            sa = _at_slot(hist.stop_active, slot)
            half = torch.where(sa, ss_half, -1.0)
            stop_px = boxes_mask(px, scene.ss_center, ss_c, ss_s, half,
                                 half)
            tl = torch.maximum(tl, torch.where(stop_px, 255, 0))
        tl_ch.append(tl.to(torch.uint8))

    def to8(m):
        return m.to(torch.uint8) * 255

    w = cfg.bev_width
    n = xy.shape[0]
    masks = torch.stack(
        [to8(road), to8(route), lane_u8] + [to8(m) for m in veh_ch]
        + [to8(m) for m in wk_ch] + tl_ch, dim=1,
    ).reshape(n, 15, w, w)

    # rendered RGB: the palette, current-frame actors, the ego on top
    img = torch.zeros(px.shape[:-1] + (3,), dtype=torch.uint8,
                      device=px.device)
    img = _paint(img, road, COLOR_ROAD)
    img = _paint(img, route, COLOR_ROUTE)
    img = _paint(img, lane_u8 == 255, COLOR_LANE_SOLID)
    img = _paint(img, lane_u8 == 120, COLOR_LANE_BROKEN)
    for level, color in COLOR_LIGHTS:
        img = _paint(img, tl_ch[-1] == level, color)
    img = _paint(img, veh_ch[-1], COLOR_VEHICLE)
    img = _paint(img, wk_ch[-1], COLOR_WALKER)

    def ego_mask(scale_len, scale_wid):
        one = torch.ones_like(yaw)[:, None]
        return boxes_mask(px, xy[:, None, :], c[:, None], s[:, None],
                          one * scale_len, one * scale_wid)

    img = _paint(img, ego_mask(params.half_length, params.half_width),
                 COLOR_EGO)
    # collision_px (chauffeurnet.py:209): the 1.1-scaled ego box over the
    # latest walker mask
    ego_col = ego_mask(params.half_length * 1.1, params.half_width * 1.1)
    collision_px = (ego_col & wk_ch[-1]).any(dim=-1)
    return masks, img.reshape(n, w, w, 3), collision_px


def render_bev_full(scene, cfg: EnvConfig, xy, yaw, route_id, head,
                    hist: HistoryState,
                    params: VehicleParams = DEFAULT_VEHICLE):
    """Returns (masks (N, 15, W, W) u8, rendered (N, W, W, 3) u8,
    collision_px (N,) bool) for N envs, in chunks of ``PLAIN_CHUNK``."""
    parts = []
    for lo in range(0, xy.shape[0], PLAIN_CHUNK):
        sl = slice(lo, lo + PLAIN_CHUNK)
        h = HistoryState(**{k: getattr(hist, k)[sl]
                            for k in HistoryState.__dataclass_fields__})
        parts.append(_render_chunk(scene, cfg, xy[sl], yaw[sl],
                                   route_id[sl], head[sl], h, params))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))
