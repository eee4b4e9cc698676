# Frozen copy of gail_carla_tpu_torch/ops/bev.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Bird's-eye-view rendering by vector rasterization: the plain PyTorch
version, batch-native.

Port of ``gail_carla_tpu/ops/bev.py``. Each output pixel computes its
distance to a small set of nearby capsule segments: road-boundary and
lane-marking tables fetched from the ego's spatial-hash cell, and the
"route ahead" band of 20 capsules over the dense-route window at the
env's route cursor. The three channels are (road, route, lane), the
policy observation of the reference (mask 0 of chauffeurnet).

This module is the reference for the CUDA kernel (ops/bev_cuda.py): both
take the same fetched tables (``bev_inputs``) and the same cos/sin of yaw,
and keep the same float32 op order, so they agree bit for bit. On the CPU
``render_bev_batch_auto`` runs this version; on a CUDA tensor it launches
the kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from bench_port.plain_reference.frozen.config import EnvConfig
from bench_port.plain_reference.frozen.sim.cursor import take_window

ROUTE_WINDOW = 84       # dense points sliced at the cursor (>= 80 drawn)
ROUTE_STRIDE = 4        # subsample for capsule segments (20 segs over 80 m)
ROUTE_HALF_W = 1.6      # m; 16 px stroke at 5 px/m (chauffeurnet.py:152)
# mask values normalise by multiplying with the rounded float32
# reciprocal, as the JAX renderer and its kernel do
INV_255 = 1.0 / 255.0
# envs per pass of the plain renderer: its (pixels x segments)
# intermediates are ~5 MB per env and table
PLAIN_CHUNK = 8


@dataclasses.dataclass
class BevInputs:
    """Per-env tables one render reads (the kernel's arguments)."""

    pose: torch.Tensor      # (N, 4) f32 [x, y, cos yaw, sin yaw]
    counts: torch.Tensor    # (N, 2) i32 live [n_bnd, n_lane] of the cell
    bnd: torch.Tensor       # (N, Mb, 4) oriented boundary edges
    lane: torch.Tensor      # (N, Ml, 4) lane-marking capsules
    lane_val: torch.Tensor  # (N, Ml) marking value (255 / 120)
    lane_w: torch.Tensor    # (N, Ml) marking half width, metres
    route: torch.Tensor     # (N, K, 4) route-window capsules


def pixel_world_coords(cfg: EnvConfig, xy, c, s):
    """(N, W*W, 2) world coordinates of each BEV pixel for poses ``xy``
    (N, 2) with heading cos ``c`` and sin ``s`` (N,). Chauffeurnet's affine
    frame (chauffeurnet.py:274-289): ego ``pixels_ev_to_bottom`` px above
    the bottom edge, heading up, columns spanning ego-right; the scale is
    folded into the direction vectors first, as in the JAX renderer."""
    w = cfg.bev_width
    ppm = cfg.pixels_per_meter
    fwd = torch.stack([c, s], dim=-1)
    right = torch.stack([-s, c], dim=-1)
    top_left = (
        xy + ((w - cfg.pixels_ev_to_bottom) / ppm) * fwd
        - (0.5 * w / ppm) * right
    )
    scale = w / (w - 1.0) / ppm
    cols = torch.arange(w, dtype=torch.float32, device=xy.device)
    rows = torch.arange(w, dtype=torch.float32, device=xy.device)
    px = (
        top_left[:, None, None, :]
        + cols[None, None, :, None] * (scale * right)[:, None, None, :]
        - rows[None, :, None, None] * (scale * fwd)[:, None, None, :]
    )
    return px.reshape(xy.shape[0], w * w, 2)


def capsule_dist2_all(px, seg_ab):
    """(..., P, S) squared distance from each pixel (..., P, 2) to each
    segment (..., S, 4), with the division hoisted to a per-segment
    reciprocal (the kernel's op order)."""
    ax = seg_ab[..., None, :, 0]
    ay = seg_ab[..., None, :, 1]
    abx = seg_ab[..., None, :, 2] - ax
    aby = seg_ab[..., None, :, 3] - ay
    inv_denom = 1.0 / ((abx * abx + aby * aby) + 1e-9)
    aab = ax * abx + ay * aby
    pxx = px[..., :, None, 0]
    pxy = px[..., :, None, 1]
    t = torch.clamp(((pxx * abx + pxy * aby) - aab) * inv_denom, 0.0, 1.0)
    dx = (pxx - ax) - t * abx
    dy = (pxy - ay) - t * aby
    return dx * dx + dy * dy


def boundary_dist_cross(px, bnd_segs):
    """(..., P, S) squared distance AND length-normalised cross against
    oriented boundary edges; cross > 0 means the interior side. Per-edge
    coefficients are folded once, as the kernel hoists them."""
    ax = bnd_segs[..., None, :, 0]
    ay = bnd_segs[..., None, :, 1]
    abx = bnd_segs[..., None, :, 2] - ax
    aby = bnd_segs[..., None, :, 3] - ay
    inv_denom = 1.0 / ((abx * abx + aby * aby) + 1e-9)
    inv_len = torch.sqrt(inv_denom)
    tx = abx * inv_denom
    ty = aby * inv_denom
    tc = (ax * abx + ay * aby) * inv_denom
    nx = abx * inv_len
    ny = aby * inv_len
    pxx = px[..., :, None, 0]
    pxy = px[..., :, None, 1]
    t = torch.clamp((pxx * tx + pxy * ty) - tc, 0.0, 1.0)
    dx = (pxx - ax) - t * abx
    dy = (pxy - ay) - t * aby
    d2 = dx * dx + dy * dy
    crn = nx * dy - ny * dx
    return d2, crn


def boundary_inside(px, bnd_segs, dmax: float):
    """(..., P) bool: pixel inside the oriented-contour region.

    The nearest boundary edge's cross sign decides, guarded by
    ``d2 <= dmax^2``; "nearest" minimises ``key = d2 - 1e-3*|crn|`` with the
    first of equal keys winning, which resolves exact vertex ties to the
    edge with the unambiguous sign (``gail_carla_tpu/ops/bev.py:
    boundary_inside`` states the argument)."""
    d2, crn = boundary_dist_cross(px, bnd_segs)
    key = d2 - 1e-3 * torch.abs(crn)
    keymin, first = torch.min(key, dim=-1)
    cr_sel = torch.gather(crn, -1, first[..., None])[..., 0]
    return (cr_sel > 0.0) & (keymin <= dmax * dmax)


def _cell_of(scene, xy):
    """(cy, cx) spatial-hash cell of each pose (N, 2), clamped to the grid."""
    gy, gx = scene.cell_road.shape[:2]
    cell = torch.floor((xy - scene.cell_grid_lo) / scene.cell_size).to(
        torch.int64
    )
    cx = cell[:, 0].clamp(0, gx - 1)
    cy = cell[:, 1].clamp(0, gy - 1)
    return cy, cx


def fetch_cell(scene, xy):
    """Per env (road_segs (N,Mr,4), road_flag (N,Mr), lane_segs (N,Ml,4),
    lane_val (N,Ml), lane_w (N,Ml)) of its cell."""
    cy, cx = _cell_of(scene, xy)
    return (scene.cell_road[cy, cx], scene.cell_road_flag[cy, cx],
            scene.cell_lane[cy, cx], scene.cell_lane_val[cy, cx],
            scene.cell_lane_w[cy, cx])


def fetch_bnd_cell(scene, xy):
    """Per env oriented road-boundary edges: (segs (N,Mb,4), n_live (N,))."""
    cy, cx = _cell_of(scene, xy)
    return scene.cell_bnd[cy, cx], scene.cell_bnd_n[cy, cx]


def fetch_hard_cell(scene, xy):
    """Per env hard-surface boundary edges: (segs (N,Mh,4), n_live (N,)),
    the layout-collision geometry (aliases the road boundary on
    procedural towns)."""
    cy, cx = _cell_of(scene, xy)
    return scene.cell_hard[cy, cx], scene.cell_hard_n[cy, cx]


def fetch_cell_counts(scene, xy):
    """(n_bnd (N,), n_lane (N,)) live segment counts of each env's cell."""
    cy, cx = _cell_of(scene, xy)
    return scene.cell_bnd_n[cy, cx], scene.cell_lane_n[cy, cx]


def fetch_tl_cell(scene, xy):
    """Per env the culled traffic-light stop lines of its cell: (segs
    (N,Mt,4), source light index (N,Mt), n_live (N,)). The cell tables are
    built with the road tables' margin rule (``segments.py::
    build_tl_cells``), so drawing only these lines gives the same pixels
    as drawing every light of the town."""
    cy, cx = _cell_of(scene, xy)
    return (scene.cell_tl[cy, cx], scene.cell_tl_idx[cy, cx],
            scene.cell_tl_n[cy, cx])


def route_window_segs(scene, route_id, head):
    """(N, K, 4) capsule segments of the route ahead of each cursor; the
    window start is clamped into the row as ``dynamic_slice`` clamps it."""
    win = take_window(scene.route_xy, route_id, head, ROUTE_WINDOW)
    pts = win[:, ::ROUTE_STRIDE]
    return torch.cat([pts[:, :-1], pts[:, 1:]], dim=-1)


def bev_inputs(scene, render_state) -> BevInputs:
    """Fetch every env's tables for one render. cos and sin of yaw are
    taken here, once, for the plain version and the kernel alike."""
    xy = render_state.xy
    yaw = render_state.yaw
    _, _, lane, lane_val, lane_w = fetch_cell(scene, xy)
    bnd, _ = fetch_bnd_cell(scene, xy)
    nb, nl = fetch_cell_counts(scene, xy)
    return BevInputs(
        pose=torch.stack([xy[:, 0], xy[:, 1], torch.cos(yaw),
                          torch.sin(yaw)], dim=1).contiguous(),
        counts=torch.stack([nb, nl], dim=1).to(torch.int32).contiguous(),
        bnd=bnd.contiguous(),
        lane=lane.contiguous(),
        lane_val=lane_val.contiguous(),
        lane_w=lane_w.contiguous(),
        route=route_window_segs(
            scene, render_state.route_id, render_state.head
        ).contiguous(),
    )


def render_bev_plain(cfg: EnvConfig, inp: BevInputs,
                     dmax: float) -> torch.Tensor:
    """(N, 3, W, W) float32 in [0, 1] from fetched tables, in chunks of
    ``PLAIN_CHUNK`` envs."""
    w = cfg.bev_width
    n = inp.pose.shape[0]
    out = torch.empty((n, 3, w, w), dtype=torch.float32,
                      device=inp.pose.device)
    for lo in range(0, n, PLAIN_CHUNK):
        sl = slice(lo, min(lo + PLAIN_CHUNK, n))
        px = pixel_world_coords(
            cfg, inp.pose[sl, :2], inp.pose[sl, 2], inp.pose[sl, 3]
        )
        road = boundary_inside(px, inp.bnd[sl], dmax)
        route_d2 = torch.amin(capsule_dist2_all(px, inp.route[sl]), dim=-1)
        route = route_d2 <= ROUTE_HALF_W ** 2
        # lane channel: the max marking value covering the pixel
        d2 = capsule_dist2_all(px, inp.lane[sl])
        lw = inp.lane_w[sl, None, :]
        hit = d2 <= lw * lw
        lane = torch.amax(
            torch.where(hit, inp.lane_val[sl, None, :], 0.0), dim=-1
        ) * INV_255
        img = torch.stack(
            [road.to(torch.float32), route.to(torch.float32), lane], dim=1
        )
        out[sl] = img.reshape(-1, 3, w, w)
    return out


def render_bev_batch(scene, cfg: EnvConfig, render_state) -> torch.Tensor:
    """(N, 3, W, W) observation of a RenderState batch, plain version."""
    return render_bev_plain(cfg, bev_inputs(scene, render_state),
                            scene.bnd_dmax)


def render_bev_batch_auto(scene, cfg: EnvConfig, render_state):
    """The CUDA kernel for a render state on the card, the plain version
    for one on the CPU. There is no fallback between the two."""
    return render_bev_batch(scene, cfg, render_state)
