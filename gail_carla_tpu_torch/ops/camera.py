"""Pseudo-camera RGB: ground-plane and ray-traced-box projective
rendering.

Port of ``gail_carla_tpu/ops/camera.py``. The reference records three
384x216 fov-60 RGB cameras in its expert demos (``carla_env.py:25-48``);
the policy never reads them, but the demo-file format holds them. Each
camera pixel below the horizon is ray-cast onto the ground plane and
painted with the BEV's road / lane palette (grass elsewhere); pixels above
it get a zenith-to-horizon sky gradient. NPC vehicles, walkers, static
obstacles and traffic-light heads are ray-traced as oriented 3D boxes
(slab method) with a depth test against the ground, the nearest
``MAX_BOXES`` kept, their faces Lambert-shaded against the sun direction.
An exponential distance fog and a day/night brightness factor follow the
weather (``sim/weather.py``). No textures or meshes: a geometric sensor.

Arithmetic follows the JAX source op by op: true divisions (the fixed
pixel grids are computed once on the host in float32 numpy, so the card
and the CPU use the same values), the nearest boxes kept in a stable order
(``jax.lax.top_k`` keeps the lower index of a tie first), and the picked
box's colour and shade gathered, which equals the JAX version's one-hot
product. Every float-to-uint8 cast truncates, as there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gail_carla_tpu_torch.ops.bev import (
    boundary_inside, fetch_bnd_cell, fetch_cell, fetch_cell_counts,
)
from gail_carla_tpu_torch.sim.transforms import norm2

CAM_W, CAM_H = 384, 216      # carla_env.py:27-28
CAM_FOV = 60.0               # degrees
CAM_HEIGHT = 1.3             # m above ground (carla_env.py:30)
CAM_FORWARD = 0.8            # m ahead of the ego origin
# the three demo cameras and their yaw offsets (carla_env.py:33-47)
CAMERAS = {"rgb": 0.0, "rgb_left": math.radians(-55.0),
           "rgb_right": math.radians(55.0)}

SKY = (135, 180, 235)           # horizon tint (also the fog colour)
SKY_ZENITH = (70, 120, 215)     # overhead blue, gradient to SKY at horizon
GROUND = (90, 85, 80)
ROAD = (46, 52, 54)
LANE_SOLID = (255, 0, 255)
LANE_BROKEN = (255, 140, 255)
# actor palette: the BEV rendered image's (ops/bev_full.py)
VEHICLE = (0, 0, 255)
WALKER = (0, 255, 255)
BUILDING = (120, 120, 120)
TL_COLORS = ((0, 255, 0), (255, 255, 0), (255, 0, 0))  # green/yellow/red

# box half-heights (m): vehicle roofline ~1.5, walker ~1.8, building 6
VEH_HH, WALKER_HH, OB_HH = 0.75, 0.9, 3.0
VEH_EXTENT, WALKER_EXTENT = (2.45, 1.06, VEH_HH), (0.35, 0.35, WALKER_HH)
TL_HEAD_Z, TL_HEAD_HE = 2.4, (0.35, 0.35, 0.35)   # light head centre/size
MAX_BOXES = 64               # nearest boxes kept per frame


def _pixel_grid():
    """The fixed per-pixel values, float32 numpy (P = H*W): ray
    coordinates uu, vv, the below-horizon flag, the ground depth, the sky
    gradient position and the sky colour."""
    f32 = np.float32
    f = CAM_W / (2.0 * math.tan(math.radians(CAM_FOV) / 2.0))
    u = (np.arange(CAM_W, dtype=f32) - f32(CAM_W / 2.0) + f32(0.5)) / f32(f)
    v = (np.arange(CAM_H, dtype=f32) - f32(CAM_H / 2.0) + f32(0.5)) / f32(f)
    uu, vv = np.meshgrid(u, v)
    below = vv > f32(1e-4)
    depth = np.where(below, f32(CAM_HEIGHT) / np.maximum(vv, f32(1e-4)),
                     f32(1e6))
    depth = np.clip(depth, f32(0.0), f32(120.0)).astype(f32)
    vmax = f32((CAM_H / 2.0) / f)
    up = np.clip(-vv.reshape(-1) / vmax, f32(0.0), f32(1.0))
    sky = np.asarray(SKY, f32)
    sky_rgb = (sky[None, :] + up[:, None] * (np.asarray(SKY_ZENITH, f32)
                                             - sky)[None, :]).astype(np.uint8)
    return dict(uu=uu.reshape(-1), vv=vv.reshape(-1),
                below=below.reshape(-1), depth=depth.reshape(-1), up=up,
                ground=np.flatnonzero(below),
                sky_rgb=sky_rgb,
                far=(f32(120.0) * (f32(1.0) - up)).astype(f32))


def _ray_boxes(o, d, centers, yaws, extents, sun_dir):
    """Slab-method ray vs oriented-box intersection for one camera.

    ``o`` (3,) ray origin; ``d`` (P, 3) unnormalised ray directions;
    ``centers`` (B, 3), ``yaws`` (B,), ``extents`` (B, 3) half sizes;
    ``sun_dir`` (3,) unit vector toward the sun. Returns (t, shade): the
    entry parameter (P, B), 1e9 where the ray misses (in the ground hit's
    parameterisation, so the two depth-test directly), and the Lambert
    factor of the entry face (ambient 0.45 + diffuse 0.55 * max(0, n.l))."""
    c, s = torch.cos(yaws), torch.sin(yaws)
    rel = o[None, :] - centers                       # (B, 3)
    ox = c * rel[:, 0] + s * rel[:, 1]
    oy = -s * rel[:, 0] + c * rel[:, 1]
    oz = rel[:, 2]
    dx = c[None, :] * d[:, 0:1] + s[None, :] * d[:, 1:2]   # (P, B)
    dy = -s[None, :] * d[:, 0:1] + c[None, :] * d[:, 1:2]
    dz = d[:, 2:3].expand_as(dx)

    def slab(oo, dd, h):
        # dd ~ 0: a huge positive inverse keeps inside-slab rays inside
        # and pushes outside-slab rays to an empty interval
        inv = torch.where(torch.abs(dd) < 1e-9, 1e9, 1.0 / dd)
        t1 = (-h[None, :] - oo[None, :]) * inv
        t2 = (h[None, :] - oo[None, :]) * inv
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    n0, f0 = slab(ox, dx, extents[:, 0])
    n1, f1 = slab(oy, dy, extents[:, 1])
    n2, f2 = slab(oz, dz, extents[:, 2])
    tmin = torch.maximum(torch.maximum(n0, n1), n2)
    tmax = torch.minimum(torch.minimum(f0, f1), f2)
    hit = (tmax >= tmin) & (tmax > 0.0)

    # entry-face normal . sun: the box axis whose near-slab t is tmin,
    # pointing against the ray (box axes x=(c,s,0), y=(-s,c,0), z=(0,0,1))
    lx = c * sun_dir[0] + s * sun_dir[1]             # sun in box frame (B,)
    ly = -s * sun_dir[0] + c * sun_dir[1]
    lz = sun_dir[2].expand_as(lx)
    nl = torch.where(
        n0 == tmin, -torch.sign(dx) * lx[None, :],
        torch.where(n1 == tmin, -torch.sign(dy) * ly[None, :],
                    -torch.sign(dz) * lz[None, :]),
    )
    shade = 0.45 + 0.55 * torch.clamp_min(nl, 0.0)
    return torch.where(hit, torch.clamp_min(tmin, 0.0), 1e9), shade


def _boxes(scene, veh_pose, walker_pose, tl_states):
    """(centers (B, 3), yaws (B,), extents (B, 3), colours (B, 3) u8) of
    one env's vehicles, walkers, obstacles and light heads."""
    dev = scene.device
    parts = []

    def actor(pose, extent, color, hh):
        m = pose.shape[0]
        parts.append((
            torch.cat([pose[:, :2], torch.full((m, 1), hh, device=dev)], 1),
            pose[:, 2],
            torch.tensor([extent], device=dev).expand(m, 3),
            torch.tensor([color], dtype=torch.uint8, device=dev).expand(m,
                                                                        3)))

    if veh_pose is not None and veh_pose.shape[0] > 0:
        actor(veh_pose, VEH_EXTENT, VEHICLE, VEH_HH)
    if walker_pose is not None and walker_pose.shape[0] > 0:
        actor(walker_pose, WALKER_EXTENT, WALKER, WALKER_HH)
    if scene.ob_n > 0:
        n_ob = scene.ob_pose.shape[0]
        parts.append((
            torch.cat([scene.ob_pose[:, :2],
                       torch.full((n_ob, 1), OB_HH, device=dev)], 1),
            scene.ob_pose[:, 2],
            torch.cat([scene.ob_extent,
                       torch.full((n_ob, 1), OB_HH, device=dev)], 1),
            torch.tensor([BUILDING], dtype=torch.uint8,
                         device=dev).expand(n_ob, 3)))
    if tl_states is not None and scene.tl_n > 0:
        T = scene.tl_stop.shape[0]
        parts.append((
            torch.cat([scene.tl_stop[:, 1],
                       torch.full((T, 1), TL_HEAD_Z, device=dev)], 1),
            scene.tl_yaw,
            torch.tensor([TL_HEAD_HE], device=dev).expand(T, 3),
            torch.tensor(TL_COLORS, dtype=torch.uint8, device=dev)[
                torch.clamp(tl_states.long(), 0, 2)]))
    if not parts:
        return None
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


def _render_one(scene, grid, xy, yaw, offset: float, veh_pose,
                walker_pose, tl_states, brightness, sun_altitude,
                sun_azimuth, fog_density):
    dev = xy.device
    uu, vv, below = grid["uu"], grid["vv"], grid["below"]
    depth, up = grid["depth"], grid["up"]

    cam_yaw = yaw + offset
    cc, cs = torch.cos(cam_yaw), torch.sin(cam_yaw)
    base = xy + CAM_FORWARD * torch.stack([torch.cos(yaw), torch.sin(yaw)])
    fwd = torch.stack([cc, cs])
    right = torch.stack([-cs, cc])
    # the ground pass, on the pixels below the horizon only (the sky
    # paints over the others)
    g_depth, g_uu = depth[grid["ground"]], uu[grid["ground"]]
    pts = (base[None, :] + g_depth[:, None] * fwd[None, :]
           + (g_depth * g_uu)[:, None] * right[None, :])

    # ground points beyond the cell table's reach fall outside the dmax
    # guard and paint as grass (an accepted horizon artifact). Only the
    # cell's live segments are read: its padding never draws (the BEV
    # kernels cull it the same way)
    _, _, lane_segs, lane_val, lane_w = fetch_cell(scene, xy[None])
    bnd_segs, _ = fetch_bnd_cell(scene, xy[None])
    n_bnd, n_lane = (int(n) for n in fetch_cell_counts(scene, xy[None]))
    on_road = boundary_inside(pts, bnd_segs[0, :max(n_bnd, 1)],
                              scene.bnd_dmax)
    lane_segs, lane_val = lane_segs[:, :n_lane], lane_val[:, :n_lane]
    lane_w = lane_w[:, :n_lane]
    a = lane_segs[0, None, :, :2]
    ab = lane_segs[0, None, :, 2:] - a
    ap = pts[:, None, :] - a
    t = torch.clamp(
        (ap[..., 0] * ab[..., 0] + ap[..., 1] * ab[..., 1])
        / ((ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1]) + 1e-9),
        0.0, 1.0)
    ex = ap[..., 0] - t * ab[..., 0]
    ey = ap[..., 1] - t * ab[..., 1]
    d2 = ex * ex + ey * ey
    w2 = lane_w[0] * 2
    lane_v = torch.amax(
        torch.where(d2 <= (w2 * w2)[None, :], lane_val[0, None, :], 0.0),
        dim=1) if n_lane else torch.zeros_like(g_depth)

    def color(rgb):
        return torch.tensor(rgb, dtype=torch.uint8, device=dev)

    ground = color(GROUND).expand(pts.shape[0], 3)
    ground = torch.where(on_road[:, None], color(ROAD), ground)
    ground = torch.where((lane_v == 120)[:, None], color(LANE_BROKEN),
                         ground)
    ground = torch.where((lane_v == 255)[:, None], color(LANE_SOLID), ground)
    img = grid["sky_rgb"].clone()
    img[grid["ground"]] = ground

    # sun direction (unit, toward the sun) for the box faces
    if sun_altitude is None:
        alt = torch.tensor(math.radians(75.0), device=dev)
    else:
        alt = sun_altitude * (math.pi / 180.0)
    az = (torch.zeros((), device=dev) if sun_azimuth is None
          else sun_azimuth * (math.pi / 180.0))
    sun_dir = torch.stack([torch.cos(alt) * torch.cos(az),
                           torch.cos(alt) * torch.sin(az), torch.sin(alt)])

    boxes = _boxes(scene, veh_pose, walker_pose, tl_states)
    if boxes is not None:
        centers, yaws, extents, colors = boxes
        if centers.shape[0] > MAX_BOXES:
            dist = norm2(centers[:, :2] - xy[None, :])
            keep = torch.argsort(dist, stable=True)[:MAX_BOXES]
            centers, yaws = centers[keep], yaws[keep]
            extents, colors = extents[keep], colors[keep]
        o = torch.cat([base, torch.full((1,), CAM_HEIGHT, device=dev)])
        zero = torch.zeros_like(uu)
        dirs = torch.stack([cc + uu * right[0], cs + uu * right[1],
                            zero - vv], dim=1)
        t_box, shade = _ray_boxes(o, dirs, centers, yaws, extents, sun_dir)
        t_near, b_near = torch.min(t_box, dim=1)
        t_ground = torch.where(below, depth, 1e9)
        box_vis = t_near < torch.clamp_max(t_ground, 1e8)
        box_rgb = colors[b_near].to(torch.float32) * torch.gather(
            shade, 1, b_near[:, None])
        img = torch.where(box_vis[:, None], box_rgb.to(torch.uint8), img)
        fog_dist = torch.where(box_vis, t_near,
                               torch.where(below, depth, grid["far"]))
    else:
        fog_dist = torch.where(below, depth, grid["far"])

    if fog_density is not None:
        # exponential distance fog toward the horizon tint; fog 0 is a
        # visibility of 1.5 km
        vis = torch.full_like(fog_density, 1500.0) / (1.0 + fog_density)
        fg = 1.0 - torch.exp(-fog_dist / vis)
        imgf = img.to(torch.float32)
        img = (imgf + fg[:, None] * (torch.tensor(SKY, device=dev)[None, :]
                                     - imgf)).to(torch.uint8)
    if brightness is not None:
        # the whole frame scaled by the weather's ambient factor
        img = (img.to(torch.float32)
               * torch.clamp(brightness, 0.0, 1.0)).to(torch.uint8)
    return img.reshape(CAM_H, CAM_W, 3)


def render_camera(scene, xy, yaw, cam_yaw_offset: float = 0.0,
                  veh_pose=None, walker_pose=None, tl_states=None,
                  brightness=None, sun_altitude=None, sun_azimuth=None,
                  fog_density=None):
    """(N, H, W, 3) uint8 pseudo-camera frames of N envs at poses ``xy``
    (N, 2), ``yaw`` (N,); ``cam_yaw_offset`` +-55 degrees gives the
    left/right cameras (carla_env.py:33-47).

    Optional per-env inputs: ``veh_pose`` (N, K, 3) and ``walker_pose``
    (N, W, 3) actor poses and ``tl_states`` (N, T) light phases are
    ray-traced as boxes, with the scene's obstacles; ``sun_altitude`` /
    ``sun_azimuth`` (N,) degrees steer the face shading (default: high
    noon), ``fog_density`` (N,) CARLA's 0-100 fog sets the fog's
    visibility, ``brightness`` (N,) (``weather.sun_brightness``) scales
    the frame. Envs render one at a time: the box pass holds (pixels x
    boxes) tables."""
    dev = xy.device
    grid = {k: torch.from_numpy(v).to(dev) for k, v in _pixel_grid().items()}

    def pick(x, i):
        return None if x is None else x[i]

    return torch.stack([
        _render_one(scene, grid, xy[i], yaw[i], cam_yaw_offset,
                    pick(veh_pose, i), pick(walker_pose, i),
                    pick(tl_states, i), pick(brightness, i),
                    pick(sun_altitude, i), pick(sun_azimuth, i),
                    pick(fog_density, i))
        for i in range(xy.shape[0])
    ])
