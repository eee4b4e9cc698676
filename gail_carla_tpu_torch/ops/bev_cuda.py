"""The BEV rasterizer as a hand-written CUDA kernel (csrc/bev_raster.cu).

Replaces ``gail_carla_tpu/ops/bev_pallas.py::render_bev_pallas_batch``
(kernel ``_kernel``). The kernel fetches each env's tables itself: the
ego cell's boundary and lane rows and the route window, straight from the
scene. The wrapper takes cos and sin of the ego yaws in PyTorch (the ops
the plain version runs), checks every tensor the kernel reads, allocates
the output and launches on the current stream. It never falls back: a CPU
tensor raises. The plain version, ``ops/bev.py::render_bev_plain`` on
``bev_inputs``, is the CPU path and the kernel's reference.
"""
from __future__ import annotations

import ctypes
import math

import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.cuda_build import CudaLibrary
from gail_carla_tpu_torch.ops import bev_tiles
from gail_carla_tpu_torch.ops.bev import (
    ROUTE_HALF_W, ROUTE_STRIDE, ROUTE_WINDOW,
)

MAX_ENVS = 65535               # grid.y

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
LIB = CudaLibrary(
    "bev_raster.cu", "bev_raster_launch",
    [_P] * 14 + [_I] * 12 + [_F] * 9 + [_P],
)


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def base_args(scene, cfg: EnvConfig, render_state, cos_yaw, sin_yaw):
    """Checks what the road, route and lane part of a kernel reads and
    returns (pointers, ints, floats) of the launch, in the order of the C
    entry points (the tile height, pad and reaches from ``ops/bev_tiles``),
    and the device. ``cos_yaw``/``sin_yaw`` start with the N ego yaws."""
    rs = render_state
    dev = rs.xy.device
    n = rs.xy.shape[0]
    gy, gx = scene.cell_road.shape[:2]
    mb = scene.cell_bnd.shape[2]
    ml = scene.cell_lane.shape[2]
    n_routes, route_len = scene.route_xy.shape[:2]
    k = len(range(0, ROUTE_WINDOW, ROUTE_STRIDE)) - 1
    cell = float(scene.cell_size)
    if cell <= 0.0 or math.frexp(cell)[0] != 0.5:
        # the card's _cell_of multiplies by the float32 reciprocal of the
        # cell size; only for a power of two is that the division
        raise ValueError(f"cell_size {cell} is not a power of two")
    if route_len < ROUTE_WINDOW:
        raise ValueError(f"routes of {route_len} points are shorter than "
                         f"the route window ({ROUTE_WINDOW})")
    if n > MAX_ENVS:
        raise ValueError(f"at most {MAX_ENVS} envs per launch, got {n}")
    i32, f32 = torch.int32, torch.float32
    tensors = (
        ("xy", rs.xy, f32, (n, 2)),
        ("cos_yaw", cos_yaw, f32, (cos_yaw.shape[0],)),
        ("sin_yaw", sin_yaw, f32, cos_yaw.shape),
        ("route_id", rs.route_id, i32, (n,)),
        ("head", rs.head, i32, (n,)),
        ("cell_grid_lo", scene.cell_grid_lo, f32, (2,)),
        ("cell_bnd", scene.cell_bnd, f32, (gy, gx, mb, 4)),
        ("cell_bnd_n", scene.cell_bnd_n, i32, (gy, gx)),
        ("cell_lane", scene.cell_lane, f32, (gy, gx, ml, 4)),
        ("cell_lane_val", scene.cell_lane_val, f32, (gy, gx, ml)),
        ("cell_lane_w", scene.cell_lane_w, f32, (gy, gx, ml)),
        ("cell_lane_n", scene.cell_lane_n, i32, (gy, gx)),
        ("route_xy", scene.route_xy, f32, (n_routes, route_len, 2)),
    )
    for name, t, dtype, shape in tensors:
        check_tensor(name, t, dtype, shape, dev)
    if cos_yaw.shape[0] < n:
        raise ValueError("cos_yaw/sin_yaw must start with the N ego yaws")
    fwd_off, right_off, scale = bev_tiles.view_params(cfg)
    dmax = scene.bnd_dmax
    ptrs = [t.data_ptr() for _, t, _, _ in tensors]
    ints = [n, gx, gy, mb, ml, n_routes, route_len, ROUTE_WINDOW,
            ROUTE_STRIDE, k, cfg.bev_width, bev_tiles.TILE_ROWS]
    floats = [1.0 / cell, fwd_off, right_off, scale, dmax * dmax,
              ROUTE_HALF_W ** 2, bev_tiles.road_reach(dmax), ROUTE_HALF_W,
              bev_tiles.tile_pad(cfg)]
    return ptrs, ints, floats, dev


def launch(lib: CudaLibrary, args, dev):
    """Calls ``lib``'s entry point on the current stream of ``dev``;
    raises on a nonzero cudaError, else counts the launch."""
    with torch.cuda.device(dev):
        err = lib.fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{lib.entry} failed: cudaError {err}")
    lib.launches += 1


def render_bev_cuda(scene, cfg: EnvConfig, render_state, cos_yaw,
                    sin_yaw) -> torch.Tensor:
    """(N, 3, W, W) float32 by the CUDA kernel alone, given cos and sin of
    the ego yaws (N,)."""
    ptrs, ints, floats, dev = base_args(scene, cfg, render_state, cos_yaw,
                                        sin_yaw)
    n, w = ints[0], cfg.bev_width
    out = torch.empty((n, 3, w, w), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    launch(LIB, ptrs + [out.data_ptr()] + ints + floats, dev)
    return out


def render_bev_cuda_batch(scene, cfg: EnvConfig, render_state):
    """(N, 3, W, W) observation of a RenderState batch on the card."""
    yaw = render_state.yaw
    return render_bev_cuda(scene, cfg, render_state, torch.cos(yaw),
                           torch.sin(yaw))
