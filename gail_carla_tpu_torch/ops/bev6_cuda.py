"""The 6-channel BEV rasterizer as a hand-written CUDA kernel
(csrc/bev6_raster.cu).

Replaces ``gail_carla_tpu/ops/bev6_pallas.py::render_bev6_pallas_batch``
(kernel ``_kernel``). The kernel fetches each env's tables itself, as
``ops/bev_cuda.py``'s does, plus the cell's culled stop lines, the active
stop sign's row and the NPC and walker poses. Two things stay in PyTorch,
so that they are the very ops the plain version runs: the light values
(``ops/bev6.py::light_values``, sim logic) and cos and sin of every yaw
(ego, stop signs, vehicles, walkers), taken once over the concatenated
yaws (``bev6_prologue``). The wrapper checks every tensor, allocates the
output and launches on the current stream. It never falls back: a CPU
tensor raises. The plain version, ``ops/bev6.py::render_bev6_plain`` on
``bev6_inputs``, is the CPU path and the kernel's reference.
"""
from __future__ import annotations

import ctypes

import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.cuda_build import CudaLibrary
from gail_carla_tpu_torch.ops.bev import ROUTE_STRIDE, ROUTE_WINDOW
from gail_carla_tpu_torch.ops.bev6 import light_values
from gail_carla_tpu_torch.ops.bev_cuda import (
    base_args, check_tensor, launch, smem_bytes,
)
from gail_carla_tpu_torch.ops.bev_full import TL_LINE_HALF_W, WALKER_HALF
from gail_carla_tpu_torch.sim.dynamics import DEFAULT_VEHICLE

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
LIB = CudaLibrary(
    "bev6_raster.cu", "bev6_raster_launch",
    [_P] * 23 + [_I] * 17 + [_F] * 15 + [_P],
)


def _route_capsules() -> int:
    return len(range(0, ROUTE_WINDOW, ROUTE_STRIDE)) - 1


def shared_bytes(scene, n_vehicles: int, n_walkers: int) -> int:
    """Dynamic shared memory of one B2 block for ``scene`` and these actor
    counts (``smem_bytes`` of ``csrc/bev_raster_common.cuh``): each staged
    item's coefficients as floats (9 per boundary edge, 8 per lane or
    route capsule and stop line, 6 per box: the ego, the vehicles and the
    walkers) and each of the block's 8 warps' survivor lists as 16-bit
    indices. Up to 48 KB a launch needs no opt-in; past that the launch
    raises the kernel's limit (``cudaFuncAttributeMaxDynamicSharedMemory
    Size``) to these bytes, up to the card's opt-in limit per block (227 KB
    on H100), and past that limit the wrapper raises, naming the table
    maxima. Pixels do not depend on it."""
    return smem_bytes(scene.cell_bnd.shape[2], scene.cell_lane.shape[2],
                      _route_capsules(), scene.cell_tl.shape[2],
                      1 + n_vehicles + n_walkers)


def shared_bytes_bev(scene) -> int:
    """B1's counterpart of ``shared_bytes``: one block stages the cell's
    boundary edges, lane capsules and the route window's capsules (the
    same rule for the limit)."""
    return smem_bytes(scene.cell_bnd.shape[2], scene.cell_lane.shape[2],
                      _route_capsules())


def bev6_prologue(scene, cfg: EnvConfig, render_state):
    """(cos, sin, light): cos and sin of the ego (N), stop-sign (S),
    vehicle (N*K) and walker (N*Wk) yaws, concatenated in that order, and
    the (N, T) light values at each env's sim time."""
    rs = render_state
    yaws = torch.cat([rs.yaw, scene.ss_yaw, rs.npc_pose[..., 2].reshape(-1),
                      rs.walker_pose[..., 2].reshape(-1)])
    return (torch.cos(yaws), torch.sin(yaws),
            light_values(scene, cfg, rs.step))


def render_bev6_cuda(scene, cfg: EnvConfig, render_state, cos_yaw, sin_yaw,
                     light) -> torch.Tensor:
    """(N, 6, W, W) float32 by the CUDA kernel alone, given what
    ``bev6_prologue`` returns."""
    rs = render_state
    ptrs, ints, floats, dev = base_args(scene, cfg, rs, cos_yaw, sin_yaw)
    n, w = ints[0], cfg.bev_width
    gy, gx = scene.cell_road.shape[:2]
    mt = scene.cell_tl.shape[2]
    t = scene.tl_stop.shape[0]
    s = scene.ss_center.shape[0]
    k, wk = rs.npc_pose.shape[1], rs.walker_pose.shape[1]
    i32, f32 = torch.int32, torch.float32
    tensors = (
        ("cell_tl", scene.cell_tl, f32, (gy, gx, mt, 4)),
        ("cell_tl_idx", scene.cell_tl_idx, i32, (gy, gx, mt)),
        ("cell_tl_n", scene.cell_tl_n, i32, (gy, gx)),
        ("light", light, f32, (n, t)),
        ("stop_idx", rs.stop_idx, i32, (n,)),
        ("ss_center", scene.ss_center, f32, (s, 2)),
        ("ss_extent", scene.ss_extent, f32, (s, 2)),
        ("npc_pose", rs.npc_pose, f32, (n, k, 3)),
        ("walker_pose", rs.walker_pose, f32, (n, wk, 3)),
    )
    for name, x, dtype, shape in tensors:
        check_tensor(name, x, dtype, shape, dev)
    if cos_yaw.shape[0] != n + s + n * (k + wk):
        raise ValueError("cos_yaw/sin_yaw must hold the ego, stop-sign, "
                         "vehicle and walker yaws (bev6_prologue)")
    out = torch.empty((n, 6, w, w), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    mb, ml, rk = ints[3], ints[4], ints[9]
    launch(LIB, ptrs + [x.data_ptr() for _, x, _, _ in tensors]
           + [out.data_ptr()] + ints + [mt, t, s, k, wk] + floats
           + [TL_LINE_HALF_W ** 2, TL_LINE_HALF_W,
              DEFAULT_VEHICLE.half_length, DEFAULT_VEHICLE.half_width,
              WALKER_HALF[0], WALKER_HALF[1]], dev,
           f"Mb={mb} boundary edges, Ml={ml} lane capsules, {rk} route "
           f"capsules, Mt={mt} stop lines, {1 + k + wk} boxes: "
           f"{smem_bytes(mb, ml, rk, mt, 1 + k + wk)} bytes")
    return out


def render_bev6_cuda_batch(scene, cfg: EnvConfig, render_state):
    """(N, 6, W, W) observation of a RenderState batch on the card."""
    return render_bev6_cuda(scene, cfg, render_state,
                            *bev6_prologue(scene, cfg, render_state))
