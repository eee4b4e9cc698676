"""The 6-channel BEV rasterizer as a hand-written CUDA kernel
(csrc/bev6_raster.cu).

Replaces ``gail_carla_tpu/ops/bev6_pallas.py::render_bev6_pallas_batch``
(kernel ``_kernel``). The wrapper takes the tables ``ops/bev6.py::
bev6_inputs`` gathers (as ``bev6_pallas.py:246-350`` gathers them outside
the kernel), checks what the kernel is given, allocates the output and
launches on the current stream. It never falls back: a CPU tensor
raises. The plain version in ``ops/bev6.py`` is the CPU path and the
kernel's reference.
"""
from __future__ import annotations

import ctypes

import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.cuda_build import CudaLibrary
from gail_carla_tpu_torch.ops.bev import ROUTE_HALF_W
from gail_carla_tpu_torch.ops.bev6 import BOX_COLS, Bev6Inputs, bev6_inputs
from gail_carla_tpu_torch.ops.bev_cuda import (
    MAX_ENVS, MAX_SHARED_BYTES, check_tensor,
)
from gail_carla_tpu_torch.ops.bev_full import TL_LINE_HALF_W

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
LIB = CudaLibrary(
    "bev6_raster.cu", "bev6_raster_launch",
    [_P] * 11 + [_I] * 7 + [_F] * 6 + [_P],
)


def render_bev6_cuda(cfg: EnvConfig, inp: Bev6Inputs, dmax: float):
    """(N, 6, W, W) float32 from fetched tables, by the CUDA kernel."""
    b = inp.base
    dev = b.pose.device
    n = b.pose.shape[0]
    mb = b.bnd.shape[1]
    ml = b.lane.shape[1]
    k = b.route.shape[1]
    mt = inp.tl.shape[1]
    nbox = inp.boxes.shape[1]
    w = cfg.bev_width
    check_tensor("pose", b.pose, torch.float32, (n, 4), dev)
    check_tensor("counts", inp.counts, torch.int32, (n, 3), dev)
    check_tensor("bnd", b.bnd, torch.float32, (n, mb, 4), dev)
    check_tensor("lane", b.lane, torch.float32, (n, ml, 4), dev)
    check_tensor("lane_val", b.lane_val, torch.float32, (n, ml), dev)
    check_tensor("lane_w", b.lane_w, torch.float32, (n, ml), dev)
    check_tensor("route", b.route, torch.float32, (n, k, 4), dev)
    check_tensor("tl", inp.tl, torch.float32, (n, mt, 4), dev)
    check_tensor("tl_val", inp.tl_val, torch.float32, (n, mt), dev)
    check_tensor("boxes", inp.boxes, torch.float32, (n, nbox, BOX_COLS),
                 dev)
    if n > MAX_ENVS:
        raise ValueError(f"at most {MAX_ENVS} envs per launch, got {n}")
    if 4 * (9 * mb + 8 * ml + 6 * k + 7 * mt + 7 * nbox) > MAX_SHARED_BYTES:
        raise ValueError("tables exceed the kernel's shared memory")
    out = torch.empty((n, 6, w, w), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ppm = cfg.pixels_per_meter
    with torch.cuda.device(dev):
        err = LIB.fn(
            inp.counts.data_ptr(), b.pose.data_ptr(), b.bnd.data_ptr(),
            b.lane.data_ptr(), b.lane_val.data_ptr(), b.lane_w.data_ptr(),
            b.route.data_ptr(), inp.tl.data_ptr(), inp.tl_val.data_ptr(),
            inp.boxes.data_ptr(), out.data_ptr(),
            n, mb, ml, k, mt, nbox, w,
            (w - cfg.pixels_ev_to_bottom) / ppm,   # forward offset, metres
            0.5 * w / ppm,                         # right offset, metres
            w / (w - 1.0) / ppm,                   # metres per pixel step
            dmax * dmax,
            ROUTE_HALF_W ** 2,
            TL_LINE_HALF_W ** 2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bev6_raster launch failed: cudaError {err}")
    LIB.launches += 1
    return out


def render_bev6_cuda_batch(scene, cfg: EnvConfig, render_state):
    """(N, 6, W, W) observation of a RenderState batch on the card."""
    return render_bev6_cuda(cfg, bev6_inputs(scene, cfg, render_state),
                            scene.bnd_dmax)
