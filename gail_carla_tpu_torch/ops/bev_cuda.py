"""The BEV rasterizer as a hand-written CUDA kernel (csrc/bev_raster.cu).

Replaces ``gail_carla_tpu/ops/bev_pallas.py::render_bev_pallas_batch``
(kernel ``_kernel``). The wrapper gathers each env's spatial-hash tables
with clamped tensor indexing (``ops/bev.py::bev_inputs``, as
``bev_pallas.py:210-222`` gathers them outside the kernel), checks what
the kernel is given, allocates the output and launches on the current
stream. It never falls back: a CPU tensor raises. The plain version in
``ops/bev.py`` is the CPU path and the kernel's reference.
"""
from __future__ import annotations

import ctypes

import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.cuda_build import CudaLibrary
from gail_carla_tpu_torch.ops.bev import ROUTE_HALF_W, BevInputs, bev_inputs

MAX_SHARED_BYTES = 48 * 1024   # dynamic shared memory without opt-in
MAX_ENVS = 65535               # grid.y

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
LIB = CudaLibrary(
    "bev_raster.cu", "bev_raster_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _F, _F, _F, _F, _F, _P],
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


def render_bev_cuda(cfg: EnvConfig, inp: BevInputs, dmax: float):
    """(N, 3, W, W) float32 from fetched tables, by the CUDA kernel."""
    dev = inp.pose.device
    n = inp.pose.shape[0]
    mb = inp.bnd.shape[1]
    ml = inp.lane.shape[1]
    k = inp.route.shape[1]
    w = cfg.bev_width
    check_tensor("pose", inp.pose, torch.float32, (n, 4), dev)
    check_tensor("counts", inp.counts, torch.int32, (n, 2), dev)
    check_tensor("bnd", inp.bnd, torch.float32, (n, mb, 4), dev)
    check_tensor("lane", inp.lane, torch.float32, (n, ml, 4), dev)
    check_tensor("lane_val", inp.lane_val, torch.float32, (n, ml), dev)
    check_tensor("lane_w", inp.lane_w, torch.float32, (n, ml), dev)
    check_tensor("route", inp.route, torch.float32, (n, k, 4), dev)
    if n > MAX_ENVS:
        raise ValueError(f"at most {MAX_ENVS} envs per launch, got {n}")
    if 4 * (9 * mb + 8 * ml + 6 * k) > MAX_SHARED_BYTES:
        raise ValueError("segment tables exceed the kernel's shared memory")
    out = torch.empty((n, 3, w, w), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ppm = cfg.pixels_per_meter
    with torch.cuda.device(dev):
        err = LIB.fn(
            inp.counts.data_ptr(), inp.pose.data_ptr(),
            inp.bnd.data_ptr(), inp.lane.data_ptr(),
            inp.lane_val.data_ptr(), inp.lane_w.data_ptr(),
            inp.route.data_ptr(), out.data_ptr(),
            n, mb, ml, k, w,
            (w - cfg.pixels_ev_to_bottom) / ppm,   # forward offset, metres
            0.5 * w / ppm,                         # right offset, metres
            w / (w - 1.0) / ppm,                   # metres per pixel step
            dmax * dmax,
            ROUTE_HALF_W ** 2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bev_raster launch failed: cudaError {err}")
    LIB.launches += 1
    return out


def render_bev_cuda_batch(scene, cfg: EnvConfig, render_state):
    """(N, 3, W, W) observation of a RenderState batch on the card."""
    return render_bev_cuda(cfg, bev_inputs(scene, render_state),
                           scene.bnd_dmax)
