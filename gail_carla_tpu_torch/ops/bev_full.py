"""Helpers of the full-parity BEV that the 6-channel observation shares.

Port of the parts of ``gail_carla_tpu/ops/bev_full.py`` that
``ops/bev6.py`` uses: the point-in-oriented-box test and the stroke and
box sizes (its ``capsule_min_dist2_per_seg`` is ``ops/bev.py::
capsule_dist2_all``). The 15-channel mask stack (``render_bev_full``) and
its history ring are not ported.
"""
from __future__ import annotations

import torch

WALKER_HALF = (0.8, 0.8)  # chauffeurnet.py:266-269 min bbox after scaling
TL_LINE_HALF_W = 0.6      # 6 px stroke at 5 px/m (chauffeurnet.py:237)


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
