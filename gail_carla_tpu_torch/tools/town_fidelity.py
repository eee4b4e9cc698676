"""Per-town fidelity report: the reconstructed towns against their mask
packs. Port of ``gail_carla_tpu/tools/town_fidelity.py``.

For each town with a pack this measures, against the ground-truth
textures the reference's own BEV renderer samples (chauffeurnet.py:72-85,
142-153):

- lane-graph on-road fraction: edge points with positive signed distance to
  the pack's ``road`` boundary after ``repair_graph_to_mask``;
- dense benchmark-route on-road fraction (first 3 routes of the town's
  benchmark pack, ``repair_dense_route`` applied);
- traffic-light stop-line placement: max distance any synthesized stop-line
  centre sits off the road mask;
- BEV IoU: the port's own render (B1 on the card, its plain version on the
  CPU) road/lane channels vs a host-side warp of the pack's ``road`` /
  ``lane_marking_all`` textures at sampled route poses.

The scene work is host numpy; the renders run on ``--device`` (the card
unless ``--device cpu``). Packs are read through ``scene/h5_maps.py``.

Usage:  python -m gail_carla_tpu_torch.tools.town_fidelity
        [--towns Town01 ...] [--out report.md] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# the shipped data file that actually carries each town's benchmark pack
# (Town02/Town05 routes live only in routes_testing.xml)
ROUTE_FILE = {
    "Town02": "routes_testing.xml",
    "Town05": "routes_testing.xml",
}


def _pose_state(scene, rid: int, head: int):
    """The RenderState of one ego on route ``rid`` at point ``head``."""
    from gail_carla_tpu_torch.sim.env import RenderState

    dev = scene.device
    i = torch.zeros(1, dtype=torch.int32, device=dev)
    return RenderState(
        xy=scene.route_xy[rid, head][None], yaw=scene.route_yaw[rid, head][None],
        route_id=i + rid, head=i + head, step=i, stop_idx=i - 1,
        npc_pose=torch.zeros((1, 0, 3), device=dev),
        walker_pose=torch.zeros((1, 0, 3), device=dev),
    )


def town_report(town: str, n_routes: int = 3, device="cuda"):
    from gail_carla_tpu_torch.config import EnvConfig
    from gail_carla_tpu_torch.ops.bev import (
        pixel_world_coords, render_bev_batch_auto,
    )
    from gail_carla_tpu_torch.scene import mask_geo
    from gail_carla_tpu_torch.scene.h5_maps import (
        PPM, load_town_geometry, read_pack,
    )
    from gail_carla_tpu_torch.scene.town_import import (
        benchmark_routes, build_town_graph, collect_town_routes,
        densify_route, make_town_scene, repair_dense_route,
        repair_graph_to_mask,
    )

    geo = load_town_geometry(town)
    graph = repair_graph_to_mask(
        build_town_graph(collect_town_routes(town)), geo
    )
    pts = np.concatenate([e.pts for e in graph.edges], axis=0)
    graph_on = float(
        (mask_geo.boundary_signed_distance(geo.bnd_ab, pts) > 0).mean()
    )

    route_on = []
    route_file = ROUTE_FILE.get(town, "routes_training.xml")
    for r in benchmark_routes(town, route_file)[:n_routes]:
        d = repair_dense_route(densify_route(r.waypoints), geo)
        sd = mask_geo.boundary_signed_distance(geo.bnd_ab, d.xy)
        route_on.append(float((sd > 0).mean()))

    stop_off = 0.0
    for t in graph.traffic_lights:
        c = 0.5 * (t.stop_a + t.stop_b)
        sd = mask_geo.boundary_signed_distance(geo.bnd_ab, c[None, :])
        stop_off = max(stop_off, float(-sd[0]))

    sc = make_town_scene(town, route_file, device=device)
    cfg = EnvConfig()
    pack = read_pack(town, ("road", "lane_marking_all"))
    off = pack.world_offset
    road_tex, lane_tex = pack["road"], pack["lane_marking_all"]

    def host_warp(tex, xy, yaw):
        px = pixel_world_coords(
            cfg, torch.tensor([xy], dtype=torch.float32),
            torch.cos(torch.tensor([yaw], dtype=torch.float32)),
            torch.sin(torch.tensor([yaw], dtype=torch.float32)),
        )[0].numpy().astype(np.float64)
        sx = np.round((px[:, 0] - off[0]) * PPM).astype(int)
        sy = np.round((px[:, 1] - off[1]) * PPM).astype(int)
        ok = (
            (sx >= 0) & (sx < tex.shape[1])
            & (sy >= 0) & (sy < tex.shape[0])
        )
        out = np.zeros(px.shape[0], tex.dtype)
        out[ok] = tex[sy[ok], sx[ok]]
        return out.reshape(cfg.bev_width, cfg.bev_width)

    road_ious, lane_ious = [], []
    route_n = sc.route_n.cpu().numpy()
    for rid in range(min(n_routes, int(sc.n_routes))):
        n = int(route_n[rid])
        for h in (30, min(300, n - 10)):
            rs = _pose_state(sc, rid, h)
            xy = rs.xy[0].cpu().numpy().tolist()
            yaw = float(rs.yaw[0])
            img = render_bev_batch_auto(sc, cfg, rs)[0].cpu().numpy()
            ref = host_warp(road_tex, xy, yaw) > 0
            ours = img[0] > 0.5
            road_ious.append(
                (ref & ours).sum() / max((ref | ours).sum(), 1)
            )
            ref_l = host_warp(lane_tex, xy, yaw) > 0
            ours_l = img[2] > 0
            lane_ious.append(
                (ref_l & ours_l).sum() / max((ref_l | ours_l).sum(), 1)
            )

    return {
        "town": town,
        "graph_on_road": graph_on,
        "route_on_road_min": min(route_on),
        "n_traffic_lights": len(graph.traffic_lights),
        "stopline_max_off_road_m": stop_off,
        "bev_road_iou_mean": float(np.mean(road_ious)),
        "bev_road_iou_min": float(np.min(road_ious)),
        "bev_lane_iou_mean": float(np.mean(lane_ious)),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--towns", nargs="*", default=None)
    p.add_argument("--out", default=None,
                   help="also append a markdown table to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the renders (default: the card)")
    args = p.parse_args(argv)

    from gail_carla_tpu_torch.device import resolve_device
    from gail_carla_tpu_torch.scene.h5_maps import available_towns

    dev = resolve_device(args.device)
    towns = args.towns or available_towns()
    rows = []
    for t in towns:
        r = town_report(t, device=dev)
        rows.append(r)
        print({k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in r.items()}, flush=True)

    if args.out:
        hdr = ("| town | graph on-road | route on-road (min) | lights | "
               "stopline max off-road (m) | BEV road IoU mean/min | "
               "BEV lane IoU |\n|---|---|---|---|---|---|---|\n")
        lines = "".join(
            f"| {r['town']} | {r['graph_on_road']:.4f} | "
            f"{r['route_on_road_min']:.4f} | {r['n_traffic_lights']} | "
            f"{r['stopline_max_off_road_m']:.2f} | "
            f"{r['bev_road_iou_mean']:.4f}/{r['bev_road_iou_min']:.4f} | "
            f"{r['bev_lane_iou_mean']:.4f} |\n"
            for r in rows
        )
        with open(args.out, "a") as f:
            f.write(hdr + lines)
        print(f"wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
