# Frozen copy of gail_carla_tpu_torch/sim/traffic.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""Background traffic: NPC vehicles and walkers, batched over envs.

Port of ``gail_carla_tpu/sim/traffic.py`` (zombie_vehicle_handler.py:
8-83 and zombie_walker_handler.py:7-98 of the reference):

- vehicles drive pre-compiled random lane-graph patrols
  (``scene.patrol_*``) with the LocalPlanner/PID stack, brake for a lead
  vehicle and for red lights, and teleport back to the patrol start when
  it runs out;
- the last ``cfg.n_scenario_actors`` vehicle slots are the task's
  scripted scenario actors (scenario_actor_handler.py:15-37): each drives
  its ego route's polyline (``scene.sa_patrol``) at its task speed,
  blind to lead vehicles and lights, and parks at the polyline's end;
  slots the route does not use park far away;
- walkers follow sidewalks. A reconstructed town's scene carries real
  sidewalk centrelines (skeletons of the H5 ``sidewalk`` layer,
  ``scene.walk_*``): each walker follows one at offset 0, and a crossing
  lerps the offset to ``scene.walk_cross[path]``, the signed lateral
  displacement across the adjacent road (and back). Procedural towns
  have no sidewalk masks: the walker follows a vehicle patrol polyline
  on the pavement band just off the road edge (``half_lane +
  SIDEWALK_OFFSET`` to the right, past the oncoming lane to the left),
  and a crossing flips the band's sign. The offset lerps over at walking
  speed.

Randomness is injected: ``reset_traffic`` takes a ``TrafficResetDraws``
and ``step_traffic`` the walkers' crossing coin, each drawn from a
``torch.Generator`` when not given; the scenario slots take no draw.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from bench_port.plain_reference.frozen.agents.autopilot import local_planner_act
from bench_port.plain_reference.frozen.agents.controllers import make_autopilot
from bench_port.plain_reference.frozen.config import EnvConfig
from bench_port.plain_reference.frozen.sim import signals
from bench_port.plain_reference.frozen.sim.cursor import take_window
from bench_port.plain_reference.frozen.sim.dynamics import (
    VehicleParams, VehicleState, step_vehicle,
)
from bench_port.plain_reference.frozen.sim.state import (
    TrafficState, make_empty_traffic, tree_select,
)
from bench_port.plain_reference.frozen.sim.transforms import (
    cast_angle, deg2rad_f32, norm2, vec_global_to_ref,
)

NPC_PARAMS = VehicleParams()  # same vehicle class as the ego

# Sidewalk band centre, metres beyond the lane half-width.
SIDEWALK_OFFSET = 1.2
# Mean seconds between road crossings per walker.
CROSS_EVERY_S = 40.0
# Spawn candidates (patrol, head) per vehicle; the first >= 10 m from the
# ego wins, ties broken by a small jitter.
N_CANDIDATES = 4
# Where an unused scenario slot j parks: (PARK + PARK_STEP * j) on both axes.
PARK, PARK_STEP = 1.0e6, 10.0


class TrafficResetDraws(NamedTuple):
    """The random numbers of one traffic reset, N envs, K random vehicles
    (``cfg.n_npc_vehicles``; the scenario slots take none) with C = 4
    spawn candidates each, W walkers."""

    veh_pat: torch.Tensor       # (N, K, C) int patrol id in [0, P)
    veh_frac: torch.Tensor      # (N, K, C) uniform [0, 1) head fraction
    veh_jitter: torch.Tensor    # (N, K, C) uniform [0, 1) pick tie-break
    veh_speed: torch.Tensor     # (N, K) target speed in [4.5, 6.5) m/s
    walker_pat: torch.Tensor    # (N, W) int polyline id in [0, Pw)
    walker_frac: torch.Tensor   # (N, W) uniform [0, 1) head fraction
    walker_side: torch.Tensor   # (N, W) uniform [0, 1): < 0.5 kerbside
    #                             (unused on sidewalk paths)
    walker_speed: torch.Tensor  # (N, W) speed in [1, 2) m/s


def _walker_arrays(scene):
    """(polyline_xy, polyline_n, on_sidewalk): the real sidewalk
    centrelines when the scene has them (reconstructed towns), else the
    vehicle patrol polylines (procedural towns use pavement bands)."""
    if scene.walk_xy is not None:
        return scene.walk_xy, scene.walk_n, True
    return scene.patrol_xy, scene.patrol_n, False


def draw_traffic_reset(scene, cfg: EnvConfig, n: int,
                       generator: Optional[torch.Generator]):
    """The draws of one traffic reset of n envs, on the scene's device."""
    dev = scene.device
    K, W, C = cfg.n_npc_vehicles, cfg.n_npc_walkers, N_CANDIDATES
    P = scene.patrol_xy.shape[0]
    Pw = _walker_arrays(scene)[0].shape[0]

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def pat(rows, *shape):
        return torch.randint(0, rows, shape, generator=generator,
                             device=dev, dtype=torch.int32)

    return TrafficResetDraws(
        veh_pat=pat(P, n, K, C), veh_frac=u(n, K, C),
        veh_jitter=u(n, K, C), veh_speed=4.5 + 2.0 * u(n, K),
        walker_pat=pat(Pw, n, W), walker_frac=u(n, W), walker_side=u(n, W),
        walker_speed=1.0 + u(n, W),
    )


def draw_cross(n: int, n_walkers: int, device,
               generator: Optional[torch.Generator]):
    """The walkers' crossing coin of one step, uniform (N, W)."""
    return torch.rand((n, n_walkers), generator=generator, device=device)


def _rows(table, pat, head, size: int):
    """``table[pat, head:head+size]`` for every index of ``pat``/``head``
    (any shape), the window clamped into the row like ``dynamic_slice``."""
    win = take_window(table, pat.reshape(-1), head.reshape(-1), size)
    return win.reshape(pat.shape + win.shape[1:])


def _unit_normal(c0, c1):
    """Unit tangent of c0 -> c1 (with a 1e-6 guard) and its left normal."""
    seg = c1 - c0
    tang = seg / (norm2(seg)[..., None] + 1e-6)
    normal = torch.stack([-tang[..., 1], tang[..., 0]], dim=-1)
    return tang, normal


def _bands(scene):
    """(kerbside, far side) pavement offsets, metres (right-hand traffic:
    the kerbside pavement is to the right, +normal, of the lane)."""
    near = scene.half_lane + SIDEWALK_OFFSET
    far = -(3.0 * scene.half_lane + SIDEWALK_OFFSET)
    return near, far


def _scenario_slots(scene, n_slots: int, route_id: torch.Tensor):
    """(xy, yaw, patrol, target speed) of the A = ``n_slots`` scenario
    slots of each env, (N, A, ...): slot j takes its route's
    ``sa_patrol[route, j]`` polyline at its start and task speed; a slot
    without one parks at ``PARK + PARK_STEP * j`` with speed 0 on patrol
    row 0."""
    dev = route_id.device
    width = scene.sa_patrol.shape[1]
    j = torch.arange(n_slots, device=dev)
    jc = j.clamp_max(width - 1)
    rid = route_id.long()[:, None]
    row = torch.where(j < width, scene.sa_patrol[rid, jc], -1)    # (N, A)
    active = row >= 0
    row_safe = row.clamp_min(0)
    park = (PARK + PARK_STEP * j.to(torch.float32))[:, None]       # (A, 1)
    xy = torch.where(active[..., None],
                     scene.patrol_xy[row_safe.long(), 0], park)
    yaw = torch.where(active, scene.patrol_yaw[row_safe.long(), 0], 0.0)
    speed = torch.where(active, scene.sa_speed[rid, jc], 0.0)
    return xy, yaw, row_safe.to(torch.int32), speed


def reset_traffic(scene, cfg: EnvConfig, ego_xy: torch.Tensor,
                  draws: Optional[TrafficResetDraws] = None,
                  generator: Optional[torch.Generator] = None,
                  route_id: Optional[torch.Tensor] = None
                  ) -> TrafficState:
    """Spawn K vehicles per env on random patrol points >= 10 m from the
    ego (zombie_vehicle_handler.py:30-40), then the A scenario slots of
    the env's ego route (``route_id`` (N,), route 0 when not given), and W
    walkers at random points of the sidewalk paths (offset 0) or of the
    patrols (on a random pavement band), with random speeds."""
    n = ego_xy.shape[0]
    K, W = cfg.n_npc_vehicles, cfg.n_npc_walkers
    A = cfg.n_scenario_actors
    dev = ego_xy.device
    t = make_empty_traffic(n, K + A, W, dev)
    if K + A == 0 and W == 0:
        return t
    if draws is None and (K or W):
        draws = draw_traffic_reset(scene, cfg, n, generator)

    xy, yaw, patrol, head, target = [], [], [], [], []
    if K > 0:
        pat = draws.veh_pat
        pn = scene.patrol_n[pat.long()]
        # float -> int32 truncates toward zero, also for rows < 80 points
        h = (draws.veh_frac * (pn.to(torch.float32) - 80.0)).to(torch.int32)
        heads = torch.minimum(h.clamp_min(0), pn - 2)
        pos = _rows(scene.patrol_xy, pat, heads, 1)[..., 0, :]  # (N,K,C,2)
        dist_ego = norm2(pos - ego_xy[:, None, None, :])
        ok = dist_ego >= 10.0
        pick = torch.argmax(
            ok.to(torch.float32) + draws.veh_jitter * 0.1, dim=2
        )[..., None]                                            # (N,K,1)
        k_patrol = torch.gather(pat, 2, pick)[..., 0]
        k_head = torch.gather(heads, 2, pick)[..., 0]
        xy.append(torch.gather(pos, 2, pick[..., None].expand(n, K, 1, 2))[
            ..., 0, :])
        yaw.append(_rows(scene.patrol_yaw, k_patrol, k_head, 1)[..., 0])
        patrol.append(k_patrol.to(torch.int32))
        head.append(k_head.to(torch.int32))
        target.append(draws.veh_speed)
    if A > 0:
        if route_id is None:
            route_id = torch.zeros(n, dtype=torch.int32, device=dev)
        sa_xy, sa_yaw, sa_patrol, sa_speed = _scenario_slots(scene, A,
                                                             route_id)
        xy.append(sa_xy)
        yaw.append(sa_yaw)
        patrol.append(sa_patrol)
        head.append(torch.zeros_like(sa_patrol))
        target.append(sa_speed)
    if K + A > 0:
        veh_yaw = torch.cat(yaw, dim=1)
        t.veh = VehicleState(xy=torch.cat(xy, dim=1), yaw=veh_yaw,
                             speed=torch.zeros_like(veh_yaw))
        t.veh_patrol = torch.cat(patrol, dim=1)
        t.veh_head = torch.cat(head, dim=1)
        t.veh_target_speed = torch.cat(target, dim=1)

    if W > 0:
        wxy, wn, on_sidewalk = _walker_arrays(scene)
        pat = draws.walker_pat
        pn = wn[pat.long()]
        head = torch.minimum(
            (draws.walker_frac * (pn.to(torch.float32) - 2.0)).to(
                torch.int32).clamp_min(0),
            pn - 2,
        )
        win = _rows(wxy, pat, head, 2)
        tang, normal = _unit_normal(win[..., 0, :], win[..., 1, :])
        if on_sidewalk:
            # real pavement centrelines: walk them at offset 0
            off = torch.zeros_like(draws.walker_side)
        else:
            near, far = _bands(scene)
            off = torch.where(draws.walker_side < 0.5, near, far)
        t.walker_xy = win[..., 0, :] + off[..., None] * normal
        t.walker_yaw = torch.atan2(tang[..., 1], tang[..., 0])
        t.walker_patrol = pat.to(torch.int32)
        t.walker_head = head.to(torch.int32)
        t.walker_off = off
        t.walker_off_t = off
        t.walker_speed = draws.walker_speed
    return t


def _advance_patrol(scene, patrol, head, xy, window: int = 6):
    """The ego route cursor's forward walk (task_vehicle.py:103-128) over
    the patrol arrays."""
    win = _rows(scene.patrol_xy, patrol, head, window + 1)
    p0, p1 = win[..., :-1, :], win[..., 1:, :]
    d = p1 - p0
    r = xy[..., None, :] - p0
    dot = d[..., 0] * r[..., 0] + d[..., 1] * r[..., 1]
    offs = torch.arange(window, device=head.device)
    pn = scene.patrol_n[patrol.long()]
    valid = (head[..., None] + offs) < (pn[..., None] - 1)
    adv = torch.where((dot > 0) & valid, offs + 1, 0).amax(dim=-1)
    return torch.minimum(head + adv, pn - 1)


def _desired_speed_cap(scene, traffic: TrafficState, ego: VehicleState,
                       tl_states):
    """(N, K) speed cap of each vehicle: a ramp behind the nearest
    same-heading vehicle (other NPCs and the ego) within 12 m in a 45 deg
    cone, and before a red or yellow light within 18 m."""
    n, K = traffic.veh_patrol.shape
    veh = traffic.veh
    all_xy = torch.cat([veh.xy, ego.xy[:, None, :]], dim=1)      # (N,K+1,2)
    all_yaw = torch.cat([veh.yaw, ego.yaw[:, None]], dim=1)
    rel = all_xy[:, None, :, :] - veh.xy[:, :, None, :]          # (N,K,K+1,2)
    local = vec_global_to_ref(rel, veh.yaw[:, :, None])
    dist = norm2(local)
    angle = torch.abs(torch.atan2(local[..., 1], local[..., 0]))
    same = torch.abs(cast_angle(all_yaw[:, None, :] - veh.yaw[:, :, None])
                     ) <= deg2rad_f32(150.0)
    idx = torch.arange(K + 1, device=dist.device)
    notme = idx[None, :] != idx[:K, None]                         # (K,K+1)
    hazard = notme & same & (angle < deg2rad_f32(45.0)) & (dist < 12.0)
    d_lead = torch.where(hazard, dist, 1e9).amin(dim=-1)
    spd_lead = torch.where(
        d_lead < 1e9,
        6.0 * torch.clamp(torch.clamp_min(d_lead - 8.0, 0.0), 0, 5) / 5.0,
        1e9,
    )
    state, loc, _ = signals.affecting_light(
        scene, veh.xy.reshape(n * K, 2), veh.yaw.reshape(n * K),
        tl_states.repeat_interleave(K, dim=0),
        offset=-0.8 * NPC_PARAMS.half_length, dist_threshold=18.0,
    )
    red = ((state == signals.RED) | (state == signals.YELLOW)).reshape(n, K)
    d_rl = norm2(loc).reshape(n, K)
    spd_rl = torch.where(
        red, 6.0 * torch.clamp(torch.clamp_min(d_rl - 5.0, 0.0), 0, 5) / 5.0,
        1e9,
    )
    return torch.minimum(spd_lead, spd_rl)


def _step_vehicles(scene, cfg: EnvConfig, traffic: TrafficState,
                   ego: VehicleState, sim_time) -> TrafficState:
    """The vehicles' tick. The last ``cfg.n_scenario_actors`` slots drive
    blind (no lead-vehicle or red-light cap: constant_speed_agent.py:5-29,
    basic_agent.py:32) and stop at their polyline's end, where their
    target speed latches to 0, instead of teleporting back."""
    n, K = traffic.veh_patrol.shape
    is_scenario = torch.arange(K, device=sim_time.device) >= (
        K - cfg.n_scenario_actors)
    tl_states = signals.light_states(scene, sim_time)
    cap = _desired_speed_cap(scene, traffic, ego, tl_states)
    target = torch.where(is_scenario, traffic.veh_target_speed,
                         torch.minimum(traffic.veh_target_speed, cap))
    ap, action = local_planner_act(
        scene.patrol_xy, scene.patrol_cmd, traffic.veh_ap, traffic.veh.xy,
        traffic.veh.yaw, traffic.veh.speed, traffic.veh_patrol,
        traffic.veh_head, target,
    )
    veh = step_vehicle(traffic.veh, action[..., 0], action[..., 1],
                       torch.zeros_like(target), cfg.dt, NPC_PARAMS)
    head = _advance_patrol(scene, traffic.veh_patrol, traffic.veh_head,
                           veh.xy)

    # patrol exhausted -> teleport back to its start (zombie_vehicle.py);
    # scenario actors stop at their route's end
    pn = scene.patrol_n[traffic.veh_patrol.long()]
    at_end = head >= torch.where(is_scenario, pn - 2, pn - 8)
    teleport = at_end & ~is_scenario
    zero = torch.zeros_like(head)
    start_xy = _rows(scene.patrol_xy, traffic.veh_patrol, zero, 1)[..., 0, :]
    start_yaw = _rows(scene.patrol_yaw, traffic.veh_patrol, zero, 1)[..., 0]
    veh = VehicleState(
        xy=torch.where(teleport[..., None], start_xy, veh.xy),
        yaw=torch.where(teleport, start_yaw, veh.yaw),
        speed=torch.where(at_end, 0.0, veh.speed),
    )
    ap = tree_select(teleport, make_autopilot((n, K), head.device), ap)
    return dataclasses.replace(
        traffic, veh=veh, veh_ap=ap,
        veh_head=torch.where(teleport, 0, head).to(torch.int32),
        # ended scenario actors park for the rest of the episode
        veh_target_speed=torch.where(at_end & is_scenario, 0.0,
                                     traffic.veh_target_speed),
    )


def _step_walkers(scene, cfg: EnvConfig, traffic: TrafficState,
                  cross_coin) -> TrafficState:
    wxy, wn, on_sidewalk = _walker_arrays(scene)
    win = _rows(wxy, traffic.walker_patrol, traffic.walker_head, 2)
    c1 = win[..., 1, :]
    _, normal = _unit_normal(win[..., 0, :], c1)

    # a crossing toggles the target between the kerbside pavement and the
    # one across the road (the walker is on the road only while crossing)
    flip = cross_coin < cfg.dt / CROSS_EVERY_S
    if on_sidewalk:
        other = scene.walk_cross[traffic.walker_patrol.long()]
        flip_target = torch.where(
            torch.abs(traffic.walker_off_t) < 0.5 * torch.abs(other),
            other, 0.0)
    else:
        near, far = _bands(scene)
        flip_target = (near + far) - traffic.walker_off_t
    off_t = torch.where(flip, flip_target, traffic.walker_off_t)
    step_len = traffic.walker_speed * cfg.dt
    off = traffic.walker_off + torch.clamp(
        off_t - traffic.walker_off, -step_len, step_len
    )

    target = c1 + off[..., None] * normal
    d = target - traffic.walker_xy
    dist = norm2(d)
    new_xy = traffic.walker_xy + d / (dist[..., None] + 1e-6) * step_len[
        ..., None]
    yaw = torch.atan2(d[..., 1], d[..., 0])

    pn = wn[traffic.walker_patrol.long()]
    head = torch.where(dist < 1.0, traffic.walker_head + 1,
                       traffic.walker_head)
    # polyline exhausted -> loop back to its start
    at_end = head >= pn - 1
    head = torch.where(at_end, 0, head)
    s = _rows(wxy, traffic.walker_patrol, torch.zeros_like(head), 2)
    _, snormal = _unit_normal(s[..., 0, :], s[..., 1, :])
    new_xy = torch.where(at_end[..., None],
                         s[..., 0, :] + off[..., None] * snormal, new_xy)
    return dataclasses.replace(
        traffic, walker_xy=new_xy, walker_yaw=yaw,
        walker_head=head.to(torch.int32), walker_off=off, walker_off_t=off_t,
    )


def step_traffic(scene, cfg: EnvConfig, traffic: TrafficState,
                 ego: VehicleState, sim_time: torch.Tensor,
                 cross_coin: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> TrafficState:
    """One tick for every NPC of every env. ``sim_time`` (N,) is the time
    after the tick (light phases); ``cross_coin`` (N, W) uniform draws
    decide the walkers' crossings."""
    n, K = traffic.veh_patrol.shape
    W = traffic.walker_patrol.shape[1]
    if K > 0:
        traffic = _step_vehicles(scene, cfg, traffic, ego, sim_time)
    if W > 0:
        if cross_coin is None:
            cross_coin = draw_cross(n, W, ego.xy.device, generator)
        traffic = _step_walkers(scene, cfg, traffic, cross_coin)
    return traffic
