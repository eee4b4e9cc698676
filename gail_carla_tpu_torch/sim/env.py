"""The driving environment: batch-native reset and step.

Port of ``gail_carla_tpu/sim/env.py``. Every function takes and returns
N envs at once (an explicit env axis in place of ``jax.vmap``). Auto-reset
on done happens inside ``step_batch``, as in the JAX version and the
reference's SubprocVecEnv worker.

Randomness: the JAX version splits a PRNG key carried in the state. Here
each consumer takes its draws as an optional argument and fills it from
a ``torch.Generator`` when it is not given:
- ``reset_env``: restart coin and restart position (``env.py:86-101``)
  and the traffic spawn draws (``traffic.py:53-208``), ``ResetDraws``;
- ``observe``: the GNSS noise (``cursor.py:72``), standard normal (N, 2);
- ``step_batch``: both of those for the auto-reset envs (``env.py:273``)
  and the walkers' crossing coin (``traffic.py:361``); ``StepDraws``
  bundles the three.

Semantics traced to the reference:
- route cursor advance + completion:  task_vehicle.py:103-138
- spawn curriculum:                   ego_vehicle_handler.py:55-78
- blocked / route-deviation criteria: criteria/blocked.py, route_deviation.py
- GNSS target & command:              obs_manager/navigation/gnss.py:96-116
- metrics 4-vector & delta-completion reward: carla_env.py:140-153
- leaderboard terminal:               terminal/leaderboard.py
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops.bev import fetch_cell, fetch_hard_cell
from gail_carla_tpu_torch.ops.bev_full import push_history
from gail_carla_tpu_torch.sim import criteria as crit
from gail_carla_tpu_torch.sim import rewards as rew
from gail_carla_tpu_torch.sim import signals
from gail_carla_tpu_torch.sim import terminals as term
from gail_carla_tpu_torch.sim.collisions import (
    dedup_events, dynamic_collisions, obstacle_collision, static_collision,
)
from gail_carla_tpu_torch.sim.cursor import (
    advance_cursor, advance_plan, route_transform, take_row, take_window,
)
from gail_carla_tpu_torch.sim.dynamics import (
    DEFAULT_VEHICLE, VehicleParams, VehicleState, step_vehicle,
)
from gail_carla_tpu_torch.sim.state import (
    WorldState, make_empty_history, tree_select,
)
from gail_carla_tpu_torch.sim.traffic import (
    TrafficResetDraws, draw_cross, draw_traffic_reset, reset_traffic,
    step_traffic,
)
from gail_carla_tpu_torch.sim.transforms import norm2
from gail_carla_tpu_torch.utils.trace import span


@dataclasses.dataclass
class RenderState:
    """Everything needed to (re-)render this step's policy observation."""

    xy: torch.Tensor        # (N, 2)
    yaw: torch.Tensor       # (N,)
    route_id: torch.Tensor  # (N,) i32
    head: torch.Tensor      # (N,) i32 route cursor
    step: torch.Tensor      # (N,) i32 sim step
    stop_idx: torch.Tensor  # (N,) i32 active un-completed stop sign, -1
    npc_pose: torch.Tensor  # (N, K, 3)
    walker_pose: torch.Tensor  # (N, W, 3)


@dataclasses.dataclass
class StepOutput:
    metrics: torch.Tensor   # (N, 4) [target lat, target lon, speed, cmd]
    render: RenderState
    reward: torch.Tensor    # (N,)
    done: torch.Tensor      # (N,) bool
    info: Dict[str, torch.Tensor]


class ResetDraws(NamedTuple):
    """The draws of one reset: the restart coin and the restart position,
    uniform [0, 1) (N,), and the traffic spawn draws (drawn from the
    generator when None)."""

    restart: torch.Tensor
    pos: torch.Tensor
    traffic: Optional[TrafficResetDraws] = None


class StepDraws(NamedTuple):
    """Every draw of one ``step_batch``, as its keyword arguments."""

    reset_draws: Optional[ResetDraws] = None
    gnss_noise: Optional[torch.Tensor] = None
    traffic_coin: Optional[torch.Tensor] = None


def draw_reset(scene, cfg: EnvConfig, n: int,
               generator: Optional[torch.Generator]) -> ResetDraws:
    u = torch.rand((2, n), generator=generator, device=scene.device)
    traffic = None
    if cfg.n_npc_vehicles + cfg.n_scenario_actors or cfg.n_npc_walkers:
        traffic = draw_traffic_reset(scene, cfg, n, generator)
    return ResetDraws(u[0], u[1], traffic)


def draw_gnss(n: int, device, generator: Optional[torch.Generator]):
    return torch.randn((n, 2), generator=generator, device=device)


def draw_step(scene, cfg: EnvConfig, n: int,
              generator: Optional[torch.Generator]) -> StepDraws:
    """Every draw of one ``step_batch`` of n envs, on the scene's device."""
    return StepDraws(
        reset_draws=draw_reset(scene, cfg, n, generator),
        gnss_noise=draw_gnss(n, scene.device, generator),
        traffic_coin=draw_cross(n, cfg.n_npc_walkers, scene.device,
                                generator),
    )


def reset_env(
    scene,
    cfg: EnvConfig,
    route_ids: torch.Tensor,
    resume_idx: Optional[torch.Tensor] = None,
    completed_last: Optional[torch.Tensor] = None,
    draws: Optional[ResetDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> WorldState:
    """Spawn N envs on their routes with the reference's resume curriculum
    (ego_vehicle_handler.py:55-78): after completing the route (or in eval
    mode) restart at 0; otherwise with prob 0.1 restart at a random route
    point; otherwise resume from where the last episode ended."""
    dev = scene.device
    N = route_ids.shape[0]
    rid = route_ids.to(torch.int32)
    if draws is None:
        draws = draw_reset(scene, cfg, N, generator)
    n = scene.route_n[rid.long()]
    if resume_idx is None:
        resume_idx = torch.zeros(N, dtype=torch.int32, device=dev)
    if completed_last is None:
        completed_last = torch.ones(N, dtype=torch.bool, device=dev)

    random_restart = draws.restart < cfg.random_restart_prob
    random_idx = torch.minimum(
        (draws.pos * 0.9 * n.to(torch.float32)).to(torch.int32), n - 2
    )
    if cfg.train:
        start = torch.where(
            completed_last, 0,
            torch.where(random_restart, random_idx, resume_idx),
        )
    else:
        start = torch.zeros_like(resume_idx)
    # never spawn so close to the end that the episode is trivial
    start = torch.minimum(start.clamp_min(0), (n - 20).clamp_min(0))
    start = start.to(torch.int32)

    s0 = take_row(scene.route_s, rid, start)
    route_len_ep = torch.clamp_min(scene.route_len_m[rid.long()] - s0, 1e-3)
    ego = VehicleState(
        xy=take_row(scene.route_xy, rid, start),
        yaw=take_row(scene.route_yaw, rid, start),
        speed=torch.zeros(N, device=dev),
    )
    z = torch.zeros(N, device=dev)
    zi = torch.zeros(N, dtype=torch.int32, device=dev)
    m1 = torch.full((N,), -1, dtype=torch.int32, device=dev)
    zb = torch.zeros(N, dtype=torch.bool, device=dev)
    return WorldState(
        ego=ego,
        last_steer=z,
        route_id=rid,
        head=start,
        last_head=start,
        start_idx=start,
        s0=s0,
        route_len_ep=route_len_ep,
        plan_idx=m1,
        blocked_elapsed=z,
        out_route_dist=z,
        stop_target=m1,
        stop_completed=zb,
        stop_affected=zb,
        encountered_light=m1,
        last_red_light=m1,
        last_cross_light=m1,
        speed_q=torch.zeros((N, 10), device=dev),
        speed_q_len=zi,
        stuck_counter=zi,
        last_lat_dist=z,
        col_xy=torch.full((N, 2), 1e9, device=dev),
        col_time=torch.full((N,), -1e9, device=dev),
        col_id=m1,
        n_col_static=zi,
        n_col_vehicle=zi,
        n_col_walker=zi,
        n_red=zi,
        n_stop=zi,
        n_enc_light=zi,
        n_enc_stop=zi,
        outside_lane_m=z,
        wrong_lane_m=z,
        step=zi,
        episode_reward=z,
        last_total=z,
        resume_idx=resume_idx.to(torch.int32),
        completed_last=completed_last,
        traffic=reset_traffic(scene, cfg, ego.xy, draws.traffic, generator,
                              route_id=rid),
        history=(
            make_empty_history(N, cfg.n_npc_vehicles + cfg.n_scenario_actors,
                               cfg.n_npc_walkers,
                               scene.tl_stop.shape[0],
                               scene.ss_center.shape[0], dev)
            if cfg.full_bev else None
        ),
    )


def observe(scene, cfg: EnvConfig, state: WorldState,
            gnss_noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None):
    """(state', metrics (N, 4), render): the metrics 4-vector
    (carla_env.py:140-144) and the render state; advances plan_idx (the
    reference advances the target once per tick)."""
    if gnss_noise is None:
        gnss_noise = draw_gnss(state.head.shape[0], scene.device, generator)
    plan_idx, command, target_gps = advance_plan(
        scene, cfg, gnss_noise, state.ego.xy, state.ego.yaw, state.route_id,
        state.plan_idx,
    )
    speed = torch.abs(state.ego.speed)
    metrics = torch.stack(
        [target_gps[:, 0], target_gps[:, 1], speed,
         command.to(torch.float32)], dim=1,
    )
    t = state.traffic
    render = RenderState(
        xy=state.ego.xy,
        yaw=state.ego.yaw,
        route_id=state.route_id,
        head=state.head,
        step=state.step,
        stop_idx=torch.where(
            state.stop_completed, -1, state.stop_target
        ).to(torch.int32),
        npc_pose=torch.cat([t.veh.xy, t.veh.yaw[..., None]], dim=-1),
        walker_pose=torch.cat([t.walker_xy, t.walker_yaw[..., None]],
                              dim=-1),
    )
    state = dataclasses.replace(state, plan_idx=plan_idx)
    return state, metrics, render


def reset_batch(scene, cfg: EnvConfig, route_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[ResetDraws] = None,
                gnss_noise: Optional[torch.Tensor] = None):
    """Create N worlds on ``route_ids`` and observe them:
    (states, metrics, render)."""
    route_ids = route_ids.to(scene.device)
    states = reset_env(scene, cfg, route_ids, draws=draws,
                       generator=generator)
    return observe(scene, cfg, states, gnss_noise, generator)


def chain_endless(scene, state: WorldState) -> WorldState:
    """Endless target extension (task_vehicle.py:67-82,143-145): an env
    whose cursor is within 2 points of its row's end continues on
    ``scene.endless_next[row]``, which starts at this row's end pose.
    Completed metres and the episode's route length both carry over;
    ``plan_idx`` restarts at -1 and ``advance_plan`` picks the new row's
    first target at the step's observe (``env.py:232-257``)."""
    rid0 = state.route_id
    n_cur = scene.route_n[rid0.long()]
    rid_next = scene.endless_next[rid0.long()]
    switch = (state.head >= n_cur - 2) & (rid_next != rid0)
    completed_so_far = take_row(scene.route_s, rid0, state.head) - state.s0
    zero = torch.zeros_like(state.head)
    return dataclasses.replace(
        state,
        route_id=torch.where(switch, rid_next, rid0).to(torch.int32),
        head=torch.where(switch, zero, state.head),
        last_head=torch.where(switch, zero, state.last_head),
        s0=torch.where(switch, -completed_so_far, state.s0),
        route_len_ep=torch.where(
            switch, state.route_len_ep + scene.route_len_m[rid_next.long()],
            state.route_len_ep,
        ),
        plan_idx=torch.where(switch, torch.full_like(state.plan_idx, -1),
                             state.plan_idx),
    )


def step_batch(
    scene,
    cfg: EnvConfig,
    state: WorldState,
    action: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    reset_draws: Optional[ResetDraws] = None,
    gnss_noise: Optional[torch.Tensor] = None,
    traffic_coin: Optional[torch.Tensor] = None,
    params: VehicleParams = DEFAULT_VEHICLE,
) -> Tuple[WorldState, StepOutput]:
    """One synchronous world tick for N envs. ``action`` (N, 2) =
    (steer, throttle) like carla_env.py:120-126, or (N, 3) with brake.
    Auto-resets on done and returns the new episode's observation with
    the finished episode's reward/done/info. The draws the step makes
    (see ``StepDraws``) come from ``generator`` unless given."""
    with span("env.step"):
        return _step(scene, cfg, state, action, generator, reset_draws,
                     gnss_noise, traffic_coin, params)


def _step(scene, cfg, state, action, generator, reset_draws, gnss_noise,
          traffic_coin, params):
    if cfg.endless_extension and scene.endless_next is not None:
        state = chain_endless(scene, state)
    steer, throttle = action[:, 0], action[:, 1]
    brake = action[:, 2] if action.shape[1] > 2 else torch.zeros_like(steer)
    ego = step_vehicle(state.ego, steer, throttle, brake, cfg.dt, params)

    rid = state.route_id
    head, last_head, dist_traveled = advance_cursor(
        scene, rid, state.head, state.last_head, ego.xy
    )
    n = scene.route_n[rid.long()]
    route_completed = take_row(scene.route_s, rid, head) - state.s0
    total = route_completed / state.route_len_ep
    step_count = state.step + 1
    sim_time = step_count.to(torch.float32) * cfg.dt
    speed = torch.abs(ego.speed)

    with span("sim.traffic"):
        traffic = step_traffic(scene, cfg, state.traffic, ego, sim_time,
                               traffic_coin, generator)

    # core criteria (blocked / deviation / completion / timeout)
    blocked_elapsed = torch.where(
        speed < cfg.blocked_speed, state.blocked_elapsed + cfg.dt, 0.0
    )
    c_blocked = blocked_elapsed > cfg.blocked_time

    head_xy = take_row(scene.route_xy, rid, head)
    dev_m = norm2(ego.xy - head_xy)
    out_route_dist = state.out_route_dist + torch.where(
        dev_m > cfg.deviation_min, dist_traveled, 0.0
    )
    c_deviation = (dev_m > cfg.deviation_max) | (
        out_route_dist / state.route_len_ep > cfg.deviation_pct
    )

    end_xy = take_row(scene.route_xy, rid, n - 1)
    c_route = (total > cfg.completion_pct) & (
        norm2(ego.xy - end_xy) < cfg.completion_dist
    )
    if cfg.endless_extension:
        # endless tasks have no route end (terminal/valeo.py:92-96)
        c_route = torch.zeros_like(c_route)
    c_timeout = step_count >= cfg.max_steps

    # collisions (one shared spatial-hash fetch per step)
    road_segs, road_flag, _, _, _ = fetch_cell(scene, ego.xy)
    hard_segs, _ = fetch_hard_cell(scene, ego.xy)
    raw_static = static_collision(
        params, ego, hard_segs, scene.hard_dmax
    ) | obstacle_collision(scene, params, ego)
    hits = dynamic_collisions(traffic, params, ego)
    ev = dedup_events(
        ego, sim_time, raw_static, hits, traffic.veh_patrol.shape[1],
        state.col_xy, state.col_time, state.col_id,
    )

    # signal criteria
    tl_states = signals.light_states(scene, sim_time)
    last_red_light, last_cross_light, ran_red = crit.run_red_light(
        scene, params, ego, tl_states, state.last_red_light,
        state.last_cross_light,
    )
    route_pts = take_window(scene.route_xy, rid, head, 20)
    ss_state, enc_stop, ran_stop = crit.run_stop_sign(
        scene, ego, route_pts, take_row(scene.route_yaw, rid, head),
        crit.StopSignState(
            state.stop_target, state.stop_completed, state.stop_affected
        ),
    )
    encountered_light, enc_light = crit.encounter_light(
        scene, ego, tl_states, state.encountered_light
    )
    outside_lane, wrong_lane = crit.outside_route_lane(
        scene, ego, road_segs, road_flag
    )

    # valeo terminal state (terminal/valeo.py:37-72)
    light_state, light_loc, light_idx = signals.affecting_light(
        scene, ego.xy, ego.yaw, tl_states,
        offset=-0.8 * params.half_length, dist_threshold=18.0,
    )
    veh_found, _ = rew.hazard_vehicle(traffic, ego.xy, ego.yaw)
    ped_found, _ = rew.hazard_walker(traffic, ego.xy, ego.yaw)
    is_free_road = (~veh_found) & (~ped_found) & (
        (light_idx < 0) | (light_state == signals.GREEN)
    )
    speed_q = torch.roll(state.speed_q, 1, dims=1)
    speed_q[:, 0] = speed
    speed_q_len = torch.clamp_max(state.speed_q_len + 1, 10)
    speed_mean = speed_q.sum(dim=1) / speed_q_len.clamp_min(1)
    stuck_counter = torch.where(
        speed_mean >= 1.0, 0,
        state.stuck_counter + (is_free_road & (speed_mean < 1.0)),
    ).to(torch.int32)
    c_stuck = stuck_counter >= cfg.stuck_steps

    route_tf_xy, route_tf_yaw = route_transform(scene, rid, head, last_head)
    d_vec = ego.xy - route_tf_xy
    lat_dist = torch.abs(
        -torch.sin(route_tf_yaw) * d_vec[:, 0]
        + torch.cos(route_tf_yaw) * d_vec[:, 1]
    )
    thresh_lat = torch.where(
        lat_dist - state.last_lat_dist > 0.8,
        lat_dist + 0.5,
        torch.clamp_min(state.last_lat_dist, cfg.lat_dist_thresh),
    )
    c_lat_dist = lat_dist > thresh_lat + 1e-2

    # terminal handler
    flags = term.CriteriaFlags(
        c_route=c_route, c_blocked=c_blocked, c_deviation=c_deviation,
        c_collision=ev.any, c_run_red=ran_red, c_run_stop=ran_stop,
        c_collision_px=hits.ped, c_stuck=c_stuck, c_lat_dist=c_lat_dist,
        timeout=c_timeout,
    )
    tout = term.compute_terminal(
        cfg.terminal_mode, flags, speed, cfg.exploration_suggest
    )
    done = tout.done

    # infraction counters (for leaderboard episode_stat)
    n_col_static = state.n_col_static + ev.static
    n_col_vehicle = state.n_col_vehicle + ev.veh
    n_col_walker = state.n_col_walker + ev.ped
    n_red = state.n_red + ran_red
    n_stop = state.n_stop + ran_stop
    n_enc_light = state.n_enc_light + enc_light
    n_enc_stop = state.n_enc_stop + enc_stop
    outside_lane_m = state.outside_lane_m + torch.where(
        outside_lane, dist_traveled, 0.0
    )
    wrong_lane_m = state.wrong_lane_m + torch.where(
        wrong_lane, dist_traveled, 0.0
    )

    # reward
    delta_reward = total - state.last_total
    if cfg.reward_mode == "valeo" or cfg.compute_valeo_reward:
        ss_active = (ss_state.target >= 0) & (~ss_state.completed)
        tgt = ss_state.target.clamp_min(0).long()
        stop_dist = norm2(scene.ss_center[tgt] - ego.xy)
        valeo_reward, desired_speed = rew.valeo_action_reward(
            traffic,
            rew.ValeoInputs(
                ego_xy=ego.xy, ego_yaw=ego.yaw, ego_speed=speed,
                steer=steer, last_steer=state.last_steer,
                route_tf_xy=route_tf_xy, route_tf_yaw=route_tf_yaw,
                light_state=light_state, light_dist=norm2(light_loc),
                stop_dist=stop_dist, has_stop=ss_active,
                terminal_reward=tout.terminal_reward,
            ),
        )
    else:
        valeo_reward = torch.zeros_like(speed)
        desired_speed = torch.zeros_like(speed)
    reward = valeo_reward if cfg.reward_mode == "valeo" else delta_reward
    episode_reward = state.episode_reward + reward

    # BEV history ring (chauffeurnet.py:105-133)
    history = state.history
    if cfg.full_bev:
        S = scene.ss_center.shape[0]
        stop_active = (
            (torch.arange(S, device=ego.xy.device)[None, :]
             == ss_state.target[:, None]) & ~ss_state.completed[:, None]
        )
        history = push_history(
            history,
            torch.cat([traffic.veh.xy, traffic.veh.yaw[..., None]], dim=-1),
            torch.cat([traffic.walker_xy, traffic.walker_yaw[..., None]],
                      dim=-1),
            tl_states, stop_active,
        )

    # leaderboard episode stats (ego_vehicle_handler.py:208-248)
    score_route = torch.clamp(total, 0.0, 1.0) * 100.0
    score_penalty = (
        0.50 ** n_col_walker
        * 0.60 ** n_col_vehicle
        * 0.65 ** n_col_static
        * 0.70 ** n_red
        * 0.80 ** n_stop
    )
    km = torch.clamp_min(route_completed, 1.0) / 1000.0

    # curriculum carry (persists through the auto-reset)
    resume_idx = torch.where(done, head, state.resume_idx)
    completed_last = torch.where(done, c_route, state.completed_last)

    cont = dataclasses.replace(
        state,
        ego=ego,
        last_steer=steer,
        head=head,
        last_head=last_head,
        blocked_elapsed=blocked_elapsed,
        out_route_dist=out_route_dist,
        stop_target=ss_state.target,
        stop_completed=ss_state.completed,
        stop_affected=ss_state.affected,
        encountered_light=encountered_light,
        last_red_light=last_red_light,
        last_cross_light=last_cross_light,
        speed_q=speed_q,
        speed_q_len=speed_q_len,
        stuck_counter=stuck_counter,
        last_lat_dist=lat_dist,
        col_xy=ev.col_xy,
        col_time=ev.col_time,
        col_id=ev.col_id,
        n_col_static=n_col_static,
        n_col_vehicle=n_col_vehicle,
        n_col_walker=n_col_walker,
        n_red=n_red,
        n_stop=n_stop,
        n_enc_light=n_enc_light,
        n_enc_stop=n_enc_stop,
        outside_lane_m=outside_lane_m,
        wrong_lane_m=wrong_lane_m,
        step=step_count,
        episode_reward=episode_reward,
        last_total=total,
        resume_idx=resume_idx,
        completed_last=completed_last,
        traffic=traffic,
        history=history,
    )
    fresh = reset_env(scene, cfg, rid, resume_idx, completed_last,
                      draws=reset_draws, generator=generator)
    next_state = tree_select(done, fresh, cont)
    next_state, metrics, render = observe(
        scene, cfg, next_state, gnss_noise, generator
    )

    info = {
        "route_completed": c_route,
        "blocked": c_blocked,
        "route_deviation": c_deviation,
        "collision": ev.any,
        "collision_vehicle": ev.veh,
        "collision_walker": ev.ped,
        "collision_intensity": ev.intensity,
        "run_red_light": ran_red,
        "run_stop_sign": ran_stop,
        "encounter_light": enc_light,
        "encounter_stop": enc_stop,
        "outside_lane": outside_lane,
        "wrong_lane": wrong_lane,
        "timeout": c_timeout,
        "episode_reward": episode_reward,
        "episode_length": step_count,
        "route_id": rid,
        "route_completed_in_m": route_completed,
        "route_length_in_m": state.route_len_ep,
        "valeo_reward": valeo_reward,
        "desired_speed": desired_speed,
        "terminal_reward": tout.terminal_reward,
        "exploration_suggest_steps": tout.suggest_steps,
        "exploration_suggest_go": tout.suggest_go,
        "exploration_suggest_stop": tout.suggest_stop,
        "exploration_suggest_turn": tout.suggest_turn,
        "score_route": score_route,
        "score_penalty": score_penalty * 100.0,
        "score_composed": score_route * score_penalty,
        "n_collisions_layout": n_col_static,
        "n_collisions_vehicle": n_col_vehicle,
        "n_collisions_walker": n_col_walker,
        "n_red_light": n_red,
        "n_stop_sign": n_stop,
        "red_light_per_km": n_red.to(torch.float32) / km,
        "stop_sign_per_km": n_stop.to(torch.float32) / km,
    }
    return next_state, StepOutput(
        metrics=metrics, render=render, reward=reward, done=done, info=info,
    )
