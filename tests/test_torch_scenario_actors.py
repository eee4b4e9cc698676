"""Scripted scenario actors in the port against the JAX package:
``build_scene(scenario_actors=)``, the scenario slots of
``sim/traffic.py`` (the last ``n_scenario_actors`` vehicle slots, keyed
per ego route by ``scene.sa_patrol``), ``leaderboard_suite(
scenario_actors=)`` and the plain 6-channel renderer drawing them.

- ``tests/test_scenario_actors.py``'s four cases on the port: an
  adversary drives from a side street onto the ego lane ~45 m ahead and
  parks; a blind full-throttle ego hits it, the hazard-aware expert
  yields to it; spare slots park far away.
- Reset and 200 steps of 4 envs with 2 random NPC vehicles and 3
  scenario slots (route 0: 2 adversaries and a parked slot; route 1: 3
  parked slots) against JAX's, every draw injected (the draws cover the
  2 random vehicles only, as JAX's keys do): patrols, heads and target
  speeds equal, poses and the PID states within 1e-4
  (``test_torch_traffic.py::compare_traffic``); the adversaries reach
  their polyline's end and stop, the parked slots stay parked.
- The 6-channel BEV of those render states (5 vehicle boxes per env, 3
  of them parked ~1e6 m away on route 1) by the port's plain renderer
  and by JAX's ``render_bev6_batch_auto``: 0 values differ.

The JAX package is imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_traffic import (
    _t, compare_poses, compare_traffic, jax_batch_reset_draws,
    jax_step_draws,
)

from gail_carla_tpu_torch.agents.autopilot import autopilot_act
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.envs import suites
from gail_carla_tpu_torch.ops.bev6 import render_bev6_batch
from gail_carla_tpu_torch.scene.routes import RouteDef
from gail_carla_tpu_torch.scene.scene import STATIC_FIELDS, build_scene
from gail_carla_tpu_torch.scene.town import make_grid_town, nearest_edge_point
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.sim.traffic import PARK, PARK_STEP

N_STEPS = 200
PARITY_ENV = EnvConfig(train=False, obs_mode="state", n_npc_vehicles=2,
                       n_scenario_actors=3, max_time=12.0)


def _routes_and_actors(graph, n_routes):
    """The ego route along the first road from x=10 (``n_routes`` copies),
    the adversary's side-street polyline parking on the ego lane ~45 m
    ahead, and a slower second one 20 m further on."""
    start = np.array([10.0, 1.75])
    ek, _ = nearest_edge_point(graph, start)
    e = graph.edges[ek]
    wps = np.array([[e.pts[0][0], e.pts[0][1], 0.0],
                    [e.pts[-1][0], e.pts[-1][1], 0.0]])
    routes = [RouteDef(route_id=r, town="t", waypoints=wps)
              for r in range(n_routes)]
    x_block = float(e.pts[0][0]) + 45.0
    y_lane = float(e.pts[0][1])
    adversary = np.stack([np.full(26, x_block),
                          np.linspace(y_lane + 25.0, y_lane, 26)], axis=1)
    second = adversary + np.array([20.0, 0.0])
    return routes, adversary, second


@pytest.fixture(scope="module")
def scenes():
    """(the one-route scene of ``tests/test_scenario_actors.py``, the
    two-route parity scene and its JAX twin)."""
    from gail_carla_tpu.scene.scene import build_scene as jax_build
    from gail_carla_tpu.scene.town import make_grid_town as jax_town

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        graph = make_grid_town(nx=3, ny=3, block=80.0)
        routes, adv, second = _routes_and_actors(graph, 1)
        one = build_scene(graph, routes, scenario_actors={0: [(adv, 6.0)]})
        routes2, _, _ = _routes_and_actors(graph, 2)
        actors = {0: [(adv, 6.0), (second, 4.0)]}
        two = build_scene(graph, routes2, scenario_actors=actors)
    finally:
        torch.set_num_threads(n)
    jax_two = jax_build(jax_town(nx=3, ny=3, block=80.0), routes2,
                        scenario_actors=actors)
    return one, two, jax_two


def _drive(scene, policy, n_steps=400, n_scenario_actors=1):
    """The ego on route 0 stepped by ``policy(world) -> action``: (any
    vehicle collision, the least distance from the ego to a vehicle)."""
    cfg = EnvConfig(train=False, obs_mode="state",
                    n_scenario_actors=n_scenario_actors)
    gen = torch.Generator().manual_seed(0)
    st, _, _ = port_env.reset_batch(scene, cfg, torch.tensor([0]), gen)
    hit, gap = False, 1e9
    for _ in range(n_steps):
        d = torch.linalg.norm(st.traffic.veh.xy[0] - st.ego.xy[0], dim=-1)
        gap = min(gap, float(d.min()))
        st, out = port_env.step_batch(scene, cfg, st, policy(st), gen)
        hit |= bool(out.info["n_collisions_vehicle"][0] > 0)
    return hit, gap


def test_scenario_actor_spawns_on_its_route(scenes):
    scene = scenes[0]
    cfg = EnvConfig(train=False, obs_mode="state", n_scenario_actors=1)
    st, _, _ = port_env.reset_batch(scene, cfg, torch.tensor([0]),
                                    torch.Generator().manual_seed(0))
    # the slot exists and sits at the adversary polyline's start
    assert st.traffic.veh.xy.shape == (1, 1, 2)
    xy = st.traffic.veh.xy[0, 0].numpy()
    assert np.linalg.norm(xy) < 1e5
    row = int(scene.sa_patrol[0, 0])
    np.testing.assert_allclose(xy, scene.patrol_xy[row, 0].numpy(),
                               atol=1e-4)
    assert float(st.traffic.veh_target_speed[0, 0]) == 6.0


def test_blind_ego_collides_with_scenario_actor(scenes):
    hit, _ = _drive(scenes[0], lambda st: torch.tensor([[0.0, 1.0]]))
    assert hit, "full-throttle ego should hit the parked adversary"


def test_yielding_expert_avoids_scenario_actor(scenes):
    scene = scenes[0]
    ap = [make_autopilot((1,), "cpu")]

    def expert(st):
        ap[0], act = autopilot_act(scene, ap[0], st, obey_signals=True)
        return act

    hit, gap = _drive(scene, expert)
    assert not hit, "hazard-aware expert must yield to the parked adversary"
    # it actually got near the adversary (the scenario is exercised)
    assert gap < 20.0


def test_inactive_slots_park_far_away(scenes):
    scene = scenes[0]
    cfg = EnvConfig(train=False, obs_mode="state", n_scenario_actors=3)
    st, _, _ = port_env.reset_batch(scene, cfg, torch.tensor([0]),
                                    torch.Generator().manual_seed(0))
    xy = st.traffic.veh.xy[0].numpy()
    assert xy.shape == (3, 2)
    assert np.linalg.norm(xy[0]) < 1e5          # the real adversary
    assert (np.abs(xy[1:]) > 1e5).all()         # spare slots parked
    assert (st.traffic.veh_target_speed[0, 1:] == 0).all()


def _compare_scene(scene, jax_scene):
    for name, v in scene.tensors():
        np.testing.assert_array_equal(v.cpu().numpy(),
                                      np.asarray(getattr(jax_scene, name)),
                                      err_msg=name)
    for name in STATIC_FIELDS:
        assert getattr(scene, name) == getattr(jax_scene, name), name


def test_build_scene_scenario_actors_matches_jax(scenes):
    _, scene, jax_scene = scenes
    _compare_scene(scene, jax_scene)
    assert scene.sa_max == 2
    P = scene.patrol_xy.shape[0]
    np.testing.assert_array_equal(scene.sa_patrol.numpy(),
                                  [[P - 2, P - 1], [-1, -1]])
    np.testing.assert_array_equal(scene.sa_speed.numpy(),
                                  [[6.0, 4.0], [0.0, 0.0]])
    assert scene.patrol_n[-1] == 26


def test_scenario_traffic_matches_jax(scenes):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.ops.bev6 import render_bev6_batch_auto
    from gail_carla_tpu.sim import env as jax_env
    from gail_carla_tpu.sim.env import RenderState as JaxRenderState

    _, scene, jax_scene = scenes
    cfg = PARITY_ENV
    n_patrols = scene.patrol_xy.shape[0]
    rid = np.array([0, 1, 0, 1], np.int32)
    n = len(rid)
    rng = np.random.default_rng(5)
    actions = np.stack([rng.uniform(-0.05, 0.05, (N_STEPS, n)),
                        rng.uniform(0.2, 0.5, (N_STEPS, n))],
                       -1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    js, _, jr = jax_env.reset_batch(jax_scene, cfg, key, jnp.asarray(rid))
    draws, gnss = jax_batch_reset_draws(key, n, cfg, n_patrols)
    assert draws.traffic.veh_pat.shape == (n, 2, 4)
    ps, _, pr = port_env.reset_batch(scene, cfg, _t(rid), draws=draws,
                                     gnss_noise=gnss)
    compare_traffic(js.traffic, ps.traffic, "reset")
    compare_poses(pr.npc_pose, jr.npc_pose, "npc_pose at reset")
    park = PARK + PARK_STEP * np.arange(3, dtype=np.float32)

    step = jax.jit(lambda s, a: jax_env.step_batch(jax_scene, cfg, s, a))
    renders, n_done, stopped = [], 0, np.zeros((n, 3), bool)
    for t in range(N_STEPS):
        rngs = js.rng
        js, jout = step(js, jnp.asarray(actions[t]))
        sd = jax_step_draws(rngs, jout.done, cfg, n_patrols)
        ps, pout = port_env.step_batch(scene, cfg, ps, _t(actions[t]),
                                       **sd._asdict())
        tr = ps.traffic
        compare_traffic(js.traffic, tr, f"step {t}")
        np.testing.assert_array_equal(
            tr.veh_target_speed.numpy(),
            np.asarray(js.traffic.veh_target_speed), err_msg=f"step {t}")
        np.testing.assert_array_equal(pout.done.numpy(),
                                      np.asarray(jout.done))
        compare_poses(pout.render.npc_pose, jout.render.npc_pose,
                      f"npc_pose at step {t}")
        # route 1's slots and route 0's third stay parked, speed 0
        sa_xy = tr.veh.xy[:, 2:].numpy()
        np.testing.assert_array_equal(sa_xy[1::2], np.broadcast_to(
            park[None, :, None], (2, 3, 2)))
        np.testing.assert_array_equal(sa_xy[0::2, 2], [[park[2]] * 2] * 2)
        assert (tr.veh_target_speed[1::2, 2:] == 0).all()
        stopped |= ((tr.veh_target_speed[:, 2:] == 0)
                    & (tr.veh.speed[:, 2:] == 0)).numpy()
        n_done += int(pout.done.sum())
        if t % 40 == 20:
            renders.append(pout.render)
    # both adversaries of route 0 reach their polyline's end and stop
    assert stopped[0::2, :2].all()
    assert n_done >= 4

    # the 6-channel BEV at those steps: 5 boxes per env, parked ones too
    bev = EnvConfig(bev_width=96, obs_mode="bev6", n_npc_vehicles=2,
                    n_scenario_actors=3)
    rs = type(renders[0])(**{
        f.name: torch.cat([getattr(r, f.name) for r in renders])
        for f in dataclasses.fields(renders[0])})
    assert rs.npc_pose.shape[1] == 5
    got = render_bev6_batch(scene, bev, rs).numpy()
    want = np.asarray(render_bev6_batch_auto(jax_scene, bev, JaxRenderState(
        **{f.name: jnp.asarray(getattr(rs, f.name).numpy())
           for f in dataclasses.fields(rs)})))
    assert int((got != want).sum()) == 0
    assert got[:, 4].any()                       # the vehicle channel


def test_leaderboard_suite_scenario_actors_matches_jax():
    from gail_carla_tpu.envs.suites import leaderboard_suite as jax_suite

    n_routes = 2
    scene, cfg, tasks = suites.leaderboard_suite(n_routes=n_routes,
                                                 device="cpu")
    P = scene.patrol_xy.shape[0]
    # one adversary per route: the route's own points 30-55, 6 m/s
    actors = {r: [(scene.route_xy[r, 30:56].numpy(), 6.0)]
              for r in range(n_routes)}
    scene, cfg, tasks = suites.leaderboard_suite(
        n_routes=n_routes, scenario_actors=actors, device="cpu")
    jscene, jcfg, jtasks = jax_suite(n_routes=n_routes,
                                     scenario_actors=actors)
    _compare_scene(scene, jscene)
    assert cfg.n_scenario_actors == jcfg.n_scenario_actors == 1
    assert dataclasses.asdict(cfg) == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    assert tasks == jtasks
    np.testing.assert_array_equal(scene.sa_patrol.numpy(), [[P], [P + 1]])
    with pytest.raises(ValueError, match="generated scenes"):
        suites.leaderboard_suite(town="Town01", scenario_actors=actors,
                                 device="cpu")
