"""The port's NPC traffic against the JAX package's: reset and step of
vehicles and walkers inside ``step_batch``, dynamic collisions and the
hazard detectors.

The closed-loop test resets 4 envs with 3 NPC vehicles and 2 walkers
each on the smoke-preset scene and steps them 120 times with fixed numpy
actions, the default randomness on, and episodes short enough to
auto-reset. JAX's threefry draws are not torch's, so every draw the JAX
envs make (restart coin and position, GNSS noise, the traffic spawn draws
and the walkers' crossing coin) is recomputed from the JAX state's key
and injected into the port's step. Discrete fields must be equal; floats
agree within 1e-4 (ulp-level differences between the two libraries'
sin/cos/atan2, accumulated over the steps). The JAX package is imported
inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim import collisions, rewards
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.sim.dynamics import DEFAULT_VEHICLE, VehicleState
from gail_carla_tpu_torch.sim.state import make_empty_traffic
from gail_carla_tpu_torch.sim.traffic import (
    N_CANDIDATES, TrafficResetDraws,
)
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
# 10 s episodes: every env auto-resets inside the 120 steps
ENV = dataclasses.replace(PRESET["env"], n_npc_vehicles=3, n_npc_walkers=2,
                          max_time=10.0)
TOL = dict(rtol=1e-4, atol=1e-4)
TRAFFIC_DISCRETE = ("veh_patrol", "veh_head", "walker_patrol",
                    "walker_head")
TRAFFIC_FLOATS = ("veh_target_speed", "walker_xy", "walker_off",
                  "walker_off_t", "walker_speed")


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    return (make_benchmark_scene(**PRESET["scene"], device="cpu"),
            make_jax_scene(**PRESET["scene"]))


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_traffic_draws(k_traffic, n_veh, n_walkers, n_patrols,
                      n_walk_paths=None):
    """The draws ``reset_traffic`` makes from one env's key, as numpy-able
    arrays in the order of ``TrafficResetDraws``; the walkers draw from
    ``n_walk_paths`` sidewalk paths when the scene has them, else from the
    patrols."""
    import jax

    k_p, k_h, k_s, k_wx, k_wg, k_ws = jax.random.split(k_traffic, 6)
    k_side, k_speed = jax.random.split(k_ws)
    vc = (n_veh, N_CANDIDATES)
    return (
        jax.random.randint(k_p, vc, 0, n_patrols),
        jax.random.uniform(k_h, vc),
        # jitter and target speed come from the same key in JAX
        jax.random.uniform(k_s, vc),
        jax.random.uniform(k_s, (n_veh,), minval=4.5, maxval=6.5),
        jax.random.randint(k_wx, (n_walkers,), 0,
                           n_walk_paths or n_patrols),
        jax.random.uniform(k_wg, (n_walkers,)),
        jax.random.uniform(k_side, (n_walkers,)),
        jax.random.uniform(k_speed, (n_walkers,), minval=1.0, maxval=2.0),
    )


def jax_reset_draws(k_reset, cfg, n_patrols, n_walk_paths=None):
    """(restart, pos, traffic draws) that ``reset_env`` makes from one
    env's key, and the key the reset state carries."""
    import jax

    rng, k_restart, k_pos, k_traffic = jax.random.split(k_reset, 4)
    return rng, (jax.random.uniform(k_restart), jax.random.uniform(k_pos),
                 jax_traffic_draws(k_traffic, cfg.n_npc_vehicles,
                                   cfg.n_npc_walkers, n_patrols,
                                   n_walk_paths))


def jax_step_draws_raw(rngs, done, cfg, n_patrols, n_walk_paths=None):
    """Per env, every draw ``step_env`` makes from its pre-step key: the
    auto-reset's draws, the GNSS noise of the observe after the (possible)
    reset, and the walkers' crossing coin, as JAX arrays (jittable with
    ``cfg`` and ``n_patrols`` fixed)."""
    import jax
    import jax.numpy as jnp

    def one(r, d):
        rng_next, k_reset, k_npc = jax.random.split(r, 3)
        fresh, (restart, pos, traffic) = jax_reset_draws(
            k_reset, cfg, n_patrols, n_walk_paths)
        _, k = jax.random.split(jnp.where(d, fresh, rng_next))
        coin = jax.random.uniform(k_npc, (cfg.n_npc_walkers,))
        return restart, pos, traffic, jax.random.normal(k, (2,)), coin

    return jax.vmap(one)(rngs, done)


def step_draws_from_raw(raw):
    """``jax_step_draws_raw``'s arrays as a port ``StepDraws``."""
    restart, pos, traffic, gnss, coin = raw
    return port_env.StepDraws(
        reset_draws=port_env.ResetDraws(
            _t(restart), _t(pos), TrafficResetDraws(*map(_t, traffic))),
        gnss_noise=_t(gnss), traffic_coin=_t(coin),
    )


def jax_step_draws(rngs, done, cfg, n_patrols, n_walk_paths=None):
    """``jax_step_draws_raw`` as a port ``StepDraws``."""
    return step_draws_from_raw(jax_step_draws_raw(rngs, done, cfg,
                                                  n_patrols, n_walk_paths))


def jax_batch_reset_draws(key, n, cfg, n_patrols, n_walk_paths=None):
    """The draws of ``reset_batch(key)`` over n envs: ``ResetDraws`` and
    the first observe's GNSS noise."""
    import jax

    def one(k):
        rng, draws = jax_reset_draws(k, cfg, n_patrols, n_walk_paths)
        _, kg = jax.random.split(rng)
        return draws, jax.random.normal(kg, (2,))

    (restart, pos, traffic), gnss = jax.vmap(one)(jax.random.split(key, n))
    return port_env.ResetDraws(_t(restart), _t(pos),
                               TrafficResetDraws(*map(_t, traffic))), _t(gnss)


def assert_angles_close(got, want, err_msg):
    """Headings within 1e-4 rad modulo 2 pi: a heading of exactly +-pi
    (an actor moving along -x) wraps to either sign on an ulp of its
    direction vector's y component (XLA contracts a + b*c into one fused
    multiply-add under jit, torch rounds the product first)."""
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    d = (d + np.pi) % (2.0 * np.pi) - np.pi
    assert np.abs(d).max(initial=0.0) <= 1e-4, err_msg


def compare_poses(got, want, err_msg):
    """(..., 3) x, y, yaw actor poses: positions within 1e-4, headings
    within 1e-4 rad modulo 2 pi."""
    want = np.asarray(want)
    np.testing.assert_allclose(got[..., :2].numpy(), want[..., :2],
                               err_msg=err_msg, **TOL)
    assert_angles_close(got[..., 2].numpy(), want[..., 2], err_msg)


def compare_traffic(jt, pt, where):
    for name in TRAFFIC_DISCRETE:
        np.testing.assert_array_equal(
            getattr(pt, name).numpy(), np.asarray(getattr(jt, name)),
            err_msg=f"traffic.{name} at {where}")
    for name in TRAFFIC_FLOATS:
        np.testing.assert_allclose(
            getattr(pt, name).numpy(), np.asarray(getattr(jt, name)),
            err_msg=f"traffic.{name} at {where}", **TOL)
    for name in ("xy", "speed"):
        np.testing.assert_allclose(
            getattr(pt.veh, name).numpy(), np.asarray(getattr(jt.veh, name)),
            err_msg=f"traffic.veh.{name} at {where}", **TOL)
    assert_angles_close(pt.veh.yaw.numpy(), jt.veh.yaw,
                        f"traffic.veh.yaw at {where}")
    assert_angles_close(pt.walker_yaw.numpy(), jt.walker_yaw,
                        f"traffic.walker_yaw at {where}")
    for pid in ("turn_pid", "speed_pid"):
        jp, pp = getattr(jt.veh_ap, pid), getattr(pt.veh_ap, pid)
        for name in ("idx", "count"):
            np.testing.assert_array_equal(
                getattr(pp, name).numpy(), np.asarray(getattr(jp, name)),
                err_msg=f"{pid}.{name} at {where}")
        for name in ("buf", "prev"):
            np.testing.assert_allclose(
                getattr(pp, name).numpy(), np.asarray(getattr(jp, name)),
                err_msg=f"{pid}.{name} at {where}", **TOL)
    np.testing.assert_array_equal(
        pt.veh_ap.last_command.numpy(),
        np.asarray(jt.veh_ap.last_command),
        err_msg=f"last_command at {where}")


def test_traffic_reset_and_step_match_jax(scenes):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim import env as jax_env

    port_scene, jax_scene = scenes
    n_patrols = port_scene.patrol_xy.shape[0]
    rid = np.array([0, 1, 0, 1], np.int32)
    n, T = len(rid), 120
    rng = np.random.default_rng(4)
    actions = np.stack([rng.uniform(-0.2, 0.2, (T, n)),
                        rng.uniform(0.3, 1.0, (T, n))], -1).astype(np.float32)

    key = jax.random.PRNGKey(7)
    js, _, jr = jax_env.reset_batch(jax_scene, ENV, key, jnp.asarray(rid))
    draws, gnss = jax_batch_reset_draws(key, n, ENV, n_patrols)
    ps, _, pr = port_env.reset_batch(port_scene, ENV, _t(rid), draws=draws,
                                     gnss_noise=gnss)
    compare_traffic(js.traffic, ps.traffic, "reset")
    compare_poses(pr.npc_pose, jr.npc_pose, "npc_pose at reset")
    compare_poses(pr.walker_pose, jr.walker_pose, "walker_pose at reset")
    js, ps = _near_patrol_ends(js, ps, port_scene)

    step = jax.jit(lambda s, a: jax_env.step_batch(jax_scene, ENV, s, a))
    n_done = teleports = crossings = loops = 0
    for t in range(T):
        rngs = js.rng
        prev_head = ps.traffic.veh_head
        prev_whead = ps.traffic.walker_head
        prev_off_t = ps.traffic.walker_off_t
        js, jout = step(js, jnp.asarray(actions[t]))
        sd = jax_step_draws(rngs, jout.done, ENV, n_patrols)
        ps, pout = port_env.step_batch(port_scene, ENV, ps, _t(actions[t]),
                                       **sd._asdict())
        compare_traffic(js.traffic, ps.traffic, f"step {t}")
        np.testing.assert_array_equal(pout.done.numpy(),
                                      np.asarray(jout.done))
        for k in ("collision_vehicle", "collision_walker", "valeo_reward",
                  "desired_speed", "collision_intensity"):
            v = np.asarray(jout.info[k])
            if v.dtype.kind == "b":
                np.testing.assert_array_equal(pout.info[k].numpy(), v)
            else:
                np.testing.assert_allclose(pout.info[k].numpy(), v, **TOL)
        for k in ("npc_pose", "walker_pose"):
            compare_poses(getattr(pout.render, k), getattr(jout.render, k),
                          f"{k} at step {t}")
        live = ~pout.done[:, None]
        teleports += int(((ps.traffic.veh_head < prev_head) & live).sum())
        loops += int(((ps.traffic.walker_head < prev_whead) & live).sum())
        crossings += int(((ps.traffic.walker_off_t != prev_off_t)
                          & live).sum())
        n_done += int(pout.done.sum())
    assert n_done >= 4          # episodes ended and auto-reset
    assert teleports >= 4       # every env's vehicle 0 ran out of patrol
    assert crossings >= 1
    assert loops >= 4


def _near_patrol_ends(js, ps, scene):
    """Both states with vehicle 0 of each env moved 14 points before the
    end of its patrol (it teleports back within the test) and walker 0
    two points before the end of its polyline (it loops back)."""
    pxy = scene.patrol_xy.numpy()
    pyaw = scene.patrol_yaw.numpy()
    pn = scene.patrol_n.numpy()
    jt, pt = js.traffic, ps.traffic
    vp = np.asarray(jt.veh_patrol)
    vh = np.asarray(jt.veh_head).copy()
    vxy = np.asarray(jt.veh.xy).copy()
    vyaw = np.asarray(jt.veh.yaw).copy()
    wp = np.asarray(jt.walker_patrol)
    wh = np.asarray(jt.walker_head).copy()
    wxy = np.asarray(jt.walker_xy).copy()
    for e in range(vp.shape[0]):
        vh[e, 0] = pn[vp[e, 0]] - 14
        vxy[e, 0] = pxy[vp[e, 0], vh[e, 0]]
        vyaw[e, 0] = pyaw[vp[e, 0], vh[e, 0]]
        wh[e, 0] = pn[wp[e, 0]] - 3
        wxy[e, 0] = pxy[wp[e, 0], wh[e, 0]]
    js = js.replace(traffic=jt.replace(
        veh=jt.veh.replace(xy=vxy, yaw=vyaw), veh_head=vh,
        walker_head=wh, walker_xy=wxy))
    pt.veh.xy, pt.veh.yaw, pt.veh_head = _t(vxy), _t(vyaw), _t(vh)
    pt.walker_head, pt.walker_xy = _t(wh), _t(wxy)
    return js, ps


def _traffic_at(veh_pose, veh_speed, walker_pose, walker_speed):
    """A port TrafficState holding the given (N, K, 3) vehicle and
    (N, W, 3) walker poses."""
    n, K = veh_pose.shape[:2]
    W = walker_pose.shape[1]
    t = make_empty_traffic(n, K, W, "cpu")
    t.veh = VehicleState(xy=_t(veh_pose[..., :2]), yaw=_t(veh_pose[..., 2]),
                         speed=_t(veh_speed))
    t.walker_xy = _t(walker_pose[..., :2])
    t.walker_yaw = _t(walker_pose[..., 2])
    t.walker_speed = _t(walker_speed)
    return t


def _constructed_poses():
    """Ego poses and actor poses around them: overlapping boxes, near
    misses just outside the separating distance, actors ahead and behind
    in and out of the hazard cones, and exact-equal positions."""
    rng = np.random.default_rng(11)
    n, K, W = 64, 5, 4
    ego = np.stack([rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
                    rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    # offsets in the ego frame: a mix of overlaps (|x| < 4.9), near misses
    # (x ~ 4.9-5.2) and far actors
    lx = rng.choice([0.0, 2.0, 4.5, 4.95, 5.1, 8.0, 12.0, -6.0, 30.0], (n, K))
    ly = rng.choice([0.0, 1.0, 2.1, 2.2, 3.0, -2.0, 9.0], (n, K))
    lyaw = rng.choice([0.0, 0.3, np.pi / 2, np.pi, -2.8], (n, K))
    c, s = np.cos(ego[:, 2:3]), np.sin(ego[:, 2:3])
    veh = np.stack([ego[:, :1] + lx * c - ly * s,
                    ego[:, 1:2] + lx * s + ly * c,
                    ego[:, 2:3] + lyaw], -1).astype(np.float32)
    wx = rng.choice([0.0, 2.5, 2.9, 3.0, 6.0, 9.0, -1.0], (n, W))
    wy = rng.choice([0.0, 1.3, 1.5, 4.0, -8.0], (n, W))
    walker = np.stack([ego[:, :1] + wx * c - wy * s,
                       ego[:, 1:2] + wx * s + wy * c,
                       rng.uniform(-np.pi, np.pi, (n, W))],
                      -1).astype(np.float32)
    veh[:3, 0, :2] = ego[:3, :2]          # exact-equal positions
    walker[3:6, 1, :2] = ego[3:6, :2]
    return (ego, veh, rng.uniform(0, 8, (n, K)).astype(np.float32),
            walker, rng.uniform(1, 2, (n, W)).astype(np.float32),
            rng.uniform(0, 8, n).astype(np.float32))


def test_dynamic_collisions_and_hazards_match_jax():
    import jax
    from gail_carla_tpu.sim import collisions as jax_col
    from gail_carla_tpu.sim import rewards as jax_rew
    from gail_carla_tpu.sim.dynamics import DEFAULT_VEHICLE as jax_vehicle
    from gail_carla_tpu.sim.dynamics import VehicleState as JaxVehicle
    from gail_carla_tpu.sim.state import make_empty_traffic as jax_empty

    ego, veh, veh_speed, walker, walker_speed, ego_speed = (
        _constructed_poses())
    K, W = veh.shape[1], walker.shape[1]

    def jax_one(e, es, v, vs, w, ws):
        t = jax_empty(K, W).replace(
            veh=JaxVehicle(xy=v[:, :2], yaw=v[:, 2], speed=vs),
            walker_xy=w[:, :2], walker_yaw=w[:, 2], walker_speed=ws,
        )
        ev = JaxVehicle(xy=e[:2], yaw=e[2], speed=es)
        hits = jax_col.dynamic_collisions(t, jax_vehicle, ev)
        return (hits, jax_rew.hazard_vehicle(t, e[:2], e[2]),
                jax_rew.hazard_walker(t, e[:2], e[2]))

    want_hits, want_hv, want_hw = jax.vmap(jax_one)(
        ego, ego_speed, veh, veh_speed, walker, walker_speed)

    traffic = _traffic_at(veh, veh_speed, walker, walker_speed)
    ev = VehicleState(xy=_t(ego[:, :2]), yaw=_t(ego[:, 2]),
                      speed=_t(ego_speed))
    got = collisions.dynamic_collisions(traffic, DEFAULT_VEHICLE, ev)
    for name in ("veh", "ped", "veh_id", "ped_id"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want_hits, name)),
            err_msg=name)
    for name in ("veh_rel_speed", "ped_rel_speed"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want_hits, name)),
            rtol=1e-6, atol=1e-6, err_msg=name)
    for fn, want in ((rewards.hazard_vehicle, want_hv),
                     (rewards.hazard_walker, want_hw)):
        found, dist = fn(traffic, ev.xy, ev.yaw)
        np.testing.assert_array_equal(found.numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(dist.numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)
    # every case occurs: hits and misses of both kinds, several first ids
    assert 0 < int(got.veh.sum()) < len(ego)
    assert 0 < int(got.ped.sum()) < len(ego)
    assert len(np.unique(got.veh_id.numpy()[got.veh.numpy()])) >= 2
    assert 0 < int(rewards.hazard_vehicle(traffic, ev.xy, ev.yaw)[0].sum())
    assert 0 < int(rewards.hazard_walker(traffic, ev.xy, ev.yaw)[0].sum())


def test_unported_traffic_options_raise(scenes):
    """Every traffic option runs (the name is kept from when walkers on
    sidewalk centrelines raised): scenario actors
    (``tests/test_torch_scenario_actors.py``) and walkers on a scene's
    ``walk_*`` tables, here 5 patrol polylines handed in as sidewalk paths
    with signed crossing offsets: reset and 12 steps with JAX's draws
    injected equal JAX's traffic at the closed-loop test's tolerances (the
    reconstructed town's paths: ``tests/test_torch_town_env.py``)."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim import env as jax_env

    port_scene, jax_scene = scenes
    rid = torch.tensor([0, 1], dtype=torch.int32)
    sa = dataclasses.replace(ENV, n_scenario_actors=1)
    st, _, _ = port_env.reset_batch(port_scene, sa, rid)
    port_env.step_batch(port_scene, sa, st, torch.zeros((2, 2)))
    assert st.traffic.veh_patrol.shape == (2, ENV.n_npc_vehicles + 1)

    paths = 5
    cross = np.array([9.0, -9.0, 8.5, -8.5, 10.0], np.float32)
    walk = dict(walk_xy=port_scene.patrol_xy[:paths],
                walk_yaw=port_scene.patrol_yaw[:paths],
                walk_n=port_scene.patrol_n[:paths],
                walk_cross=torch.from_numpy(cross))
    sidewalks = dataclasses.replace(port_scene, **walk)
    jax_sidewalks = jax_scene.replace(
        **{k: jnp.asarray(v.numpy()) for k, v in walk.items()})
    n_patrols = port_scene.patrol_xy.shape[0]
    n = 4
    key = jax.random.PRNGKey(3)
    reset = jax.jit(lambda k, r: jax_env.reset_batch(jax_sidewalks, ENV,
                                                     k, r))
    js, _, _ = reset(key, jnp.asarray(np.arange(n) % 2))
    draws, gnss = jax_batch_reset_draws(key, n, ENV, n_patrols, paths)
    ps, _, _ = port_env.reset_batch(sidewalks, ENV,
                                    _t(np.arange(n, dtype=np.int32) % 2),
                                    draws=draws, gnss_noise=gnss)
    compare_traffic(js.traffic, ps.traffic, "reset on sidewalk paths")
    assert float(ps.traffic.walker_off.abs().max()) == 0.0
    assert int(ps.traffic.walker_patrol.max()) < paths
    step = jax.jit(lambda s, a: jax_env.step_batch(jax_sidewalks, ENV, s, a))
    step_draws = jax.jit(lambda r, d: jax_step_draws_raw(r, d, ENV,
                                                         n_patrols, paths))
    actions = np.tile(np.float32([[0.0, 0.5]]), (n, 1))
    for t in range(12):
        rngs = js.rng
        js, jout = step(js, jnp.asarray(actions))
        sd = step_draws_from_raw(step_draws(rngs, jout.done))
        ps, _ = port_env.step_batch(sidewalks, ENV, ps, _t(actions),
                                    **sd._asdict())
        compare_traffic(js.traffic, ps.traffic, f"sidewalk step {t}")
