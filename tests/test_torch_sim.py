"""The port's batched simulator against the JAX package's ``step_batch``.

Reset, then 200 steps on routes 0 and 1 of the smoke-preset scene at
``bev_width=64`` under fixed numpy actions, with the default randomness
switched on (GNSS noise, 10% random restarts). JAX's threefry draws are
not torch's, so every draw the JAX envs make (restart coin and position,
GNSS noise) is recomputed from the JAX state's key and injected into the
port's step. Discrete fields must be equal; positions, rewards and the
other float fields agree within 1e-4 (ulp-level differences between the
two libraries' sin/cos/atan2 and tan/atan, accumulated over the steps).
The JAX package is imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
TOL = dict(rtol=1e-4, atol=1e-4)
DISCRETE = (
    "route_id", "head", "last_head", "start_idx", "plan_idx", "stop_target",
    "stop_completed", "stop_affected", "encountered_light",
    "last_red_light", "last_cross_light", "speed_q_len", "stuck_counter",
    "col_id", "n_col_static", "n_col_vehicle", "n_col_walker", "n_red",
    "n_stop", "n_enc_light", "n_enc_stop", "step", "resume_idx",
    "completed_last",
)
FLOATS = (
    "last_steer", "s0", "route_len_ep", "blocked_elapsed", "out_route_dist",
    "speed_q", "last_lat_dist", "col_xy", "col_time", "outside_lane_m",
    "wrong_lane_m", "episode_reward", "last_total",
)


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    return (make_benchmark_scene(**PRESET["scene"], device="cpu"),
            make_jax_scene(**PRESET["scene"]))


def _t(a):
    return torch.from_numpy(np.array(a))


def _reset_draws(keys):
    """The draws ``reset_batch`` makes from per-env keys: (restart coin,
    restart position, GNSS noise of the first observe)."""
    import jax

    def one(key):
        rng, k_restart, k_pos, _ = jax.random.split(key, 4)
        _, k = jax.random.split(rng)
        return (jax.random.uniform(k_restart), jax.random.uniform(k_pos),
                jax.random.normal(k, (2,)))

    return jax.vmap(one)(keys)


def _step_draws(rngs, done):
    """The draws ``step_env`` makes from each env's pre-step key: the
    auto-reset's restart coin and position, and the GNSS noise of the
    observe after the (possible) reset."""
    import jax
    import jax.numpy as jnp

    def one(r, d):
        rng_next, k_reset, _ = jax.random.split(r, 3)
        fresh, k_restart, k_pos, _ = jax.random.split(k_reset, 4)
        _, k = jax.random.split(jnp.where(d, fresh, rng_next))
        return (jax.random.uniform(k_restart), jax.random.uniform(k_pos),
                jax.random.normal(k, (2,)))

    return jax.vmap(one)(rngs, done)


def _compare_states(js, ps, where):
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=f"{name} at {where}")
    for name in FLOATS:
        np.testing.assert_allclose(
            getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=f"{name} at {where}", **TOL)
    for name in ("xy", "yaw", "speed"):
        np.testing.assert_allclose(
            getattr(ps.ego, name).numpy(), np.asarray(getattr(js.ego, name)),
            err_msg=f"ego.{name} at {where}", **TOL)


def test_reset_env_matches_jax_with_injected_draws(scenes):
    """The resume curriculum: restart at 0 after completion, at a random
    route point with the restart probability, else resume."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import reset_env

    port_scene, jax_scene = scenes
    cfg = dataclasses.replace(PRESET["env"], random_restart_prob=0.5)
    n = 16
    rng = np.random.default_rng(0)
    rid = (np.arange(n) % 2).astype(np.int32)
    resume = rng.integers(0, 400, n).astype(np.int32)
    completed = rng.uniform(size=n) < 0.3
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    want = jax.vmap(lambda k, r, s, c: reset_env(jax_scene, cfg, k, r, s, c))(
        keys, jnp.asarray(rid), jnp.asarray(resume), jnp.asarray(completed))
    restart, pos, _ = _reset_draws(keys)
    got = port_env.reset_env(
        port_scene, cfg, _t(rid), _t(resume), _t(completed),
        draws=port_env.ResetDraws(_t(restart), _t(pos)),
    )
    _compare_states(want, got, "reset")
    # every branch of the curriculum is taken
    start = got.start_idx.numpy()
    assert (start == 0).any() and (start == np.minimum(
        resume, port_scene.route_n.numpy()[rid] - 20)).any()
    assert ((start != 0) & (start != resume)).any()


@pytest.mark.parametrize("reward_mode,terminal_mode", [
    ("delta_completion", "leaderboard"),   # what training optimises
    ("valeo", "valeo"),                    # the shaped reward + terminal
])
def test_step_batch_200_steps_matches_jax(scenes, reward_mode,
                                          terminal_mode):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim import env as jax_env

    port_scene, jax_scene = scenes
    cfg = dataclasses.replace(PRESET["env"], reward_mode=reward_mode,
                              terminal_mode=terminal_mode)
    rid = np.array([0, 1, 0, 1], np.int32)
    n, T = len(rid), 200
    rng = np.random.default_rng(1)
    actions = np.stack([rng.uniform(-0.3, 0.3, (T, n)),
                        rng.uniform(0.2, 1.0, (T, n))], -1).astype(np.float32)
    actions[:, 2, 0] = 0.9         # steers off the road: collisions
    actions[100:, 3, 1] = 0.0      # stops: blocked criterion

    key = jax.random.PRNGKey(0)
    js, jm, jr = jax_env.reset_batch(jax_scene, cfg, key, jnp.asarray(rid))
    restart, pos, gnss = _reset_draws(jax.random.split(key, n))
    ps, pm, pr = port_env.reset_batch(
        port_scene, cfg, _t(rid),
        draws=port_env.ResetDraws(_t(restart), _t(pos)), gnss_noise=_t(gnss),
    )
    _compare_states(js, ps, "reset")
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **TOL)

    step = jax.jit(lambda s, a: jax_env.step_batch(jax_scene, cfg, s, a))
    n_done = 0
    for t in range(T):
        rngs = js.rng
        js, jout = step(js, jnp.asarray(actions[t]))
        restart, pos, gnss = _step_draws(rngs, jout.done)
        ps, pout = port_env.step_batch(
            port_scene, cfg, ps, _t(actions[t]),
            reset_draws=port_env.ResetDraws(_t(restart), _t(pos)),
            gnss_noise=_t(gnss),
        )
        _compare_states(js, ps, f"step {t}")
        np.testing.assert_array_equal(pout.done.numpy(),
                                      np.asarray(jout.done))
        np.testing.assert_allclose(pout.reward.numpy(),
                                   np.asarray(jout.reward), **TOL)
        np.testing.assert_allclose(pout.metrics.numpy(),
                                   np.asarray(jout.metrics), **TOL)
        for k, v in jout.info.items():
            v = np.asarray(v)
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(
                    pout.info[k].numpy(), v, err_msg=f"{k} at step {t}")
            else:
                np.testing.assert_allclose(
                    pout.info[k].numpy(), v, err_msg=f"{k} at step {t}",
                    **TOL)
        n_done += int(pout.done.sum())
    # episodes ended and auto-reset along the way
    assert n_done >= 4


# the env modes the other parity tests do not pin: the terminal modes
# valeo_nodetpx and leaderboard_dagger (with and without NPC traffic),
# evaluation mode (no route-resume curriculum), the valeo reward emitted
# beside the training reward, and the valeo reward without the
# exploration suggestion
STEP_MODES = {
    "valeo_nodetpx": dict(reward_mode="valeo", terminal_mode="valeo_nodetpx"),
    "dagger": dict(terminal_mode="leaderboard_dagger"),
    "dagger_traffic": dict(terminal_mode="leaderboard_dagger",
                           n_npc_vehicles=3, n_npc_walkers=3),
    "eval": dict(train=False),
    "valeo_reward_info": dict(compute_valeo_reward=True),
    "no_exploration_suggest": dict(reward_mode="valeo",
                                   terminal_mode="valeo",
                                   exploration_suggest=False),
}


@pytest.mark.parametrize("mode", list(STEP_MODES))
def test_step_batch_modes_match_jax(scenes, mode):
    """40 steps of 4 envs with 2 s episodes in each mode of
    ``STEP_MODES``, every draw of the JAX envs injected (reset, GNSS,
    traffic spawns and crossing coins): the same comparisons as the
    200-step test, plus the traffic state where there are NPCs."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim import env as jax_env
    from test_torch_traffic import (
        compare_traffic, jax_batch_reset_draws, jax_step_draws,
    )

    port_scene, jax_scene = scenes
    cfg = dataclasses.replace(PRESET["env"], max_time=2.0,
                              **STEP_MODES[mode])
    n_patrols = port_scene.patrol_xy.shape[0]
    traffic = cfg.n_npc_vehicles > 0
    rid = np.array([0, 1, 0, 1], np.int32)
    n, T = len(rid), 40
    rng = np.random.default_rng(2)
    actions = np.stack([rng.uniform(-0.3, 0.3, (T, n)),
                        rng.uniform(0.2, 1.0, (T, n))], -1).astype(np.float32)
    actions[:, 2, 0] = 0.9         # steers off the road: collisions
    actions[10:, 3, 1] = 0.0       # stops: blocked criterion

    key = jax.random.PRNGKey(1)
    js, jm, _ = jax_env.reset_batch(jax_scene, cfg, key, jnp.asarray(rid))
    draws, gnss = jax_batch_reset_draws(key, n, cfg, n_patrols)
    ps, pm, _ = port_env.reset_batch(port_scene, cfg, _t(rid), draws=draws,
                                     gnss_noise=gnss)
    _compare_states(js, ps, "reset")
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **TOL)

    step = jax.jit(lambda s, a: jax_env.step_batch(jax_scene, cfg, s, a))
    n_done = 0
    for t in range(T):
        rngs = js.rng
        js, jout = step(js, jnp.asarray(actions[t]))
        sd = jax_step_draws(rngs, jout.done, cfg, n_patrols)
        ps, pout = port_env.step_batch(port_scene, cfg, ps, _t(actions[t]),
                                       **sd._asdict())
        _compare_states(js, ps, f"step {t}")
        if traffic:
            compare_traffic(js.traffic, ps.traffic, f"step {t}")
        np.testing.assert_array_equal(pout.done.numpy(),
                                      np.asarray(jout.done))
        np.testing.assert_allclose(pout.reward.numpy(),
                                   np.asarray(jout.reward), **TOL)
        np.testing.assert_allclose(pout.metrics.numpy(),
                                   np.asarray(jout.metrics), **TOL)
        assert set(pout.info) == set(jout.info)
        for k, v in jout.info.items():
            v = np.asarray(v)
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(
                    pout.info[k].numpy(), v, err_msg=f"{k} at step {t}")
            else:
                np.testing.assert_allclose(
                    pout.info[k].numpy(), v, err_msg=f"{k} at step {t}",
                    **TOL)
        n_done += int(pout.done.sum())
    assert n_done >= 4


def test_local_planner_act_matches_jax(scenes):
    """The NPCs' LocalPlanner on the patrol tables, (4 envs, 3 vehicles)
    at once, for 40 calls: the PIDs' 30-sample ring buffer wraps, and the
    20-point window near a row's end is shifted back into the row as
    ``dynamic_slice`` shifts it. Poses are drawn anew for every call (no
    closed loop), so states and actions agree to 1e-5."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.agents.autopilot import (
        local_planner_act as jax_act,
    )
    from gail_carla_tpu.agents.controllers import make_autopilot
    from gail_carla_tpu.sim.dynamics import VehicleState as JaxVehicle

    from gail_carla_tpu_torch.agents.autopilot import local_planner_act
    from gail_carla_tpu_torch.agents.controllers import (
        make_autopilot as port_make_autopilot,
    )

    port_scene, jax_scene = scenes
    n, k = 4, 3
    rng = np.random.default_rng(5)
    pxy = port_scene.patrol_xy.numpy()
    pn = port_scene.patrol_n.numpy()
    L = pxy.shape[1]
    pat = rng.integers(0, pxy.shape[0], (n, k)).astype(np.int32)
    head = (rng.uniform(0, 1, (n, k)) * (pn[pat] - 1)).astype(np.int32)
    head[0] = [L - 1, L - 5, pn[pat[0, 2]] - 2]     # windows past the end
    speed = rng.uniform(4.5, 6.5, (n, k)).astype(np.float32)

    ap0 = make_autopilot()
    jap = jax.tree.map(lambda a: jnp.broadcast_to(a, (n * k,) + a.shape),
                       ap0)
    pap = port_make_autopilot((n, k), "cpu")
    step = jax.jit(jax.vmap(
        lambda a, xy, yaw, v, p, h, ts: jax_act(
            jax_scene.patrol_xy, jax_scene.patrol_cmd, a,
            JaxVehicle(xy=xy, yaw=yaw, speed=v), p, h, ts)))
    for t in range(40):
        h = np.minimum(head + t // 4, L - 1).astype(np.int32)
        xy = (pxy[pat, np.minimum(h, pn[pat] - 1)]
              + rng.normal(0.0, 3.0, (n, k, 2))).astype(np.float32)
        yaw = rng.uniform(-np.pi, np.pi, (n, k)).astype(np.float32)
        v = rng.uniform(0.0, 7.0, (n, k)).astype(np.float32)
        jap, jaction = step(jap, xy.reshape(-1, 2), yaw.reshape(-1),
                            v.reshape(-1), pat.reshape(-1), h.reshape(-1),
                            speed.reshape(-1))
        pap, paction = local_planner_act(
            port_scene.patrol_xy, port_scene.patrol_cmd, pap, _t(xy),
            _t(yaw), _t(v), _t(pat), _t(h), _t(speed))
        np.testing.assert_allclose(
            paction.numpy().reshape(-1, 2), np.asarray(jaction),
            rtol=1e-5, atol=1e-5, err_msg=f"action at call {t}")
        np.testing.assert_array_equal(
            pap.last_command.numpy().reshape(-1),
            np.asarray(jap.last_command), err_msg=f"command at call {t}")
        for name in ("turn_pid", "speed_pid"):
            jp, pp = getattr(jap, name), getattr(pap, name)
            for f in ("idx", "count"):
                np.testing.assert_array_equal(
                    getattr(pp, f).numpy().reshape(-1),
                    np.asarray(getattr(jp, f)), err_msg=f"{name}.{f}")
            np.testing.assert_allclose(
                pp.buf.numpy().reshape(n * k, -1), np.asarray(jp.buf),
                rtol=1e-5, atol=1e-5, err_msg=f"{name}.buf at call {t}")
    assert int(pap.turn_pid.count.min()) == 30      # the window is full
