"""The port's GPS-space expert (``agents/gps_autopilot.py``) against the
JAX package's ``gps_autopilot_act``, and its route progress.

Parity: JAX's expert, vmapped over envs and jitted (as its test runs it),
drives ``step_batch`` for ``STEPS`` steps; the port's batched expert is
fed the same world states step by step and carries its own controller
state, with JAX's steer draws injected. Actions, both PIDs' windows and
the plan cursor are compared at every step, up to the first step where
ulp differences of the two compiled arithmetics flip a plan-window
decision (a distance within float32 rounding of its threshold). The
scene is the reference preset's (plans padded to 32 points; routes 0 and
6 have 29), and one env starts its cursor near the end of route 0's
plan, where the 8-point window's start clamps and the window no longer
lines up with its indices. Tolerance 1e-5 on actions and PID values
(the PID sums its window in another order; XLA contracts multiply-adds
inside jit).
The JAX package is imported inside the tests only (read-only reference).
"""
import types

import numpy as np
import torch

from gail_carla_tpu_torch.agents.gps_autopilot import (
    GPS_PID_WINDOW, MAX_DIST_DEG, MIN_DIST_DEG, PLAN_WINDOW,
    gps_autopilot_act, make_gps_autopilot,
)
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import reset_batch, step_batch
from gail_carla_tpu_torch.sim.transforms import location_to_gps
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

# tests/test_agents_extra.py's scene, and the reference preset's
SCENE = dict(n_routes=2, nx=3, ny=3, block=80.0, min_length=150.0)
REF_SCENE = dict(n_routes=10, nx=4, ny=4, block=100.0, min_length=400.0)
ROUTES = (0, 1, 2, 3, 0)
STEPS = 200
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_run(jax_scene, ap0, routes, n_steps):
    """JAX's expert on ``routes`` for ``n_steps`` closed-loop steps (reset
    key 0, steer keys from key 1): per step the world it saw (ego xy,
    yaw, speed, route ids), its steer draws, its action and its new
    controller state."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.agents.gps_autopilot import (
        gps_autopilot_act as jax_act,
    )
    from gail_carla_tpu.sim.env import reset_batch as jax_reset
    from gail_carla_tpu.sim.env import step_batch as jax_step

    cfg = EnvConfig(train=False)
    states, _, _ = jax_reset(jax_scene, cfg, jax.random.PRNGKey(0),
                             jnp.asarray(routes, jnp.int32))
    act = jax.vmap(jax_act, in_axes=(None, 0, 0, 0))

    @jax.jit
    def run(states, ap, keys):
        def body(carry, k):
            states, ap = carry
            ap2, action = act(jax_scene, ap, states, k)
            states2, _ = jax_step(jax_scene, cfg, states, action)
            seen = (states.ego.xy, states.ego.yaw, states.ego.speed,
                    states.route_id)
            noise = jax.vmap(jax.random.normal)(k)
            return (states2, ap2), (seen, noise, action, ap2)
        return jax.lax.scan(body, (states, ap), keys)[1]

    keys = jax.random.split(jax.random.PRNGKey(1), n_steps * len(routes))
    keys = keys.reshape(n_steps, len(routes), -1)
    return jax.tree.map(np.asarray, run(states, ap0, keys))


def _jax_ap0(n, near_idx):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.agents.gps_autopilot import make_gps_autopilot as mk

    ap = jax.tree.map(lambda a: jnp.stack([a] * n), mk())
    return ap.replace(near_idx=jnp.asarray(near_idx, jnp.int32))


def _flip_at(jax_scene, seen, near_idx_prev, step, env):
    """True when a pop decision of JAX's window at ``step`` for ``env``
    sat within float32 rounding of its threshold (a distance to a plan
    point against the pop distance, or a cumulative plan distance against
    the look-ahead)."""
    xy, rid = seen[0][step, env], int(seen[3][step, env])
    plan = np.asarray(jax_scene.plan_gps)[rid]
    start = min(int(near_idx_prev), plan.shape[0] - PLAN_WINDOW)
    window = plan[start:start + PLAN_WINDOW]
    gps = location_to_gps(_t(xy)[None]).numpy()[0]
    d = np.linalg.norm(window - gps, axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(window[1:] - window[:-1], axis=-1))])
    near = lambda v, th: np.abs(v - th) <= 1e-5 * th  # noqa: E731
    return bool(near(d, MIN_DIST_DEG).any() or near(cum, MAX_DIST_DEG).any())


def test_gps_autopilot_matches_jax():
    """Per step for ``STEPS`` steps: actions, the turn and speed PIDs'
    windows, counters and last errors, and the plan cursor. Env 4 starts
    its cursor three points before the end of route 0's plan (the clamped
    window)."""
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    jax_scene = make_jax_scene(**REF_SCENE)
    scene = make_benchmark_scene(**REF_SCENE, device="cpu")
    pn = scene.plan_n.numpy()
    routes = list(ROUTES)
    near0 = [1, 1, 1, 1, int(pn[0]) - 3]
    # the window's start clamps: it would run past the padded plan
    assert near0[4] + PLAN_WINDOW > scene.plan_gps.shape[1]
    seen, noise, want_act, want_ap = _jax_run(
        jax_scene, _jax_ap0(len(routes), near0), routes, STEPS)

    ap = make_gps_autopilot(len(routes))
    ap.near_idx = torch.tensor(near0, dtype=torch.int32)
    compared, worst = STEPS, 0.0
    for t in range(STEPS):
        world = types.SimpleNamespace(
            ego=types.SimpleNamespace(xy=_t(seen[0][t]), yaw=_t(seen[1][t]),
                                      speed=_t(seen[2][t])),
            route_id=_t(seen[3][t]))
        prev_idx = ap.near_idx.clone()
        ap, action = gps_autopilot_act(scene, ap, world,
                                       noise=_t(noise[t]))
        want_idx = want_ap.near_idx[t]
        if not np.array_equal(ap.near_idx.numpy(), want_idx):
            bad = np.flatnonzero(ap.near_idx.numpy() != want_idx)
            assert all(_flip_at(jax_scene, seen, prev_idx[e], t, e)
                       for e in bad), f"step {t}: cursor {ap.near_idx} vs " \
                                      f"{want_idx}"
            compared = t
            break
        np.testing.assert_allclose(action.numpy(), want_act[t],
                                   err_msg=f"step {t}", **TOL)
        worst = max(worst, float(np.abs(action.numpy() - want_act[t]).max()))
        for name in ("turn_pid", "speed_pid"):
            got, want = getattr(ap, name), getattr(want_ap, name)
            for f in ("buf", "prev"):
                np.testing.assert_allclose(
                    getattr(got, f).numpy(), getattr(want, f)[t],
                    err_msg=f"step {t} {name}.{f}", **TOL)
            for f in ("idx", "count"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              getattr(want, f)[t])
    print(f"compared {compared} of {STEPS} steps (worst action |diff| "
          f"{worst:.3g}); cursor advanced "
          f"{(want_ap.near_idx[compared - 1] - near0).tolist()}")
    assert compared >= STEPS // 2
    # the cursor moved on the normal starts and reached the plan's last
    # target from the clamped one
    assert (want_ap.near_idx[compared - 1][:4] > 1).all()
    assert want_ap.near_idx[compared - 1][4] == pn[0] - 2
    assert GPS_PID_WINDOW < compared


def test_gps_autopilot_makes_route_progress():
    """tests/test_agents_extra.py::test_gps_autopilot_makes_route_progress
    on the port: one env on route 0 for 600 steps makes more than 100 m
    of route progress."""
    scene = make_benchmark_scene(**SCENE, device="cpu")
    cfg = EnvConfig(train=False)
    gen = torch.Generator()
    gen.manual_seed(0)
    states, _, _ = reset_batch(scene, cfg, torch.zeros(1, dtype=torch.int32),
                               gen)
    ap = make_gps_autopilot(1)
    best = 0.0
    for _ in range(600):
        ap, action = gps_autopilot_act(scene, ap, states, gen)
        states, out = step_batch(scene, cfg, states, action, gen)
        best = max(best, float(out.info["route_completed_in_m"][0]))
    # the GPS expert targets 4 m/s and follows the sparse plan; it must
    # make substantial progress without leaving the route
    assert best > 100.0, best
