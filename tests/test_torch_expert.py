"""The port's scripted expert against the JAX package's: the noisers, the
expert's decision (``autopilot_act``), the golden expert trace, and
``tests/test_env.py``'s expert tests on the port. The closed-loop demos
with noise are in ``tests/test_torch_demos.py``, which uses the helpers
here.

JAX's threefry draws are not torch's, so every draw the JAX functions
make (the reset's, each step's, the noisers') is recomputed from JAX's
keys and injected into the port (``DemoDraws``). Tolerances: the noiser's
state equal in every field (flags, counters, times, durations), its noise
1e-6 (XLA fuses multiply-adds inside the jitted step: an ulp of a value
below 1); ``autopilot_act`` 1e-5 on actions from placed poses (no closed
loop); the golden trace at ``tests/test_golden.py``'s tolerances (xy
1e-3, actions and metrics 1e-4), and JAX's run of it within 1e-4. The
JAX package is imported inside the tests only (read-only reference).
"""
import contextlib
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.agents import noiser as port_noiser
from gail_carla_tpu_torch.agents.autopilot import (
    _signal_speed, autopilot_act, reset_autopilot_where,
)
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.algo.expert import DemoDraws, generate_demos
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
# two short routes (107 m and 118 m) that the expert completes inside 300
# steps, so that valid and invalid demo rows both occur
SHORT = dict(n_routes=2, nx=2, ny=2, block=60.0, min_length=60.0)
# the smoke scene with 3 NPC vehicles and 3 walkers, 6-channel obs
TRAFFIC_ENV = dataclasses.replace(EnvConfig(train=False), obs_mode="bev6",
                                  bev_width=64, n_npc_vehicles=3,
                                  n_npc_walkers=3)
GOLDEN = pathlib.Path(__file__).parent / "golden_expert_route0.npz"


@contextlib.contextmanager
def single_torch_thread():
    """torch on one thread inside the block, restored after it: the
    simulator's tensors are a few elements wide, and with the test
    workers running side by side more threads only contend for the
    cores. Module-scoped fixtures run before ``one_torch_thread`` and
    use this themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread for each test (``single_torch_thread``)."""
    with single_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _scenes(kwargs):
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    return (make_benchmark_scene(**kwargs, device="cpu"),
            make_jax_scene(**kwargs))


@pytest.fixture(scope="module")
def smoke_scenes():
    return _scenes(PRESET["scene"])


def _noiser_step_draws(keys):
    """The draws of JAX's ``noiser_step`` from per-env keys."""
    import jax

    def one(k):
        k_coin, k_seed, k_amount = jax.random.split(k, 3)
        return (jax.random.randint(k_coin, (), 0, 2),
                jax.random.randint(k_seed, (), 0, 61),
                jax.random.randint(k_amount, (), 50, 201))

    return jax.vmap(one)(keys)


def _noiser_init_draws(keys):
    """The draws of JAX's ``make_noiser`` from per-env keys."""
    import jax

    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.randint(k1, (), -2, 3),
                jax.random.randint(k2, (), 50, 201))

    return port_noiser.NoiserInitDraws(*map(_t, jax.vmap(one)(keys)))


def jax_demo_draws(key, route_ids, n_steps, cfg, jax_scene, n_patrols,
                   jax_demos):
    """Every draw of JAX's ``generate_demos(key, route_ids, n_steps)`` as a
    port ``DemoDraws``. The env draws follow each env's key chain through
    its episode ends, read from the JAX demos: the step after an end
    starts at ``step == 0``. The last step's end is not needed: it only
    picks the key of a GNSS draw that no emitted row sees."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import reset_batch as jax_reset
    from test_torch_slice import _jax_rollout_draws
    from test_torch_traffic import jax_batch_reset_draws

    n = len(route_ids)
    rng, k_reset, k_n1, k_n2 = jax.random.split(key, 4)
    reset, gnss = jax_batch_reset_draws(k_reset, n, cfg, n_patrols)
    st, _, _ = jax_reset(jax_scene, cfg, k_reset,
                         jnp.asarray(route_ids, jnp.int32))
    step = np.asarray(jax_demos.render.step)
    dones = np.zeros((n_steps, n), bool)
    dones[:-1] = step[1:] == 0

    def per_step(k):
        k1, k2 = jax.random.split(k)
        return (_noiser_step_draws(jax.random.split(k1, n)),
                _noiser_step_draws(jax.random.split(k2, n)))

    thr, steer = jax.vmap(per_step)(jax.random.split(rng, n_steps))
    return DemoDraws(
        reset=reset, reset_gnss=gnss,
        throttle_init=_noiser_init_draws(jax.random.split(k_n1, n)),
        steer_init=_noiser_init_draws(jax.random.split(k_n2, n)),
        throttle=port_noiser.NoiserDraws(*map(_t, thr)),
        steer=port_noiser.NoiserDraws(*map(_t, steer)),
        env=_jax_rollout_draws(st.rng, dones, cfg, n_patrols),
    )


# the schedule's fields are flags, counters, times on the 0.1 s grid and
# durations on the 0.01 s grid: all must be equal
NOISER_FIELDS = ("active", "removing", "sec_count", "start_t", "end_t",
                 "mean", "intensity", "amount")


@pytest.mark.parametrize("schedule", [(15.0, 10.0, 2.0), (25.0, 4.0, 0.5)],
                         ids=["throttle", "steer"])
def test_noiser_matches_jax(schedule):
    """Both noise schedules over 400 steps of 8 envs: every state field,
    the apply flag and the noise after each step, then the noise applied
    to actions (the steer noise scaled by speed)."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.agents import noiser as jax_noiser

    freq, intensity, min_amount = schedule
    n, n_steps = 8, 400
    k_init, k_steps = jax.random.split(jax.random.PRNGKey(3))
    init_keys = jax.random.split(k_init, n)
    js = jax.vmap(lambda k: jax_noiser.make_noiser(k, intensity,
                                                   min_amount))(init_keys)
    ps = port_noiser.make_noiser(n, intensity, min_amount, "cpu",
                                 draws=_noiser_init_draws(init_keys))
    # the sim time is the float32 product step * dt, an input of the
    # jitted step (XLA cannot contract it into the differences)
    step = jax.jit(jax.vmap(lambda s, k, t: jax_noiser.noiser_step(
        s, k, t, freq, min_amount, 0.1)))
    rng = np.random.default_rng(0)
    n_on = n_rm_done = 0
    for i in range(n_steps):
        t = np.full(n, np.float32(i) * np.float32(0.1), np.float32)
        keys = jax.random.split(jax.random.fold_in(k_steps, i), n)
        js, j_apply, j_noise = step(js, keys, jnp.asarray(t))
        draws = port_noiser.NoiserDraws(*map(_t, _noiser_step_draws(keys)))
        amount_before = ps.amount
        ps, p_apply, p_noise = port_noiser.noiser_step(
            ps, _t(t), freq, min_amount, 0.1, draws)
        where = f"step {i}"
        for name in NOISER_FIELDS:
            np.testing.assert_array_equal(
                getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                err_msg=f"{name} at {where}")
        np.testing.assert_array_equal(p_apply.numpy(), np.asarray(j_apply))
        np.testing.assert_allclose(p_noise.numpy(), np.asarray(j_noise),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"noise at {where}")
        n_on += int(p_apply.sum())
        n_rm_done += int((ps.amount != amount_before).sum())

        action = np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1, n)],
                          1).astype(np.float32)
        kmh = rng.uniform(0.0, 30.0, n).astype(np.float32)
        want = jax.vmap(jax_noiser.apply_steer_noise)(
            jax.vmap(jax_noiser.apply_throttle_noise)(
                jnp.asarray(action), j_apply, j_noise),
            j_apply, j_noise, jnp.asarray(kmh))
        got = port_noiser.apply_steer_noise(
            port_noiser.apply_throttle_noise(_t(action), p_apply, p_noise),
            p_apply, p_noise, _t(kmh))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"noised action at {where}")
    # noise was on for a good share of the steps, and noise windows ended
    # and drew a new duration
    assert n_on > n * n_steps // 10 and n_rm_done >= n


def _stop_line_heads(scene, route_id):
    """Route points whose segment crosses a stop line."""
    from gail_carla_tpu_torch.sim import signals

    pts = scene.route_xy[route_id, :int(scene.route_n[route_id])]
    a, b = pts[:-1, None], pts[1:, None]
    inter = signals.segments_intersect(a, b, scene.tl_stop[None, :, 0],
                                       scene.tl_stop[None, :, 1])
    return torch.nonzero(inter[:, :scene.tl_n].any(1))[:, 0].numpy()


@pytest.mark.parametrize("obey", [False, True], ids=["plain", "obey"])
def test_autopilot_act_matches_jax(smoke_scenes, obey):
    """``autopilot_act`` on 6 envs with 3 NPC vehicles and 3 walkers for
    40 calls from placed poses: half of the egos 5-60 route points before
    a stop line at random sim times (every light phase), random active or
    completed stop signs, the first vehicle and walker placed ahead of the
    ego. The controller state carries over between calls (the PIDs' ring
    buffers wrap), and episode ends reset it."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.agents import autopilot as jax_ap
    from gail_carla_tpu.sim.env import reset_batch as jax_reset
    from test_torch_traffic import jax_batch_reset_draws

    port_scene, jax_scene = smoke_scenes
    cfg = TRAFFIC_ENV
    n, n_calls = 6, 40
    rid = np.array([0, 1, 0, 1, 0, 1], np.int32)
    key = jax.random.PRNGKey(11)
    js, _, _ = jax_reset(jax_scene, cfg, key, jnp.asarray(rid))
    draws, gnss = jax_batch_reset_draws(key, n, cfg,
                                        port_scene.patrol_xy.shape[0])
    ps, _, _ = port_env.reset_batch(port_scene, cfg, _t(rid), draws=draws,
                                    gnss_noise=gnss)
    jap = jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape),
                       jax_ap.make_autopilot())
    pap = make_autopilot((n,), "cpu")
    act = jax.jit(jax.vmap(lambda a, w: jax_ap.autopilot_act(
        jax_scene, a, w, 6.0, obey)))
    reset = jax.jit(jax.vmap(jax_ap.reset_autopilot_where))

    rng = np.random.default_rng(2)
    route_xy = port_scene.route_xy.numpy()
    route_yaw = port_scene.route_yaw.numpy()
    route_n = port_scene.route_n.numpy()
    lines = {r: _stop_line_heads(port_scene, r) for r in (0, 1)}
    n_capped = 0
    for c in range(n_calls):
        head = np.empty(n, np.int32)
        for e in range(n):
            if e % 2 == 0 and len(lines[rid[e]]):
                head[e] = max(rng.choice(lines[rid[e]]) - rng.integers(5, 60),
                              0)
            else:
                head[e] = rng.integers(0, route_n[rid[e]] - 1)
        xy = (route_xy[rid, head] + rng.normal(0, 0.8, (n, 2))
              ).astype(np.float32)
        yaw = (route_yaw[rid, head] + rng.normal(0, 0.1, n)
               ).astype(np.float32)
        speed = rng.uniform(0.0, 7.0, n).astype(np.float32)
        step = rng.integers(0, 480, n).astype(np.int32)
        stop_target = rng.integers(-1, port_scene.ss_n, n).astype(np.int32)
        stop_done = rng.uniform(0, 1, n) < 0.3
        fwd = np.stack([np.cos(yaw), np.sin(yaw)], 1)
        veh_xy = np.array(ps.traffic.veh.xy)
        veh_xy[:, 0] = xy + fwd * rng.uniform(5, 45, (n, 1))
        veh_yaw = np.array(ps.traffic.veh.yaw)
        veh_yaw[:, 0] = yaw
        wk_xy = np.array(ps.traffic.walker_xy)
        wk_xy[:, 0] = xy + fwd * rng.uniform(5, 25, (n, 1))

        js = js.replace(
            ego=js.ego.replace(xy=jnp.asarray(xy), yaw=jnp.asarray(yaw),
                               speed=jnp.asarray(speed)),
            head=jnp.asarray(head), step=jnp.asarray(step),
            stop_target=jnp.asarray(stop_target),
            stop_completed=jnp.asarray(stop_done),
            traffic=js.traffic.replace(
                veh=js.traffic.veh.replace(xy=jnp.asarray(veh_xy),
                                           yaw=jnp.asarray(veh_yaw)),
                walker_xy=jnp.asarray(wk_xy)),
        )
        ps = dataclasses.replace(
            ps, ego=dataclasses.replace(ps.ego, xy=_t(xy), yaw=_t(yaw),
                                        speed=_t(speed)),
            head=_t(head), step=_t(step), stop_target=_t(stop_target),
            stop_completed=_t(stop_done),
            traffic=dataclasses.replace(
                ps.traffic,
                veh=dataclasses.replace(ps.traffic.veh, xy=_t(veh_xy),
                                        yaw=_t(veh_yaw)),
                walker_xy=_t(wk_xy)),
        )
        jap, jaction = act(jap, js)
        pap, paction = autopilot_act(port_scene, pap, ps, 6.0, obey)
        np.testing.assert_allclose(paction.numpy(), np.asarray(jaction),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"action at call {c}")
        np.testing.assert_array_equal(pap.last_command.numpy(),
                                      np.asarray(jap.last_command))
        for pid in ("turn_pid", "speed_pid"):
            np.testing.assert_allclose(
                getattr(pap, pid).buf.numpy(),
                np.asarray(getattr(jap, pid).buf), rtol=1e-5, atol=1e-5,
                err_msg=f"{pid} at call {c}")
        done = rng.uniform(0, 1, n) < 0.1
        jap = reset(jnp.asarray(done), jap)
        pap = reset_autopilot_where(_t(done), pap)
        capped = _signal_speed(port_scene, ps, torch.full((n,), 6.0))
        n_capped += int((capped < 6.0).sum())
    # the signal and hazard caps bound the speed in many placements
    assert n_capped >= n * n_calls // 4


def _run_both(kwargs, cfg, route_ids, n_steps, seed, with_noise, obey):
    """JAX's ``generate_demos`` and the port's with JAX's draws injected."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.expert import generate_demos as jax_demos

    port_scene, jax_scene = _scenes(kwargs)
    key = jax.random.PRNGKey(seed)
    want = jax_demos(jax_scene, cfg, key, jnp.asarray(route_ids, jnp.int32),
                     n_steps, with_noise=with_noise, obey_signals=obey)
    draws = jax_demo_draws(key, route_ids, n_steps, cfg, jax_scene,
                           port_scene.patrol_xy.shape[0], want)
    got = generate_demos(port_scene, cfg, None, route_ids, n_steps,
                         with_noise=with_noise, obey_signals=obey,
                         draws=draws)
    return got, want


def _first_divergence(got, want):
    """Per env, the first step whose action or metrics differ by more than
    1e-4, whose position differs by more than 1e-4 or whose route cursor
    differs (T if none): every row before it agrees within those
    tolerances. ``valid`` is compared for the envs that never diverge."""
    T, n = got.actions.shape[:2]

    def err(a, b):
        return np.abs(a.numpy() - np.asarray(b)).reshape(T, n, -1).max(-1)

    bad = ((err(got.actions, want.actions) > 1e-4)
           | (err(got.metrics, want.metrics) > 1e-4)
           | (err(got.render.xy, want.render.xy) > 1e-4)
           | (got.render.head.numpy() != np.asarray(want.render.head)))
    first = [int(np.argmax(bad[:, e])) if bad[:, e].any() else T
             for e in range(n)]
    for e in range(n):
        if first[e] == T:
            np.testing.assert_array_equal(got.valid[:, e].numpy(),
                                          np.asarray(want.valid)[:, e])
    return first


def test_generate_demos_reproduces_golden_trace():
    """The port reproduces ``tests/golden_expert_route0.npz`` (the expert
    without noise on route 0 of the smoke scene, 300 steps, JAX's reset
    draws from ``PRNGKey(42)``) to ``tests/test_golden.py``'s
    tolerances, and JAX's run at every step."""
    got, want = _run_both(PRESET["scene"], EnvConfig(train=False), [0], 300,
                          42, False, False)
    gold = np.load(GOLDEN)
    np.testing.assert_allclose(got.render.xy[:, 0].numpy(), gold["xy"],
                               atol=1e-3)
    np.testing.assert_allclose(got.actions[:, 0].numpy(), gold["actions"],
                               atol=1e-4)
    np.testing.assert_allclose(got.metrics[:, 0].numpy(), gold["metrics"],
                               atol=1e-4)
    assert _first_divergence(got, want) == [300]


# tests/test_env.py's expert tests, on the port
@pytest.fixture(scope="module")
def env_scene():
    return make_benchmark_scene(n_routes=3, nx=3, ny=3, block=80.0,
                                min_length=200.0, device="cpu")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_expert_completes_routes(env_scene):
    demos = generate_demos(env_scene, EnvConfig(train=False), _gen(5),
                           [0, 1, 2], 1000, with_noise=False)
    valid = demos.valid.numpy()
    assert valid.any(axis=0).all(), "some route never completed"
    assert float(demos.metrics[..., 2].max()) > 5.0
    act = demos.actions.numpy()
    assert (np.abs(act[..., 0]) <= 1.0).all()
    assert (act[..., 1] >= 0.0).all() and (act[..., 1] <= 1.0).all()


def test_expert_with_noise_still_completes(env_scene):
    demos = generate_demos(env_scene, EnvConfig(train=False), _gen(6),
                           [0, 0], 1000, with_noise=True)
    assert demos.valid.any(), "noisy expert never completed the route"


def test_determinism(env_scene):
    cfg = EnvConfig(train=True)
    out1 = generate_demos(env_scene, cfg, _gen(8), [0], 200)
    out2 = generate_demos(env_scene, cfg, _gen(8), [0], 200)
    assert torch.equal(out1.actions, out2.actions)
    assert torch.equal(out1.metrics, out2.metrics)
