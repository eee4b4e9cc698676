"""The port's gym-style env API against the JAX package's: the task
suites (scenes array for array, configs field by field, task lists), the
registry, ``DrivingEnv`` (plain and ``obs_dict=True``), ``VecEnv``
against ``TpuVecEnv`` and ``EnvMonitor``'s CSV rows.

The suites' numpy draws (``default_rng(seed)``) are the same in both
packages, so their scenes must be equal. JAX's threefry draws are not
torch's, so every draw the JAX envs make is recomputed from their keys
and injected into the port (``tests/test_torch_traffic.py``'s helpers).
Tolerances: observations 0 values differ, metrics, reward and float info
values 1e-4 (``test_torch_traffic.py``'s), discrete info values equal,
``observe_full``'s floats 1e-5. The JAX package is imported inside the
tests only (read-only reference).
"""
import dataclasses
import random

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_expert import single_torch_thread
from test_torch_traffic import (
    TrafficResetDraws, _t, jax_batch_reset_draws, jax_reset_draws,
    jax_step_draws_raw, step_draws_from_raw,
)

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.envs import registry, suites
from gail_carla_tpu_torch.envs.gym_env import DrivingEnv
from gail_carla_tpu_torch.envs.vec_env import VecEnv
from gail_carla_tpu_torch.scene.scene import TorchScene, make_benchmark_scene
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.sim.weather import make_weather
from gail_carla_tpu_torch.utils.monitor import EnvEpoch, EnvMonitor

TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_envs_api.py's scene
API_SCENE = dict(n_routes=2, nx=3, ny=3, block=80.0, min_length=150.0)
TIERS = ("empty", "regular", "dense", "leaderboard")
CORL_TYPES = ("straight", "one_curve", "navigation", "navigation_dynamic")


def assert_scenes_equal(port: TorchScene, ref):
    """Every field of a port scene equal to the JAX scene's."""
    names = {f.name for f in dataclasses.fields(TorchScene)}
    assert names == {f.name for f in dataclasses.fields(ref)}
    for name in sorted(names):
        a, b = getattr(ref, name), getattr(port, name)
        if a is None:
            assert b is None, name
        elif isinstance(b, torch.Tensor):
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        else:
            assert a == b, name


def assert_suites_equal(port, ref):
    (ps, pc, pt), (js, jc, jt) = port, ref
    assert_scenes_equal(ps, js)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pt == jt


@pytest.fixture(scope="module")
def nocrash():
    """The NoCrash grid suite of both packages, built once: every tier
    shares the seed-2021 grid scene."""
    from gail_carla_tpu.envs import suites as jax_suites

    with single_torch_thread():
        return (suites.nocrash_suite(device="cpu"),
                jax_suites.nocrash_suite())


def test_nocrash_scene_matches_jax(nocrash):
    assert_suites_equal(*nocrash)


@pytest.mark.parametrize("tier", TIERS)
def test_nocrash_tiers_match_jax(nocrash, tier, monkeypatch):
    """Each traffic tier's config and tasks (the Town01 densities, dense
    100 vehicles and 250 walkers) on the shared scene, which both
    packages' ``build_scene`` return from the fixture here."""
    from gail_carla_tpu.envs import suites as jax_suites

    (port_scene, _, _), (jax_scene, _, _) = nocrash
    monkeypatch.setattr(suites, "build_scene", lambda *a, **k: port_scene)
    monkeypatch.setattr(jax_suites, "build_scene", lambda *a, **k: jax_scene)
    port = suites.nocrash_suite(background_traffic=tier, device="cpu")
    ref = jax_suites.nocrash_suite(background_traffic=tier)
    assert_suites_equal(port, ref)
    assert (port[1].n_npc_vehicles, port[1].n_npc_walkers) == \
        suites.NOCRASH_TRAFFIC["Town01"][tier]


@pytest.mark.parametrize("task_type", CORL_TYPES)
def test_corl2017_suite_matches_jax(task_type):
    from gail_carla_tpu.envs.suites import corl2017_suite

    assert_suites_equal(suites.corl2017_suite(task_type, device="cpu"),
                        corl2017_suite(task_type))


def test_leaderboard_suite_matches_jax():
    from gail_carla_tpu.envs.suites import leaderboard_suite

    assert_suites_equal(suites.leaderboard_suite(device="cpu"),
                        leaderboard_suite())


def test_endless_suite_matches_jax():
    """The chained rows, ``endless_next`` included, padded to 512."""
    from gail_carla_tpu.envs.suites import endless_suite

    port = suites.endless_suite(n_rows=6, row_m=150.0, device="cpu")
    assert_suites_equal(port, endless_suite(n_rows=6, row_m=150.0))
    assert port[0].route_xy.shape[1] % 512 == 0
    assert port[1].endless_extension


def test_unported_suite_options_raise():
    """The reconstructed towns need the town importers (ROADMAP A7): they
    raise, nothing falls back to the grid. Scripted scenario actors are
    ported (``tests/test_torch_scenario_actors.py``), on generated scenes
    only, as in the JAX suite."""
    for fn in (suites.leaderboard_suite, suites.nocrash_suite,
               suites.corl2017_suite):
        with pytest.raises(NotImplementedError, match="A7"):
            fn(town="Town01", device="cpu")
    with pytest.raises(ValueError, match="generated scenes"):
        suites.leaderboard_suite(town="Town01", scenario_actors={0: []},
                                 device="cpu")


def test_registry_ids_match_jax():
    from gail_carla_tpu.envs.registry import available_envs

    assert registry.available_envs() == available_envs()
    assert len(registry.available_envs()) == 10
    with pytest.raises(KeyError):
        registry.make("NoSuchEnv-v0", device="cpu")


def test_registry_caches_per_device():
    a = registry.make("NoCrash-v0", device="cpu", n_routes=2)
    b = registry.make("NoCrash-v0", device="cpu", n_routes=2)
    assert a.scene is b.scene and a.tasks == b.tasks
    assert a.scene.device.type == "cpu"
    assert a.cfg.n_npc_vehicles == 0 and len(a.tasks) == 4 * 2
    assert ("NoCrash-v0", (("n_routes", 2),), "cpu") in registry._SUITE_CACHE


@pytest.mark.slow
def test_registry_all_suites_build():
    """Mirror of ``tests/test_envs_api.py::test_registry_all_suites_build``
    on the CPU."""
    for env_id in ("LeaderBoard-v0", "NoCrash-v1", "CoRL2017-v0",
                   "CoRL2017-v2", "Endless-v0"):
        env = registry.make(env_id, device="cpu")
        obs, metrics = env.reset()
        assert obs.shape[0] == 3
        obs, metrics, reward, done, info = env.step([0.0, 0.5])
        assert np.isfinite(reward)


@pytest.fixture(scope="module")
def api_scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    with single_torch_thread():
        return (make_benchmark_scene(**API_SCENE, device="cpu"),
                make_jax_scene(**API_SCENE))


def jitted_draws(cfg, n_patrols):
    """(reset draws, step draws): jitted functions of the draws a JAX env's
    next ``reset`` makes from its key (the port's ``reset`` arguments for
    N=1), and of a step's from the pre-step keys and the step's dones (a
    port ``StepDraws``)."""
    import jax
    import jax.numpy as jnp

    def reset_raw(key):
        _, k = jax.random.split(key)
        rng, draws = jax_reset_draws(k, cfg, n_patrols)
        return draws, jax.random.normal(jax.random.split(rng)[1], (2,))

    reset_fn = jax.jit(reset_raw)
    step_fn = jax.jit(
        lambda r, d: jax_step_draws_raw(r, d, cfg, n_patrols))

    def reset_draws(key):
        (restart, pos, traffic), gnss = reset_fn(key)
        return port_env.ResetDraws(
            _t(restart)[None], _t(pos)[None],
            TrafficResetDraws(*(_t(x)[None] for x in traffic))), \
            _t(gnss)[None]

    def step_draws(rngs, dones):
        return step_draws_from_raw(step_fn(rngs, jnp.asarray(dones)))

    return reset_draws, step_draws


def _compare_info(got, want, where):
    assert set(got) == set(want), where
    for k, v in want.items():
        if k == "episode":
            for kk in v:
                np.testing.assert_allclose(got[k][kk], v[kk],
                                           err_msg=f"{k}.{kk} {where}", **TOL)
        elif isinstance(v, float):
            assert isinstance(got[k], float), f"{k} {where}"
            np.testing.assert_allclose(got[k], v, err_msg=f"{k} {where}",
                                       **TOL)
        else:
            assert type(got[k]) is type(v) and got[k] == v, f"{k} {where}"


def _compare_tree(got, want, where):
    """A nested obs dict: integer and boolean leaves equal, floats 1e-5."""
    assert set(got) == set(want), where
    for k, v in want.items():
        if isinstance(v, dict):
            _compare_tree(got[k], v, f"{where}.{k}")
            continue
        v = np.asarray(v)
        assert got[k].shape == v.shape, f"{where}.{k}"
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], v, err_msg=f"{where}.{k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{where}.{k}")


def _drive_both(port_env_, jax_env, cfg, n_patrols, actions, resets,
                obs_dict=False):
    """Reset both envs and step them through ``actions`` (T, 2), resetting
    again at the steps in ``resets``; every observation, metric, reward,
    done and info compared."""
    def check_obs(got, want, where):
        if obs_dict:
            _compare_tree(got, want, where)
        else:
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=where)

    reset_draws, step_draws = jitted_draws(cfg, n_patrols)
    tasks_seen = []
    for t, a in enumerate(actions):
        if t in resets:
            draws, gnss = reset_draws(jax_env._rng)
            jo, jm = jax_env.reset()
            po, pm = port_env_.reset(draws, gnss)
            assert port_env_.task == jax_env.task
            tasks_seen.append(port_env_.task)
            check_obs(po, jo, f"reset at {t}")
            np.testing.assert_allclose(pm, jm, err_msg=f"reset {t}", **TOL)
            for f in dataclasses.fields(port_env_.weather):
                np.testing.assert_allclose(
                    getattr(port_env_.weather, f.name),
                    getattr(jax_env.weather, f.name), err_msg=f.name, **TOL)
        pre = jax_env._state.rng
        jo, jm, jr, jd, ji = jax_env.step(a)
        draws = step_draws(pre[None], np.array([jd]))
        po, pm, pr, pd, pi = port_env_.step(a, draws)
        where = f"step {t}"
        check_obs(po, jo, where)
        np.testing.assert_allclose(pm, jm, err_msg=where, **TOL)
        np.testing.assert_allclose(pr, jr, err_msg=where, **TOL)
        assert isinstance(pr, float) and pd == jd, where
        _compare_info(pi, ji, where)
    return tasks_seen


def test_driving_env_matches_jax(api_scenes):
    """30 steps at 64 px with 2 NPC vehicles and a walker, 2 s episodes
    (auto-resets inside ``step``), three resets that draw a task from the
    shuffled list and its weather from the same ``random.Random``."""
    from gail_carla_tpu.envs.gym_env import DrivingEnv as JaxDrivingEnv

    port_scene, jax_scene = api_scenes
    cfg = EnvConfig(train=False, bev_width=64, n_npc_vehicles=2,
                    n_npc_walkers=1, max_time=2.0)
    tasks = [{"route_id": r, "weather": w, "n_npc_vehicles": 2,
              "n_npc_walkers": 1}
             for w in ("ClearNoon", "dynamic_50", "WetSunset") for r in (0, 1)]
    jax_env = JaxDrivingEnv(jax_scene, cfg, tasks=tasks, seed=11)
    env = DrivingEnv(port_scene, cfg, tasks=tasks, seed=11)
    for space in ("action_space", "observation_space", "metrics_space"):
        assert (dataclasses.astuple(getattr(env, space))
                == dataclasses.astuple(getattr(jax_env, space))), space
    rng = np.random.default_rng(3)
    actions = np.stack([rng.uniform(-0.3, 0.3, 30), rng.uniform(0.4, 1.0, 30)],
                       -1).astype(np.float32)
    seen = _drive_both(env, jax_env, cfg, port_scene.patrol_xy.shape[0],
                       actions, resets=(0, 10, 20))
    # the shuffle as random.Random(11) draws it: the task index, then
    # the task's weather, at every reset
    py = random.Random(11)
    want = []
    for _ in range(3):
        task = tasks[py.randrange(len(tasks))]
        make_weather(task["weather"], py)
        want.append(task)
    assert seen == want
    env.set_task_idx(7)
    jax_env.set_task_idx(7)
    assert env.task == jax_env.task == tasks[1]


def test_driving_env_obs_dict_matches_jax(api_scenes):
    """``obs_dict=True``: the nested ``observe_full`` dict is the obs."""
    from gail_carla_tpu.envs.gym_env import DrivingEnv as JaxDrivingEnv

    port_scene, jax_scene = api_scenes
    cfg = EnvConfig(train=False, n_npc_vehicles=2, n_npc_walkers=1)
    jax_env = JaxDrivingEnv(jax_scene, cfg, shuffle_tasks=False,
                            obs_dict=True)
    env = DrivingEnv(port_scene, cfg, shuffle_tasks=False, obs_dict=True)
    actions = np.tile(np.array([0.0, 0.6], np.float32), (8, 1))
    _drive_both(env, jax_env, cfg, port_scene.patrol_xy.shape[0], actions,
                resets=(0,), obs_dict=True)
    obs = env._obs(None)
    assert obs["route_plan"]["location"].shape == (20, 2)
    assert float(obs["speed"]["speed"][0]) > 0.2


def test_vec_env_matches_jax(api_scenes, tmp_path):
    """``VecEnv`` against ``TpuVecEnv`` at 4 envs for 25 steps (2 s
    episodes: every env auto-resets), and ``EnvMonitor``'s CSV files from
    its ``dones`` and ``infos`` equal to JAX's monitor's."""
    from gail_carla_tpu.envs.vec_env import TpuVecEnv
    from gail_carla_tpu.utils.monitor import EnvEpoch as JaxEnvEpoch
    from gail_carla_tpu.utils.monitor import EnvMonitor as JaxEnvMonitor

    port_scene, jax_scene = api_scenes
    n_patrols = port_scene.patrol_xy.shape[0]
    cfg = EnvConfig(train=True, bev_width=64, n_npc_vehicles=2,
                    n_npc_walkers=1, max_time=2.0)
    jv = TpuVecEnv(jax_scene, cfg, num_envs=4, seed=5)
    pv = VecEnv(port_scene, cfg, num_envs=4, seed=5)
    import jax

    _, k = jax.random.split(jv._rng)
    draws, gnss = jax_batch_reset_draws(k, 4, cfg, n_patrols)
    jo, jm = jv.reset()
    po, pm = pv.reset(draws, gnss)
    np.testing.assert_array_equal(po, np.asarray(jo))
    np.testing.assert_allclose(pm, jm, **TOL)
    EnvEpoch.set_epoch(3)
    JaxEnvEpoch.set_epoch(3)
    pmon = EnvMonitor(str(tmp_path / "port"), 4)
    jmon = JaxEnvMonitor(str(tmp_path / "jax"), 4)
    _, step_draws = jitted_draws(cfg, n_patrols)
    rng = np.random.default_rng(9)
    n_done = 0
    for t in range(25):
        a = np.stack([rng.uniform(-0.3, 0.3, 4), rng.uniform(0.4, 1.0, 4)],
                     -1).astype(np.float32)
        pre = jv._state.rng
        jo, jm, jr, jd, ji = jv.step(a)
        sd = step_draws(pre, np.asarray(jd))
        po, pm, pr, pd, pi = pv.step(a, sd)
        where = f"step {t}"
        np.testing.assert_array_equal(po, np.asarray(jo), err_msg=where)
        np.testing.assert_allclose(pm, jm, err_msg=where, **TOL)
        np.testing.assert_allclose(pr, jr, err_msg=where, **TOL)
        np.testing.assert_array_equal(pd, np.asarray(jd), err_msg=where)
        assert pr.dtype == np.float32 and pd.dtype == np.bool_
        for i in range(4):
            _compare_info(pi[i], ji[i], f"{where} env {i}")
        assert pi[1]["route_id"] == 1   # round-robin route assignment
        n_done += int(pd.sum())
        pmon.record_step(pd, pi)
        jmon.record_step(pd, pi)
    pmon.close()
    jmon.close()
    assert n_done >= 4
    for i in range(4):
        got = (tmp_path / "port" / "env_info" / f"{i}.csv").read_text()
        want = (tmp_path / "jax" / "env_info" / f"{i}.csv").read_text()
        assert got == want and got.count("\n") >= 2
        assert got.splitlines()[1].startswith(f"1,3,{i % 2},")
