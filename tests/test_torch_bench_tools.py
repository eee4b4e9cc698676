"""The port's policy benchmarks against the JAX package's:
``tools/benchmark_policy.benchmark`` (policy and expert) on the smoke
scene, ``tools/nocrash_bench.run_tier`` on the NoCrash grid suite with
its regular traffic (20 vehicles, 50 walkers), and the three CLIs.

Every draw of the JAX runs is recomputed from their keys and injected
into the port (``PRNGKey(1 + e)`` for the benchmark's episode ``e``,
``fold_in(PRNGKey(2021), e)`` for a tier's). The policy is a float32 toy
model whose flax parameters both packages share (the JAX tool's
``ModelConfig()`` is swapped for it inside the test). The benchmark's
rows and JSON line and the tiers' results must be equal as the tools
round them (scores to 0.1, rates to 0.01, rewards to 0.001). The JAX
package is imported inside the tests only (read-only reference).
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_expert import single_torch_thread
from test_torch_traffic import (
    TrafficResetDraws, _t, jax_reset_draws, jax_step_draws_raw,
    step_draws_from_raw,
)

from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.convert import policy_from_flax
from gail_carla_tpu_torch.envs.suites import nocrash_suite
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import ResetDraws
from gail_carla_tpu_torch.tools import benchmark_policy, corl_bench
from gail_carla_tpu_torch.tools import nocrash_bench
from gail_carla_tpu_torch.train import make_presets

SMOKE = make_presets()["smoke"]["scene"]
TOY = ModelConfig(conv_channels=(8, 16), hidden_size=64, head_size=32,
                  disc_hidden=32, dtype="float32")
POLICY_STEPS, EXPERT_STEPS = 40, 200


def jax_episode_draws(jax_scene, cfg, key, n_steps):
    """``run_latched``'s draw arguments for the JAX run of one episode
    from ``key`` (one env per route): ``reset_batch``'s draws (as
    ``jax_batch_reset_draws`` takes them) and each step's from the keys
    the envs carry. The step draws assume no env is done: after an env's
    first done nothing it draws reaches a latched value."""
    import jax
    import jax.numpy as jnp

    R = jax_scene.n_routes
    n_patrols = jax_scene.patrol_xy.shape[0]

    @jax.jit
    def all_draws(key):
        def reset_one(k):
            rng, draws = jax_reset_draws(k, cfg, n_patrols)
            rng, kg = jax.random.split(rng)
            return rng, draws, jax.random.normal(kg, (2,))

        rng0, draws, gnss = jax.vmap(reset_one)(jax.random.split(key, R))

        def next_rng(r, _):
            nxt = jax.vmap(
                lambda k: jax.random.split(jax.random.split(k, 3)[0])[0]
            )(r)
            return nxt, r

        _, rngs = jax.lax.scan(next_rng, rng0, None, length=n_steps)
        steps = jax.vmap(lambda r: jax_step_draws_raw(
            r, jnp.zeros(R, bool), cfg, n_patrols))(rngs)
        return draws, gnss, steps

    (restart, pos, traffic), gnss, raw = jax.tree.map(np.asarray,
                                                      all_draws(key))
    env_draws = [step_draws_from_raw(jax.tree.map(lambda a: a[t], raw))
                 for t in range(n_steps)]
    reset = ResetDraws(_t(restart), _t(pos),
                       TrafficResetDraws(*map(_t, traffic)))
    return {"reset_draws": reset, "reset_gnss": _t(gnss),
            "env_draws": env_draws}


@contextlib.contextmanager
def jax_toy_policy(monkeypatch):
    """The JAX tool's ``init_policy`` with ``TOY`` in place of
    ``ModelConfig()``; yields the list its params are appended to."""
    from gail_carla_tpu.models import policy as jax_policy

    made = []
    init = jax_policy.init_policy

    def toy(rng, cfg, obs_shape):
        net, params = init(rng, TOY, obs_shape)
        made.append((params, obs_shape))
        return net, params

    monkeypatch.setattr(jax_policy, "init_policy", toy)
    yield made


def run_jax_benchmark(**kw):
    """JAX's ``benchmark`` and the JSON line it prints."""
    from gail_carla_tpu.tools.benchmark_policy import benchmark

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = benchmark(scene_kwargs=dict(SMOKE), **kw)
    return rows, json.loads(out.getvalue().strip().splitlines()[-1])


def run_port_benchmark(**kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = benchmark_policy.benchmark(scene_kwargs=dict(SMOKE),
                                          device="cpu", **kw)
    return rows, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def smoke_scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    with single_torch_thread():
        return (make_benchmark_scene(**SMOKE, device="cpu"),
                make_jax_scene(**SMOKE))


@pytest.fixture(scope="module")
def expert_rows(smoke_scenes):
    """Both packages' expert benchmark (``EXPERT_STEPS`` steps) and
    JSON lines."""
    import jax
    from gail_carla_tpu.config import EnvConfig as JaxEnvConfig

    _, jax_scene = smoke_scenes
    want = run_jax_benchmark(max_steps=EXPERT_STEPS, expert=True)
    cfg = JaxEnvConfig(train=False, max_time=EXPERT_STEPS * 0.1)
    draws = jax_episode_draws(jax_scene, cfg, jax.random.PRNGKey(1),
                              EXPERT_STEPS)
    with single_torch_thread():
        got = run_port_benchmark(max_steps=EXPERT_STEPS, expert=True,
                                 episode_draws=[draws])
    return got, want


def test_benchmark_expert_matches_jax(expert_rows):
    (rows, line), (want_rows, want_line) = expert_rows
    assert rows == want_rows
    assert line == want_line
    # the expert drives both routes until the cap's timeout
    assert all(r["route_score"] > 10.0 and r["steps"] == EXPERT_STEPS
               for r in rows)


@pytest.mark.parametrize("obs_mode", ["bev", "bev6"])
def test_benchmark_policy_matches_jax(smoke_scenes, obs_mode, monkeypatch):
    """The toy policy on the ``obs_mode`` BEV at the tool's 192 px for
    ``POLICY_STEPS`` steps (every episode times out at the cap: the
    tool's ``max_time`` follows it). The closed loop first renders a
    differing pixel at step 9 on ``bev`` and at step 26 on ``bev6``: the
    jitted JAX render of the same render state differs from JAX's own
    eager render, which the port equals, by one route pixel (XLA's fused
    multiply-adds; ROADMAP §C). The policy's actions, and the poses, part
    from there by up to 3.2e-2 m by step 39, which stays under the
    tool's rounding of the rows: every row is equal."""
    import jax
    from gail_carla_tpu.config import EnvConfig as JaxEnvConfig

    _, jax_scene = smoke_scenes
    with jax_toy_policy(monkeypatch) as made:
        want = run_jax_benchmark(max_steps=POLICY_STEPS, obs_mode=obs_mode)
    (params, obs_shape), = made
    net = policy_from_flax(jax.tree.map(np.asarray, params), TOY, obs_shape,
                           device="cpu")
    cfg = JaxEnvConfig(train=False, obs_mode=obs_mode,
                       max_time=POLICY_STEPS * 0.1)
    draws = jax_episode_draws(jax_scene, cfg, jax.random.PRNGKey(1),
                              POLICY_STEPS)
    got = run_port_benchmark(max_steps=POLICY_STEPS, obs_mode=obs_mode,
                             net=net, episode_draws=[draws])
    assert got == want
    assert all(r["steps"] == POLICY_STEPS for r in got[0])


@pytest.fixture(scope="module")
def tier_scenes():
    from gail_carla_tpu.envs.suites import nocrash_suite as jax_suite

    with single_torch_thread():
        port = nocrash_suite(n_routes=2, device="cpu")
    return port, jax_suite(n_routes=2)


@pytest.mark.parametrize("expert", [True, False], ids=["expert", "policy"])
def test_run_tier_matches_jax(tier_scenes, expert):
    """``run_tier`` on ``nocrash_suite(n_routes=2)`` at the regular tier:
    the expert for one 30 s episode (300 steps, state observation), the
    toy policy on the 64 px bev6 BEV for two 4 s episodes (40 steps;
    episode ``e`` from ``fold_in(key, e)``)."""
    import jax
    from gail_carla_tpu.models.policy import init_policy as jax_init
    from gail_carla_tpu.tools.nocrash_bench import run_tier as jax_tier

    (scene, cfg, _), (jax_scene, jcfg, _) = tier_scenes
    steps, episodes = (300, 1) if expert else (40, 2)
    kw = dict(max_time=steps * 0.1, bev_width=64)
    cfg = dataclasses.replace(nocrash_bench.tier_config(cfg, "bev6",
                                                        expert), **kw)
    jcfg = dataclasses.replace(jcfg, train=False, obs_mode=cfg.obs_mode,
                               **kw)
    net = params = port_net = None
    if not expert:
        net, params = jax_init(jax.random.PRNGKey(5), TOY, (6, 64, 64))
        port_net = policy_from_flax(jax.tree.map(np.asarray, params), TOY,
                                    (6, 64, 64), device="cpu")
    rng = jax.random.PRNGKey(2021)
    want = jax_tier(jax_scene, jcfg, net, params, rng, episodes, steps,
                    expert=expert)
    draws = [jax_episode_draws(jax_scene, jcfg, jax.random.fold_in(rng, e),
                               steps) for e in range(episodes)]
    got = nocrash_bench.run_tier(scene, cfg, port_net, 2021, episodes,
                                 steps, expert=expert, episode_draws=draws)
    assert {k: got[k] for k in want} == want
    assert got["steps_run"] == [steps] * episodes
    assert want["mean_driving_score"] > 0.0


def test_benchmark_main_prints_jax_keys(expert_rows, capsys):
    """The CLI on the CPU (``--device cpu``) with the tool's policy:
    ``ModelConfig()`` at 192 px on the reference scene; its JSON line
    has the keys of JAX's."""
    _, (want_rows, want_line) = expert_rows
    rows = benchmark_policy.main(["--device", "cpu", "--max-steps", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(want_line)
    assert len(line["routes"]) == len(rows) == 10
    assert set(line["routes"][0]) == set(want_line["routes"][0])
    assert all(r["steps"] == 3 for r in rows)


def test_bench_clis_wait_on_the_town_importers():
    """The NoCrash and CoRL CLIs benchmark the reconstructed towns
    (``--town Town01`` by default): they raise until the town importers
    are ported, and keep the JAX tools' ``--ckpt``/``--expert`` error;
    so does ``benchmark_policy --town``. A policy at ``obs_mode="state"``
    raises as the JAX tool fails (its conv policy cannot take state
    vectors); the expert at ``"state"`` runs
    (``tests/test_torch_state_learner.py``)."""
    for main in (nocrash_bench.main, corl_bench.main):
        with pytest.raises(NotImplementedError, match="A7"):
            main(["--expert", "--device", "cpu"])
        with pytest.raises(SystemExit):
            main(["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="A7"):
        benchmark_policy.main(["--town", "Town01", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="obs_mode='state'"):
        benchmark_policy.benchmark(scene_kwargs=dict(SMOKE), device="cpu",
                                   obs_mode="state", expert=False,
                                   max_steps=2)
