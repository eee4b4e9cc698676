"""Training and benchmarking on the state-vector observation
(``obs_mode="state"``) in the port, against the JAX package.

- ``tests/test_algo.py::test_state_obs_mode_ppo`` on the port: 4 PPO
  updates on state obs (MLP encoder, float rollout store, no critic), the
  env reward finite and rising.
- One whole ``algo="ppo"`` update against JAX's, with the float store
  and with the observations re-derived from the render states and
  metrics (``store_obs=False``): ``test_torch_learner.py``'s toy shapes,
  injected draws and tolerances (``check_update_matches_jax``).
- ``build_expert_buffer`` at ``"state"``: JAX's float rows within 1e-6
  (its chunks are jitted; XLA may fuse the lateral offset's multiply-add).
- ``algo="wdgail"`` at ``"state"`` raises in the port, where the JAX
  package fails in its first critic update (``models/discriminator.py::
  STATE_OBS_ERROR``), also through ``train.main`` before the demos.
- ``benchmark_policy.benchmark(obs_mode="state", expert=True)``: the
  rows equal JAX's as the tool rounds them (scores 0.1, rewards 0.001).

The JAX package is imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_learner import (
    ENV, MODEL, TCFG, _port_state, check_update_matches_jax,
)

from gail_carla_tpu_torch import train
from gail_carla_tpu_torch.algo import buffers
from gail_carla_tpu_torch.algo.expert import DemoBatch
from gail_carla_tpu_torch.algo.learner import WDGAILLearner
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from gail_carla_tpu_torch.convert import init_policy
from gail_carla_tpu_torch.models.discriminator import STATE_OBS_ERROR
from gail_carla_tpu_torch.ops.state_obs import STATE_OBS_DIM
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import reset_batch
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
STATE_ENV = dataclasses.replace(ENV, obs_mode="state")
PPO = dataclasses.replace(TCFG, algo="ppo", bcgail=False)


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = make_benchmark_scene(**PRESET["scene"], device="cpu")
    finally:
        torch.set_num_threads(n)
    return port, make_jax_scene(**PRESET["scene"])


def test_state_obs_mode_ppo(scenes):
    """``tests/test_algo.py::test_state_obs_mode_ppo`` on the port (its
    scene is the smoke preset's)."""
    scene, _ = scenes
    env_cfg = EnvConfig(train=True, obs_mode="state")
    model_cfg = ModelConfig(hidden_size=64, head_size=32, dtype="float32")
    tcfg = TrainConfig(
        algo="ppo", n_envs=4, num_steps=256, mini_batch_size=32,
        ppo_epoch=2, routes=(0, 1), bcgail=False, lr=3e-4,
    )
    learner = WDGAILLearner(scene, env_cfg, model_cfg, tcfg, expert=None)
    assert learner.obs_shape == (STATE_OBS_DIM,)
    state = learner.init_state()
    rews = []
    for _ in range(4):
        state, metrics = learner.update(state)
        rews.append(float(metrics["env_reward_mean"]))
    assert all(np.isfinite(r) for r in rews)
    assert rews[-1] > rews[0], rews  # dense reward is quickly learnable


@pytest.mark.parametrize("store_obs", [True, False],
                         ids=["stored", "rederived"])
def test_state_ppo_update_matches_jax(scenes, store_obs):
    port_scene, jax_scene = scenes
    check_update_matches_jax(jax_scene, port_scene, STATE_ENV, MODEL, PPO,
                             None, None, store_obs=store_obs)


def test_state_rollout_stores_float_rows(scenes):
    port_scene, _ = scenes
    gen = torch.Generator().manual_seed(1)
    net = init_policy(MODEL, (STATE_OBS_DIM,), seed=1, device="cpu")
    st, met, ren = reset_batch(port_scene, STATE_ENV, torch.tensor([0, 1]),
                               gen)
    ro = collect_rollout(port_scene, STATE_ENV, net, st, met, ren, gen, 6,
                         store_obs=True)[3]
    assert ro.obs.dtype == torch.float32
    assert ro.obs.shape == (7, 2, STATE_OBS_DIM)
    t_idx, n_idx = torch.tensor([0, 6, 3]), torch.tensor([1, 0, 1])
    stored = buffers.fetch_rollout_obs(port_scene, STATE_ENV, ro, t_idx,
                                       n_idx)
    again = buffers.fetch_rollout_obs(
        port_scene, STATE_ENV, dataclasses.replace(ro, obs=None), t_idx,
        n_idx)
    assert torch.equal(stored, again)


def test_build_expert_buffer_state_matches_jax(scenes):
    """The same demos (a port rollout with a random validity mask) through
    both ``build_expert_buffer``s at ``"state"``: valid rows compacted and
    repeated, the float32 observation rows stored."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import build_expert_buffer
    from gail_carla_tpu.algo.expert import DemoBatch as JaxDemoBatch

    port_scene, jax_scene = scenes
    gen = torch.Generator().manual_seed(3)
    net = init_policy(MODEL, (STATE_OBS_DIM,), seed=3, device="cpu")
    st, met, ren = reset_batch(port_scene, STATE_ENV,
                               torch.tensor([0, 1, 1]), gen)
    ro = collect_rollout(port_scene, STATE_ENV, net, st, met, ren, gen,
                         12)[3]
    valid = torch.from_numpy(
        np.random.default_rng(4).uniform(size=(12, 3)) < 0.4)
    render = buffers.map_state(lambda a: a[:-1], ro.render)
    demos = DemoBatch(render, ro.metrics[:-1], ro.actions, valid)
    from gail_carla_tpu.sim.env import RenderState as JaxRenderState

    jdemos = JaxDemoBatch(
        JaxRenderState(**{f.name: jnp.asarray(getattr(render, f.name)
                                              .numpy())
                          for f in dataclasses.fields(render)}),
        jnp.asarray(ro.metrics[:-1].numpy()),
        jnp.asarray(ro.actions.numpy()), jnp.asarray(valid.numpy()))
    size = int(valid.sum()) + 5
    want = build_expert_buffer(jax_scene, STATE_ENV, jdemos, size=size)
    got = buffers.build_expert_buffer(port_scene, STATE_ENV, demos,
                                      size=size)
    assert got.obs.dtype == torch.float32
    assert got.obs.shape == np.asarray(want.obs).shape == (size,
                                                            STATE_OBS_DIM)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs),
                               rtol=0.0, atol=1e-6)
    np.testing.assert_array_equal(got.metrics.numpy(),
                                  np.asarray(want.metrics))
    want_rs = _port_state(want.render)
    for f in dataclasses.fields(want_rs):
        assert torch.equal(getattr(got.render, f.name),
                           getattr(want_rs, f.name)), f.name
    # a stored row is its re-derived observation
    idx = torch.tensor([0, size - 1, 2])
    stored = buffers.fetch_expert_obs(port_scene, STATE_ENV, got, idx)
    again = buffers.fetch_expert_obs(
        port_scene, STATE_ENV, dataclasses.replace(got, obs=None), idx)
    assert torch.equal(stored, again)


def test_wdgail_at_state_raises(scenes, tmp_path):
    port_scene, _ = scenes
    expert = buffers.ExpertBuffer(
        render=None, metrics=torch.zeros(1, 4),
        obs=torch.zeros(1, STATE_OBS_DIM), actions=torch.zeros(1, 2))
    with pytest.raises(NotImplementedError) as err:
        WDGAILLearner(port_scene, STATE_ENV, MODEL, TCFG, expert)
    assert str(err.value) == STATE_OBS_ERROR
    # the CLI's default algo is "wdgail": it refuses before the demos
    with pytest.raises(NotImplementedError, match="obs_mode='state'"):
        train.main(["--preset", "smoke", "--obs-mode", "state",
                    "--device", "cpu", "--log-dir", str(tmp_path)])


def test_benchmark_expert_at_state_matches_jax(scenes):
    """The expert benchmark at ``obs_mode="state"`` (the NoCrash and CoRL
    ``--expert`` runs' mode), ``EXPERT_STEPS`` steps on the smoke scene,
    JAX's draws injected."""
    import jax
    from gail_carla_tpu.config import EnvConfig as JaxEnvConfig
    from test_torch_bench_tools import (
        EXPERT_STEPS, jax_episode_draws, run_jax_benchmark,
        run_port_benchmark,
    )

    _, jax_scene = scenes
    want = run_jax_benchmark(max_steps=EXPERT_STEPS, expert=True,
                             obs_mode="state")
    cfg = JaxEnvConfig(train=False, obs_mode="state",
                       max_time=EXPERT_STEPS * 0.1)
    draws = jax_episode_draws(jax_scene, cfg, jax.random.PRNGKey(1),
                              EXPERT_STEPS)
    got = run_port_benchmark(max_steps=EXPERT_STEPS, expert=True,
                             obs_mode="state", episode_draws=[draws])
    assert got == want
    assert all(r["route_score"] > 10.0 for r in got[0])
