"""The port's state-vector observation (``ops/state_obs.py``) and the
policy's and critic's state encoder against the JAX package's.

The observation: 4 envs on the smoke scene after 10 steps of JAX's
simulator (fixed numpy actions); env 3's route cursor is then moved to
within 20 points of the route table's end, where ``dynamic_slice`` clamps
the 20-point window (the port's ``take_window``), with distinct points
written at the table's end so that the clamp shows. The port is held to
JAX's jitted observation, the one its rollouts store, at 1e-6 absolute
on features of order 1: XLA may contract the lateral offset's
``sum(right * d)`` into one fused multiply-add (measured worst |diff|:
printed by the test).

The encoder: flax's ``ObsEncoder`` on a (B, 24) input is two
``Dense(256)`` + LeakyReLU layers. The policy and the critic from
converted float32 params within 1e-5 relative (``test_torch_policy.py``'s
tolerance), the bfloat16 default loosely; the numpy initialiser has
flax's tree. The gradient penalty cannot take state obs in either
package. The JAX package is imported inside the tests only (read-only
reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

from gail_carla_tpu_torch.config import EnvConfig, ModelConfig
from gail_carla_tpu_torch.convert import (
    critic_from_flax, init_critic_flax_params, init_flax_params,
    policy_from_flax, save_flax_params_checkpoint,
)
from gail_carla_tpu_torch.models import discriminator as disc_mod
from gail_carla_tpu_torch.models import policy as port_policy
from gail_carla_tpu_torch.ops.state_obs import (
    STATE_OBS_DIM, state_observation_batch,
)
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import RenderState
from gail_carla_tpu_torch.train import make_presets
from gail_carla_tpu_torch.utils import checkpoint as ckpt_mod

PRESET = make_presets()["smoke"]
ENV = EnvConfig(train=False, obs_mode="state")
N_ENVS, N_STEPS = 4, 10
CLAMP_ENV, CLAMP_BACK = 3, 7     # env 3's head: 7 points before the end
OBS_ATOL = 1e-6
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPE = (STATE_OBS_DIM,)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_render(jr):
    return RenderState(**{f.name: _t(getattr(jr, f.name))
                          for f in dataclasses.fields(RenderState)})


def test_state_observation_matches_jax():
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.ops.state_obs import (
        STATE_OBS_DIM as JAX_DIM, state_observation_batch as jax_obs,
    )
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )
    from gail_carla_tpu.sim.env import reset_batch, step_batch

    assert STATE_OBS_DIM == JAX_DIM == 24
    jax_scene = make_jax_scene(**PRESET["scene"])
    port_scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    rid = jnp.asarray([0, 1, 0, 1], jnp.int32)
    js, met, ren = reset_batch(jax_scene, ENV, jax.random.PRNGKey(5), rid)
    step = jax.jit(lambda s, a: step_batch(jax_scene, ENV, s, a))
    rng = np.random.default_rng(2)
    for _ in range(N_STEPS):
        act = np.stack([rng.uniform(-0.3, 0.3, N_ENVS),
                        rng.uniform(0.5, 1.0, N_ENVS)], 1)
        js, out = step(js, jnp.asarray(act, jnp.float32))
    met, ren = out.metrics, out.render
    L = jax_scene.route_xy.shape[1]
    ren = ren.replace(head=ren.head.at[CLAMP_ENV].set(L - CLAMP_BACK))
    # distinct points at the table's end (the padding repeats the last
    # route point), so that a clamped window shows
    xy = np.array(jax_scene.route_xy)
    xy[1, L - 30:] += np.arange(30)[:, None] * np.float32([0.5, 0.25])
    jax_scene = jax_scene.replace(route_xy=jnp.asarray(xy))
    port_scene = dataclasses.replace(port_scene,
                                     route_xy=torch.from_numpy(xy))

    want = np.asarray(jax.jit(lambda r, m: jax_obs(jax_scene, ENV, r, m))(
        ren, met))
    eager = np.asarray(jax_obs(jax_scene, ENV, ren, met))
    got = state_observation_batch(port_scene, ENV, _port_render(ren),
                                  _t(met)).numpy()
    assert got.shape == want.shape == (N_ENVS, STATE_OBS_DIM)
    assert got.dtype == np.float32
    worst = float(np.abs(got - want).max())
    print(f"state obs: worst |diff| {worst:.3g} (jitted JAX), "
          f"{float(np.abs(got - eager).max()):.3g} (eager JAX)")
    np.testing.assert_allclose(got, want, rtol=0.0, atol=OBS_ATOL)
    # the clamp: env 3's 10 waypoints are the row's last 20 points, 2 apart
    ego_xy, ego_yaw = np.asarray(ren.xy)[CLAMP_ENV], float(
        np.asarray(ren.yaw)[CLAMP_ENV])
    loc = got[CLAMP_ENV, :20].reshape(10, 2) / 0.05
    c, s = np.cos(ego_yaw), np.sin(ego_yaw)
    back = ego_xy + np.stack([loc[:, 0] * c - loc[:, 1] * s,
                              loc[:, 0] * s + loc[:, 1] * c], 1)
    np.testing.assert_allclose(back, xy[1, L - 20::2], atol=1e-3)
    # any leading shape: (T, N) gives the same rows
    two = state_observation_batch(
        port_scene, ENV,
        RenderState(**{f.name: torch.stack([getattr(
            _port_render(ren), f.name)] * 2)
            for f in dataclasses.fields(RenderState)}),
        torch.stack([_t(met)] * 2))
    assert two.shape == (2, N_ENVS, STATE_OBS_DIM)
    assert torch.equal(two[1], torch.from_numpy(got))


def _state_inputs(batch, seed):
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.0, 0.6, (batch, STATE_OBS_DIM)).astype(np.float32)
    metrics = np.stack([
        rng.normal(0.0, 2e-4, batch), rng.normal(0.0, 2e-4, batch),
        rng.uniform(0.0, 8.0, batch), rng.integers(1, 7, batch),
    ], axis=1).astype(np.float32)
    act = rng.normal(0.0, 0.5, (batch, 2)).astype(np.float32)
    return obs, metrics, act


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_policy_and_critic_match_flax(dtype):
    """``ModelConfig()`` widths (hidden 512, head 256) behind the state
    encoder: the policy's values, means and log-probs (JAX's action noise
    injected) and the critic's output, float32 within 1e-5 relative;
    bfloat16 within 5e-2 of flax's own bfloat16 run (both round the
    Dense layers' inputs, weights and outputs to bfloat16, summing in
    another order)."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.models.discriminator import init_discriminator
    from gail_carla_tpu.models.policy import act as jax_act
    from gail_carla_tpu.models.policy import init_policy as jax_init

    cfg = ModelConfig(dtype=dtype)
    tol = TOL if dtype == "float32" else dict(rtol=0.0, atol=5e-2)
    net, params = jax_init(jax.random.PRNGKey(0), cfg, SHAPE)
    dnet, dparams = init_discriminator(jax.random.PRNGKey(1), cfg, SHAPE)
    enc = params["params"]["ObsEncoder_0"]
    assert set(enc) == {"Dense_0", "Dense_1"}
    assert enc["Dense_0"]["kernel"].shape == (STATE_OBS_DIM, 256)
    assert params["params"]["Dense_0"]["kernel"].shape == (256 + 5 + 8, 512)

    obs, metrics, act = _state_inputs(8, 0)
    key = jax.random.PRNGKey(7)
    v, a, lp = jax_act(net, params, jnp.asarray(obs), jnp.asarray(metrics),
                       key)
    noise = _t(jax.random.normal(key, (8, 2)))
    d = dnet.apply(dparams, jnp.asarray(obs), jnp.asarray(metrics),
                   jnp.asarray(act))

    port = policy_from_flax(jax.tree.map(np.asarray, params), cfg, SHAPE,
                            device="cpu")
    critic = critic_from_flax(jax.tree.map(np.asarray, dparams), cfg, SHAPE,
                              device="cpu")
    assert len(port.obs_enc.dense) == 2 and len(port.obs_enc.convs) == 0
    pv, pa, plp = port_policy.act(port, _t(obs), _t(metrics), noise=noise)
    with torch.no_grad():
        pd = critic(_t(obs), _t(metrics), _t(act))
    np.testing.assert_allclose(pv.numpy(), np.asarray(v), **tol)
    np.testing.assert_allclose(pa.numpy(), np.asarray(a), **tol)
    np.testing.assert_allclose(pd.numpy(), np.asarray(d), **tol)
    if dtype == "float32":
        np.testing.assert_allclose(plp.numpy(), np.asarray(lp), **TOL)


def test_state_init_params_have_flax_tree(tmp_path):
    """The numpy initialiser builds flax's tree at (24,) for the policy and
    the critic, and a JAX state policy's params go through the port's
    params-only checkpoint unchanged."""
    import jax
    from gail_carla_tpu.models.discriminator import init_discriminator
    from gail_carla_tpu.models.policy import init_policy as jax_init

    cfg = ModelConfig()
    _, params = jax_init(jax.random.PRNGKey(2), cfg, SHAPE)
    _, dparams = init_discriminator(jax.random.PRNGKey(3), cfg, SHAPE)
    shapes = lambda p: jax.tree.map(np.shape, p)  # noqa: E731
    assert shapes(init_flax_params(cfg, SHAPE, seed=0)) == shapes(
        jax.tree.map(np.asarray, params))
    assert shapes(init_critic_flax_params(cfg, SHAPE, seed=0)) == shapes(
        jax.tree.map(np.asarray, dparams))

    flat = jax.tree.map(np.asarray, params)
    save_flax_params_checkpoint(flat, cfg, str(tmp_path / "p"))
    net = policy_from_flax(init_flax_params(cfg, SHAPE, seed=1), cfg, SHAPE,
                           device="cpu")
    ckpt_mod.restore_checkpoint(str(tmp_path / "p"), {"params": net})
    k = flat["params"]["ObsEncoder_0"]["Dense_1"]["kernel"]
    np.testing.assert_array_equal(net.obs_enc.dense[1].weight.detach()
                                  .numpy(), k.T)


def test_grad_penalty_refuses_state_obs_in_both_packages():
    """The reference's penalty mixes a (B, 24) obs with a (B, 1, 1, 1)
    alpha into (B, 1, B, 24), which its critic cannot take; the port
    raises its own error instead of broadcasting."""
    import jax
    import jax.numpy as jnp
    from flax.errors import ScopeParamNotFoundError
    from gail_carla_tpu.models import discriminator as jax_disc

    cfg = ModelConfig(dtype="float32")
    dnet, dparams = jax_disc.init_discriminator(jax.random.PRNGKey(4), cfg,
                                                SHAPE)
    e, p = _state_inputs(4, 1), _state_inputs(4, 2)
    with pytest.raises(ScopeParamNotFoundError):
        jax_disc.grad_penalty(dnet, dparams, jax.random.PRNGKey(5),
                              tuple(map(jnp.asarray, e)),
                              tuple(map(jnp.asarray, p)))
    net = critic_from_flax(jax.tree.map(np.asarray, dparams), cfg, SHAPE,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="obs_mode='state'"):
        disc_mod.grad_penalty(net, tuple(map(_t, e)), tuple(map(_t, p)),
                              alpha=torch.full((4, 1, 1, 1), 0.5))
