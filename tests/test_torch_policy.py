"""The port's policy against the flax one: converted float32 params at the
full ``ModelConfig`` width (convs 32-64-128-256, hidden 512, head 256) on
192 px observations. Conv and matmul sums run in another order in the two
libraries, so values and means are held to 1e-5 relative; log-probs too,
with JAX's action noise injected. The JAX package is imported inside the
tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.convert import (
    flax_to_state_dict, init_flax_params, init_policy, policy_from_flax,
)
from gail_carla_tpu_torch.models import policy as port_policy

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(batch, width, seed):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.0, 1.0, (batch, 3, width, width)).astype(np.float32)
    metrics = np.stack([
        rng.normal(0.0, 2e-4, batch), rng.normal(0.0, 2e-4, batch),
        rng.uniform(0.0, 8.0, batch), rng.integers(1, 7, batch),
    ], axis=1).astype(np.float32)
    return obs, metrics


@pytest.fixture(scope="module")
def flax_policy():
    import jax
    from gail_carla_tpu.models.policy import init_policy as jax_init

    cfg = ModelConfig(dtype="float32")
    net, params = jax_init(jax.random.PRNGKey(0), cfg, (3, 192, 192))
    return cfg, net, params


def test_policy_forward_matches_flax(flax_policy):
    import jax
    import jax.numpy as jnp

    cfg, net, params = flax_policy
    obs, metrics = _inputs(2, 192, 0)
    v, mean, logstd = net.apply(params, jnp.asarray(obs),
                                jnp.asarray(metrics))
    port = policy_from_flax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    with torch.no_grad():
        pv, pmean, plogstd = port(torch.from_numpy(obs),
                                  torch.from_numpy(metrics))
    np.testing.assert_allclose(pv.numpy(), np.asarray(v), **TOL)
    np.testing.assert_allclose(pmean.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_array_equal(plogstd.numpy(), np.asarray(logstd))


def test_act_logprob_matches_flax_with_injected_noise(flax_policy):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.models.policy import act as jax_act
    from gail_carla_tpu.models.policy import evaluate_actions

    cfg, net, params = flax_policy
    obs, metrics = _inputs(2, 192, 1)
    key = jax.random.PRNGKey(7)
    v, a, lp = jax_act(net, params, jnp.asarray(obs), jnp.asarray(metrics),
                       key)
    noise = np.array(jax.random.normal(key, (2, 2)))
    port = policy_from_flax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    pv, pa, plp = port_policy.act(port, torch.from_numpy(obs),
                                  torch.from_numpy(metrics),
                                  noise=torch.from_numpy(noise))
    np.testing.assert_allclose(pa.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(plp.numpy(), np.asarray(lp), **TOL)
    _, elp, ent = evaluate_actions(net, params, jnp.asarray(obs),
                                   jnp.asarray(metrics), a)
    with torch.no_grad():
        _, pelp, pent = port_policy.evaluate_actions(
            port, torch.from_numpy(obs), torch.from_numpy(metrics),
            torch.from_numpy(np.array(a)))
    np.testing.assert_allclose(pelp.numpy(), np.asarray(elp), **TOL)
    np.testing.assert_allclose(pent.numpy(), np.asarray(ent), **TOL)


def test_bfloat16_convs_track_float32():
    """The configured bfloat16 convs (float32 parameters) stay close to
    the float32 forward: a loose check of the working type, not parity."""
    cfg = ModelConfig(conv_channels=(8, 16), hidden_size=64, head_size=32)
    params = init_flax_params(cfg, (3, 64, 64), seed=3)
    obs, metrics = _inputs(4, 64, 2)
    outs = []
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        net = policy_from_flax(params, c, (3, 64, 64), device="cpu")
        with torch.no_grad():
            outs.append(net(torch.from_numpy(obs), torch.from_numpy(metrics)))
    (vb, mb, _), (vf, mf, _) = outs
    np.testing.assert_allclose(mb.numpy(), mf.numpy(), atol=5e-2)
    np.testing.assert_allclose(vb.numpy(), vf.numpy(), atol=5e-2)


def test_converter_layout_roundtrip():
    """HWIO conv kernels become OIHW and (in, out) Dense kernels become
    (out, in) Linear weights; the numpy initialiser has flax's shapes."""
    cfg = ModelConfig(conv_channels=(8, 16), hidden_size=64, head_size=32)
    params = init_flax_params(cfg, (3, 64, 64), seed=0)
    sd = flax_to_state_dict(params, cfg)
    k = params["params"]["ObsEncoder_0"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(sd["obs_enc.convs.1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    d0 = params["params"]["Dense_0"]["kernel"]
    assert d0.shape == (14 * 14 * 16 + 5 + 8, 64)
    np.testing.assert_array_equal(sd["body.0.weight"].numpy(), d0.T)
    net = init_policy(cfg, (3, 64, 64), seed=0, device="cpu")
    assert set(net.state_dict()) == set(sd)


def test_bev6_policy_matches_flax():
    """The 6-channel policy (``obs_mode="bev6"``) at full width: the extra
    channels are normalised by 0.5/0.25, the first conv takes 6 inputs,
    and ``Dense_0`` still consumes the NHWC flatten (25,613 = 10*10*256 +
    5 + 8 features at 192 px). Values, means and log-probs within 1e-5
    relative, as for the 3-channel policy."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.models.policy import act as jax_act
    from gail_carla_tpu.models.policy import init_policy as jax_init

    cfg = ModelConfig(dtype="float32")
    shape = (6, 192, 192)
    net, params = jax_init(jax.random.PRNGKey(4), cfg, shape)
    p = params["params"]
    assert p["ObsEncoder_0"]["Conv_0"]["kernel"].shape == (4, 4, 6, 32)
    assert p["Dense_0"]["kernel"].shape == (25613, 512)
    numpy_p = init_flax_params(cfg, shape, seed=0)["params"]
    assert jax.tree.map(np.shape, numpy_p) == jax.tree.map(np.shape, p)

    rng = np.random.default_rng(6)
    obs, metrics = _inputs(2, 192, 3)
    # the signal channel's values, and 0/1 actor masks
    extra = np.stack([
        rng.choice([0.0, 80.0, 170.0, 255.0], (2, 192, 192)) / 255.0,
        rng.uniform(0, 1, (2, 192, 192)) < 0.1,
        rng.uniform(0, 1, (2, 192, 192)) < 0.05,
    ], axis=1).astype(np.float32)
    obs = np.concatenate([obs, extra], axis=1)
    key = jax.random.PRNGKey(8)
    v, a, lp = jax_act(net, params, jnp.asarray(obs), jnp.asarray(metrics),
                       key)
    noise = np.array(jax.random.normal(key, (2, 2)))
    port = policy_from_flax(jax.tree.map(np.asarray, params), cfg, shape,
                            device="cpu")
    pv, pa, plp = port_policy.act(port, torch.from_numpy(obs),
                                  torch.from_numpy(metrics),
                                  noise=torch.from_numpy(noise))
    np.testing.assert_allclose(pv.numpy(), np.asarray(v), **TOL)
    np.testing.assert_allclose(pa.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(plp.numpy(), np.asarray(lp), **TOL)
