"""A policy trained by the JAX package, carried into the port: the
committed orbax checkpoint ``docs/results/ckpts/r3_town01_s0_best_params``
(the seed-0 Town01 policy of RESULTS.md: ``obs_mode="bev6"``, 192 px,
``ModelConfig()``) is restored with orbax on the JAX side, converted by
``convert.py::save_flax_params_checkpoint`` into the port's params-only
checkpoint, and warm-started through ``train.run(init_params=...)``. The
warm-started policy must give the flax policy's values, action means and
log-probs within 1e-5 relative at float32 (``tests/test_torch_policy.py``'s
tolerance). ``docs/`` is not copied to the card, so this runs on the CPU
only. The JAX package is imported inside the test only (read-only
reference).

``run`` builds its expert buffers before it warm-starts the policy; here
they keep their render states only (``materialize_obs=False``): at 192 px
the plain renderer on the CPU costs ~0.2 s a row, and a run of no update
reads no observation of them.
"""
import dataclasses
import functools
import pathlib

import numpy as np
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

from gail_carla_tpu_torch import train
from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.convert import save_flax_params_checkpoint
from gail_carla_tpu_torch.models import policy as port_policy

CKPT = (pathlib.Path(__file__).parent.parent / "docs" / "results" / "ckpts"
        / "r3_town01_s0_best_params")
TOL = dict(rtol=1e-5, atol=1e-6)
# one 107 m route: the warm start's demos stay short
ONE_ROUTE = dict(n_routes=1, nx=2, ny=2, block=60.0, min_length=40.0)


def test_jax_checkpoint_warm_starts_the_port(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.models.policy import act as jax_act
    from gail_carla_tpu.models.policy import init_policy as jax_init
    from gail_carla_tpu.utils.checkpoint import restore_checkpoint

    cfg = ModelConfig(dtype="float32")
    shape = (6, 192, 192)
    net, template = jax_init(jax.random.PRNGKey(0), cfg, shape)
    restored, _ = restore_checkpoint(str(CKPT), {"params": template})
    params = jax.tree.map(np.asarray, restored["params"])
    # the checkpoint is not the template's random init
    assert not np.array_equal(params["params"]["Dense_0"]["kernel"],
                              np.asarray(template["params"]["Dense_0"]
                                         ["kernel"]))
    port_ckpt = tmp_path / "port_best_params"
    save_flax_params_checkpoint(params, cfg, str(port_ckpt))

    smoke = train.make_presets()["smoke"]
    env_cfg = dataclasses.replace(smoke["env"], obs_mode="bev6",
                                  bev_width=192)
    tcfg = dataclasses.replace(smoke["train"], routes=(0,), eval_route=0)
    monkeypatch.setattr(train, "build_expert_buffer", functools.partial(
        train.build_expert_buffer, materialize_obs=False))
    state, _ = train.run(env_cfg, cfg, tcfg, ONE_ROUTE, 300, max_updates=0,
                         log_dir=str(tmp_path / "log"),
                         init_params=str(port_ckpt), device="cpu")
    assert state.update_i == 0

    rng = np.random.default_rng(3)
    obs = np.concatenate([
        rng.uniform(0.0, 1.0, (3, 3, 192, 192)),
        rng.choice([0.0, 80.0, 170.0, 255.0], (3, 1, 192, 192)) / 255.0,
        rng.uniform(0, 1, (3, 2, 192, 192)) < 0.1,
    ], axis=1).astype(np.float32)
    metrics = np.stack([
        rng.normal(0.0, 2e-4, 3), rng.normal(0.0, 2e-4, 3),
        rng.uniform(0.0, 8.0, 3), rng.integers(1, 7, 3),
    ], axis=1).astype(np.float32)
    key = jax.random.PRNGKey(8)
    v, a, lp = jax_act(net, restored["params"], jnp.asarray(obs),
                       jnp.asarray(metrics), key)
    noise = np.array(jax.random.normal(key, (3, 2)))
    pv, pa, plp = port_policy.act(state.policy, torch.from_numpy(obs),
                                  torch.from_numpy(metrics),
                                  noise=torch.from_numpy(noise))
    np.testing.assert_allclose(pv.numpy(), np.asarray(v), **TOL)
    np.testing.assert_allclose(pa.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(plp.numpy(), np.asarray(lp), **TOL)
