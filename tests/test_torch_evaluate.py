"""``evaluate_policy``'s early stop: the port stops once every env has
ended an episode (nothing after an env's first episode reaches the
result) and must return JAX's full-length evaluation, every draw
injected, within 1e-4 (``tests/test_torch_slice.py``'s tolerance; the
discrete fields equal). The JAX package is imported inside the test only
(read-only reference).
"""
import dataclasses

import numpy as np
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

from gail_carla_tpu_torch.algo import evaluate as evaluate_mod
from gail_carla_tpu_torch.algo.evaluate import evaluate_policy
from gail_carla_tpu_torch.convert import policy_from_flax
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]


def test_evaluate_stops_early_with_the_full_length_result():
    """``evaluate_policy`` stops once every env has ended an episode; its
    result equals JAX's full-length evaluation (every draw injected), and
    it stepped the envs fewer times than ``max_steps``."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.evaluate import evaluate_policy as jax_eval
    from gail_carla_tpu.models.policy import init_policy as jax_init
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )
    from gail_carla_tpu.sim.env import reset_batch as jax_reset
    from test_torch_slice import _jax_rollout_draws
    from test_torch_traffic import jax_batch_reset_draws

    cfg = dataclasses.replace(PRESET["env"], max_time=6.0)
    eval_cfg = dataclasses.replace(cfg, train=False,
                                   terminal_mode="leaderboard")
    w = cfg.bev_width
    net, params = jax_init(jax.random.PRNGKey(5), PRESET["model"], (3, w, w))
    port_net = policy_from_flax(jax.tree.map(np.asarray, params),
                                PRESET["model"], (3, w, w), device="cpu")
    port_scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    jax_scene = make_jax_scene(**PRESET["scene"])
    rid = np.array([0, 1, 1], np.int32)
    n, max_steps = len(rid), 150
    key = jax.random.PRNGKey(8)
    want = jax_eval(jax_scene, cfg, net, params, key, route_ids=rid,
                    max_steps=max_steps)
    st, _, _ = jax_reset(jax_scene, eval_cfg, key, jnp.asarray(rid))
    n_patrols = port_scene.patrol_xy.shape[0]
    env_draws = _jax_rollout_draws(st.rng, np.zeros((max_steps, n), bool),
                                   eval_cfg, n_patrols)
    draws, gnss = jax_batch_reset_draws(key, n, eval_cfg, n_patrols)

    calls = []
    step_batch = evaluate_mod.step_batch

    def counted(*a, **k):
        calls.append(1)
        return step_batch(*a, **k)

    evaluate_mod.step_batch = counted
    try:
        got = evaluate_policy(port_scene, cfg, port_net, None,
                              route_ids=rid, max_steps=max_steps,
                              reset_draws=draws, reset_gnss=gnss,
                              env_draws=env_draws)
    finally:
        evaluate_mod.step_batch = step_batch
    assert bool(got["done"].all())
    # 6 s episodes: every env has ended one by step 60
    assert len(calls) <= 60 < max_steps
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
