"""The port's slice end to end against the JAX package: ``collect_rollout``
(with ``store_obs=False``) and ``evaluate_policy`` on the smoke preset,
with converted params and JAX's action noise injected.

The env randomness is switched off here (GNSS noise 0, no random
restarts): the port draws it from a torch generator inside the loop, and
tests/test_torch_sim.py already holds the env against JAX with those
draws injected. Discrete outcomes must be equal; floats agree within
1e-4 (ulp-level library differences, accumulated over the steps). The
JAX package is imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.algo.evaluate import evaluate_policy
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.convert import policy_from_flax
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.ops import bev
from gail_carla_tpu_torch.sim.env import RenderState, reset_batch
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
ENV = dataclasses.replace(PRESET["env"], gnss_noise_deg=0.0,
                          random_restart_prob=0.0)
# short episodes (15 steps to the timeout) so the rollout auto-resets
ROLL_ENV = dataclasses.replace(ENV, max_time=1.5)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    import jax
    from gail_carla_tpu.models.policy import init_policy as jax_init
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    w = ENV.bev_width
    net, params = jax_init(jax.random.PRNGKey(2), PRESET["model"],
                           (3, w, w))
    port_net = policy_from_flax(jax.tree.map(np.asarray, params),
                                PRESET["model"], (3, w, w), device="cpu")
    return (make_benchmark_scene(**PRESET["scene"], device="cpu"),
            make_jax_scene(**PRESET["scene"]), net, params, port_net)


def _close(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_collect_rollout_matches_jax(setup):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.rollout import collect_rollout as jax_collect
    from gail_carla_tpu.sim.env import reset_batch as jax_reset

    port_scene, jax_scene, net, params, port_net = setup
    rid = np.array([0, 1, 0, 1], np.int32)
    n_steps = 40
    key = jax.random.PRNGKey(5)
    st, met, ren = jax_reset(jax_scene, ROLL_ENV, key, jnp.asarray(rid))
    out = jax_collect(jax_scene, ROLL_ENV, net, params, st, met, ren, key,
                      n_steps, store_obs=False)
    noise = np.stack([np.asarray(jax.random.normal(k, (len(rid), 2)))
                      for k in jax.random.split(key, n_steps)])

    pst, pmet, pren = reset_batch(port_scene, ROLL_ENV, torch.from_numpy(rid))
    pout = collect_rollout(port_scene, ROLL_ENV, port_net, pst, pmet, pren,
                           None, n_steps,
                           action_noise=torch.from_numpy(noise))
    ro, pro = out[3], pout[3]

    # first step whose JAX and port observations differ
    flip = n_steps + 1
    for t in range(n_steps + 1):
        jrs = _port_render(ro.render, t)
        prs = _port_render(pro.render, t)
        if not torch.equal(bev.render_bev_batch(port_scene, ROLL_ENV, jrs),
                           bev.render_bev_batch(port_scene, ROLL_ENV, prs)):
            flip = t
            break
    assert flip >= 30, flip
    if flip <= n_steps:
        dxy = (_port_render(ro.render, flip).xy - pro.render.xy[flip]).abs()
        assert float(dxy.max()) <= 1e-4

    rows = slice(0, flip)           # steps acted on equal observations
    done = 1.0 - pro.masks[1:][rows]
    for name in ("actions", "logp", "values", "env_rewards",
                 "gail_rewards"):
        _close(getattr(pro, name)[rows], getattr(ro, name)[rows], name)
    rows = slice(0, flip + 1)       # states up to the first differing one
    for name in ("metrics", "masks"):
        _close(getattr(pro, name)[rows], getattr(ro, name)[rows], name)
    for name in ("xy", "yaw", "route_id", "head", "step", "stop_idx"):
        _close(getattr(pro.render, name)[rows],
               getattr(ro.render, name)[rows], f"render.{name}")
    if flip > n_steps:
        for k, v in out[4].items():
            _close(pout[4][k], v, k)
    assert pro.obs is None
    assert int(done.sum()) >= 4   # episodes ended inside the window


def _port_render(render, t):
    """Row ``t`` of a stacked JAX or port render state, as a port one."""
    return RenderState(**{
        f.name: torch.from_numpy(np.array(getattr(render, f.name)[t]))
        for f in dataclasses.fields(RenderState)
    })


def test_collect_rollout_refuses_stored_obs(setup):
    port_scene, _, _, _, port_net = setup
    st, met, ren = reset_batch(port_scene, ENV, torch.tensor([0]))
    with pytest.raises(NotImplementedError, match="store_obs"):
        collect_rollout(port_scene, ENV, port_net, st, met, ren, None, 1,
                        store_obs=True)


def test_evaluate_policy_matches_jax(setup):
    import jax
    from gail_carla_tpu.algo.evaluate import evaluate_policy as jax_eval

    port_scene, jax_scene, net, params, port_net = setup
    want = jax_eval(jax_scene, ENV, net, params, jax.random.PRNGKey(1),
                    route_ids=[0, 1, 1], max_steps=120)
    got = evaluate_policy(port_scene, ENV, port_net, None,
                          route_ids=[0, 1, 1], max_steps=120)
    assert set(got) == set(want)
    # the first episodes end before any observation differs
    for k in want:
        _close(got[k], want[k], k)
    assert bool(got["done"].all())
