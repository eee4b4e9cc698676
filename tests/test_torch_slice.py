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


def test_collect_rollout_stored_obs_matches_jax(setup):
    """``collect_rollout(store_obs=True)``: the bit-packed store of every
    step's observation and of the bootstrap's equals JAX's byte for byte,
    over a window that ends before the first observation that differs
    (step 36 of this rollout, see ``test_collect_rollout_matches_jax``)."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.rollout import collect_rollout as jax_collect
    from gail_carla_tpu.sim.env import reset_batch as jax_reset

    port_scene, jax_scene, net, params, port_net = setup
    rid = np.array([0, 1, 0, 1], np.int32)
    n_steps = 30
    key = jax.random.PRNGKey(5)
    st, met, ren = jax_reset(jax_scene, ROLL_ENV, key, jnp.asarray(rid))
    ro = jax_collect(jax_scene, ROLL_ENV, net, params, st, met, ren, key,
                     n_steps, store_obs=True)[3]
    noise = np.stack([np.asarray(jax.random.normal(k, (len(rid), 2)))
                      for k in jax.random.split(key, n_steps)])

    pst, pmet, pren = reset_batch(port_scene, ROLL_ENV, torch.from_numpy(rid))
    pro = collect_rollout(port_scene, ROLL_ENV, port_net, pst, pmet, pren,
                          None, n_steps, store_obs=True,
                          action_noise=torch.from_numpy(noise))[3]
    want = np.asarray(ro.obs)
    assert pro.obs.dtype == torch.uint8
    assert pro.obs.shape == want.shape == (n_steps + 1, len(rid), 64, 64)
    np.testing.assert_array_equal(pro.obs.numpy(), want)
    # the store holds road, route and both lane levels, and episodes
    # ended inside the window
    assert (want & 1).any() and (want & 2).any()
    assert set(np.unique((want >> 2) & 3).tolist()) == {0, 1, 2}
    assert int((1.0 - pro.masks[1:]).sum()) >= 4


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


# the bev6 slice: 6-channel observation at 128 px (a view wide enough to
# see the NPCs), 12 NPC vehicles and 12 walkers per env, the default env
# randomness on (every draw injected), 15-step episodes
BEV6_ENV = dataclasses.replace(PRESET["env"], obs_mode="bev6",
                               bev_width=128, n_npc_vehicles=12,
                               n_npc_walkers=12, max_time=1.5)


def _jax_rollout_draws(rng0, dones, cfg, n_patrols):
    """Per step of a JAX rollout, the port ``StepDraws`` of every draw the
    JAX envs made, from the reset state's keys and the steps' done flags."""
    import jax
    import jax.numpy as jnp
    from test_torch_traffic import jax_step_draws

    def next_rng(r, d):
        rng_next, k_reset, _ = jax.random.split(r, 3)
        fresh = jax.random.split(k_reset, 4)[0]
        return jax.random.split(jnp.where(d, fresh, rng_next))[0]

    out, r = [], rng0
    for d in dones:
        d = jnp.asarray(d)
        out.append(jax_step_draws(r, d, cfg, n_patrols))
        r = jax.vmap(next_rng)(r, d)
    return out


def test_bev6_rollout_with_traffic_matches_jax():
    """``collect_rollout`` with ``obs_mode="bev6"`` and NPC traffic, port
    against JAX with converted params and every draw injected. The
    comparison runs up to the first step whose JAX observation, as the
    jitted JAX rollout rendered and stored it, differs from the port's:
    XLA fuses a + b*c into one multiply-add inside the rollout, which
    eventually flips a single pixel."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import unpack_bev_obs
    from gail_carla_tpu.algo.rollout import collect_rollout as jax_collect
    from gail_carla_tpu.models.policy import init_policy as jax_init
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )
    from gail_carla_tpu.sim.env import reset_batch as jax_reset
    from test_torch_traffic import compare_poses, jax_batch_reset_draws

    from gail_carla_tpu_torch.ops.bev6 import render_bev6_batch

    cfg = BEV6_ENV
    w = cfg.bev_width
    net, params = jax_init(jax.random.PRNGKey(3), PRESET["model"], (6, w, w))
    port_net = policy_from_flax(jax.tree.map(np.asarray, params),
                                PRESET["model"], (6, w, w), device="cpu")
    port_scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    jax_scene = make_jax_scene(**PRESET["scene"])
    n_patrols = port_scene.patrol_xy.shape[0]
    rid = np.array([0, 1, 0, 1], np.int32)
    n, n_steps = len(rid), 40
    key = jax.random.PRNGKey(9)
    st, met, ren = jax_reset(jax_scene, cfg, key, jnp.asarray(rid))
    # stored observations: the first step whose JAX observation (rendered
    # inside the jitted rollout) differs from the port's ends the window
    out = jax_collect(jax_scene, cfg, net, params, st, met, ren, key,
                      n_steps, store_obs=True)
    ro = out[3]
    jax_obs = np.asarray(jax.vmap(lambda o: unpack_bev_obs(cfg, o))(ro.obs))
    noise = np.stack([np.asarray(jax.random.normal(k, (n, 2)))
                      for k in jax.random.split(key, n_steps)])
    dones = np.asarray(ro.masks)[1:] == 0.0
    env_draws = _jax_rollout_draws(st.rng, dones, cfg, n_patrols)

    draws, gnss = jax_batch_reset_draws(key, n, cfg, n_patrols)
    pst, pmet, pren = reset_batch(port_scene, cfg, torch.from_numpy(rid),
                                  draws=draws, gnss_noise=gnss)
    pout = collect_rollout(port_scene, cfg, port_net, pst, pmet, pren, None,
                           n_steps, action_noise=torch.from_numpy(noise),
                           env_draws=env_draws)
    pro = pout[3]

    flip = n_steps
    seen = torch.zeros(6, dtype=torch.bool)
    for t in range(n_steps):
        img = render_bev6_batch(port_scene, cfg, _port_render(pro.render, t))
        if not np.array_equal(img.numpy(), jax_obs[t]):
            flip = t
            break
        seen |= img.amax(dim=(0, 2, 3)) > 0
    # the first differing observation is at step 37 of 40: one lane
    # pixel that XLA computes with a fused multiply-add inside the jitted
    # rollout (the JAX renderer called alone gives the port's pixels)
    assert flip >= 30, flip

    rows = slice(0, flip)
    for name in ("actions", "logp", "values", "env_rewards"):
        _close(getattr(pro, name)[rows], getattr(ro, name)[rows], name)
    rows = slice(0, flip + 1)
    for name in ("metrics", "masks"):
        _close(getattr(pro, name)[rows], getattr(ro, name)[rows], name)
    for name in ("xy", "yaw", "route_id", "head", "step", "stop_idx"):
        _close(getattr(pro.render, name)[rows],
               getattr(ro.render, name)[rows], f"render.{name}")
    for name in ("npc_pose", "walker_pose"):
        compare_poses(getattr(pro.render, name)[rows],
                      np.asarray(getattr(ro.render, name))[rows],
                      f"render.{name}")
    assert int((1.0 - pro.masks[1:][:flip]).sum()) >= 4
    # the policy saw NPC vehicles and walkers before the window ended
    assert bool(seen[4]) and bool(seen[5])


def test_bev6_evaluate_with_traffic_matches_jax():
    """``evaluate_policy`` with ``obs_mode="bev6"`` and NPC traffic, port
    against JAX with converted params and every draw injected: the reset's
    and each step's. The policy's throttle bias is raised so that the ego
    drives into the traffic within 3 s episodes, and a port run with other
    draws must end differently, so the draws decide the results compared.
    The step draws follow each env's key chain without an auto-reset; an
    env's chain changes only after its first episode ends, and nothing
    after that reaches the latched results."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.evaluate import evaluate_policy as jax_eval
    from gail_carla_tpu.models.policy import init_policy as jax_init
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )
    from gail_carla_tpu.sim.env import reset_batch as jax_reset
    from test_torch_traffic import jax_batch_reset_draws

    cfg = dataclasses.replace(BEV6_ENV, max_time=3.0)
    eval_cfg = dataclasses.replace(cfg, train=False,
                                   terminal_mode="leaderboard")
    w = cfg.bev_width
    net, params = jax_init(jax.random.PRNGKey(4), PRESET["model"], (6, w, w))
    params = jax.tree.map(np.array, params)
    params["params"]["Dense_4"]["bias"][2] += 2.0   # throttle mean
    port_net = policy_from_flax(params, PRESET["model"], (6, w, w),
                                device="cpu")
    port_scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    jax_scene = make_jax_scene(**PRESET["scene"])
    n_patrols = port_scene.patrol_xy.shape[0]
    rid = np.array([0, 1, 1, 0], np.int32)
    n, n_steps = len(rid), 32
    key = jax.random.PRNGKey(6)
    want = jax_eval(jax_scene, cfg, net, params, key, route_ids=rid,
                    max_steps=n_steps)

    st, _, _ = jax_reset(jax_scene, eval_cfg, key, jnp.asarray(rid))
    env_draws = _jax_rollout_draws(st.rng, np.zeros((n_steps, n), bool),
                                   eval_cfg, n_patrols)
    draws, gnss = jax_batch_reset_draws(key, n, eval_cfg, n_patrols)
    got = evaluate_policy(port_scene, cfg, port_net, None, route_ids=rid,
                          max_steps=n_steps, reset_draws=draws,
                          reset_gnss=gnss, env_draws=env_draws)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    assert bool(got["done"].all())

    gen = torch.Generator()
    gen.manual_seed(0)
    other = evaluate_policy(port_scene, cfg, port_net, gen, route_ids=rid,
                            max_steps=n_steps)
    assert not torch.equal(other["score_route"], got["score_route"])
