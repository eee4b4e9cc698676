"""One whole ``WDGAILLearner.update`` against JAX's on the 6-channel
observation (``obs_mode="bev6"``, 2 NPC vehicles and 2 walkers per env)
with the packed store, for ``algo="wdgail"`` and ``"ppo"``: the mode
``tests/test_torch_learner.py`` leaves out (the re-rendered observation
is in ``tests/test_torch_learner_rerender.py``).

Toy shapes and tolerances of ``tests/test_torch_learner.py``
(``check_update_matches_jax``: metrics 1e-4 relative, weights 2e-5,
every draw injected). The expert buffer is JAX's ``build_expert_buffer``
over 2 envs x 64 steps of the port's scripted expert on the smoke scene
(rendered by JAX, converted to tensors). The JAX package is imported
inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_learner import (
    ENV, MODEL, TCFG, _port_expert, _t, check_update_matches_jax,
)

from gail_carla_tpu_torch.agents.autopilot import TARGET_SPEED, autopilot_act
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.algo.rollout import stack_states
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import reset_batch, step_batch
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
ENV6 = dataclasses.replace(ENV, obs_mode="bev6", n_npc_vehicles=2,
                           n_npc_walkers=2)
EXPERT_STEPS, EXPERT_ROWS = 64, 128


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


def expert_buffers(port_scene, jax_scene, env):
    """(JAX's expert buffer, its port copy): ``EXPERT_ROWS`` rows of the
    port's scripted expert on routes 0 and 1, every step valid, rendered
    and packed by JAX's ``build_expert_buffer`` for ``env``."""
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import build_expert_buffer
    from gail_carla_tpu.algo.expert import DemoBatch as JaxDemoBatch
    from gail_carla_tpu.sim.env import RenderState as JaxRenderState

    gen = torch.Generator().manual_seed(0)
    st, met, ren = reset_batch(port_scene, env, torch.tensor([0, 1]), gen)
    ap = make_autopilot((2,), "cpu")
    rens, mets, acts = [], [], []
    for _ in range(EXPERT_STEPS):
        ap, act = autopilot_act(port_scene, ap, st, TARGET_SPEED, True)
        rens.append(ren)
        mets.append(met)
        acts.append(act)
        st, out = step_batch(port_scene, env, st, act, gen)
        met, ren = out.metrics, out.render
    render = stack_states(rens)
    jdemos = JaxDemoBatch(
        JaxRenderState(**{f.name: jnp.asarray(getattr(render, f.name)
                                              .numpy())
                          for f in dataclasses.fields(render)}),
        jnp.asarray(torch.stack(mets).numpy()),
        jnp.asarray(torch.stack(acts).numpy()),
        jnp.ones((EXPERT_STEPS, 2), bool))
    expert = build_expert_buffer(jax_scene, env, jdemos, size=EXPERT_ROWS)
    return expert, _port_expert(expert)


def check_mode(scenes, env, store_obs, algo):
    """``check_update_matches_jax`` for ``algo`` on ``env`` with the
    expert of ``expert_buffers``; returns the port's metrics and state."""
    port_scene, jax_scene = scenes
    if algo == "wdgail":
        tcfg = dataclasses.replace(TCFG, gail_reward_shift=0.5)
        jax_expert, port_expert = expert_buffers(port_scene, jax_scene, env)
    else:
        tcfg = dataclasses.replace(TCFG, algo="ppo", bcgail=False)
        jax_expert = port_expert = None
    got, ps2 = check_update_matches_jax(
        jax_scene, port_scene, env, MODEL, tcfg, jax_expert, port_expert,
        store_obs=store_obs)
    if algo == "wdgail":
        assert float(got["ppo/bc_loss"]) != 0.0
        assert ps2.disc_opt.count == 2 * 64 // TCFG.gail_batch_size
    else:
        assert ps2.disc_opt.count == 0
    assert _t(np.asarray(got["ppo/value_loss"])).isfinite()
    return got, ps2


@pytest.mark.parametrize("algo", ["wdgail", "ppo"])
def test_learner_update_bev6_matches_jax(scenes, algo):
    _, ps2 = check_mode(scenes, ENV6, True, algo)
    assert ps2.render.npc_pose.shape[1] == ENV6.n_npc_vehicles
