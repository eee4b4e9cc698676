"""The port's observation store (``algo/buffers.py``) against the JAX
package's: the bit-packed observation (``pack_bev_obs``/``unpack_bev_obs``)
for ``"bev"`` and ``"bev6"``, ``build_expert_buffer`` and the stored-vs-
re-rendered minibatch fetch.

Packing thresholds discrete levels and unpacking multiplies each level by
``INV_255`` as the renderers do, so the standard is bit-exact: 0 differing
values, and ``unpack(pack(render))`` equals the render. The render states
come from the port's simulator with NPC traffic plus envs placed at stop
lines with actors in view (``test_torch_bev6.bev6_render_states``), so
every channel and light level is drawn. The JAX package is imported
inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.algo import buffers
from gail_carla_tpu_torch.algo.expert import DemoBatch
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.convert import init_policy
from gail_carla_tpu_torch.ops.bev import render_bev_batch
from gail_carla_tpu_torch.ops.bev6 import render_bev6_batch
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import RenderState, reset_batch
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
TRAFFIC = dict(n_npc_vehicles=3, n_npc_walkers=2)
MODES = {
    "bev": EnvConfig(bev_width=64),
    "bev6": EnvConfig(bev_width=64, obs_mode="bev6", **TRAFFIC),
}
RENDER = {"bev": render_bev_batch, "bev6": render_bev6_batch}


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    return (make_benchmark_scene(**PRESET["scene"], device="cpu"),
            make_jax_scene(**PRESET["scene"]))


def _jax_state(rs):
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import RenderState as JaxRenderState

    return JaxRenderState(**{f.name: jnp.asarray(getattr(rs, f.name).numpy())
                             for f in dataclasses.fields(RenderState)})


@pytest.mark.parametrize("mode", ["bev", "bev6"])
def test_pack_unpack_match_jax(scenes, mode):
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import pack_bev_obs, unpack_bev_obs
    from test_torch_bev6 import bev6_render_states

    port_scene, _ = scenes
    cfg = MODES[mode]
    rs = bev6_render_states(port_scene, 12, 10, seed=0)
    img = RENDER[mode](port_scene, cfg, rs)
    c = img.shape[1]
    # every level of every channel is drawn
    levels = {0: {0, 255}, 1: {0, 255}, 2: {0, 120, 255},
              3: {0, 80, 170, 255}, 4: {0, 255}, 5: {0, 255}}
    for ch in range(c):
        got = set(np.unique(np.rint(img[:, ch].numpy() * 255.0)).tolist())
        assert got == levels[ch], (ch, got)

    packed = buffers.pack_bev_obs(cfg, img)
    want = np.asarray(pack_bev_obs(cfg, jnp.asarray(img.numpy())))
    assert packed.dtype == torch.uint8 and packed.shape == (12, 64, 64)
    np.testing.assert_array_equal(packed.numpy(), want)
    back = buffers.unpack_bev_obs(cfg, packed)
    assert back.numpy().tobytes() == img.numpy().tobytes()

    # every byte value, against JAX's unpack
    every = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16)
    got = buffers.unpack_bev_obs(cfg, every).numpy()
    want = np.asarray(unpack_bev_obs(cfg, jnp.asarray(every.numpy())))
    assert got.shape == (1, c, 16, 16)
    assert got.tobytes() == want.tobytes()


def _rollout(scene, cfg, n_steps, seed, store_obs):
    gen = torch.Generator()
    gen.manual_seed(seed)
    c = 6 if cfg.obs_mode == "bev6" else 3
    net = init_policy(PRESET["model"], (c, 64, 64), seed=seed, device="cpu")
    st, met, ren = reset_batch(scene, cfg, torch.tensor([0, 1, 1]), gen)
    return collect_rollout(scene, cfg, net, st, met, ren, gen, n_steps,
                           store_obs=store_obs)[3]


@pytest.mark.parametrize("mode", ["bev", "bev6"])
def test_build_expert_buffer_matches_jax(scenes, mode):
    """The same demos (a port rollout with a random validity mask) through
    both ``build_expert_buffer``s: valid rows compacted and repeated up to
    ``size``, obs rendered and packed."""
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import build_expert_buffer
    from gail_carla_tpu.algo.expert import DemoBatch as JaxDemoBatch

    port_scene, jax_scene = scenes
    cfg = MODES[mode]
    ro = _rollout(port_scene, cfg, 12, seed=3, store_obs=False)
    valid = torch.from_numpy(
        np.random.default_rng(4).uniform(size=(12, 3)) < 0.4)
    render = buffers.map_state(lambda a: a[:-1], ro.render)
    demos = DemoBatch(render, ro.metrics[:-1], ro.actions, valid)
    jdemos = JaxDemoBatch(_jax_state(render),
                          jnp.asarray(ro.metrics[:-1].numpy()),
                          jnp.asarray(ro.actions.numpy()),
                          jnp.asarray(valid.numpy()))
    n_valid = int(valid.sum())
    size = n_valid + 5          # repeats the first valid rows
    want = build_expert_buffer(jax_scene, cfg, jdemos, size=size)
    got = buffers.build_expert_buffer(port_scene, cfg, demos, size=size)
    assert got.size == size
    np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))
    np.testing.assert_array_equal(got.metrics.numpy(),
                                  np.asarray(want.metrics))
    np.testing.assert_array_equal(got.actions.numpy(),
                                  np.asarray(want.actions))
    for f in dataclasses.fields(RenderState):
        np.testing.assert_array_equal(
            getattr(got.render, f.name).numpy(),
            np.asarray(getattr(want.render, f.name)))
    capped = buffers.build_expert_buffer(port_scene, cfg, demos,
                                         materialize_obs=False, max_size=4)
    assert capped.obs is None and capped.size == 4

    # the packed store and a re-render give the same float obs
    idx = torch.tensor([0, size - 1, 3, 7])
    stored = buffers.fetch_expert_obs(port_scene, cfg, got, idx)
    remat = buffers.fetch_expert_obs(
        port_scene, cfg, dataclasses.replace(got, obs=None), idx)
    assert stored.numpy().tobytes() == remat.numpy().tobytes()


@pytest.mark.parametrize("mode", ["bev", "bev6"])
def test_fetch_rollout_obs_stored_matches_rerender(scenes, mode):
    port_scene, _ = scenes
    cfg = MODES[mode]
    ro = _rollout(port_scene, cfg, 10, seed=5, store_obs=True)
    assert ro.obs.dtype == torch.uint8 and ro.obs.shape == (11, 3, 64, 64)
    t_idx = torch.tensor([0, 3, 7, 10, 5])
    n_idx = torch.tensor([0, 2, 1, 0, 2])
    stored = buffers.fetch_rollout_obs(port_scene, cfg, ro, t_idx, n_idx)
    remat = buffers.fetch_rollout_obs(
        port_scene, cfg, dataclasses.replace(ro, obs=None), t_idx, n_idx)
    assert stored.shape == (5, 6 if mode == "bev6" else 3, 64, 64)
    assert stored.numpy().tobytes() == remat.numpy().tobytes()
