"""The port's 6-channel BEV renderer (``obs_mode="bev6"``) against the
JAX package's, and the CUDA kernel module's CPU behaviour.

Render states come from the port's simulator after steps with NPC
vehicles and walkers (tests/test_torch_traffic.py holds that simulator
against JAX), plus envs placed from a numpy seed at stop lines and stop
signs with actors around the ego, so that the signal, vehicle and walker
channels are drawn at every light phase. The renderers are elementwise
float32 code with the same op order, so the standard is bit-exact: 0
differing pixels. The JAX package is imported inside the tests only
(read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops import bev6, bev6_cuda
from gail_carla_tpu_torch.ops.bev import fetch_tl_cell
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import RenderState, reset_batch, step_batch
from gail_carla_tpu_torch.train import make_presets

PRESETS = make_presets()
TRAFFIC = dict(obs_mode="bev6", n_npc_vehicles=3, n_npc_walkers=2)


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    out = {}
    for name in ("smoke", "reference"):
        kw = PRESETS[name]["scene"]
        out[name] = (make_benchmark_scene(**kw, device="cpu"),
                     make_jax_scene(**kw))
    return out


def bev6_render_states(scene, n: int, n_placed: int, seed: int,
                       device="cpu"):
    """A RenderState batch: ``n`` envs after 20 steps of the port's
    simulator with 3 NPC vehicles and 2 walkers each, of which the first
    ``n_placed`` are then moved to stop lines and active stop signs at
    random sim steps, with their actors inside the 64 px view
    (``ops/bev6.py::place_in_view``)."""
    cfg = EnvConfig(**TRAFFIC)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rid = torch.arange(n, device=device) % scene.n_routes
    st, _, ren = reset_batch(scene, cfg, rid, gen)
    action = torch.tensor([[0.05, 0.7]], device=device).expand(n, 2)
    for _ in range(20):
        st, out = step_batch(scene, cfg, st, action, gen)
    # ego-frame offsets inside the 64 px view (8 m behind, 4.8 m ahead,
    # 6.4 m to each side)
    return bev6.place_in_view(scene, out.render, range(n_placed),
                              np.random.default_rng(seed),
                              cfg.n_npc_vehicles, cfg.n_npc_walkers,
                              view=(6.0, 4.0, 5.0))


def _jax_rs(rs):
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import RenderState as JaxRenderState

    return JaxRenderState(**{f.name: jnp.asarray(getattr(rs, f.name).numpy())
                             for f in dataclasses.fields(RenderState)})


@pytest.mark.parametrize("name,width", [("smoke", 64), ("reference", 192)])
def test_render_bev6_batch_matches_jax(scenes, name, width):
    from gail_carla_tpu.ops.bev6 import render_bev6_batch as jax_render

    port_scene, jax_scene = scenes[name]
    cfg = EnvConfig(bev_width=width, **TRAFFIC)
    rs = bev6_render_states(port_scene, 12, 8, seed=width)
    want = np.asarray(jax_render(jax_scene, cfg, _jax_rs(rs)))
    got = bev6.render_bev6_batch(port_scene, cfg, rs).numpy()
    assert got.shape == (12, 6, width, width)
    assert int((got != want).sum()) == 0
    # every channel is drawn, and the signals at more than one value
    assert all(got[:, c].any() for c in range(6))
    assert len(np.unique(got[:, 3])) >= 3


def test_render_bev6_auto_on_cpu_matches_pallas_interpret(scenes):
    """The plain version (every light) against the TPU kernel run in
    interpret mode (the cell's culled lights, the one active stop box)."""
    from gail_carla_tpu.ops.bev6_pallas import render_bev6_pallas_batch

    port_scene, jax_scene = scenes["smoke"]
    cfg = EnvConfig(bev_width=64, **TRAFFIC)
    rs = bev6_render_states(port_scene, 4, 3, seed=5)
    want = np.asarray(render_bev6_pallas_batch(jax_scene, cfg, _jax_rs(rs),
                                               interpret=True))
    launches = bev6_cuda.LIB.launches
    got = bev6.render_bev6_batch_auto(port_scene, cfg, rs).numpy()
    np.testing.assert_array_equal(got, want)
    assert bev6_cuda.LIB.launches == launches
    assert all(got[:, c].any() for c in (3, 4, 5))


def test_fetch_tl_cell_matches_jax(scenes):
    """The culled light table of each env's cell, with the cell index
    clamped into the grid for poses outside it."""
    import jax
    from gail_carla_tpu.ops.bev import fetch_tl_cell as jax_fetch

    port_scene, jax_scene = scenes["reference"]
    rng = np.random.default_rng(2)
    xy = rng.uniform(-150.0, 450.0, (64, 2)).astype(np.float32)
    want = jax.vmap(lambda p: jax_fetch(jax_scene, p))(xy)
    got = fetch_tl_cell(port_scene, torch.from_numpy(xy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].max()) > 0


def test_bev6_cuda_wrapper_raises_on_cpu_tensors():
    scene = make_benchmark_scene(**PRESETS["smoke"]["scene"], device="cpu")
    cfg = EnvConfig(bev_width=64, **TRAFFIC)
    rs = bev6_render_states(scene, 2, 1, seed=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bev6_cuda.render_bev6_cuda_batch(scene, cfg, rs)
    assert bev6_cuda.LIB.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("width", [192, 100])
def test_bev6_kernel_matches_plain_on_card(width):
    """The CUDA kernel against the plain version on the card, 0 differing
    values (runs where a CUDA device is present:
    ``python -m pytest --noconftest -m cuda tests/test_torch_bev6.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make_benchmark_scene(**PRESETS["reference"]["scene"],
                                 device="cuda")
    cfg = EnvConfig(bev_width=width, **TRAFFIC)
    rs = bev6_render_states(scene, 16, 8, seed=width, device="cuda")
    got = bev6_cuda.render_bev6_cuda_batch(scene, cfg, rs)
    want = bev6.render_bev6_batch(scene, cfg, rs)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0
    assert all(bool(got[:, c].any()) for c in (3, 4, 5))
