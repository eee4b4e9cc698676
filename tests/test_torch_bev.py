"""The port's BEV renderer against the JAX package's, and the CUDA kernel
module's CPU behaviour.

Inputs are poses along the routes of the reference-preset scene, made
from a numpy seed, including cursors within the route window (84 points)
of the route end, where the window start is clamped. The renderers are
elementwise float32 code with the same op order, so the standard is
bit-exact: 0 differing pixels. The JAX package is imported inside the
tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops import bev, bev_cuda
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import RenderState
from gail_carla_tpu_torch.train import make_presets

SCENE_KW = make_presets()["reference"]["scene"]


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    return (make_benchmark_scene(**SCENE_KW, device="cpu"),
            make_jax_scene(**SCENE_KW))


def _poses(scene, n, seed):
    """(rid, head, xy, yaw) numpy arrays: n poses jittered off the routes,
    up to three with cursors near their route's end."""
    rng = np.random.default_rng(seed)
    route_n = scene.route_n.numpy()
    rid = (np.arange(n) % len(route_n)).astype(np.int32)
    nr = route_n[rid]
    head = (rng.uniform(0.0, 1.0, n) * (nr - 1)).astype(np.int32)
    k = min(n, 3)
    head[:k] = nr[:k] - 1 - rng.integers(0, 84, k)
    xy = scene.route_xy.numpy()[rid, head] + rng.normal(0.0, 2.0, (n, 2))
    yaw = scene.route_yaw.numpy()[rid, head] + rng.normal(0.0, 0.3, n)
    return rid, head, xy.astype(np.float32), yaw.astype(np.float32)


def _port_rs(poses, device="cpu"):
    rid, head, xy, yaw = poses
    n = len(rid)
    z = torch.zeros(n, dtype=torch.int32)
    rs = RenderState(
        xy=torch.from_numpy(xy), yaw=torch.from_numpy(yaw),
        route_id=torch.from_numpy(rid), head=torch.from_numpy(head),
        step=z, stop_idx=z, npc_pose=torch.zeros((n, 0, 3)),
        walker_pose=torch.zeros((n, 0, 3)),
    )
    return RenderState(**{f.name: getattr(rs, f.name).to(device)
                          for f in dataclasses.fields(rs)})


def _render_states(poses):
    """(JAX RenderState, port RenderState) of the same poses."""
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import RenderState as JaxRenderState

    rid, head, xy, yaw = poses
    n = len(rid)
    z = jnp.zeros(n, jnp.int32)
    jax_rs = JaxRenderState(
        xy=jnp.asarray(xy), yaw=jnp.asarray(yaw), route_id=jnp.asarray(rid),
        head=jnp.asarray(head), step=z, stop_idx=z,
        npc_pose=jnp.zeros((n, 0, 3)), walker_pose=jnp.zeros((n, 0, 3)),
    )
    return jax_rs, _port_rs(poses)


@pytest.mark.parametrize("width", [192, 64])
def test_render_bev_batch_matches_jax(scenes, width):
    from gail_carla_tpu.ops.bev import render_bev_batch as jax_render

    port_scene, jax_scene = scenes
    cfg = EnvConfig(bev_width=width)
    jax_rs, port_rs = _render_states(_poses(port_scene, 8, width))
    want = np.asarray(jax_render(jax_scene, cfg, jax_rs))
    got = bev.render_bev_batch(port_scene, cfg, port_rs).numpy()
    assert got.shape == (8, 3, width, width)
    assert int((got != want).sum()) == 0
    # every channel is exercised
    assert all(got[:, c].any() for c in range(3))


def test_render_auto_on_cpu_matches_pallas_interpret(scenes):
    from gail_carla_tpu.ops.bev_pallas import render_bev_pallas_batch

    port_scene, jax_scene = scenes
    cfg = EnvConfig(bev_width=64)
    jax_rs, port_rs = _render_states(_poses(port_scene, 2, 7))
    want = np.asarray(render_bev_pallas_batch(jax_scene, cfg, jax_rs,
                                              interpret=True))
    launches = bev_cuda.LIB.launches
    got = bev.render_bev_batch_auto(port_scene, cfg, port_rs).numpy()
    np.testing.assert_array_equal(got, want)
    assert bev_cuda.LIB.launches == launches


def test_cuda_wrapper_raises_on_cpu_tensors():
    scene = make_benchmark_scene(**make_presets()["smoke"]["scene"],
                                 device="cpu")
    cfg = EnvConfig(bev_width=64)
    port_rs = _port_rs(_poses(scene, 2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bev_cuda.render_bev_cuda_batch(scene, cfg, port_rs)
    assert bev_cuda.LIB.launches == 0


def test_route_window_clamps_at_row_end():
    """``dynamic_slice`` clamps the window start so the window stays in
    the row; the port clamps it explicitly (an unclamped index on the
    card is a device-side assert)."""
    scene = make_benchmark_scene(**make_presets()["smoke"]["scene"],
                                 device="cpu")
    L = scene.route_xy.shape[1]
    rid = torch.tensor([0, 0], dtype=torch.int32)
    head = torch.tensor([L - 1, L - bev.ROUTE_WINDOW], dtype=torch.int32)
    segs = bev.route_window_segs(scene, rid, head)
    torch.testing.assert_close(segs[0], segs[1], rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card, 0 differing
    pixels (runs where a CUDA device is present:
    ``python -m pytest --noconftest -m cuda tests/test_torch_bev.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make_benchmark_scene(**SCENE_KW, device="cuda")
    for width in (192, 100):
        cfg = dataclasses.replace(EnvConfig(), bev_width=width)
        rs = _port_rs(_poses(scene.to("cpu"), 16, width), "cuda")
        got = bev_cuda.render_bev_cuda_batch(scene, cfg, rs)
        want = bev.render_bev_batch(scene, cfg, rs)
        assert int((got != want).sum()) == 0

