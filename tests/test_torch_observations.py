"""The port's ``observe_full`` (``sim/observations.py``) against the JAX
package's, vmapped over envs.

Both packages read the same world state: JAX's after a 10-step run of 3
envs on the smoke scene (fixed numpy actions), converted leaf by leaf
into the port's ``WorldState``. Env 2's route cursor is then moved to
within 20 points of the route table's end, where ``dynamic_slice`` clamps
the waypoint and route windows' start (the port's ``take_window``).
Tolerances: integer and boolean leaves equal, floats within 1e-5, the
rendered birdview and its masks 0 values differ. With 4 NPC vehicles and
2 walkers per env the object finders pad to ``max_detection=10``; a run
without actors takes their empty branch. The JAX package is imported
inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.sim.observations import observe_full
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
N_ENVS, N_STEPS = 3, 10
CLAMP_ENV, CLAMP_BACK = 2, 7   # env 2's head: 7 points before the end


def port_state(template, js):
    """The JAX state ``js`` as a port state with ``template``'s
    structure (every tensor leaf converted)."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(js)).to(template.dtype)
    return type(template)(**{
        f.name: port_state(getattr(template, f.name), getattr(js, f.name))
        for f in dataclasses.fields(template)
    })


def compare_obs(got, want, where=""):
    assert set(got) == set(want), where
    for k, v in want.items():
        name = f"{where}.{k}"
        if isinstance(v, dict):
            compare_obs(got[k], v, name)
            continue
        v, g = np.asarray(v), got[k].numpy()
        assert g.shape == v.shape, name
        if v.dtype.kind in "biu":
            assert g.dtype == v.dtype, name
            np.testing.assert_array_equal(g, v, err_msg=name)
        else:
            np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    return (make_benchmark_scene(**PRESET["scene"], device="cpu"),
            make_jax_scene(**PRESET["scene"]))


@pytest.mark.parametrize("actors", [(4, 2), (0, 0)], ids=["traffic",
                                                        "no_actors"])
def test_observe_full_matches_jax(scenes, actors):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import reset_batch, step_batch
    from gail_carla_tpu.sim.observations import observe_full as jax_full

    port_scene, jax_scene = scenes
    n_veh, n_wal = actors
    cfg = EnvConfig(train=False, full_bev=True, bev_width=64,
                    n_npc_vehicles=n_veh, n_npc_walkers=n_wal)
    rid = jnp.asarray([0, 1, 0], jnp.int32)
    js, _, _ = reset_batch(jax_scene, cfg, jax.random.PRNGKey(3), rid)
    step = jax.jit(lambda s, a: step_batch(jax_scene, cfg, s, a)[0])
    rng = np.random.default_rng(1)
    for _ in range(N_STEPS):
        act = np.stack([rng.uniform(-0.2, 0.2, N_ENVS),
                        rng.uniform(0.5, 1.0, N_ENVS)], 1)
        js = step(js, jnp.asarray(act, jnp.float32))
    L = jax_scene.route_xy.shape[1]
    js = js.replace(head=js.head.at[CLAMP_ENV].set(L - CLAMP_BACK))
    # distinct points and commands at the table's end (the padding repeats
    # the last route point), so that a clamped window shows
    xy = np.array(jax_scene.route_xy)
    cmd = np.array(jax_scene.route_cmd)
    xy[0, L - 30:] += np.arange(30)[:, None] * np.float32([0.5, 0.25])
    cmd[0, L - 30:] = np.arange(30) % 6 + 1
    jax_scene = jax_scene.replace(route_xy=jnp.asarray(xy),
                                  route_cmd=jnp.asarray(cmd))
    port_scene = dataclasses.replace(port_scene,
                                     route_xy=torch.from_numpy(xy),
                                     route_cmd=torch.from_numpy(cmd))
    want = jax.jit(jax.vmap(lambda s: jax_full(jax_scene, cfg, s)))(js)

    template, _, _ = port_env.reset_batch(
        port_scene, cfg, torch.from_numpy(np.array(rid)),
        torch.Generator().manual_seed(0))
    got = observe_full(port_scene, cfg, port_state(template, js))
    compare_obs(got, want)
    # the clamp: env 2's 20-point plan is the row's last 20 points
    tail = port_scene.route_xy[0, L - 20:]
    loc = got["route_plan"]["location"][CLAMP_ENV]
    assert not torch.equal(loc[0], loc[-1])
    ego = port_state(template, js).ego
    back = torch.stack([
        ego.xy[CLAMP_ENV, 0] + loc[:, 0] * torch.cos(ego.yaw[CLAMP_ENV])
        - loc[:, 1] * torch.sin(ego.yaw[CLAMP_ENV]),
        ego.xy[CLAMP_ENV, 1] + loc[:, 0] * torch.sin(ego.yaw[CLAMP_ENV])
        + loc[:, 1] * torch.cos(ego.yaw[CLAMP_ENV])], dim=-1)
    np.testing.assert_allclose(back.numpy(), tail.numpy(), atol=1e-3)
    np.testing.assert_array_equal(
        got["route_plan"]["command"][CLAMP_ENV].numpy(), cmd[0, L - 20:])
    mask = got["surrounding_vehicles"]["binary_mask"]
    assert mask.shape == (N_ENVS, 10)
    if n_veh:
        # the finder's slots past the 4 actors are padding
        assert not mask[:, n_veh:].any()
        assert (got["surrounding_vehicles"]["location"][:, :n_veh]
                != 0).any()
    else:
        assert not mask.any()
        assert not got["surrounding_pedestrians"]["location"].any()
    assert got["birdview"]["masks"].shape == (N_ENVS, 15, 64, 64)
