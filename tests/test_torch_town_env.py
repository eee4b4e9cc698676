"""The reconstructed town end to end, the port against the JAX package, on
the synthetic reference tree of ``tests/test_torch_town_import.py``: the
env's reset and steps on the town scene with NPC vehicles and walkers on
the sidewalk paths (every draw injected; the closed-loop tests'
tolerances), its ``"bev"`` and ``"bev6"`` observations (0 pixels differ
up to the first flip) and placed states with walkers in view (0 pixels),
the town presets field for field, and the suites' town scenes, configs
and task lists. The JAX package is imported inside
the tests only (read-only reference)."""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.envs import suites
from gail_carla_tpu_torch.ops.bev import render_bev_batch
from gail_carla_tpu_torch.ops.bev6 import place_in_view, render_bev6_batch
from gail_carla_tpu_torch.scene.town_import import make_town_scene
from gail_carla_tpu_torch.sim.env import reset_batch, step_batch
from gail_carla_tpu_torch.train import make_presets
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_slice import _close
from test_torch_town_import import (  # noqa: F401 (tree: a fixture)
    TOWN, assert_scene_matches_jax, tree,
)

PRESET = make_presets()["smoke"]
# 64 px, 2 s episodes, walkers only: the town's vehicles drive the same
# patrol code as the grid's (tests/test_torch_traffic.py), on patrol
# tables that test_town_suites_match_jax holds equal
BEV6 = dataclasses.replace(PRESET["env"], max_time=2.0, obs_mode="bev6",
                           n_npc_walkers=6)
STEPS = 24


@pytest.fixture(scope="module")
def scenes(tree):
    from gail_carla_tpu.scene import town_import as jax_ti

    return make_town_scene(TOWN, device="cpu"), jax_ti.make_town_scene(TOWN)


@pytest.fixture(scope="module")
def town_steps(scenes):
    """4 envs on the town scene, reset and stepped 24 times with fixed
    numpy actions by both packages (2 s episodes: every env auto-resets),
    6 walkers on the sidewalk paths each, every draw of the JAX envs
    injected into the port's. Returns the per-step (JAX
    state, JAX step output, port state, port step output) and the port's
    reset state."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim import env as jax_env
    from test_torch_traffic import (
        jax_batch_reset_draws, jax_step_draws_raw, step_draws_from_raw,
    )

    port_scene, jax_scene = scenes
    n_patrols = port_scene.patrol_xy.shape[0]
    n_paths = port_scene.walk_xy.shape[0]
    rid = np.array([0, 1, 2, 3], np.int32)
    n = len(rid)
    rng = np.random.default_rng(6)
    actions = np.stack([rng.uniform(-0.15, 0.15, (STEPS, n)),
                        rng.uniform(0.4, 1.0, (STEPS, n))],
                       -1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    js, _, _ = jax_env.reset_batch(jax_scene, BEV6, key, jnp.asarray(rid))
    draws, gnss = jax_batch_reset_draws(key, n, BEV6, n_patrols, n_paths)
    ps, _, _ = reset_batch(port_scene, BEV6, torch.from_numpy(rid),
                           draws=draws, gnss_noise=gnss)
    reset = ps
    step = jax.jit(lambda s, a: jax_env.step_batch(jax_scene, BEV6, s, a))
    step_draws = jax.jit(lambda r, d: jax_step_draws_raw(
        r, d, BEV6, n_patrols, n_paths))
    out = []
    for t in range(STEPS):
        rngs = js.rng
        js, jout = step(js, jnp.asarray(actions[t]))
        sd = step_draws_from_raw(step_draws(rngs, jout.done))
        ps, pout = step_batch(port_scene, BEV6, ps,
                              torch.from_numpy(actions[t]), **sd._asdict())
        out.append((js, jout, ps, pout))
    return out, reset


def test_town_env_steps_match_jax(scenes, town_steps):
    """The town's env steps with sidewalk walkers: the walkers start on
    the sidewalk paths at offset 0; traffic within the closed-loop tests' 1e-4 and discrete fields
    equal at every step, as are the ego's render state, the done flags and
    the step infos."""
    from test_torch_traffic import compare_poses, compare_traffic

    steps, reset = town_steps
    port_scene = scenes[0]
    assert float(reset.traffic.walker_off.abs().max()) == 0.0
    assert int(reset.traffic.walker_patrol.max()) < port_scene.walk_xy.shape[0]
    n_done = 0
    for t, (js, jout, ps, pout) in enumerate(steps):
        compare_traffic(js.traffic, ps.traffic, f"step {t}")
        np.testing.assert_array_equal(pout.done.numpy(),
                                      np.asarray(jout.done))
        for name in ("xy", "route_id", "head", "step", "stop_idx"):
            _close(getattr(pout.render, name), getattr(jout.render, name),
                   f"render.{name} at step {t}")
        for name in ("npc_pose", "walker_pose"):
            compare_poses(getattr(pout.render, name),
                          getattr(jout.render, name), f"{name} at step {t}")
        for k in ("collision_vehicle", "collision_walker", "valeo_reward",
                  "desired_speed"):
            _close(pout.info[k], jout.info[k], f"info.{k} at step {t}")
        n_done += int(pout.done.sum())
    assert n_done >= 4


@pytest.mark.parametrize("obs_mode", ["bev", "bev6"])
def test_town_renders_match_jax(scenes, town_steps, obs_mode):
    """The observation of every step of ``town_steps``, the port's render
    of its state against JAX's of its own: 0 values differ up to the first
    flip (an ulp of a pose, ROADMAP section C), no earlier than step 12;
    then states of the port with its sidewalk walkers placed in the 64 px
    view before stop lines (``ops/bev6.py::place_in_view``),
    rendered by both: 0 values differ, walkers drawn."""
    import jax
    from gail_carla_tpu.ops import bev as jax_bev
    from gail_carla_tpu.ops import bev6 as jax_bev6
    from test_torch_bev6 import _jax_rs

    port_scene, jax_scene = scenes
    cfg = dataclasses.replace(BEV6, obs_mode=obs_mode)
    port_render = render_bev6_batch if obs_mode == "bev6" else \
        render_bev_batch
    jax_render = jax.jit(lambda rs: (
        jax_bev6.render_bev6_batch if obs_mode == "bev6"
        else jax_bev.render_bev_batch)(jax_scene, cfg, rs))
    steps, _ = town_steps
    flip = len(steps)
    for t, (_, jout, _, pout) in enumerate(steps):
        got = port_render(port_scene, cfg, pout.render).numpy()
        if not np.array_equal(got, np.asarray(jax_render(jout.render))):
            flip = t
            break
    assert flip >= 12, flip

    placed = place_in_view(port_scene, steps[10][3].render,
                           range(0, 4, 2), np.random.default_rng(3), 0, 6,
                           view=(6.0, 4.0, 5.0))
    got = port_render(port_scene, cfg, placed)
    want = np.asarray(jax_render(_jax_rs(placed)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got[:, 0] != 0).sum()) > 0
    if obs_mode == "bev6":
        assert int((got[:, 5] != 0).sum()) > 0     # the walkers


def test_town_presets_match_jax():
    """``make_presets()`` equals JAX's field for field, the town presets
    (town01, town03, town04) among them."""
    from gail_carla_tpu.train import make_presets as jax_presets

    port, want = make_presets(), jax_presets()
    assert sorted(port) == sorted(want)
    assert {"town01", "town03", "town04"} <= set(port)
    for name in want:
        for part in ("env", "model", "train"):
            assert dataclasses.asdict(port[name][part]) == \
                dataclasses.asdict(want[name][part]), (name, part)
        assert port[name]["scene"] == want[name]["scene"], name
        assert port[name]["demo_steps"] == want[name]["demo_steps"], name


@pytest.mark.parametrize("suite", ["leaderboard", "nocrash", "corl"])
def test_town_suites_match_jax(tree, suite):
    """The suites' town branches: the leaderboard suite on the town's
    route pack, NoCrash dense (100 + 250) and CoRL2017
    navigation_dynamic (Town01's 20 + 50) on their packs of bare
    start/goal pairs: scene, config and task list equal JAX's."""
    from gail_carla_tpu.envs import suites as jax_suites

    if suite == "leaderboard":
        port = suites.leaderboard_suite(town=TOWN, device="cpu")
        want = jax_suites.leaderboard_suite(town=TOWN)
    elif suite == "nocrash":
        port = suites.nocrash_suite("dense", town=TOWN, device="cpu")
        want = jax_suites.nocrash_suite("dense", town=TOWN)
        assert port[1].n_npc_walkers == 250
    else:
        port = suites.corl2017_suite("navigation_dynamic", town=TOWN,
                                     device="cpu")
        want = jax_suites.corl2017_suite("navigation_dynamic", town=TOWN)
        assert port[1].n_npc_vehicles == 20
    assert port[0].walk_xy is not None
    assert_scene_matches_jax(port[0], want[0], suite)
    assert dataclasses.asdict(port[1]) == dataclasses.asdict(want[1])
    assert port[2] == want[2] and len(port[2]) >= 4
