"""The port's demo-file tools against the JAX package's: the exporter
(``tools/gen_trajectories.py``), the tree loader (``tools/
expert_dataset.py``), the repaired ``algo/buffers.py::_decode`` and a
training update from a file-backed expert buffer.

The JAX tree is made once per module: 25 steps of route 0 of the smoke
scene with cameras. The port's exporter gets JAX's draws (its
``PRNGKey(1337)`` chain recomputed as ``DemoDraws``) and must write the
same tree: the same step count, actions within 1e-5 relative, metrics
within 1e-4, masks and the rendered BEV at 0 differing values up to the
first closed-loop flip (none in these 25 steps), cameras within one
level. The update from a file-backed buffer (3 and 6 channels, the
tree's masks cut to the learner tests' 64 px) is held to
``tests/test_torch_learner.py``'s tolerances with every draw injected.
Behaviour cloning and the command-line recipe are in
``tests/test_torch_bc.py``. The JAX package is imported inside the tests
only (read-only reference).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from test_torch_expert import (  # noqa: F401 (one_torch_thread: autouse)
    _noiser_init_draws, _noiser_step_draws, one_torch_thread,
    single_torch_thread,
)
from test_torch_traffic import jax_batch_reset_draws

from gail_carla_tpu_torch.agents.noiser import NoiserDraws
from gail_carla_tpu_torch.algo import buffers
from gail_carla_tpu_torch.algo.expert import DemoDraws
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.tools.expert_dataset import (
    expert_buffer_from_tree, load_expert_tree,
)
from gail_carla_tpu_torch.tools.gen_trajectories import gen_trajectories
from gail_carla_tpu_torch.train import make_presets
from gail_carla_tpu_torch.utils.png import read_png

SCENE = make_presets()["smoke"]["scene"]
TREE_STEPS = 25
# the exporter's env (gen_trajectories.py: 192 px, full BEV)
TREE_ENV = EnvConfig(train=False, full_bev=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_tree_draws(n_routes, n_steps, jax_scene, n_patrols):
    """Each episode's draws of JAX's ``gen_trajectories`` (one episode
    per route, none ending before ``n_steps``), as port ``DemoDraws``:
    per episode a 4-way split of the run's key (reset, two noiser inits),
    per step a 3-way split (two noiser steps), and the env's own chain."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import reset_batch as jax_reset
    from test_torch_slice import _jax_rollout_draws

    rng = jax.random.PRNGKey(1337)
    out = []
    for route in range(n_routes):
        rng, k_r, k_n1, k_n2 = jax.random.split(rng, 4)
        reset, gnss = jax_batch_reset_draws(k_r, 1, TREE_ENV, n_patrols)
        st, _, _ = jax_reset(jax_scene, TREE_ENV, k_r,
                             jnp.asarray([route], jnp.int32))
        thr, steer = [], []
        for _ in range(n_steps):
            rng, k1, k2 = jax.random.split(rng, 3)
            thr.append(_noiser_step_draws(k1[None]))
            steer.append(_noiser_step_draws(k2[None]))
        stack = lambda d: NoiserDraws(*[  # noqa: E731
            _t(np.stack([np.asarray(s[i]) for s in d])) for i in range(3)])
        out.append(DemoDraws(
            reset=reset, reset_gnss=gnss,
            throttle_init=_noiser_init_draws(k_n1[None]),
            steer_init=_noiser_init_draws(k_n2[None]),
            throttle=stack(thr), steer=stack(steer),
            env=_jax_rollout_draws(st.rng, np.zeros((n_steps, 1), bool),
                                   TREE_ENV, n_patrols)))
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(port scene, JAX scene, JAX tree dir, port tree dir), both trees
    written from the same draws."""
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )
    from gail_carla_tpu.tools.gen_trajectories import (
        gen_trajectories as jax_gen,
    )

    base = tmp_path_factory.mktemp("trees")
    jax_gen(out_dir=str(base / "jax"), traj_name="t", n_routes=1,
            max_steps=TREE_STEPS, with_cameras=True, scene_kwargs=SCENE)
    port_scene = make_benchmark_scene(**SCENE, device="cpu")
    jax_scene = make_jax_scene(**SCENE)
    draws = jax_tree_draws(1, TREE_STEPS, jax_scene,
                           port_scene.patrol_xy.shape[0])
    with single_torch_thread():
        summary = gen_trajectories(
            out_dir=str(base / "port"), traj_name="t", n_routes=1,
            max_steps=TREE_STEPS, with_cameras=True, device="cpu",
            draws=draws, scene=port_scene)
    assert summary == [dict(route=0, ep=0, steps=TREE_STEPS,
                            completed=False)]
    return port_scene, jax_scene, base / "jax", base / "port"


def _episode(tree):
    return tree / "t" / "route_00" / "ep_00"


def test_exported_tree_matches_jax(trees):
    _, _, jax_dir, port_dir = trees
    je, pe = _episode(jax_dir), _episode(port_dir)
    jp = json.loads((je / "episode.json").read_text())
    pp = json.loads((pe / "episode.json").read_text())
    assert set(pp) == {"actions", "metrics"}
    assert list(pp["actions"]) == list(jp["actions"]) == [
        str(i) for i in range(TREE_STEPS)]
    np.testing.assert_allclose(
        np.array(list(pp["actions"].values())),
        np.array(list(jp["actions"].values())), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.array(list(pp["metrics"].values())),
        np.array(list(jp["metrics"].values())), rtol=1e-4, atol=1e-4)
    # masks and the rendered BEV at 0 values at every step: no closed-loop
    # flip within these steps
    for i in range(TREE_STEPS):
        names = [f"birdview_masks/{i:04d}_{m:02d}.png" for m in range(5)]
        for name in names + [f"birdview/{i:04d}.png"]:
            np.testing.assert_array_equal(read_png(pe / name),
                                          read_png(je / name),
                                          err_msg=name)
    n_vals = n_diff = 0
    for cam in ("rgb", "rgb_left", "rgb_right"):
        for i in range(TREE_STEPS):
            got = read_png(pe / cam / f"{i:04d}.png").astype(int)
            want = read_png(je / cam / f"{i:04d}.png").astype(int)
            assert np.abs(got - want).max() <= 1, (cam, i)
            n_vals += got.size
            n_diff += int((got != want).sum())
    # measured: 0 differing camera values
    assert n_diff == 0, (n_diff, n_vals)


@pytest.mark.parametrize("n_channels", [3, 6])
def test_loaders_read_each_others_trees(trees, n_channels):
    from gail_carla_tpu.tools.expert_dataset import (
        load_expert_tree as jax_load,
    )

    _, _, jax_dir, port_dir = trees
    for tree in (jax_dir, port_dir):
        got = load_expert_tree(str(tree), [0], n_channels=n_channels)
        want = jax_load(str(tree), [0], n_channels=n_channels)
        assert got[0].shape == (TREE_STEPS, n_channels, 192, 192)
        assert got[0].dtype == np.uint8
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the parent of the trajectory directory loads too
    np.testing.assert_array_equal(
        load_expert_tree(str(jax_dir / "t"), [0], n_channels=n_channels)[0],
        load_expert_tree(str(jax_dir), [0], n_channels=n_channels)[0])


def test_decode_matches_jax(trees):
    """``_decode`` of the (M, C, W, W) planes equals JAX's compiled one
    (lane levels of 120 show a true division's ulp), and the bit-packed
    path is unchanged."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import _decode as jax_decode
    from gail_carla_tpu.algo.buffers import pack_bev_obs as jax_pack

    _, _, jax_dir, _ = trees
    for nc, mode in ((3, "bev"), (6, "bev6")):
        cfg = dataclasses.replace(TREE_ENV, obs_mode=mode)
        obs = load_expert_tree(str(jax_dir), [0], n_channels=nc)[0]
        assert (obs[:, 2] == 120).any()
        want = np.asarray(jax.jit(lambda o: jax_decode(cfg, o))(
            jnp.asarray(obs)))
        got = buffers._decode(cfg, _t(obs)).numpy()
        np.testing.assert_array_equal(got, want)
        packed = np.asarray(jax_pack(cfg, jnp.asarray(want)))
        np.testing.assert_array_equal(
            buffers._decode(cfg, _t(packed)).numpy(),
            np.asarray(jax.jit(lambda o: jax_decode(cfg, o))(
                jnp.asarray(packed))))


# the learner of tests/test_torch_learner.py: 64 px, toy model, 2 envs x
# 32 steps with 15-step episodes (at 192 px the two packages' rollouts
# render an observation that differs by a pixel within a few steps, from
# an ulp of a pose, which moves the losses by more than its tolerances)
LEARN_ENV = EnvConfig(train=True, bev_width=64, max_time=1.5)
LEARN_MODEL = ModelConfig(conv_channels=(8, 16), hidden_size=32,
                          head_size=16, disc_hidden=16, dtype="float32")
LEARN_TCFG = TrainConfig(
    n_envs=2, num_steps=64, mini_batch_size=16, ppo_epoch=2,
    gail_batch_size=16, gail_pre_epoch=2, gail_epoch=1, gail_thre=2,
    routes=(0, 1), bcgail=True, gail_gamma=0.5, decay=0.9,
    gail_norm_reward=True)
# the 64 px window of the 192 px masks around the ego (row 152)
CROP = (slice(100, 164), slice(64, 128))


@pytest.fixture(scope="module")
def small_tree(trees, tmp_path_factory):
    """The JAX tree with every mask file cut to the 64 px window around
    the ego (written by the port's codec): a tree at the learner's
    width."""
    import shutil

    from gail_carla_tpu_torch.utils.png import write_png

    src = _episode(trees[2])
    dst = tmp_path_factory.mktemp("small") / "t" / "route_00" / "ep_00"
    (dst / "birdview_masks").mkdir(parents=True)
    shutil.copy(src / "episode.json", dst / "episode.json")
    for f in sorted((src / "birdview_masks").iterdir()):
        write_png(dst / "birdview_masks" / f.name, read_png(f)[CROP])
    return dst.parent.parent


@pytest.mark.parametrize("n_channels", [3, 6])
def test_update_from_file_buffer_matches_jax(trees, small_tree, n_channels):
    """One ``WDGAILLearner.update`` whose expert buffer is read from a
    tree (the JAX tree's masks cut to 64 px), JAX against the port, same
    initial weights and every draw injected: metrics, weights, the env
    state handed on."""
    import jax
    from gail_carla_tpu.algo.learner import WDGAILLearner as JaxLearner
    from gail_carla_tpu.tools.expert_dataset import (
        expert_buffer_from_tree as jax_buffer,
    )
    from test_torch_learner import (
        LOSS, _close, _compare_aux, _compare_params, _jax_update_draws,
    )

    from gail_carla_tpu_torch.algo.learner import WDGAILLearner
    from gail_carla_tpu_torch.convert import (
        critic_state_dict, flax_to_state_dict,
    )

    port_scene, jax_scene, _, _ = trees
    env = dataclasses.replace(
        LEARN_ENV, obs_mode="bev6" if n_channels == 6 else "bev")
    je = jax_buffer(str(small_tree), [0], n_channels=n_channels)
    pe = expert_buffer_from_tree(str(small_tree), [0], n_channels=n_channels)
    assert tuple(pe.obs.shape) == (TREE_STEPS, n_channels, 64, 64)
    jl = JaxLearner(jax_scene, env, LEARN_MODEL, LEARN_TCFG, je)
    js = jl.init_state()
    n_patrols = port_scene.patrol_xy.shape[0]
    draws, had_resets = _jax_update_draws(jl, js, env, n_patrols)
    assert had_resets
    _, k_env = jax.random.split(jl._init_rng)
    reset_draws, gnss = jax_batch_reset_draws(k_env, LEARN_TCFG.n_envs, env,
                                              n_patrols)
    js2, want = jl.update(js)

    pl = WDGAILLearner(
        port_scene, env, LEARN_MODEL, LEARN_TCFG, pe,
        policy_params=jax.tree.map(np.asarray, jl._policy_params0),
        disc_params=jax.tree.map(np.asarray, jl._disc_params0))
    ps = pl.init_state(reset_draws=reset_draws, reset_gnss=gnss)
    ps2, got = pl.update(ps, draws)

    _compare_aux(got, want)
    _compare_params(ps2.policy.state_dict(),
                    flax_to_state_dict(js2.policy_params, LEARN_MODEL),
                    "policy")
    _compare_params(ps2.disc.state_dict(),
                    critic_state_dict(js2.disc_params, LEARN_MODEL),
                    "critic")
    _close(ps2.metrics, js2.metrics, LOSS, "env metrics")
    assert np.isfinite(float(got["disc/dis_loss"]))
