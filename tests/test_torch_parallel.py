"""Data-parallel training over ``torch.distributed`` (``parallel/mesh.py``,
``parallel/collectives.py``) against the JAX package's ``shard_map``
versions, with two gloo ranks in spawned processes on the CPU (the group
set up through a ``file://`` store in the test's directory).

- The reductions: ``update_rms`` / ``update_scale`` with the moments
  averaged over the ranks, ``ppo_update`` (advantage moments and
  gradients) and ``disc_update`` (gradients), against JAX's under
  ``jax.shard_map`` on two of conftest's fake CPU devices, each rank on
  its device's inputs and draws.
- One whole ``ShardedWDGAILLearner.update`` at world 2 against JAX's on
  ``make_mesh(2)``, each rank's draws recomputed from its device's key
  ``fold_in(split(rng)[1], index)``.
- Port-only invariants, as ``tests/test_parallel.py`` has them: each
  rank's env block and expert shard, replicated leaves bitwise equal on
  both ranks after two updates, a perturbed replica staying divergent,
  equal metrics; ``train.run(use_sharding=True)`` under the group, whose
  checkpoint restores into an unsharded learner that updates from it,
  and which raises without a group.

Toy shapes and tolerances of ``tests/test_torch_learner.py`` (losses and
aux 1e-4 relative / 1e-6 absolute, weights 2e-5). The JAX package is
imported inside the tests only (read-only reference).
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gail_carla_tpu_torch import train
from gail_carla_tpu_torch.algo import ppo, wdgail
from gail_carla_tpu_torch.algo.learner import WDGAILLearner
from gail_carla_tpu_torch.convert import (
    critic_from_flax, critic_state_dict, flax_to_state_dict,
    policy_from_flax,
)
from gail_carla_tpu_torch.parallel.mesh import (
    ENV_FIELDS, ShardedWDGAILLearner, dp_group, map_tensors,
)
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.train import make_presets
from gail_carla_tpu_torch.utils import checkpoint as ckpt
from gail_carla_tpu_torch.utils import running_mean_std as rms
from test_torch_expert import SHORT
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_learner import (  # noqa: F401 (setup: a fixture)
    ELEM, ENV, LOSS, MODEL, OBS, PRESET, TCFG, _close, _compare_aux,
    _compare_params, _jax_disc_draws, _jax_ppo_draws, _t, setup,
)

WORLD = 2
# the reward normaliser's batches (tests/test_torch_learner.py): steady,
# a 100x outlier, a tiny spread, steady; one row per rank
RMS_BATCHES = ((1.0, 3.0), (-5.0, 300.0), (0.2, 1e-3), (2.0, 3.0))


# --- the ranks ---------------------------------------------------------------

def _rank_main(rank, fn, world, tmp):
    """One spawned rank: torch on one thread, the gloo group through the
    file store, ``fn(rank, world, tmp)``'s result saved for the parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_ranks(fn, tmp, inputs=None, world=WORLD):
    """``fn`` on ``world`` gloo ranks in spawned processes; ``inputs`` are
    saved for them to read (``_inputs``). Returns each rank's result."""
    tmp = str(tmp)
    if inputs is not None:
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    mp.spawn(_rank_main, args=(fn, world, tmp), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _inputs(tmp):
    return torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)


def _env_slice(tree, rank, world, axis):
    """Rank ``rank``'s contiguous block of a tree's env axis ``axis``."""
    def cut(a):
        n = a.shape[axis] // world
        return a.narrow(axis, rank * n, n).clone()
    return map_tensors(cut, tree)


def _digests(state):
    """sha256 of every replicated leaf of a ``LearnerState``: both nets,
    both optimizer states, the reward statistics, the BC weight, the
    update counter, the generator."""
    saved = ckpt.to_saved(state)
    out = {}

    def walk(v, path):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(v[k], f"{path}/{k}")
        elif isinstance(v, list):
            for i, x in enumerate(v):
                walk(x, f"{path}[{i}]")
        elif isinstance(v, torch.Tensor):
            out[path] = hashlib.sha256(
                v.reshape(-1).contiguous().view(torch.uint8).numpy()
                .tobytes()).hexdigest()
        else:
            out[path] = repr(v)

    for f in ("policy", "policy_opt", "disc", "disc_opt", "reward_rms",
              "gail_gamma", "update_i", "generator"):
        walk(saved[f], f)
    return out


def _reductions_rank(rank, world, tmp):
    """The port's reductions on this rank's inputs: the two normalisers
    over ``RMS_BATCHES``, one ``ppo_update`` and one ``disc_update``."""
    inp = _inputs(tmp)
    group = dist.group.WORLD
    out = {}
    for name in ("update_rms", "update_scale"):
        st, seq = rms.make_rms(), []
        for b in inp["batches"]:
            st = getattr(rms, name)(st, b[rank], group)
            seq.append((st.mean, st.var, st.count))
        out[name] = seq
    scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    ro = _env_slice(inp["rollout"], rank, world, 1)
    expert = _env_slice(inp["expert"], rank, world, 0)
    net = policy_from_flax(inp["pparams"], MODEL, OBS, device="cpu")
    popt = ppo.make_policy_optimizer(TCFG)
    st, aux = ppo.ppo_update(
        scene, ENV, TCFG, net, popt, popt.init(list(net.parameters())), ro,
        inp["returns"][:, rank:rank + 1], None, torch.tensor(0.5), expert,
        perms=inp["ppo"][rank][0], expert_idx=inp["ppo"][rank][1],
        group=group)
    out["ppo"] = (aux, net.state_dict(), st.count)
    dnet = critic_from_flax(inp["dparams"], MODEL, OBS, device="cpu")
    dopt = wdgail.make_disc_optimizer(TCFG)
    st, aux = wdgail.disc_update(
        scene, ENV, TCFG, dnet, dopt, dopt.init(list(dnet.parameters())), ro,
        expert, None, 2, inp["disc"][rank], group=group)
    out["disc"] = (aux, dnet.state_dict(), st.count)
    return out


def _update_rank(rank, world, tmp):
    """A world-2 ``ShardedWDGAILLearner``: its blocks, one update with
    this rank's injected draws, a second from the generator, digests of
    the replicated leaves, then one replica perturbed and updated."""
    inp = _inputs(tmp)
    scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    learner = ShardedWDGAILLearner(
        scene, ENV, MODEL, TCFG, inp["expert"], policy_params=inp["pparams"],
        disc_params=inp["dparams"])
    state = learner.init_state(reset_draws=inp["reset"],
                               reset_gnss=inp["gnss"])
    out = dict(env_block=learner.env_block, shard=learner.shard_expert,
               expert_rows=learner.expert.size,
               expert_val_rows=learner.expert_val.size,
               expert_actions=learner.expert.actions,
               env_rows={f: {t.shape[0] for t in _leaves(getattr(state, f))}
                         for f in ENV_FIELDS},
               policy_rows=next(state.policy.parameters()).shape)
    state, m1 = learner.update(state, inp["draws"][rank])
    out["update1"] = dict(
        metrics=m1, policy=_copy(state.policy), critic=_copy(state.disc),
        gail_gamma=state.gail_gamma,
        rms=(state.reward_rms.mean, state.reward_rms.var,
             state.reward_rms.count),
        returns_acc=state.returns_acc, env_metrics=state.metrics,
        xy=state.render.xy, head=state.render.head,
        update_i=state.update_i, disc_count=state.disc_opt.count)
    state, out["metrics2"] = learner.update(state)
    out["digests2"] = _digests(state)
    if rank == 1:
        with torch.no_grad():
            next(state.policy.parameters()).add_(1.0)
    out["digests_bad"] = _digests(state)
    state, _ = learner.update(state)
    out["digests_bad2"] = _digests(state)
    try:
        ShardedWDGAILLearner(scene, ENV, MODEL,
                             dataclasses.replace(TCFG, n_envs=3),
                             inp["expert"])
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _copy(net):
    """A copy of a net's weights (the later updates change them in place)."""
    return {k: v.clone() for k, v in net.state_dict().items()}


def _leaves(tree):
    out = []
    map_tensors(out.append, tree)
    return out


def _train_rank(rank, world, tmp):
    """``train.run(use_sharding=True)`` at the smoke preset on two short
    routes, one update with a checkpoint; returns this rank's state."""
    cfg = _inputs(tmp)
    state, metrics = train.run(
        cfg["env"], cfg["model"], cfg["tcfg"], SHORT, cfg["demo_steps"],
        max_updates=1, log_dir=os.path.join(tmp, f"log{rank}"),
        ckpt_dir=os.path.join(tmp, "ckpt"), use_sharding=True, device="cpu")
    return dict(saved=ckpt.to_saved(state), metrics=metrics,
                logs=os.listdir(os.path.join(tmp, f"log{rank}"))
                if os.path.isdir(os.path.join(tmp, f"log{rank}")) else [])


# --- the JAX side ------------------------------------------------------------

def _mesh2():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]), ("dp",))


def _shard_map(f, in_specs, out_specs):
    import jax

    return jax.jit(jax.shard_map(f, mesh=_mesh2(), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _fold(rng, idx):
    import jax

    return jax.random.fold_in(rng, idx)


@pytest.fixture(scope="module")
def reductions(setup, tmp_path_factory):
    """JAX's reductions under ``shard_map`` and the port's on two ranks
    (one spawn), on the same per-device inputs and draws."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from gail_carla_tpu.algo import ppo as jax_ppo
    from gail_carla_tpu.algo import wdgail as jax_wdgail
    from gail_carla_tpu.ops.gae import compute_returns as jax_returns
    from gail_carla_tpu.utils import running_mean_std as jax_rms

    rng = np.random.default_rng(11)
    batches = np.stack([rng.normal(m, s, (WORLD, 64)) for m, s in
                        RMS_BATCHES]).astype(np.float32)
    want = {}
    for name in ("update_rms", "update_scale"):
        def f(b, name=name):
            st, seq = jax_rms.make_rms(), []
            for i in range(b.shape[0]):
                st = getattr(jax_rms, name)(st, b[i, 0], axis_name="dp")
                seq.append((st.mean, st.var, st.count))
            return seq
        want[name] = jax.tree.map(np.asarray, _shard_map(
            f, (P(None, "dp"),), P())(batches))

    ro, expert = setup["rollout"], setup["expert"]
    gail = np.random.default_rng(3).uniform(0, 1, ro.env_rewards.shape)
    returns = jax_returns(jnp.asarray(gail, jnp.float32), ro.env_rewards,
                          ro.values, ro.masks, 0.99, 0.95)
    ro_spec = jax.tree.map(lambda _: P(None, "dp"), ro)
    e_spec = jax.tree.map(lambda _: P("dp"), expert)
    popt = jax_ppo.make_policy_optimizer(TCFG)
    dopt = jax_wdgail.make_disc_optimizer(TCFG)
    rng_ppo, rng_disc = jax.random.PRNGKey(5), jax.random.PRNGKey(6)

    def ppo_f(ro, returns, expert):
        k = _fold(rng_ppo, jax.lax.axis_index("dp"))
        params, _, aux = jax_ppo.ppo_update(
            setup["jax_scene"], ENV, TCFG, setup["pnet"], setup["pparams"],
            popt, popt.init(setup["pparams"]), ro, returns, k,
            jnp.float32(0.5), expert, axis_name="dp")
        return params, jax.tree.map(lambda a: a[None], aux)

    def disc_f(ro, expert):
        k = _fold(rng_disc, jax.lax.axis_index("dp"))
        params, _, aux = jax_wdgail.disc_update(
            setup["jax_scene"], ENV, TCFG, setup["dnet"], setup["dparams"],
            dopt, dopt.init(setup["dparams"]), ro, expert, k, jnp.int32(2),
            axis_name="dp")
        return params, jax.tree.map(lambda a: a[None], aux)

    want["ppo"] = jax.tree.map(np.asarray, _shard_map(
        ppo_f, (ro_spec, P(None, "dp"), e_spec), (P(), P("dp")))(
            ro, returns, expert))
    want["disc"] = jax.tree.map(np.asarray, _shard_map(
        disc_f, (ro_spec, e_spec), (P(), P("dp")))(ro, expert))

    total = ro.actions.shape[0] * ro.actions.shape[1] // WORLD
    e_rows = setup["expert"].size // WORLD
    inputs = dict(
        batches=_t(batches), rollout=setup["port_rollout"],
        expert=setup["port_expert"], returns=_t(returns),
        pparams=setup["pparams"], dparams=setup["dparams"],
        ppo=[_jax_ppo_draws(_fold(rng_ppo, r), TCFG, total, e_rows)
             for r in range(WORLD)],
        disc=[_jax_disc_draws(_fold(rng_disc, r), TCFG, 2, e_rows, total)
              for r in range(WORLD)])
    got = _run_ranks(_reductions_rank,
                     tmp_path_factory.mktemp("reductions"), inputs)
    return want, got


@pytest.mark.parametrize("case", ["update_rms", "update_scale", "ppo",
                                  "disc"])
def test_reductions_match_jax(reductions, case):
    """Each rank's result against its JAX device's: the normalisers'
    mean, var and count after every batch; each update's aux (this rank's
    own) and the new weights (the same on both ranks, bit for bit)."""
    want, got = reductions
    if case.startswith("update_"):
        for r in range(WORLD):
            for i, (g, w) in enumerate(zip(got[r][case], want[case])):
                for f, a, b in zip(("mean", "var", "count"), g, w):
                    _close(a, b, LOSS, f"rank {r} batch {i} {f}")
        assert float(got[0][case][-1][2]) == pytest.approx(
            1e-4 + 64 * WORLD * len(RMS_BATCHES))
        return
    params, aux = want[case]
    to_sd = flax_to_state_dict if case == "ppo" else critic_state_dict
    for r in range(WORLD):
        g_aux, g_sd, count = got[r][case]
        _compare_aux(g_aux, {k: v[r] for k, v in aux.items()},
                     f"rank {r} ")
        _compare_params(g_sd, to_sd(params, MODEL), f"{case} rank {r}")
        assert count == (TCFG.ppo_epoch if case == "ppo" else 2) * 2
    for k, v in got[0][case][1].items():
        assert torch.equal(v, got[1][case][1][k]), k


@pytest.fixture(scope="module")
def sharded_update(setup, tmp_path_factory):
    """JAX's ``ShardedWDGAILLearner`` update on ``make_mesh(2)`` and the
    port's on two ranks from the same weights and reset, each rank's
    draws those of its device."""
    import jax
    from gail_carla_tpu.parallel.mesh import ShardedWDGAILLearner as JaxSL
    from gail_carla_tpu.parallel.mesh import make_mesh
    from test_torch_traffic import jax_batch_reset_draws

    jl = JaxSL(setup["jax_scene"], ENV, MODEL, TCFG, setup["expert"],
               mesh=make_mesh(WORLD))
    js = jl.init_state()
    n_patrols = setup["port_scene"].patrol_xy.shape[0]
    draws = [_jax_shard_draws(jl, js, ENV, n_patrols, r)
             for r in range(WORLD)]
    _, k_env = jax.random.split(jl._init_rng)
    reset, gnss = jax_batch_reset_draws(k_env, TCFG.n_envs, ENV, n_patrols)
    js2, want = jl.update(js)
    inputs = dict(expert=setup["port_expert"], reset=reset, gnss=gnss,
                  pparams=jax.tree.map(np.asarray, jl._policy_params0),
                  dparams=jax.tree.map(np.asarray, jl._disc_params0),
                  draws=draws)
    got = _run_ranks(_update_rank, tmp_path_factory.mktemp("update"),
                     inputs)
    return jax.tree.map(np.asarray, js2), jax.tree.map(np.asarray, want), \
        got


def _jax_shard_draws(jl, js, cfg, n_patrols, idx):
    """Device ``idx``'s draws in JAX's sharded update, as ``UpdateDraws``:
    its key is ``fold_in(split(rng)[1], idx)``, split as the unsharded
    update splits its own, over its block of envs and expert rows
    (``tests/test_torch_learner.py::_jax_update_draws`` on one device)."""
    import jax
    from gail_carla_tpu.algo import wdgail as jax_wdgail
    from gail_carla_tpu.algo.rollout import collect_rollout
    from gail_carla_tpu_torch.algo.learner import UpdateDraws
    from test_torch_slice import _jax_rollout_draws

    tcfg = jl.tcfg
    T, N = tcfg.steps_per_env, tcfg.n_envs // WORLD
    total = T * N
    local = _fold(jax.random.split(js.rng)[1], idx)
    _, k_roll, k_disc, k_ppo, k_val1, k_val2 = jax.random.split(local, 6)

    def block(tree):
        return jax.tree.map(lambda a: np.asarray(a)[idx * N:(idx + 1) * N],
                            tree)

    env_states = block(js.env_states)
    ro = collect_rollout(jl.scene, cfg, jl.policy_net, js.policy_params,
                         env_states, block(js.metrics), block(js.render),
                         k_roll, T)[3]
    dones = np.asarray(ro.masks)[1:] == 0.0
    noise = np.stack([np.asarray(jax.random.normal(k, (N, 2)))
                      for k in jax.random.split(k_roll, T)])
    n_epochs = jax_wdgail.warmup_epochs(tcfg, int(js.update_i) + 1)
    e_rows, v_rows = jl.expert.size // WORLD, jl.expert_val.size // WORLD
    n_chunks = -(-v_rows // 256)
    perms, e_idx = _jax_ppo_draws(k_ppo, tcfg, total, e_rows)
    return UpdateDraws(
        action_noise=_t(noise),
        env_draws=_jax_rollout_draws(env_states.rng, dones, cfg, n_patrols),
        disc=_jax_disc_draws(k_disc, tcfg, n_epochs, e_rows, total),
        ppo_perms=perms, ppo_expert_idx=e_idx,
        val_pre=_t(jax.random.randint(k_val1, (n_chunks, 256), 0, total)),
        val_post=_t(jax.random.randint(k_val2, (n_chunks, 256), 0, total)),
    )


def test_sharded_update_matches_jax(sharded_update):
    """Every metric (averaged over the ranks on both sides), the new
    policy and critic weights on each rank, the BC weight, the reward
    statistics and each rank's block of the env state against JAX's.
    JAX replicates the per-env return carry (ROADMAP §C): at one env per
    device it broadcasts device 0's carry over both envs and counts every
    return twice; the port keeps a carry per env and counts once."""
    js2, want, got = sharded_update
    t_n = TCFG.steps_per_env * TCFG.n_envs
    for r in range(WORLD):
        g = got[r]["update1"]
        _compare_aux(g["metrics"], want, f"rank {r} ")
        _compare_params(g["policy"], flax_to_state_dict(js2.policy_params,
                                                         MODEL),
                        f"policy rank {r}")
        _compare_params(g["critic"], critic_state_dict(js2.disc_params,
                                                       MODEL),
                        f"critic rank {r}")
        _close(g["gail_gamma"], js2.gail_gamma, ELEM, "gail_gamma")
        _close(g["rms"][0], js2.reward_rms.mean, LOSS, "reward_rms.mean")
        _close(g["rms"][1], js2.reward_rms.var, LOSS, "reward_rms.var")
        _close(g["rms"][2], 1e-4 + t_n, ELEM, "reward_rms.count")
        n = TCFG.n_envs // WORLD
        blk = slice(r * n, (r + 1) * n)
        _close(g["env_metrics"], js2.metrics[blk], LOSS, "env metrics")
        _close(g["xy"], js2.render.xy[blk], LOSS, "env xy")
        np.testing.assert_array_equal(g["head"].numpy(),
                                      js2.render.head[blk])
        assert g["update_i"] == int(js2.update_i) == 1
        assert g["disc_count"] == 2 * 2   # 2 warm-up epochs x 2 local mb
    # JAX's fault: the replicated carry and the doubled count
    _close(got[0]["update1"]["returns_acc"], js2.returns_acc[:1], LOSS,
           "returns_acc")
    assert js2.returns_acc[1] == js2.returns_acc[0]
    _close(js2.reward_rms.count, 1e-4 + 2 * t_n, ELEM, "JAX's count")


def test_sharded_invariants(sharded_update):
    """The blocks (env leaves n/2 rows, weights whole; expert 256 rows
    trimmed and split 128 + 128), replicas bitwise equal after two
    updates with equal metrics, a perturbed replica still divergent after
    an update (the gradients are averaged, not the weights), and a world
    that does not divide ``n_envs`` refused."""
    _, _, got = sharded_update
    for r, g in enumerate(got):
        assert g["env_block"] == (r, r + 1)
        assert g["shard"] and g["expert_rows"] == g["expert_val_rows"] == 128
        assert all(rows == {1} for rows in g["env_rows"].values())
        assert g["policy_rows"] == got[0]["policy_rows"]
        assert "must divide over 2 ranks" in g["refused"]
    assert not torch.equal(got[0]["expert_actions"], got[1]["expert_actions"])
    assert got[0]["digests2"] == got[1]["digests2"]
    for k, v in got[0]["metrics2"].items():
        assert torch.equal(v, got[1]["metrics2"][k]), k
    bad = [k for k in got[0]["digests_bad"]
           if got[0]["digests_bad"][k] != got[1]["digests_bad"][k]]
    assert len(bad) == 1 and bad[0].startswith("policy/")
    diverged = [k for k in got[0]["digests_bad2"]
                if k.startswith("policy/")
                and got[0]["digests_bad2"][k] != got[1]["digests_bad2"][k]]
    assert bad[0] in diverged


def test_sharding_needs_a_group():
    """Without an initialised process group the sharded learner and
    ``train.run(use_sharding=True)`` raise before any work."""
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        dp_group()
    smoke = make_presets()["smoke"]
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        train.run(smoke["env"], smoke["model"], smoke["train"], SHORT, 10,
                  use_sharding=True, device="cpu")


def _launch_rank(rank, world, tmp):
    """``train.main`` with 3 envs on this rank of the group; returns the
    refusal's message."""
    try:
        train.main(["--preset", "smoke", "--n-envs", "3", "--device", "cpu",
                    "--log-dir", os.path.join(tmp, f"log{rank}")])
    except ValueError as e:
        return str(e)
    return None


def test_main_refuses_ranks_that_do_not_divide_the_envs(tmp_path):
    """``train.main`` on two ranks with 3 envs raises on both before any
    work (the default ``use_sharding`` shards whenever the group has more
    than one rank), where each rank would otherwise train a full copy of
    its own; neither writes a log."""
    got = _run_ranks(_launch_rank, tmp_path)
    assert all(g is not None and "must divide over 2 ranks" in g
               for g in got), got
    assert not any((tmp_path / f"log{r}").exists() for r in range(WORLD))


def test_train_run_sharded(tmp_path):
    """``train.run(use_sharding=True)`` on two ranks (smoke preset, two
    short routes, one update): rank 0 alone logs; its ``update_1``
    checkpoint restores into an unsharded learner's template with the env
    leaves equal to the ranks' blocks in rank order and the replicated
    leaves equal to rank 0's, and one process updates from it."""
    smoke = make_presets()["smoke"]
    cfg = dict(env=smoke["env"], model=smoke["model"],
               tcfg=dataclasses.replace(smoke["train"], eval_interval=1),
               demo_steps=300)
    got = _run_ranks(_train_rank, tmp_path, cfg)
    assert "metrics.jsonl" in got[0]["logs"] and got[1]["logs"] == []
    rows = [json.loads(x) for x in open(tmp_path / "log0" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1] and "eval/reward" in rows[0]
    for k, v in got[0]["metrics"].items():
        if not k.startswith("eval/"):
            assert float(v) == float(got[1]["metrics"][k]), k

    scene = make_benchmark_scene(**SHORT, device="cpu")
    one = WDGAILLearner(scene, cfg["env"], cfg["model"],
                        dataclasses.replace(cfg["tcfg"], algo="ppo"), None)
    restored, _ = ckpt.restore_checkpoint(str(tmp_path / "ckpt" / "update_1"),
                                          one.init_state())
    saved = ckpt.to_saved(restored)
    ranks = [g["saved"] for g in got]

    def same(a, b, path):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path

    for f in saved:
        if f in ENV_FIELDS:
            same(saved[f], _cat_saved([rk[f] for rk in ranks]), f)
        else:
            same(saved[f], ranks[0][f], f)
    assert saved["update_i"] == 1
    # one process takes the next update from it (PPO on the env reward:
    # no expert buffer needed)
    state, metrics = one.update(restored)
    assert state.update_i == 2 and state.returns_acc.shape == (4,)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _cat_saved(parts):
    """Saved trees of the ranks joined along their leading (env) axis."""
    if isinstance(parts[0], dict):
        return {k: _cat_saved([p[k] for p in parts]) for k in parts[0]}
    if isinstance(parts[0], list):
        return [_cat_saved(list(x)) for x in zip(*parts)]
    return None if parts[0] is None else torch.cat(parts)
