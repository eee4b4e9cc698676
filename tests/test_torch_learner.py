"""The port's WDGAIL training update against the JAX package's: GAE, the
reward normaliser, the hand-ported optax chain, the critic and its
gradient penalty, ``ppo_update``, ``disc_update``, the relabel and
validation passes, and one whole ``WDGAILLearner.update`` for
``algo="wdgail"`` (BC blend and reward normalisation on) and
``algo="ppo"``.

Toy shapes of tests/test_algo.py (64 px, convs (8, 16), hidden 32,
float32, 2 envs x 32 steps). Every draw (permutations, expert picks,
penalty alphas, validation rows, action noise, env draws) is recomputed
from JAX's keys and injected into the port. Expert data is JAX's own
``generate_demos`` + ``build_expert_buffer``, converted to tensors.

Tolerances: elementwise recurrences (the normaliser, the optimizer
chain; GAE 1e-6 of its largest return, see its test) 1e-6 relative, from
float32 rounding of the same operations in another order; the critic, its penalty and gradients, and the losses and
aux of the updates 1e-4 relative (conv and matmul sums in another order,
a few optimizer steps). Parameters after updates: see ``PARAM_ATOL``.
The JAX package is imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.algo import buffers, ppo, wdgail
from gail_carla_tpu_torch.algo.learner import UpdateDraws, WDGAILLearner
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from gail_carla_tpu_torch.convert import (
    critic_from_flax, critic_state_dict, flax_to_state_dict,
    policy_from_flax,
)
from gail_carla_tpu_torch.models import discriminator as disc_mod
from gail_carla_tpu_torch.ops.gae import compute_returns
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import RenderState
from gail_carla_tpu_torch.train import make_presets
from gail_carla_tpu_torch.utils import running_mean_std as rms

PRESET = make_presets()["smoke"]
# 15-step episodes, so the rollout auto-resets (env draws injected)
ENV = EnvConfig(train=True, bev_width=64, max_time=1.5)
MODEL = ModelConfig(conv_channels=(8, 16), hidden_size=32, head_size=16,
                    disc_hidden=16, dtype="float32")
TCFG = TrainConfig(
    n_envs=2, num_steps=64, mini_batch_size=16, ppo_epoch=2,
    gail_batch_size=16, gail_pre_epoch=2, gail_epoch=1, gail_thre=2,
    routes=(0, 1), bcgail=True, gail_gamma=0.5, decay=0.9,
    gail_norm_reward=True,
)
OBS = (3, 64, 64)
ELEM = dict(rtol=1e-6, atol=1e-7)
LOSS = dict(rtol=1e-4, atol=1e-6)
# Parameters after optimizer steps, absolute. Adam divides the first
# moment by the root of the second, so every element moves by about lr
# per step whatever its gradient's size: a gradient element that is
# float noise (the two libraries sum in another order) would still move
# by up to lr, in a sign the noise decides. Where gradients are not noise
# the steps agree closely: measured worst 3.3e-6 (the "ppo" update, 8
# steps at lr 1e-4; 2.4e-7 for the critic's 8 steps at 2.5e-4). The bound
# is a fifth of one policy step, so a wrong sign, a missed or an extra
# step on any element fails.
PARAM_ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_state(js):
    return RenderState(**{f.name: _t(getattr(js, f.name))
                          for f in dataclasses.fields(RenderState)})


def _port_rollout(jr):
    return buffers.Rollout(
        render=_port_state(jr.render), metrics=_t(jr.metrics),
        obs=None if jr.obs is None else _t(jr.obs), actions=_t(jr.actions),
        logp=_t(jr.logp), values=_t(jr.values),
        env_rewards=_t(jr.env_rewards), masks=_t(jr.masks),
        gail_rewards=_t(jr.gail_rewards))


def _port_expert(je):
    return buffers.ExpertBuffer(render=_port_state(je.render),
                                metrics=_t(je.metrics), obs=_t(je.obs),
                                actions=_t(je.actions))


@pytest.fixture(scope="module")
def setup():
    """Scenes, JAX's expert buffer (and its port copy), JAX policy and
    critic params, and a JAX rollout with stored obs (and its port copy)."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import build_expert_buffer
    from gail_carla_tpu.algo.expert import generate_demos
    from gail_carla_tpu.algo.rollout import collect_rollout
    from gail_carla_tpu.models.discriminator import init_discriminator
    from gail_carla_tpu.models.policy import init_policy
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )
    from gail_carla_tpu.sim.env import reset_batch

    jax_scene = make_jax_scene(**PRESET["scene"])
    demos = generate_demos(
        jax_scene, EnvConfig(train=False, bev_width=64),
        jax.random.PRNGKey(0), jnp.arange(2, dtype=jnp.int32),
        n_steps=900, with_noise=False)
    expert = build_expert_buffer(jax_scene, ENV, demos, size=256)
    pnet, pparams = init_policy(jax.random.PRNGKey(1), MODEL, OBS)
    dnet, dparams = init_discriminator(jax.random.PRNGKey(2), MODEL, OBS)
    key = jax.random.PRNGKey(3)
    st, met, ren = reset_batch(jax_scene, ENV, key,
                               jnp.asarray([0, 1], jnp.int32))
    ro = collect_rollout(jax_scene, ENV, pnet, pparams, st, met, ren, key,
                         32, store_obs=True)[3]
    return dict(
        port_scene=make_benchmark_scene(**PRESET["scene"], device="cpu"),
        jax_scene=jax_scene, expert=expert, port_expert=_port_expert(expert),
        pnet=pnet, pparams=jax.tree.map(np.asarray, pparams), dnet=dnet,
        dparams=jax.tree.map(np.asarray, dparams), rollout=ro,
        port_rollout=_port_rollout(ro),
    )


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


def _compare_aux(got: dict, want: dict, prefix=""):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        _close(got[k], v, LOSS, prefix + k)


def _compare_params(port_sd: dict, flax_sd: dict, what: str):
    """Every weight within ``PARAM_ATOL``; prints the worst difference
    (``pytest -s`` shows it)."""
    assert set(port_sd) == set(flax_sd)
    worst = 0.0
    for k, v in flax_sd.items():
        d = float((port_sd[k] - v).abs().max())
        worst = max(worst, d)
        assert d <= PARAM_ATOL, f"{what} {k}: max |diff| {d}"
    print(f"{what}: worst |dparam| {worst:.3g}")


def test_compute_returns_matches_jax():
    from gail_carla_tpu.ops.gae import compute_returns as jax_returns

    rng = np.random.default_rng(0)
    T, N = 40, 3
    gail = rng.normal(0.5, 1.0, (T, N)).astype(np.float32)
    env = rng.normal(0.0, 0.1, (T, N)).astype(np.float32)
    values = rng.normal(0.0, 2.0, (T + 1, N)).astype(np.float32)
    masks = (rng.uniform(size=(T + 1, N)) > 0.1).astype(np.float32)
    masks[0] = 1.0
    for coefs in ((1.0, 0.0), (0.0, 1.0), (0.7, 0.3)):
        want = jax_returns(gail, env, values, masks, 0.99, 0.95, *coefs)
        got = compute_returns(_t(gail), _t(env), _t(values), _t(masks),
                              0.99, 0.95, *coefs)
        # 1e-6 of the largest return: XLA contracts the recurrence's
        # multiply-adds into fused ones inside the scan, which moves a
        # result by an ulp of its operands, not of a result that cancels
        # to near zero (measured worst 1.8e-7 of the largest return)
        scale = float(np.abs(np.asarray(want)).max())
        _close(got, want, dict(rtol=1e-6, atol=1e-6 * scale),
               f"returns {coefs}")
        worst = float(np.abs(got.numpy() - np.asarray(want)).max())
        print(f"returns {coefs}: worst |diff| {worst / scale:.3g} of the "
              f"largest return")


def test_running_mean_std_matches_jax():
    from gail_carla_tpu.utils import running_mean_std as jax_rms

    rng = np.random.default_rng(1)
    # a steady batch, a 100x outlier (the scale's clamp binds), a tiny one
    batches = [rng.normal(1.0, 3.0, 64), rng.normal(-5.0, 300.0, 64),
               rng.normal(0.2, 1e-3, 64), rng.normal(2.0, 3.0, 64)]
    for name in ("update_rms", "update_scale"):
        want, got = jax_rms.make_rms(), rms.make_rms()
        for b in batches:
            b = b.astype(np.float32)
            want = getattr(jax_rms, name)(want, b)
            got = getattr(rms, name)(got, _t(b))
            for f in ("mean", "var", "count"):
                _close(getattr(got, f), getattr(want, f), ELEM,
                       f"{name}.{f}")
    # the clamp bound: the outlier moved the scale by exactly 1.25x
    s = rms.update_scale(rms.make_rms(), _t(batches[1].astype(np.float32)))
    assert abs(float(s.std) - 1.25) < 1e-6


@pytest.mark.parametrize("which", ["policy", "critic"])
def test_optimizer_chain_matches_optax(which):
    """The port's clip + Adam with the linear-decay schedule against
    ``optax.chain(clip_by_global_norm, adam)`` from the JAX package's own
    constructors, on one gradient sequence: clipped and unclipped steps,
    and a rate that decays every 2 steps."""
    import jax
    from gail_carla_tpu.algo import ppo as jax_ppo
    from gail_carla_tpu.algo import wdgail as jax_wdgail

    tcfg = dataclasses.replace(
        TCFG, num_steps=32, num_env_steps=32 * 5, mini_batch_size=16,
        ppo_epoch=1, use_linear_lr_decay=True,
        gail_use_linear_lr_decay=True)
    if which == "policy":
        want_opt = jax_ppo.make_policy_optimizer(tcfg)
        opt = ppo.make_policy_optimizer(tcfg)
    else:
        want_opt = jax_wdgail.make_disc_optimizer(tcfg, mb_per_update=2)
        opt = wdgail.make_disc_optimizer(tcfg, mb_per_update=2)
    assert opt.steps_per_update == 2 and opt.n_updates == 5
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 3, 2, 2), "b": (7,), "c": (5, 9)}
    jp = {k: rng.normal(0, 1, s).astype(np.float32)
          for k, s in shapes.items()}
    params = [_t(jp[k]) for k in sorted(shapes)]
    jstate, state = want_opt.init(jp), opt.init(params)
    n_clipped = 0
    for i in range(12):
        scale = 2.0 if i % 3 == 0 else 0.02
        g = {k: rng.normal(0, scale, s).astype(np.float32)
             for k, s in shapes.items()}
        n_clipped += np.sqrt(sum((v ** 2).sum() for v in g.values())) > 0.5
        upd, jstate = want_opt.update(g, jstate, jp)
        jp = jax.tree.map(np.asarray, jax.tree.map(lambda p, u: p + u,
                                                   jp, upd))
        state = opt.step(params, [_t(g[k]) for k in sorted(shapes)], state)
        for p, k in zip(params, sorted(shapes)):
            _close(p, jp[k], ELEM, f"step {i} {k}")
    assert n_clipped == 4 and state.count == 12
    assert opt.lr_at(11) < opt.lr_at(0)


def _critic_inputs(seed, b=8):
    rng = np.random.default_rng(seed)

    def triple():
        obs = rng.uniform(0, 1, (b,) + OBS).astype(np.float32)
        met = np.stack([rng.normal(0, 2e-4, b), rng.normal(0, 2e-4, b),
                        rng.uniform(0, 8, b), rng.integers(1, 7, b)],
                       1).astype(np.float32)
        act = rng.normal(0, 0.5, (b, 2)).astype(np.float32)
        return obs, met, act

    return triple(), triple()


def test_critic_and_gradient_penalty_match_flax(setup):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.models import discriminator as jax_disc

    dnet, dparams = setup["dnet"], setup["dparams"]
    e, p = _critic_inputs(0)
    alpha_key = jax.random.PRNGKey(4)
    alpha = np.asarray(jax.random.uniform(alpha_key, (8, 1, 1, 1)))

    def jax_loss(params):
        wd, d_e, d_p = jax_disc.wd_loss(dnet, params, e, p)
        gp = jax_disc.grad_penalty(dnet, params, alpha_key, e, p, 10.0)
        return -wd + gp, (wd, d_e, d_p, gp)

    (jloss, jaux), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        dparams)
    want_d = dnet.apply(dparams, *map(jnp.asarray, e))
    want_r = jax_disc.predict_reward(dnet, dparams, *map(jnp.asarray, p))

    net = critic_from_flax(dparams, MODEL, OBS, device="cpu")
    pe, pp = tuple(map(_t, e)), tuple(map(_t, p))
    with torch.no_grad():
        _close(net(*pe), want_d, LOSS, "D")
        _close(disc_mod.predict_reward(net, *pp), want_r, LOSS, "reward")
    wd, d_e, d_p = disc_mod.wd_loss(net, pe, pp)
    gp = disc_mod.grad_penalty(net, pe, pp, 10.0, alpha=_t(alpha))
    loss = -wd + gp
    for got, want, name in ((wd, jaux[0], "wd"), (d_e, jaux[1], "d_e"),
                            (d_p, jaux[2], "d_p"), (gp, jaux[3], "gp"),
                            (loss, jloss, "loss")):
        _close(got.detach(), want, LOSS, name)
    assert float(gp.detach()) > 0.1     # the penalty is not negligible here
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    want_g = critic_state_dict(jax.tree.map(np.asarray, jgrads), MODEL)
    for n, g in zip(names, grads):
        _close(g, want_g[n], dict(rtol=1e-4, atol=1e-6), f"grad {n}")


def _jax_ppo_draws(rng, tcfg, total, expert_size):
    import jax

    mb = tcfg.mini_batch_size
    n_mb = total // mb
    k_perm, k_exp = jax.random.split(rng)
    perms = np.stack([
        np.asarray(jax.random.permutation(k, total)[: n_mb * mb])
        for k in jax.random.split(k_perm, tcfg.ppo_epoch)])
    keys = jax.random.split(k_exp, tcfg.ppo_epoch * n_mb)
    e_idx = np.stack([np.asarray(jax.random.randint(k, (mb,), 0,
                                                    expert_size))
                      for k in keys])
    return _t(perms), _t(e_idx)


def _jax_disc_draws(rng, tcfg, n_epochs, expert_size, total):
    import jax

    mb = tcfg.gail_batch_size
    n_mb = min(expert_size, total) // mb
    keys = jax.random.split(rng, max(tcfg.gail_pre_epoch, tcfg.gail_epoch))
    out = []
    for ep in range(n_epochs):
        k_e, k_p, k_gp = jax.random.split(keys[ep], 3)
        e = jax.random.permutation(k_e, expert_size)[: n_mb * mb]
        p = jax.random.permutation(k_p, total)[: n_mb * mb]
        alpha = np.stack([np.asarray(jax.random.uniform(k, (mb, 1, 1, 1)))
                          for k in jax.random.split(k_gp, n_mb)])
        out.append(wdgail.DiscEpochDraws(_t(e).reshape(n_mb, mb),
                                         _t(p).reshape(n_mb, mb), _t(alpha)))
    return out


def test_ppo_update_matches_jax(setup):
    """One ``ppo_update`` with the BC blend on, from the same rollout,
    returns and params, JAX's permutations and expert picks injected."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo import ppo as jax_ppo
    from gail_carla_tpu.ops.gae import compute_returns as jax_returns

    ro, pro = setup["rollout"], setup["port_rollout"]
    gail = np.random.default_rng(3).uniform(0, 1, ro.env_rewards.shape)
    returns = jax_returns(jnp.asarray(gail, jnp.float32), ro.env_rewards,
                          ro.values, ro.masks, 0.99, 0.95)
    opt = jax_ppo.make_policy_optimizer(TCFG)
    rng = jax.random.PRNGKey(5)
    params, _, aux = jax_ppo.ppo_update(
        setup["jax_scene"], ENV, TCFG, setup["pnet"], setup["pparams"], opt,
        opt.init(setup["pparams"]), ro, returns, rng, jnp.float32(0.5),
        setup["expert"])

    total = ro.actions.shape[0] * ro.actions.shape[1]
    perms, e_idx = _jax_ppo_draws(rng, TCFG, total, 256)
    net = policy_from_flax(setup["pparams"], MODEL, OBS, device="cpu")
    popt = ppo.make_policy_optimizer(TCFG)
    state, paux = ppo.ppo_update(
        setup["port_scene"], ENV, TCFG, net, popt,
        popt.init(list(net.parameters())), pro, _t(returns), None,
        torch.tensor(0.5), setup["port_expert"], perms=perms,
        expert_idx=e_idx)
    _compare_aux(paux, aux)
    assert state.count == TCFG.ppo_epoch * (total // TCFG.mini_batch_size)
    assert abs(float(paux["bc_loss"])) > 0.0
    _compare_params(net.state_dict(), flax_to_state_dict(params, MODEL),
                    "policy")


def test_disc_update_matches_jax(setup):
    """Two critic epochs (the warm-up's first update) with JAX's
    permutations and penalty alphas injected; zero epochs leave the
    critic alone and log zeros."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo import wdgail as jax_wdgail

    ro, pro = setup["rollout"], setup["port_rollout"]
    opt = jax_wdgail.make_disc_optimizer(TCFG)
    rng = jax.random.PRNGKey(6)
    params, _, aux = jax_wdgail.disc_update(
        setup["jax_scene"], ENV, TCFG, setup["dnet"], setup["dparams"], opt,
        opt.init(setup["dparams"]), ro, setup["expert"], rng,
        jnp.int32(2))

    total = ro.actions.shape[0] * ro.actions.shape[1]
    draws = _jax_disc_draws(rng, TCFG, 2, 256, total)
    net = critic_from_flax(setup["dparams"], MODEL, OBS, device="cpu")
    popt = wdgail.make_disc_optimizer(TCFG)
    state, paux = wdgail.disc_update(
        setup["port_scene"], ENV, TCFG, net, popt,
        popt.init(list(net.parameters())), pro, setup["port_expert"], None,
        2, draws)
    _compare_aux(paux, aux)
    assert state.count == 2 * (total // TCFG.gail_batch_size)
    _compare_params(net.state_dict(), critic_state_dict(params, MODEL),
                    "critic")

    before = {k: v.clone() for k, v in net.state_dict().items()}
    state0, aux0 = wdgail.disc_update(
        setup["port_scene"], ENV, TCFG, net, popt, state, pro,
        setup["port_expert"], None, 0)
    assert state0.count == state.count
    assert all(float(v) == 0.0 for v in aux0.values())
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())


def test_relabel_and_validation_match_jax(setup):
    """Chunked passes whose last chunk wraps around: relabel in chunks of
    48 over 64 rows, validation in chunks of 100 over 256 expert rows,
    JAX's rollout rows injected."""
    import jax
    from gail_carla_tpu.algo import wdgail as jax_wdgail

    ro, pro = setup["rollout"], setup["port_rollout"]
    dnet, dparams = setup["dnet"], setup["dparams"]
    net = critic_from_flax(dparams, MODEL, OBS, device="cpu")
    want = jax_wdgail.relabel_rewards(setup["jax_scene"], ENV, dnet, dparams,
                                      ro, chunk=48)
    got = wdgail.relabel_rewards(setup["port_scene"], ENV, net, pro,
                                 chunk=48)
    _close(got, want, LOSS, "relabel")

    rng = jax.random.PRNGKey(7)
    want = jax_wdgail.validation_wd(setup["jax_scene"], ENV, dnet, dparams,
                                    ro, setup["expert"], rng, chunk=100)
    p_idx = _t(jax.random.randint(rng, (3, 100), 0, 64))
    got = wdgail.validation_wd(setup["port_scene"], ENV, net, pro,
                               setup["port_expert"], None, chunk=100,
                               policy_idx=p_idx)
    for g, w, name in zip(got, want, ("wd", "expert", "policy")):
        _close(g, w, LOSS, f"validation {name}")


def _jax_update_draws(learner, state, cfg, n_patrols):
    """Every draw of JAX's ``learner.update(state)``, as ``UpdateDraws``.
    The env draws follow each env's key chain through the rollout's
    episode ends, which a separate call of JAX's ``collect_rollout`` with
    the update's rollout key gives."""
    import jax
    from gail_carla_tpu.algo import wdgail as jax_wdgail
    from gail_carla_tpu.algo.rollout import collect_rollout
    from test_torch_slice import _jax_rollout_draws

    tcfg = learner.tcfg
    T, N = tcfg.steps_per_env, tcfg.n_envs
    total = T * N
    _, k_roll, k_disc, k_ppo, k_val1, k_val2 = jax.random.split(state.rng, 6)
    ro = collect_rollout(learner.scene, cfg, learner.policy_net,
                         state.policy_params, state.env_states, state.metrics,
                         state.render, k_roll, T)[3]
    dones = np.asarray(ro.masks)[1:] == 0.0
    noise = np.stack([np.asarray(jax.random.normal(k, (N, 2)))
                      for k in jax.random.split(k_roll, T)])
    n_epochs = jax_wdgail.warmup_epochs(tcfg, int(state.update_i) + 1)
    m = learner.expert_val.size
    n_chunks = -(-m // 256)
    perms, e_idx = _jax_ppo_draws(k_ppo, tcfg, total, learner.expert.size)
    return UpdateDraws(
        action_noise=_t(noise),
        env_draws=_jax_rollout_draws(state.env_states.rng, dones, cfg,
                                     n_patrols),
        disc=(None if tcfg.algo == "ppo" else _jax_disc_draws(
            k_disc, tcfg, n_epochs, learner.expert.size, total)),
        ppo_perms=perms, ppo_expert_idx=e_idx,
        val_pre=_t(jax.random.randint(k_val1, (n_chunks, 256), 0, total)),
        val_post=_t(jax.random.randint(k_val2, (n_chunks, 256), 0, total)),
    ), int((~dones).sum() != dones.size)


def check_update_matches_jax(jax_scene, port_scene, env, model, tcfg,
                            jax_expert, port_expert, store_obs=True):
    """One whole update of JAX's learner and of the port's from the same
    initial weights and reset, every draw injected, ``store_obs`` on both
    sides. Holds every metric, the new policy and critic weights, the
    reward statistics, the BC weight and the env state handed on; returns
    (the port's metrics, its new state)."""
    import jax
    from gail_carla_tpu.algo.learner import WDGAILLearner as JaxLearner
    from test_torch_traffic import jax_batch_reset_draws

    jl = JaxLearner(jax_scene, env, model, tcfg, jax_expert,
                    store_obs=store_obs)
    js = jl.init_state()
    n_patrols = port_scene.patrol_xy.shape[0]
    draws, had_resets = _jax_update_draws(jl, js, env, n_patrols)
    assert had_resets
    _, k_env = jax.random.split(jl._init_rng)
    reset_draws, gnss = jax_batch_reset_draws(k_env, tcfg.n_envs, env,
                                              n_patrols)
    js2, want = jl.update(js)

    pl = WDGAILLearner(
        port_scene, env, model, tcfg, port_expert, store_obs=store_obs,
        policy_params=jax.tree.map(np.asarray, jl._policy_params0),
        disc_params=jax.tree.map(np.asarray, jl._disc_params0))
    ps = pl.init_state(reset_draws=reset_draws, reset_gnss=gnss)
    ps2, got = pl.update(ps, draws)

    _compare_aux(got, want)
    assert ps2.update_i == int(js2.update_i) == 1
    _compare_params(ps2.policy.state_dict(),
                    flax_to_state_dict(js2.policy_params, model), "policy")
    _compare_params(ps2.disc.state_dict(),
                    critic_state_dict(js2.disc_params, model), "critic")
    _close(ps2.gail_gamma, js2.gail_gamma, ELEM, "gail_gamma")
    _close(ps2.returns_acc, js2.returns_acc, LOSS, "returns_acc")
    for f in ("mean", "var", "count"):
        _close(getattr(ps2.reward_rms, f), getattr(js2.reward_rms, f), LOSS,
               f"reward_rms.{f}")
    _close(ps2.metrics, js2.metrics, LOSS, "env metrics")
    _close(ps2.render.xy, js2.render.xy, LOSS, "env xy")
    np.testing.assert_array_equal(ps2.render.head.numpy(),
                                  np.asarray(js2.render.head))
    return got, ps2


@pytest.mark.parametrize("algo", ["wdgail", "ppo"])
def test_learner_update_matches_jax(setup, algo):
    """One whole update from the same initial weights and reset, every
    draw injected: ``"wdgail"`` with the BC blend, reward normalisation
    and a reward shift (critic warm-up: 2 epochs), and ``"ppo"`` on the
    env reward without an expert. Compared: every metric, the new policy
    and critic weights, the env state it hands on, the reward statistics
    and the BC weight."""
    if algo == "wdgail":
        tcfg = dataclasses.replace(TCFG, gail_reward_shift=0.5)
        jax_expert, port_expert = setup["expert"], setup["port_expert"]
    else:
        tcfg = dataclasses.replace(TCFG, algo="ppo", bcgail=False)
        jax_expert = port_expert = None
    got, ps2 = check_update_matches_jax(
        setup["jax_scene"], setup["port_scene"], ENV, MODEL, tcfg,
        jax_expert, port_expert)
    if algo == "wdgail":
        assert float(got["disc/reward_rms_std"]) != 1.0
        assert float(got["ppo/bc_loss"]) != 0.0
        assert ps2.disc_opt.count == 2 * 64 // TCFG.gail_batch_size
    else:
        assert ps2.disc_opt.count == 0
        assert float(got["ppo/bc_loss"]) == 0.0
