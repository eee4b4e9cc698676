"""The port's behaviour cloning (``algo/bc.py``) against the JAX
package's, and the demo-file and BC recipe through the port's command
lines on the CPU.

``bc_epoch`` and ``learn_bc`` run from the same initial weights on the
same expert buffer (JAX's noiseless demos on route 0 of the smoke scene
at 64 px, 256 rows, the bit-packed store; and a bev6 buffer with 3 + 3
NPCs, the expert obeying signals) with JAX's permutations injected, a
toy float32 model: losses within 1e-5 relative, weights within
``tests/test_torch_learner.py``'s 2e-5 absolute. The recipe: ``learn_bc --smoke --device cpu``
writes ``{out}/best``; ``train --preset smoke --init-params`` warm-starts
from it (its policy equals BC's best before the update) and trains;
``evaluation --smoke --device cpu`` evaluates it. The JAX package is
imported inside the tests only (read-only reference).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_learner import PARAM_ATOL, _compare_params, _port_expert

from gail_carla_tpu_torch import train
from gail_carla_tpu_torch.algo import bc
from gail_carla_tpu_torch.algo.learner import WDGAILLearner
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig
from gail_carla_tpu_torch.convert import flax_to_state_dict, policy_from_flax
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.tools import evaluation, learn_bc
from gail_carla_tpu_torch.utils import checkpoint as ckpt

PRESET = train.make_presets()["smoke"]
ENV = EnvConfig(train=False, bev_width=64)
ENV6 = dataclasses.replace(ENV, obs_mode="bev6", n_npc_vehicles=3,
                           n_npc_walkers=3)
MODEL = ModelConfig(conv_channels=(8, 16), hidden_size=32, head_size=16,
                    dtype="float32")
LOSS_RTOL = 1e-5
assert PARAM_ATOL == 2e-5


@pytest.fixture(scope="module")
def setup():
    """Scenes, and per obs mode JAX's expert buffer with its port copy and
    JAX's initial policy params."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo.buffers import build_expert_buffer
    from gail_carla_tpu.algo.expert import generate_demos
    from gail_carla_tpu.models.policy import init_policy
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    jax_scene = make_jax_scene(**PRESET["scene"])
    out = dict(jax_scene=jax_scene,
               port_scene=make_benchmark_scene(**PRESET["scene"],
                                               device="cpu"))
    for name, cfg, n_ch in (("bev", ENV, 3), ("bev6", ENV6, 6)):
        # route 0's first episode ends near step 520
        demos = generate_demos(jax_scene, cfg, jax.random.PRNGKey(0),
                               jnp.zeros((1,), jnp.int32), 600,
                               with_noise=False, obey_signals=n_ch == 6)
        buf = build_expert_buffer(jax_scene, cfg, demos, size=256)
        net, params = init_policy(jax.random.PRNGKey(1), MODEL,
                                  (n_ch, 64, 64))
        out[name] = (cfg, buf, _port_expert(buf), net,
                     jax.tree.map(np.asarray, params))
    return out


def _jax_perms(key, n_epochs, size):
    """The permutations of JAX's ``learn_bc(rng=key)`` epochs."""
    import jax

    perms = []
    for _ in range(n_epochs):
        key, k = jax.random.split(key)
        perms.append(torch.from_numpy(
            np.array(jax.random.permutation(k, size))))
    return perms


def _port_net(params, n_ch):
    return policy_from_flax(params, MODEL, (n_ch, 64, 64), device="cpu")


@pytest.mark.parametrize("mode", ["bev", "bev6"])
def test_bc_epoch_matches_jax(setup, mode):
    """One epoch (8 minibatches of 32) from the same weights and
    permutation: the mean loss and every weight after the 8 steps."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.algo import bc as jax_bc

    cfg, jbuf, pbuf, net, params = setup[mode]
    jax_scene, port_scene = setup["jax_scene"], setup["port_scene"]
    key = jax.random.PRNGKey(5)
    opt = jax_bc.make_bc_optimizer()
    jparams, _, jloss = jax.jit(lambda p, o, b, k: jax_bc.bc_epoch(
        jax_scene, cfg, net, p, opt, o, b, k))(
            params, opt.init(params), jbuf, key)
    perm = torch.from_numpy(np.array(jax.random.permutation(key,
                                                             pbuf.size)))
    pnet = _port_net(params, 6 if mode == "bev6" else 3)
    popt = bc.make_bc_optimizer()
    state, ploss = bc.bc_epoch(port_scene, cfg, pnet, popt,
                               popt.init(list(pnet.parameters())), pbuf,
                               perm=perm)
    assert state.count == pbuf.size // 32 == 8
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    _compare_params(pnet.state_dict(), flax_to_state_dict(jparams, MODEL),
                    f"bc_epoch {mode}")
    np.testing.assert_allclose(
        float(bc.bc_eval(port_scene, cfg, pnet, pbuf)),
        float(jax_bc.bc_eval(jax_scene, cfg, net, jparams, jbuf)),
        rtol=LOSS_RTOL)


def test_learn_bc_matches_jax(setup):
    """Two epochs of ``learn_bc``: each epoch's train and held-out loss,
    and the best parameters it returns."""
    import jax
    from gail_carla_tpu.algo import bc as jax_bc

    cfg, jbuf, pbuf, net, params = setup["bev"]
    key = jax.random.PRNGKey(2)
    jlog, plog = [], []
    jbest, jbest_loss = jax_bc.learn_bc(
        setup["jax_scene"], cfg, net, params, jbuf, jbuf, key, epochs=2,
        log_fn=lambda e, tr, ev: jlog.append((tr, ev)))
    pbest, pbest_loss = bc.learn_bc(
        setup["port_scene"], cfg, _port_net(params, 3), pbuf, pbuf,
        epochs=2, perms=_jax_perms(key, 2, pbuf.size),
        log_fn=lambda e, tr, ev: plog.append((tr, ev)))
    np.testing.assert_allclose(plog, jlog, rtol=LOSS_RTOL)
    np.testing.assert_allclose(pbest_loss, jbest_loss, rtol=LOSS_RTOL)
    assert plog[1][0] < plog[0][0]
    _compare_params(pbest.state_dict(), flax_to_state_dict(jbest, MODEL),
                    "learn_bc best")


def test_recipe_command_lines(tmp_path, monkeypatch):
    """``learn_bc --smoke`` -> ``train --init-params`` -> ``evaluation``
    on the CPU: BC's best checkpoint warm-starts the training policy
    exactly, the update's metrics are finite, and the evaluation reads
    the checkpoint."""
    out = tmp_path / "bc"
    best_net, best_loss = learn_bc.main(
        ["--smoke", "--device", "cpu", "--epochs", "2", "--out", str(out)])
    assert np.isfinite(best_loss)
    saved = torch.load(out / "best" / ckpt.FILE, weights_only=True)
    assert set(saved["state"]) == {"params"}

    # the policy the first update starts from is BC's best
    seen = []
    update = WDGAILLearner.update

    def probe(self, state, *a, **k):
        seen.append({n: v.clone()
                     for n, v in state.policy.state_dict().items()})
        return update(self, state, *a, **k)

    monkeypatch.setattr(WDGAILLearner, "update", probe)
    state, metrics = train.main([
        "--preset", "smoke", "--device", "cpu", "--max-updates", "1",
        "--init-params", str(out / "best"),
        "--log-dir", str(tmp_path / "log")])
    assert state.update_i == 1 and len(seen) == 1
    for k, v in best_net.state_dict().items():
        assert torch.equal(seen[0][k], v), k
    assert all(np.isfinite(float(v)) for v in metrics.values())

    results = evaluation.evaluate(str(out / "best"), route=1, episodes=1,
                                  device="cpu", smoke=True)
    assert len(results) == 1 and results[0]["length"] > 0
    json.dumps(results)

    # an episode's injected reset draws reach evaluate_policy: the same
    # episode run directly with those draws gives the same result
    from gail_carla_tpu_torch.algo.evaluate import evaluate_policy
    from gail_carla_tpu_torch.sim.env import draw_gnss, draw_reset

    scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    preset = learn_bc.make_bc_presets()["smoke"]
    g = torch.Generator()
    g.manual_seed(3)
    draws = dict(reset_draws=draw_reset(scene, preset["env"], 1, g),
                 reset_gnss=draw_gnss(1, "cpu", g))
    (got,) = evaluation.evaluate(str(out / "best"), route=1, episodes=1,
                                 device="cpu", smoke=True, scene=scene,
                                 episode_draws=[draws])
    g.manual_seed(0)
    want = evaluate_policy(scene, preset["env"], best_net, g, route_id=1,
                           max_steps=preset["env"].max_steps, **draws)
    assert got["length"] == int(want["length"][0])
    assert got["reward"] == float(want["reward"][0])
