"""Endless route chaining in the port (``sim/env.py::chain_endless``)
against the JAX package's, mirroring ``tests/test_endless.py``.

The endless suite slices one long lane walk into ~150 m rows that share
boundary poses; with ``EnvConfig.endless_extension`` an env continues
onto ``scene.endless_next[row]`` when its cursor reaches the row's end.
One env driven by the scripted expert (obeying signals: the valeo
terminal ends episodes on red lights) for ``N_STEPS`` steps in both
packages, every JAX draw injected into the port: ``route_id``, ``head``
and ``plan_idx`` equal at every step, ``s0``, ``route_len_ep``, the
metrics and the completed metres within 1e-4. The JAX package is
imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_expert import single_torch_thread
from test_torch_traffic import (
    jax_batch_reset_draws, jax_step_draws_raw, step_draws_from_raw,
)

from gail_carla_tpu_torch.agents.autopilot import (
    autopilot_act, reset_autopilot_where,
)
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.envs.suites import endless_suite
from gail_carla_tpu_torch.sim import env as port_env

N_STEPS = 1500
SUITE = dict(n_npc_vehicles=0, n_npc_walkers=0, n_rows=6, row_m=150.0,
             max_time=600.0, seed=5)
TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("route_id", "head", "plan_idx", "s0", "route_len_ep")


@pytest.fixture(scope="module")
def run():
    """Per step of both runs: the state fields ``FIELDS``, the metrics,
    ``route_completed_in_m``, ``route_completed`` and ``done``."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.agents.autopilot import autopilot_act as jax_act
    from gail_carla_tpu.agents.autopilot import (
        reset_autopilot_where as jax_reset_ap,
    )
    from gail_carla_tpu.agents.controllers import (
        make_autopilot as jax_make_ap,
    )
    from gail_carla_tpu.envs.suites import endless_suite as jax_suite
    from gail_carla_tpu.sim.env import reset_batch, step_batch

    with single_torch_thread():
        scene, cfg, _ = endless_suite(**SUITE, device="cpu")
    jax_scene, jcfg, _ = jax_suite(**SUITE)
    cfg = dataclasses.replace(cfg, train=False, obs_mode="state")
    jcfg = dataclasses.replace(jcfg, train=False, obs_mode="state")
    key = jax.random.PRNGKey(0)
    rid = jnp.zeros((1,), jnp.int32)

    @jax.jit
    def jax_run(key):
        st, _, _ = reset_batch(jax_scene, jcfg, key, rid)
        ap = jax.tree.map(lambda a: a[None], jax_make_ap())

        def body(c, _):
            st, ap = c
            ap, act = jax.vmap(
                lambda a, w: jax_act(jax_scene, a, w, obey_signals=True)
            )(ap, st)
            st2, out = step_batch(jax_scene, jcfg, st, act)
            ap = jax.vmap(jax_reset_ap)(out.done, ap)
            rec = {f: getattr(st2, f) for f in FIELDS}
            rec.update(rng=st.rng, metrics=out.metrics, done=out.done,
                       completed_m=out.info["route_completed_in_m"],
                       route_completed=out.info["route_completed"])
            return (st2, ap), rec

        return jax.lax.scan(body, (st, ap), None, length=N_STEPS)[1]

    want = jax.tree.map(np.asarray, jax_run(key))
    n_patrols = scene.patrol_xy.shape[0]
    draws_fn = jax.jit(jax.vmap(
        lambda r, d: jax_step_draws_raw(r, d, jcfg, n_patrols)))
    raw = jax.tree.map(np.asarray, draws_fn(jnp.asarray(want["rng"]),
                                            jnp.asarray(want["done"])))

    draws, gnss = jax_batch_reset_draws(key, 1, jcfg, n_patrols)
    st, _, _ = port_env.reset_batch(scene, cfg,
                                    torch.zeros(1, dtype=torch.int32),
                                    draws=draws, gnss_noise=gnss)
    ap = make_autopilot((1,), "cpu")
    got = {k: [] for k in FIELDS + ("metrics", "done", "completed_m",
                                    "route_completed")}
    with single_torch_thread():
        for t in range(N_STEPS):
            ap, act = autopilot_act(scene, ap, st, obey_signals=True)
            sd = step_draws_from_raw(jax.tree.map(lambda a: a[t], raw))
            st, out = port_env.step_batch(scene, cfg, st, act,
                                          **sd._asdict())
            ap = reset_autopilot_where(out.done, ap)
            for f in FIELDS:
                got[f].append(getattr(st, f).numpy())
            got["metrics"].append(out.metrics.numpy())
            got["done"].append(out.done.numpy())
            got["completed_m"].append(
                out.info["route_completed_in_m"].numpy())
            got["route_completed"].append(
                out.info["route_completed"].numpy())
    got = {k: np.stack(v) for k, v in got.items()}
    return scene, got, want


def test_rows_are_chained():
    scene, cfg, _ = endless_suite(**SUITE, device="cpu")
    assert cfg.endless_extension
    nxt = scene.endless_next.numpy()
    assert (nxt[:-1] == np.arange(1, len(nxt))).all()
    assert nxt[-1] == len(nxt) - 1
    # boundary poses shared: row r's end == row r+1's start
    for r in range(len(nxt) - 1):
        n = int(scene.route_n[r])
        np.testing.assert_allclose(scene.route_xy[r, n - 1].numpy(),
                                   scene.route_xy[r + 1, 0].numpy(),
                                   atol=1e-4)


def test_chaining_matches_jax(run):
    """Every step equal to JAX's, across at least two row switches."""
    _, got, want = run
    switches = int((np.diff(want["route_id"][:, 0]) != 0).sum())
    assert switches >= 2, switches
    for f in ("route_id", "head", "plan_idx", "done"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("s0", "route_len_ep", "metrics", "completed_m"):
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **TOL)


def test_episode_outruns_any_single_row(run):
    """``test_endless.py``'s check on the port's run: the completed metres
    grow monotonically past 1.5 rows' length and the route never
    completes."""
    scene, got, _ = run
    done = got["done"][:, 0]
    c = got["completed_m"][:, 0]
    last = np.concatenate([[0.0], np.where(done, 0.0, c)[:-1]])
    assert ((c >= last - 1e-3) | done).all()
    longest_row = float(scene.route_len_m.max())
    assert c.max() > 1.5 * longest_row, (c.max(), longest_row)
    assert not got["route_completed"].any()
