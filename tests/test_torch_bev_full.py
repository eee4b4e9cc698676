"""The port's full-parity BEV (``ops/bev_full.py``) and its history ring
(``sim/env.py`` with ``full_bev=True``) against the JAX package's.

A 20-step traffic run of 2 envs on the smoke scene (6 NPC vehicles and
3 walkers each, 1.2 s episodes, so both envs auto-reset and restart with
an empty ring), every draw of the JAX envs injected into the port: the
ring's discrete fields equal and its poses within the traffic tests'
1e-4; the 15 masks, the rendered RGB and ``collision_px`` of every step
from the same state and ring equal at 0 values. Then the current-frame
planes against the 3- and 6-channel renderers: each package's count of
differing values (JAX's own, as ``tests/test_tools.py:50`` checks it),
with the port held to JAX's count (0). A placed state and ring (actors,
stop lines and an active stop sign in view, a partly filled ring) makes
every channel draw. The JAX package is imported
inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, single_torch_thread,
)
from test_torch_traffic import (
    compare_poses, jax_batch_reset_draws, jax_step_draws,
)

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops.bev import render_bev_batch
from gail_carla_tpu_torch.ops.bev6 import render_bev6_batch
from gail_carla_tpu_torch.ops.bev_full import render_bev_full
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.sim.state import HistoryState
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]
ENV = EnvConfig(train=False, full_bev=True, obs_mode="bev6", bev_width=96,
                n_npc_vehicles=6, n_npc_walkers=3, max_time=1.2)
N_ENVS, N_STEPS = 2, 20


def _t(a):
    return torch.from_numpy(np.array(a))


def port_history(jh) -> HistoryState:
    return HistoryState(**{f.name: _t(getattr(jh, f.name))
                           for f in dataclasses.fields(HistoryState)})


def port_render(jr) -> port_env.RenderState:
    return port_env.RenderState(**{
        f.name: _t(getattr(jr, f.name))
        for f in dataclasses.fields(port_env.RenderState)})


@pytest.fixture(scope="module")
def run():
    """The JAX run and the port's with JAX's draws: per step, both
    packages' states and JAX's render state."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )
    from gail_carla_tpu.sim.env import reset_batch, step_batch

    port_scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    jax_scene = make_jax_scene(**PRESET["scene"])
    n_patrols = port_scene.patrol_xy.shape[0]
    key = jax.random.PRNGKey(7)
    rid = jnp.asarray([0, 1], jnp.int32)
    js, _, _ = reset_batch(jax_scene, ENV, key, rid)
    draws, gnss = jax_batch_reset_draws(key, N_ENVS, ENV, n_patrols)
    ps, _, _ = port_env.reset_batch(port_scene, ENV, _t(rid), draws=draws,
                                    gnss_noise=gnss)
    step = jax.jit(lambda s, a: step_batch(jax_scene, ENV, s, a))
    rng = np.random.default_rng(0)
    steps = []
    n_done = 0
    for _ in range(N_STEPS):
        act = np.stack([rng.uniform(-0.3, 0.3, N_ENVS),
                        rng.uniform(0.3, 1.0, N_ENVS)], 1).astype(np.float32)
        rngs = js.rng
        js, out = step(js, jnp.asarray(act))
        done = np.asarray(out.done)
        n_done += int(done.sum())
        with single_torch_thread():
            ps, _ = port_env.step_batch(
                port_scene, ENV, ps, _t(act),
                **jax_step_draws(rngs, jnp.asarray(done), ENV,
                                 n_patrols)._asdict())
        steps.append((js, ps, out.render))
    assert n_done >= N_ENVS, "every env should auto-reset once"
    return port_scene, jax_scene, steps


def test_history_ring_matches_jax(run):
    _, _, steps = run
    for i, (js, ps, _) in enumerate(steps):
        jh, ph = js.history, ps.history
        for name in ("idx", "count", "tl_state", "stop_active"):
            np.testing.assert_array_equal(
                getattr(ph, name).numpy(), np.asarray(getattr(jh, name)),
                err_msg=f"history.{name} at step {i}")
        compare_poses(ph.veh_pose, jh.veh_pose, f"veh_pose at step {i}")
        compare_poses(ph.walker_pose, jh.walker_pose,
                      f"walker_pose at step {i}")
    # the ring wrapped past an auto-reset: counts restarted from 0
    counts = np.stack([np.asarray(js.history.count) for js, _, _ in steps])
    assert (np.diff(counts, axis=0) < 0).any()


def _placed(port_scene, js, jr):
    """A state and ring that draw every channel: the run's last render
    state with env 0 before a stop line and env 1 at its active stop sign,
    their actors in view (``ops/bev6.py::place_in_view``), and a ring
    whose 20 slots hold those actors moved by up to 2 m and random light
    states, except the newest slot, which holds the current ones. Env 1's
    ring has 3 valid entries, so its older taps clamp to the oldest."""
    import jax.numpy as jnp
    from gail_carla_tpu.sim.env import RenderState as JaxRender
    from gail_carla_tpu.sim.state import HistoryState as JaxHistory

    from gail_carla_tpu_torch.ops.bev6 import place_in_view
    from gail_carla_tpu_torch.sim import signals

    rng = np.random.default_rng(1)
    pr = place_in_view(port_scene, port_render(jr), [0, 1], rng, 6, 3,
                       view=(8.0, 30.0, 12.0))
    n, ring = N_ENVS, 20
    idx = rng.integers(0, ring, n).astype(np.int32)
    newest = (idx - 1) % ring
    jitter = lambda a: a + np.concatenate(  # noqa: E731
        [rng.uniform(-2, 2, (n, ring) + a.shape[2:-1] + (2,)),
         rng.uniform(-np.pi, np.pi, (n, ring) + a.shape[2:-1] + (1,))],
        -1).astype(np.float32)
    veh = jitter(pr.npc_pose.numpy()[:, None])
    wk = jitter(pr.walker_pose.numpy()[:, None])
    T, S = port_scene.tl_stop.shape[0], port_scene.ss_center.shape[0]
    tl = rng.integers(0, 3, (n, ring, T)).astype(np.int8)
    now = signals.light_states(port_scene, pr.step.float() * ENV.dt)
    sa = np.zeros((n, ring, S), bool)
    stop = pr.stop_idx.numpy()
    for e in range(n):
        veh[e, newest[e]] = pr.npc_pose[e].numpy()
        wk[e, newest[e]] = pr.walker_pose[e].numpy()
        tl[e, newest[e]] = now[e].numpy()
        if stop[e] >= 0:
            sa[e, :, stop[e]] = True
    hist = dict(veh_pose=veh, walker_pose=wk, tl_state=tl, stop_active=sa,
                idx=idx, count=np.array([20, 3], np.int32))
    jh = JaxHistory(**{k: jnp.asarray(v) for k, v in hist.items()})
    jrp = JaxRender(**{f.name: jnp.asarray(getattr(pr, f.name).numpy())
                       for f in dataclasses.fields(port_env.RenderState)})
    return jh, jrp


def _states(run):
    """The run's (JAX state's ring, JAX render state) per step, and the
    placed pair last."""
    port_scene, _, steps = run
    out = [(js.history, jr) for js, _, jr in steps]
    js, _, jr = steps[-1]
    return out + [_placed(port_scene, js, jr)]


def test_render_bev_full_matches_jax(run):
    """Every step's render of JAX's state and ring, and the placed one's,
    through both packages: 0 differing values."""
    import jax
    from gail_carla_tpu.ops.bev_full import render_bev_full as jax_full

    port_scene, jax_scene, _ = run
    render = jax.jit(jax.vmap(lambda r, h: jax_full(
        jax_scene, ENV, r.xy, r.yaw, r.route_id, r.head, h)))
    drawn = np.zeros(15, np.int64)
    for i, (jh, jr) in enumerate(_states(run)):
        jm, jrgb, jcol = map(np.asarray, render(jr, jh))
        drawn += (jm > 0).sum(axis=(0, 2, 3))
        pr = port_render(jr)
        pm, prgb, pcol = render_bev_full(
            port_scene, ENV, pr.xy, pr.yaw, pr.route_id, pr.head,
            port_history(jh))
        np.testing.assert_array_equal(pm.numpy(), jm,
                                      err_msg=f"masks at state {i}")
        np.testing.assert_array_equal(prgb.numpy(), jrgb,
                                      err_msg=f"rendered at state {i}")
        np.testing.assert_array_equal(pcol.numpy(), jcol,
                                      err_msg=f"collision_px at state {i}")
    # every channel is drawn, and the placed state shows every light level
    assert (drawn > 0).all(), drawn
    assert {0, 80, 170, 255} <= set(np.unique(jm[:, 11:]))


def _count_vs_renderers(masks, obs3, obs6):
    """Differing values: masks 0-2 against the 3-channel render scaled to
    uint8, and masks 14, 6, 10 against the 6-channel signal, vehicle and
    walker channels."""
    to8 = lambda o: (np.asarray(o) * 255.0).astype(np.uint8)  # noqa: E731
    m = np.asarray(masks)
    base = int((to8(obs3) != m[:, :3]).sum())
    cur = int((to8(obs6)[:, 3:] != m[:, [14, 6, 10]]).sum())
    return base, cur


def test_current_planes_match_bev_and_bev6(run):
    """JAX's own count of differing values between the stack's planes and
    its 3- and 6-channel renderers over every step, and the port's on the
    same states: equal (both 0)."""
    import jax
    from gail_carla_tpu.ops.bev import render_bev_batch as jax_bev
    from gail_carla_tpu.ops.bev6 import render_bev6_batch as jax_bev6
    from gail_carla_tpu.ops.bev_full import render_bev_full as jax_full

    port_scene, jax_scene, _ = run
    render = jax.jit(jax.vmap(lambda r, h: jax_full(
        jax_scene, ENV, r.xy, r.yaw, r.route_id, r.head, h)))
    jax_counts, port_counts = np.zeros(2, int), np.zeros(2, int)
    for jh, jr in _states(run):
        jm = render(jr, jh)[0]
        jax_counts += _count_vs_renderers(
            jm, jax_bev(jax_scene, ENV, jr), jax_bev6(jax_scene, ENV, jr))
        pr = port_render(jr)
        pm = render_bev_full(port_scene, ENV, pr.xy, pr.yaw, pr.route_id,
                             pr.head, port_history(jh))[0]
        port_counts += _count_vs_renderers(
            pm, render_bev_batch(port_scene, ENV, pr),
            render_bev6_batch(port_scene, ENV, pr))
    assert tuple(port_counts) == tuple(jax_counts) == (0, 0)
