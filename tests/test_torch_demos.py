"""The port's ``generate_demos`` with noise against the JAX package's,
closed loop over 300 steps with every draw injected (``DemoDraws``, from
JAX's keys; helpers in ``tests/test_torch_expert.py``).

Rows agree within 1e-4 on actions, metrics and positions, with equal
route cursors and ``valid``, up to a stated step per env. Sim times are
on a 0.1 s grid and noise durations on a 0.01 s grid, so the noise
schedule meets exact ties; inside its compiled scan XLA on the CPU
contracts ``step * dt - t0`` into one rounding at some uses and not at
others, and at a tie that decides a transition. The port computes the
float32 time and the float32 difference, as JAX's source says. Each test
names the step where the two first part and why. The JAX package is
imported inside the tests only (read-only reference).
"""
import numpy as np
from test_torch_expert import (  # noqa: F401 (one_torch_thread: autouse)
    PRESET, SHORT, TRAFFIC_ENV, _first_divergence, _run_both,
    one_torch_thread,
)

from gail_carla_tpu_torch.config import EnvConfig


def test_generate_demos_with_noise_matches_jax():
    """The noised expert on two short routes, 300 steps, the default env
    randomness on: both envs complete their route (valid rows), and the
    episode after it is a trailing partial one (dropped). Env 0 agrees at
    every step. Env 1 agrees up to step 71: there its throttle noise
    window ends at an exact tie, ``t - end_t > amount`` with 7.1 - 4.0
    against 3.1, which JAX's compiled scan evaluates as one fused
    multiply-add of ``step * dt - end_t`` (True) and the port as the
    float32 difference of the float32 time (False, as in JAX's source)."""
    got, want = _run_both(SHORT, EnvConfig(train=False), [0, 1], 300, 5,
                          True, False)
    assert _first_divergence(got, want) == [300, 71]
    for demos in (got, want):
        valid = np.asarray(demos.valid)
        assert valid.any(axis=0).all() and not valid[-1].any()


def test_generate_demos_obeying_signals_with_traffic_matches_jax():
    """``obey_signals=True`` with 3 NPC vehicles and 3 walkers per env
    (``obs_mode="bev6"``), noise on, 300 steps on the smoke scene's two
    routes: the light, stop-sign and hazard caps inside a closed loop.
    Env 1 agrees at every step, with its NPC positions. Env 0 agrees up
    to step 65: there its steer noise meets an exact tie, ``t - start_t
    >= amount`` with 6.5 - 4.9 against 1.6, which JAX's compiled scan
    evaluates twice with two roundings (it clears ``active`` but does not
    set ``removing``); the port evaluates it once, as JAX's source
    says."""
    got, want = _run_both(PRESET["scene"], TRAFFIC_ENV, [0, 1], 300, 9,
                          True, True)
    assert _first_divergence(got, want) == [65, 300]
    np.testing.assert_allclose(got.render.npc_pose[:, 1, :, :2].numpy(),
                               np.asarray(want.render.npc_pose)[:, 1, :, :2],
                               rtol=0, atol=1e-4)
