"""One whole ``WDGAILLearner.update`` against JAX's with the re-rendered
observation (``store_obs=False``: every critic, relabel, validation and
PPO minibatch renders its obs again from the stored render states) on
``"bev"``, for ``algo="wdgail"`` and ``"ppo"``: the mode
``tests/test_torch_learner.py`` leaves out. Tolerances and draws as
there; the expert buffer as in ``tests/test_torch_learner_bev6.py``. The
JAX package is imported inside the tests only (read-only reference).
"""
import pytest
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_learner import ENV
from test_torch_learner_bev6 import check_mode, scenes  # noqa: F401


@pytest.mark.parametrize("algo", ["wdgail", "ppo"])
def test_learner_update_rerender_matches_jax(scenes, algo):  # noqa: F811
    _, ps2 = check_mode(scenes, ENV, False, algo)
    assert ps2.render.npc_pose.shape[1] == 0
