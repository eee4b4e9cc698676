"""The preset shapes of ``gail_carla_tpu/train.py`` (``make_presets``,
``train.py:49-110``), for the port's entry points and tests. One
training update is ``algo/learner.py::WDGAILLearner.update``; the loop
around it (``run``: presets, evaluation, checkpoints) is not ported yet,
and the town presets need the town importers, which are not ported
yet either."""
from __future__ import annotations

from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig


def make_presets():
    smoke = dict(
        env=EnvConfig(train=True, bev_width=64),
        model=ModelConfig(conv_channels=(8, 16), hidden_size=64,
                          head_size=32, disc_hidden=32, dtype="float32"),
        train=TrainConfig(
            n_envs=4, num_steps=256, num_env_steps=2048,
            mini_batch_size=32, ppo_epoch=2, gail_batch_size=32,
            gail_pre_epoch=2, gail_epoch=1, gail_thre=2,
            routes=(0, 1), eval_route=1, eval_interval=2,
        ),
        scene=dict(n_routes=2, nx=3, ny=3, block=80.0, min_length=150.0),
        demo_steps=900,
    )
    reference = dict(
        env=EnvConfig(train=True),
        model=ModelConfig(),
        train=TrainConfig(n_envs=10),
        scene=dict(n_routes=10, nx=4, ny=4, block=100.0, min_length=400.0),
        demo_steps=4000,
    )
    return {"smoke": smoke, "reference": reference}
