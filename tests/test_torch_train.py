"""The port's training entry point and what it persists: checkpoints of
the whole ``LearnerState`` (``utils/checkpoint.py``), the metrics log
(``utils/logging.py``), ``train.main`` end to end on the CPU with a
resume, ``--profile`` and the leaderboard-table evaluation.

Checkpoints must round-trip bit for bit, and an update from a restored
state must equal the update from the original bit for bit; a resumed run
of ``main`` must continue exactly as the uninterrupted run. The JAX
package is imported inside the tests only (read-only reference).
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

from gail_carla_tpu_torch import train
from gail_carla_tpu_torch.algo.buffers import build_expert_buffer
from gail_carla_tpu_torch.algo.expert import DemoBatch
from gail_carla_tpu_torch.algo.learner import WDGAILLearner
from gail_carla_tpu_torch.convert import init_policy
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import RenderState, reset_batch
from gail_carla_tpu_torch.utils import checkpoint as ckpt
from gail_carla_tpu_torch.utils.logging import TAG_MAP, MetricsWriter

PRESET = train.make_presets()["smoke"]
SMOKE_ARGS = ["--preset", "smoke", "--device", "cpu"]


def _flat(saved, prefix=""):
    """{path: leaf} of a ``checkpoint.to_saved`` tree."""
    if isinstance(saved, dict):
        out = {}
        for k, v in saved.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(saved, list):
        out = {}
        for i, v in enumerate(saved):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: saved}


def assert_states_equal(a, b):
    """Every tensor, scalar and the generator state of two states (or
    ``to_saved`` trees) bit for bit."""
    fa = _flat(ckpt.to_saved(a))
    fb = _flat(ckpt.to_saved(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and v.shape == fb[k].shape, k
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def _small_learner():
    """A ``WDGAILLearner`` on the smoke scene (no NPCs: zero-size traffic
    tensors), 4 envs x 16 steps, critic and PPO minibatches of 32, with an
    expert buffer of 32 rows from reset states."""
    scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    env_cfg = PRESET["env"]
    tcfg = dataclasses.replace(PRESET["train"], num_steps=64,
                               gail_reward_shift=0.5, gail_norm_reward=True)
    g = torch.Generator()
    g.manual_seed(0)
    _, metrics, render = reset_batch(scene, env_cfg,
                                     torch.arange(32) % scene.n_routes, g)
    demos = DemoBatch(
        render=RenderState(**{f.name: getattr(render, f.name)[None]
                              for f in dataclasses.fields(RenderState)}),
        metrics=metrics[None], actions=torch.rand((1, 32, 2), generator=g),
        valid=torch.ones((1, 32), dtype=torch.bool))
    expert = build_expert_buffer(scene, env_cfg, demos)
    return WDGAILLearner(scene, env_cfg, PRESET["model"], tcfg, expert)


def test_checkpoint_round_trip_and_resumed_update(tmp_path):
    """A whole CPU ``LearnerState`` after one update (optimizer moments,
    reward statistics, the generator's state, zero-size traffic tensors)
    round-trips into a fresh template bit for bit, and the next update
    from the restored state equals the one from the original bit for
    bit. ``latest_checkpoint`` and ``prune_checkpoints`` keep the newest
    ``update_*`` directories and leave others alone."""
    learner = _small_learner()
    state, _ = learner.update(learner.init_state())
    assert state.env_states.traffic.veh.xy.shape == (4, 0, 2)
    assert state.policy_opt.count > 0
    path = tmp_path / "update_1"
    ckpt.save_checkpoint(str(path), state, elapsed=12.5)

    template = learner.init_state()
    template.generator.manual_seed(99)
    restored, elapsed = ckpt.restore_checkpoint(str(path), template)
    assert elapsed == 12.5
    assert_states_equal(restored, state)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())
    assert restored.policy is template.policy

    # the next update, from the restored state and from the original
    after_r, metrics_r = learner.update(restored)
    after_o, metrics_o = learner.update(state)
    assert metrics_r.keys() == metrics_o.keys()
    for k, v in metrics_o.items():
        assert torch.equal(torch.as_tensor(metrics_r[k]),
                           torch.as_tensor(v)), k
    assert_states_equal(after_r, after_o)

    # a template of another shape is refused
    other = dataclasses.replace(template,
                                returns_acc=torch.zeros(5))
    with pytest.raises(ValueError, match="returns_acc"):
        ckpt.restore_checkpoint(str(path), other)

    for i in (2, 3, 10):
        ckpt.save_checkpoint(str(tmp_path / f"update_{i}"), {"i": i})
    ckpt.save_checkpoint(str(tmp_path / "best"), {"i": 0})
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                        "update_10")
    ckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best", "update_10", "update_3"]
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def test_metrics_writer_jsonl(tmp_path):
    """``tests/test_utils.py::test_metrics_writer_jsonl`` on the port, and
    the same tag schema as the JAX package."""
    from gail_carla_tpu.utils.logging import TAG_MAP as JAX_TAG_MAP

    assert TAG_MAP == JAX_TAG_MAP
    w = MetricsWriter(str(tmp_path), use_tensorboard=False)
    w.write(1, {"ppo/value_loss": torch.tensor(0.5), "ep_reward_mean": 1.25,
                "note": "not a number"})
    w.write(2, {"ppo/value_loss": 0.25})
    w.close()
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert rows[0]["step"] == 1 and "note" not in rows[0]
    assert abs(rows[0]["ppo/value_loss"] - 0.5) < 1e-9
    assert abs(rows[1]["ppo/value_loss"] - 0.25) < 1e-9


def _rows(log_dir):
    return [json.loads(line) for line in open(log_dir / "metrics.jsonl")]


def test_main_runs_and_resumes_bit_equal(tmp_path):
    """``main --preset smoke --device cpu --max-updates 3`` runs end to end
    (demos, expert buffers, three updates, evaluation, metrics log,
    checkpoints ``update_2`` and ``update_3``); ``--resume`` from its
    ``update_2`` alone continues to update 3, which equals the
    uninterrupted run's bit for bit: the state in memory and on disk, and
    the update's metrics (the evaluation metrics aside: a resumed run
    evaluates at its first update)."""
    ref_dir, run_dir = tmp_path / "ref", tmp_path / "run"

    def args(d):
        # one training route, which is also the held-out one: the expert
        # buffers (rendered on the CPU) stay small
        return SMOKE_ARGS + ["--max-updates", "3", "--routes", "0",
                             "--eval-route", "0", "--log-dir",
                             str(d / "log"), "--ckpt-dir", str(d / "ckpt")]

    state_ref, _ = train.main(args(ref_dir))
    assert state_ref.update_i == 3
    assert sorted(p.name for p in (ref_dir / "ckpt").iterdir()) == [
        "update_2", "update_3"]
    rows = _rows(ref_dir / "log")
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(set(TAG_MAP) <= set(r) for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())

    shutil.copytree(ref_dir / "ckpt" / "update_2",
                    run_dir / "ckpt" / "update_2")
    state, _ = train.main(args(run_dir) + ["--resume"])
    assert state.update_i == 3
    assert_states_equal(state, state_ref)
    resumed, _ = ckpt.restore_checkpoint(str(run_dir / "ckpt" / "update_3"),
                                         ckpt.to_saved(state))
    uninterrupted, _ = ckpt.restore_checkpoint(
        str(ref_dir / "ckpt" / "update_3"), ckpt.to_saved(state))
    assert_states_equal(resumed, uninterrupted)
    (row,), row_ref = _rows(run_dir / "log"), rows[-1]
    assert row["step"] == 3
    for k, v in row_ref.items():
        if k != "wall_time" and not k.startswith("eval/"):
            assert row[k] == v, k


def test_run_refuses_what_is_not_ported(tmp_path):
    """A town scene without the reference's data raises instead of
    falling back to the grid (the town path on a synthetic tree:
    ``tests/test_torch_town_env.py``); sharded training without an
    initialised process group raises instead of training on one rank; a
    demo tree without demos raises instead of training on generated
    ones."""
    from gail_carla_tpu_torch.tools import synthetic_town

    smoke = PRESET
    common = (smoke["env"], smoke["model"], smoke["train"])
    with synthetic_town.reference_tree(str(tmp_path / "none")):
        with pytest.raises(FileNotFoundError):
            train.run(*common, {"town": "Town01"}, 10, device="cpu",
                      log_dir=str(tmp_path))
    for route in smoke["train"].routes:
        ep = tmp_path / f"route_{route:02d}" / "ep_00"
        ep.mkdir(parents=True)
        (ep / "episode.json").write_text('{"actions": {}, "metrics": {}}')
    with pytest.raises(FileNotFoundError, match="no expert steps"):
        train.run(*common, smoke["scene"], 10, device="cpu",
                  demo_tree=str(tmp_path), log_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        train.run(*common, smoke["scene"], 10, device="cpu",
                  use_sharding=True, log_dir=str(tmp_path))


def test_init_params_round_trip(tmp_path):
    """``best_params``-shaped checkpoints: what ``run`` writes for the best
    policy (``{"params": policy}``) restores into another policy's
    template, as ``--init-params`` reads it."""
    shape = (3, 64, 64)
    a = init_policy(PRESET["model"], shape, seed=1, device="cpu")
    b = init_policy(PRESET["model"], shape, seed=2, device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "best_params"), {"params": a})
    ckpt.restore_checkpoint(str(tmp_path / "best_params"), {"params": b})
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v), k


def test_profiled_update_writes_a_trace(tmp_path):
    """``--profile``'s update: the same update under ``torch.profiler``,
    with its Chrome trace under ``log_dir/profile``."""
    learner = _small_learner()
    state, metrics = train._profiled_update(
        learner, learner.init_state(), torch.device("cpu"), str(tmp_path))
    assert state.update_i == 1 and "ppo/value_loss" in metrics
    trace = tmp_path / "profile" / "update_1.json"
    assert json.loads(trace.read_text())["traceEvents"]


def test_table_eval_chunks():
    """``--eval-all-routes`` with ``--eval-seeds 2``: the table over every
    route, in one call and in chunks of 3 envs (the last chunk padded with
    the first routes, which are dropped again)."""
    scene = make_benchmark_scene(**PRESET["scene"], device="cpu")
    w = PRESET["env"].bev_width
    net = init_policy(PRESET["model"], (3, w, w), seed=0, device="cpu")
    cfg = dataclasses.replace(PRESET["env"], max_time=8.0)
    whole = train._table_eval(scene, cfg, net, torch.device("cpu"), 2, 0)
    chunked = train._table_eval(scene, cfg, net, torch.device("cpu"), 2, 3)
    assert set(whole) == set(chunked) == {
        "eval/mean_driving_score", "eval/routes_completed",
        "eval/red_light_per_km"}
    for out in (whole, chunked):
        assert 0.0 <= out["eval/routes_completed"] <= 4.0
        assert all(np.isfinite(v) for v in out.values())
