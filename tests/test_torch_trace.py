"""The port's spans (``gail_carla_tpu_torch/utils/trace.py``): with
tracing off ``span`` opens nothing; under the in-memory recorder a rollout
gives the same outputs; under a CPU-only ``torch.profiler`` a rollout and
a whole ``WDGAILLearner.update`` emit their layers' spans, and the update's
spans hold all of its work.

Toy shapes of tests/test_torch_learner.py (64 px, convs (8, 16), hidden
32, float32, 2 envs) on the smoke preset's scene, with fewer steps.
"""
import dataclasses
import json

import pytest
import torch

from gail_carla_tpu_torch.algo.buffers import ExpertBuffer, map_state
from gail_carla_tpu_torch.algo.learner import WDGAILLearner
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from gail_carla_tpu_torch.convert import init_flax_params, policy_from_flax
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim.env import reset_batch
from gail_carla_tpu_torch.train import make_presets
from gail_carla_tpu_torch.utils import trace

PRESET = make_presets()["smoke"]
# 15-step episodes, so a longer rollout would auto-reset
ENV = EnvConfig(train=True, bev_width=64, max_time=1.5)
MODEL = ModelConfig(conv_channels=(8, 16), hidden_size=32, head_size=16,
                    disc_hidden=16, dtype="float32")
TCFG = TrainConfig(
    n_envs=2, num_steps=8, mini_batch_size=4, ppo_epoch=1,
    gail_batch_size=4, gail_pre_epoch=1, gail_epoch=1, gail_thre=2,
    routes=(0, 1), bcgail=True, gail_gamma=0.5, decay=0.9,
    gail_norm_reward=True,
)
OBS = (3, 64, 64)
STEPS = 3
LEARNER_SPANS = ["learner.rollout", "learner.validation", "learner.critic",
                 "learner.validation", "learner.relabel", "learner.returns",
                 "learner.ppo"]
# the update's own ops after PPO: the BC weight's decay (mul) and the
# update's metric dict (the log-std made a tensor, the exp of each entry,
# the GAIL reward's mean, the reward scale's std)
AFTER_PPO = {"aten::mul", "aten::empty", "aten::lift_fresh", "aten::detach_",
             "aten::to", "aten::select", "aten::exp", "aten::mean",
             "aten::sqrt"}


@pytest.fixture(scope="module")
def scene():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield make_benchmark_scene(**PRESET["scene"], device="cpu")
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def profiled(fn, tmp_path):
    """(fn's result, its user_annotation events, its cpu_op events) from a
    CPU-only profile's Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return (out, [e for e in events if e["cat"] == "user_annotation"],
            [e for e in events if e["cat"] == "cpu_op"])


def inside(e, outer):
    return (outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def assert_equal(a, b, where="out"):
    """Every tensor of two nests of tuples, dicts and dataclasses equal."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_equal(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_equal(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            assert_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def rollout(scene, store_obs=True, n_steps=STEPS):
    policy = policy_from_flax(init_flax_params(MODEL, OBS, 0), MODEL, OBS,
                              "cpu")
    gen = torch.Generator().manual_seed(0)
    st, met, ren = reset_batch(scene, ENV, torch.tensor([0, 1]), gen)
    return collect_rollout(scene, ENV, policy, st, met, ren, gen, n_steps,
                           store_obs)


def test_span_off_opens_nothing(monkeypatch):
    def no_record_function(name):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    assert trace._active is None
    assert trace.span("env.step") is trace.NULL
    with trace.span("env.step"):
        pass
    with trace.recording() as rec:
        with trace.span("env.step"):
            with trace.span("sim.traffic"):
                pass
        with trace.span("env.step"):
            pass
    assert trace.span("env.step") is trace.NULL
    assert [(n, p) for n, p, _, _ in rec.spans] == [
        ("sim.traffic", "env.step"), ("env.step", None), ("env.step", None)]
    assert rec.calls() == {"env.step": 2, "sim.traffic": 1}
    host, own = rec.host_ms(), rec.self_ms()
    assert own["sim.traffic"] == pytest.approx(host["sim.traffic"])
    assert own["env.step"] == pytest.approx(host["env.step"]
                                            - host["sim.traffic"])


def test_rollout_spans(scene, tmp_path):
    plain = rollout(scene)
    with trace.recording() as rec:
        recorded = rollout(scene)
    assert_equal(plain, recorded)
    per_step = {"rollout.obs": STEPS + 1, "policy.act": STEPS + 1,
                "rollout.store": STEPS + 1, "env.step": STEPS,
                "sim.traffic": STEPS}
    assert rec.calls() == per_step
    _, spans, _ = profiled(lambda: rollout(scene), tmp_path)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert {k: len(v) for k, v in by_name.items()} == per_step
    for t in by_name["sim.traffic"]:
        assert sum(inside(t, s) for s in by_name["env.step"]) == 1


def test_update_spans_hold_its_work(scene, tmp_path):
    ro = rollout(scene, n_steps=4)[3]

    def flat(x):
        return x[:-1].flatten(0, 1)

    expert = ExpertBuffer(render=map_state(flat, ro.render),
                          metrics=flat(ro.metrics), obs=flat(ro.obs),
                          actions=ro.actions.reshape(-1, 2))
    learner = WDGAILLearner(scene, ENV, MODEL, TCFG, expert)
    state = learner.init_state()
    (_, metrics), spans, ops = profiled(lambda: learner.update(state),
                                        tmp_path)
    assert all(torch.isfinite(torch.as_tensor(v)).all()
               for v in metrics.values())
    learner_spans = sorted((e for e in spans
                            if e["name"].startswith("learner.")),
                           key=lambda e: e["ts"])
    assert [e["name"] for e in learner_spans] == LEARNER_SPANS
    ops.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    top, end = [], {}
    for e in ops:
        if e["ts"] >= end.get(e["tid"], -1.0):
            top.append(e)
            end[e["tid"]] = e["ts"] + e["dur"]
    outside = {e["name"] for e in top
               if not any(inside(e, s) for s in learner_spans)}
    last = learner_spans[-1]
    assert outside <= AFTER_PPO, outside - AFTER_PPO
    assert all(e["ts"] >= last["ts"] + last["dur"] for e in top
               if not any(inside(e, s) for s in learner_spans))
