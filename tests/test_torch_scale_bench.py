"""The full-pipeline scale bench, ``tools/wdgail_scale_bench.py``, against
the JAX tool: the same CLI (the port adds ``--device``), the same
configurations from the same argv, and one whole run on the CPU that
prints the JAX tool's phase lines and final record keys.

The JAX tool imports JAX inside ``main`` only, after parsing its argv,
so its parser is read by stopping ``main`` at ``parse_args``; its
configurations are what its ``main`` passes to the set-up functions it
imports, which are replaced by recorders; its phase names and record
keys are read from its source."""
import argparse
import ast
import dataclasses
import functools
import inspect
import json
import types

import numpy as np
import pytest

from gail_carla_tpu.tools import wdgail_scale_bench as jax_tool
from gail_carla_tpu_torch import config as port_config
from gail_carla_tpu_torch.tools import wdgail_scale_bench as port_tool
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

ARGVS = (
    [],
    ["--n-envs", "1024", "--obs-mode", "bev", "--steps-per-env", "8",
     "--ppo-epoch", "2", "--mb", "2048", "--gail-batch", "1024",
     "--updates", "1", "--demo-steps", "900", "--phases",
     "--no-store-obs"],
    ["--obs-mode", "state", "--town", "Town01"],
)


class _Parsed(Exception):
    """Raised in place of returning from ``parse_args``."""


def _jax_parser(argv, monkeypatch):
    """(parser, namespace) of the JAX tool's ``main(argv)``, which is
    stopped before it imports JAX."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(self, parse(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as got:
            jax_tool.main(argv)
    return got.value.args


def _port_parser(argv, monkeypatch):
    parse = argparse.ArgumentParser.parse_args

    def keep(self, args=None, namespace=None):
        keep.parser = self
        return parse(self, args, namespace)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", keep)
        ns = port_tool.parse_args(argv)
    return keep.parser, ns


def _actions(parser):
    return {a.dest: (a.option_strings, a.default, a.choices, a.type,
                     a.nargs, a.const, a.help)
            for a in parser._actions}


@pytest.mark.parametrize("argv", ARGVS, ids=("defaults", "set", "town"))
def test_cli_matches_jax(argv, monkeypatch):
    jax_p, jax_ns = _jax_parser(argv, monkeypatch)
    port_p, port_ns = _port_parser(argv, monkeypatch)
    port_actions = _actions(port_p)
    assert port_actions.pop("device")[1] == "cuda"
    assert port_actions == _actions(jax_p)
    port_vars = vars(port_ns)
    assert port_vars.pop("device") == "cuda"
    assert port_vars == vars(jax_ns)


class _Built(Exception):
    """Raised in place of building the JAX tool's learner."""


def _jax_setup(argv, monkeypatch):
    """What the JAX tool's ``main(argv)`` passes to ``make_scene``,
    ``generate_demos``, ``build_expert_buffer`` and ``WDGAILLearner``, as
    {name: (args, kwargs)}: the first three are replaced by recorders and
    the learner raises, so ``main`` builds no scene and runs no demo."""
    from gail_carla_tpu import train as jax_train
    from gail_carla_tpu.algo import buffers, expert, learner

    calls = {}

    def recorder(name, out):
        def record(*args, **kwargs):
            calls[name] = (args, kwargs)
            return out
        return record

    def stop(*args, **kwargs):
        calls["learner"] = (args, kwargs)
        raise _Built

    with monkeypatch.context() as m:
        m.setattr(jax_train, "make_scene", recorder("scene", "scene"))
        m.setattr(expert, "generate_demos", recorder("demos", "demos"))
        m.setattr(buffers, "build_expert_buffer", recorder(
            "expert", types.SimpleNamespace(size=0)))
        m.setattr(learner, "WDGAILLearner", stop)
        with pytest.raises(_Built):
            jax_tool.main(argv)
    return calls


@pytest.mark.parametrize("argv", ARGVS, ids=("defaults", "set", "town"))
def test_configs_match_jax(argv, monkeypatch):
    calls = _jax_setup(argv, monkeypatch)
    args = port_tool.parse_args(argv)
    scene_kwargs, env_cfg, tcfg, demo_cfg = port_tool.make_configs(args)
    assert calls["scene"] == ((scene_kwargs,), {})
    (scene, j_env, j_model, j_tcfg, j_expert), kwargs = calls["learner"]
    assert (scene, j_expert.size) == ("scene", 0)
    assert kwargs == {"store_obs": not args.no_store_obs}
    for got, want in ((env_cfg, j_env), (tcfg, j_tcfg),
                      (port_config.ModelConfig(), j_model)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tcfg.steps_per_env == j_tcfg.steps_per_env == args.steps_per_env
    (scene, j_demo, _, routes, n_steps), kwargs = calls["demos"]
    assert dataclasses.asdict(demo_cfg) == dataclasses.asdict(j_demo)
    assert (scene, list(np.asarray(routes)), n_steps, kwargs) == (
        "scene", list(tcfg.routes), args.demo_steps, {"obey_signals": True})
    (scene, j_env, demos), kwargs = calls["expert"]
    assert dataclasses.asdict(env_cfg) == dataclasses.asdict(j_env)
    assert (scene, demos, kwargs) == (
        "scene", "demos", {"max_size": port_tool.EXPERT_MAX_ROWS})


def _jax_main_source():
    return ast.parse(inspect.getsource(jax_tool))


def _jax_record_keys():
    """The keys of the dict the JAX tool's ``main`` prints last."""
    for node in ast.walk(_jax_main_source()):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps record in the JAX tool")


def _jax_phase_names():
    """The names the JAX tool's ``_time_phases`` passes to ``timeit``."""
    return [node.args[0].value for node in ast.walk(_jax_main_source())
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "timeit"]


# a run cut to the CPU, where the plain renderer takes milliseconds per
# frame: a 2 x 2 grid town of 60 m blocks, whose nine training routes all
# end their first demo episode by step 240 (the earliest near step 170),
# 32 px, a small float32 model, and an expert buffer of EXPERT_ROWS rows
# (one validation chunk of 256 re-rendered rollout rows per validation)
SMALL_SCENE = dict(n_routes=10, nx=2, ny=2, block=60.0, min_length=20.0)
SMALL_ENV = dict(bev_width=32, pixels_ev_to_bottom=8)
SMALL_MODEL = port_config.ModelConfig(
    conv_channels=(8, 16), hidden_size=64, head_size=32, disc_hidden=32,
    dtype="float32")
EXPERT_ROWS = 64
RUN_ARGV = ["--device", "cpu", "--n-envs", "2", "--steps-per-env", "4",
            "--mb", "4", "--gail-batch", "4", "--ppo-epoch", "1",
            "--demo-steps", "200", "--updates", "1", "--phases"]


@pytest.mark.parametrize("extra", (["--obs-mode", "bev6"],
                                   ["--obs-mode", "bev", "--no-store-obs"]),
                         ids=("bev6", "bev-rerender"))
def test_one_run_on_the_cpu(extra, monkeypatch, capsys):
    monkeypatch.setattr(port_tool, "GRID_SCENE", SMALL_SCENE)
    monkeypatch.setattr(port_tool, "EnvConfig", functools.partial(
        port_config.EnvConfig, **SMALL_ENV))
    monkeypatch.setattr(port_tool, "ModelConfig", lambda: SMALL_MODEL)
    monkeypatch.setattr(port_tool, "EXPERT_MAX_ROWS", EXPERT_ROWS)
    record = port_tool.main(RUN_ARGV + extra)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == record
    assert list(last) == _jax_record_keys()
    assert last["metric"] == "wdgail_full_pipeline_steps_per_sec"
    assert last["obs_mode"] == extra[1]
    assert last["n_envs"] == 2 and last["steps_per_update"] == 8
    assert last["value"] > 0 and last["sec_per_update"] > 0
    lines = err.splitlines()
    names = _jax_phase_names()
    assert names == ["rollout", "disc epoch", "relabel", "gae", "ppo"]
    for name in names:
        assert sum(ln.startswith(f"phase {name}: ") and ln.endswith(" ms")
                   for ln in lines) == 1, (name, lines)
    assert any(ln.startswith("phase total ") for ln in lines)
    assert any(ln.startswith("first update: ") for ln in lines)
    rows = [int(ln.split(": ")[1]) for ln in lines
            if ln.startswith("expert buffer: ")]
    assert rows == [EXPERT_ROWS]
