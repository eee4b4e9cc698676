"""BENCHMARK.json and the harness's files against the benchmark's rules:
names and units, the metrics each cell reports, the files found by name,
and the last line a run prints."""
import json
import math
import os
import re

import pytest

from bench_port.harness import result as res
from bench_port.harness.spec import BENCH_DIR, ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench_port/run.py"]
    assert bench["paths"] == ["bench_port"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert TEXT.match(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def test_names_and_units(bench):
    groups = [bench["configs"], bench["workloads"],
              bench["end_to_end"] + bench["per_layer"]]
    for g in groups:
        names = [x["name"] for x in g]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for w in bench["workloads"]:
        cell = w["name"]
        mine = [m for m in bench["end_to_end"] if reports(m, cell)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in
                                        bench["workloads"]]):
            assert reports(moved, cell), (m["name"], cell)
        assert not ("roofline" in m["name"] or "mfu" in m["name"]) or (
            m["unit"] == "%")


def test_cells_files_found_by_name(bench):
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.workload["entry"] in ("train", "rollout")
        assert cell.workload["chips"] == w["chips"]
        limits = cell.workload["limits"]
        assert limits and all(isinstance(v, (int, float))
                              for v in limits.values())
    for m in bench["per_layer"]:
        path = os.path.join(BENCH_DIR, "metrics", m["name"] + ".py")
        assert callable(res.load_reader(m["name"])), path


def test_readers_find_nothing_outside_their_entry(bench):
    for m in bench["per_layer"]:
        assert res.load_reader(m["name"])({"entry": "none"}) is None


def test_last_line(capsys):
    res.emit(True, 3, 0, {"x": {"value": 1.5, "unit": "s"}},
             {"platform": "gpu", "kind": "k", "count": 1,
              "memory_peak_bytes": 1},
             [["gap", 0.1, 0.2]])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["checks"] == {"gap": {"value": 0.1, "limit": 0.2}}
    assert out.err.strip().splitlines()[-1] == "check gap: 0.1 limit 0.2"
    res.emit(False, 1, 1, {}, {"platform": "gpu"}, [], breakdown={
        "device_ops": [["k", 0.5]], "idle_gaps": [["h", 0.1]]})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]


def test_judge(capsys):
    assert res.judge({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0})[0]
    assert not res.judge({"a": 0.3}, {"a": 0.2})[0]
    assert not res.judge({"a": math.nan}, {"a": 0.2})[0]
    ok, rows = res.judge({"a": 0.1, "b": 9.0}, {"a": 0.2})
    assert ok and rows == [["a", 0.1, 0.2]]
    assert "reading b: 9.0" in capsys.readouterr().err
    assert not res.judge({"a": 0.1}, {})[0]
    assert not res.judge({}, {})[0]
