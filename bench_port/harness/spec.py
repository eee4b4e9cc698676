"""The cell's description, found by name: its entry in BENCHMARK.json,
its configuration file and its workload file (bench_port/workloads/)."""
from __future__ import annotations

import dataclasses
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict          # bench_port/configs/<config>.json
    workload: dict        # bench_port/workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json metrics this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> CellSpec:
    """Raises KeyError for a cell that BENCHMARK.json does not name and
    OSError where its files are missing."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "bench_port", "workloads",
                           name + ".json")) as f:
        workload = json.load(f)
    if workload["config"] != cell["config"]:
        raise ValueError(f"{name}: workload file names config "
                         f"{workload['config']}, BENCHMARK.json "
                         f"{cell['config']}")
    return CellSpec(
        name=name, chips=cell["chips"], config=config, workload=workload,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
