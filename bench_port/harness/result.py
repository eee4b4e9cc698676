"""The run's last line, its checks on standard error, the device's name
and peak, and the guard against JAX in the process."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys

from bench_port.harness.spec import BENCH_DIR

BANNED = ("jax", "jaxlib", "flax", "gail_carla_tpu")


def banned_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``gail_carla_tpu_torch`` is the program)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def device_info(device, count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def load_reader(metric: str):
    """The ``read(ctx)`` of bench_port/metrics/<metric>.py."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell, ctx: dict) -> dict:
    """Every per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.per_layer:
        v = load_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict):
    """(correct, [[name, value, limit]]) over the numbers the cell's
    ``limits`` name: each at or under its limit and finite, and at least
    one. A number the cell does not compare is printed as a reading."""
    rows, ok = [], True
    for name, value in numbers.items():
        if name not in limits:
            print(f"reading {name}: {value!r}", file=sys.stderr)
            continue
        lim = limits[name]
        ok &= value is not None and math.isfinite(value) and value <= lim
        rows.append([name, value, lim])
    return ok and bool(rows), rows


def emit(correct, attempted, failed, metrics, device, checks,
         breakdown=None) -> None:
    for name, value, lim in checks:
        print(f"check {name}: {value!r} limit {lim!r}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": lim}
                      for name, value, lim in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
