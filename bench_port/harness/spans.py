"""The program's spans in a profiled update or chunk, and the work that
each holds: a tool beside the benchmark, which prints no result line.

    python3 -m bench_port.harness.spans --workload <cell> --seed <n> \\
        [--pairs 3] [--out spans.json]

runs the cell's set-up, then one more update or chunk under
``torch.profiler`` and puts its work down to the program's spans
(``gail_carla_tpu_torch/utils/trace.py``: the ``user_annotation`` events
of the Chrome trace). A rollout cell then runs ``--pairs`` pairs of
chunks, one untraced and one under the program's recorder
(``recording()``, no profiler), for each span's host time and the
recorder's cost. It prints the tables on standard error and writes them
to ``--out`` as JSON.

The rules (``attribute``):

- a device event (kernel, copy, set) belongs to the innermost span whose
  host interval holds its launch, on any thread: backward kernels are
  launched from autograd's worker thread while the main thread waits
  inside the span;
- each idle interval of the device (between the union of its intervals,
  as ``traced.read_trace`` finds them) belongs to the innermost span at
  its middle;
- the top-level ``cpu_op`` events, those inside no other on their thread,
  belong to the innermost span that holds their start;
- each time the host waited for the device (a ``cuda*Synchronize`` call,
  or a device-to-host copy with no such call after it) and each CUDA
  runtime or driver call (its host time: a launch waits in its call while
  the device's launch queue is full) belongs to the innermost span that
  holds its start.

A span's figures hold its child spans'. ``ANY`` sums what lies in some
span, ``NONE`` what lies in none."""
from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import json
import math
import os
import sys
import tempfile
import time

from bench_port.harness.driver import say, sync
from bench_port.harness.traced import DEVICE_CATS, union

ANY, NONE = "any span", "no span"
FIELDS = ("calls", "dev_ms", "idle_ms", "idle_no_op_ms", "ops", "syncs",
          "runtime_ms")
NO_OP = "host outside any op"       # a gap's name where no host op runs
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def read(events) -> dict:
    """What ``attribute`` needs of a Chrome trace's events, in the trace's
    microseconds: ``spans`` [(name, ts, dur, tid)]; ``device`` [(launch ts
    or None, dur)] of each device event, its launch found through
    ``args.correlation``; ``cpu_top`` the starts of the top-level
    ``cpu_op`` events; ``syncs`` the times the host waited for the
    device; ``runtime`` [(ts, dur)] of each runtime and driver call;
    ``gaps`` [(start, end, name of the innermost host op at the middle)]
    of the device's idle intervals."""
    dev, cpu, ann, runtime = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat == "cpu_op":
            cpu.append(e)
        elif cat == "user_annotation":
            ann.append(e)
        elif cat in RUNTIME_CATS:
            runtime.append(e)
    launch = {e["args"]["correlation"]: e for e in runtime
              if "correlation" in e.get("args", {})}
    device = []
    for e in dev:
        r = launch.get(e.get("args", {}).get("correlation"))
        device.append((None if r is None else r["ts"], e["dur"]))
    return {"spans": [(e["name"], e["ts"], e["dur"], e.get("tid"))
                      for e in ann],
            "device": device, "cpu_top": top_level(cpu),
            "syncs": syncs(dev, runtime, launch),
            "runtime": [(e["ts"], e["dur"]) for e in runtime],
            "gaps": gaps(dev, cpu)}


def top_level(cpu) -> list:
    """Starts of the ``cpu_op`` events inside no other on their thread."""
    out, end = [], {}
    for e in sorted(cpu, key=lambda e: (e.get("tid"), e["ts"], -e["dur"])):
        if e["ts"] >= end.get(e.get("tid"), -math.inf):
            out.append(e["ts"])
            end[e.get("tid")] = e["ts"] + e["dur"]
    return out


def syncs(dev, runtime, launch) -> list:
    """Times at which the host waited for the device: each
    ``SYNC_CALLS`` call, and the launch of each device-to-host copy whose
    next runtime call on its thread is not one of them (a blocking copy
    launches its copy and then synchronises: one sync)."""
    by_tid = collections.defaultdict(list)
    for e in runtime:
        by_tid[e.get("tid")].append((e["ts"], e["name"]))
    for calls in by_tid.values():
        calls.sort()
    out = [e["ts"] for e in runtime if e["name"] in SYNC_CALLS]
    for e in dev:
        r = launch.get(e.get("args", {}).get("correlation"))
        if r is None or e.get("cat") != "gpu_memcpy" or "DtoH" not in e[
                "name"]:
            continue
        calls = by_tid[r.get("tid")]
        k = bisect.bisect_right(calls, (r["ts"], r["name"]))
        if k >= len(calls) or calls[k][1] not in SYNC_CALLS:
            out.append(r["ts"])
    return sorted(out)


def gaps(dev, cpu) -> list:
    """The device's idle intervals over the host's ops and the device's
    work, each named by the innermost host op at its middle."""
    busy = union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    if not cpu:
        return []
    lo = min(e["ts"] for e in cpu)
    hi = max([e["ts"] + e["dur"] for e in cpu] + [b for _, b in busy])
    cpu = sorted(cpu, key=lambda e: e["ts"])
    starts = [e["ts"] for e in cpu]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, name, best = (a + b) / 2, NO_OP, None
        k = bisect.bisect_right(starts, mid)
        for e in cpu[max(0, k - 400):k]:    # as traced.read_trace looks
            if e["ts"] + e["dur"] >= mid and (best is None or
                                              e["dur"] < best):
                name, best = e["name"], e["dur"]
        out.append((a, b, name))
    return out


class SpanIndex:
    """The innermost span at any time, and the names of a span and of
    every span that holds it."""

    def __init__(self, spans):
        # by start, the longer first: of the spans holding a time, the
        # last in this order is the innermost
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.names = []
        for i, (name, ts, dur, _) in enumerate(self.spans):
            self.names.append({name} | {
                n for n, t, d, _ in self.spans[:i] if t + d >= ts + dur})
        self.edges = sorted({x for _, ts, dur, _ in self.spans
                             for x in (ts, ts + dur)})
        self.owner, active, k = [], [], 0
        for a, b in zip(self.edges, self.edges[1:]):
            mid = (a + b) / 2
            while k < len(self.spans) and self.spans[k][1] <= mid:
                active.append(k)
                k += 1
            active = [i for i in active
                      if self.spans[i][1] + self.spans[i][2] > mid]
            self.owner.append(active[-1] if active else None)

    def names_at(self, t):
        """The names of the spans holding ``t`` (``None``: no span)."""
        k = bisect.bisect_right(self.edges, t) - 1
        i = self.owner[k] if 0 <= k < len(self.owner) else None
        return None if i is None else self.names[i]


def attribute(trace: dict) -> dict:
    """{span name, ``ANY`` or ``NONE``: {field: value}} over ``FIELDS``
    (``dev_ms`` summed durations, ``idle_no_op_ms`` the part of
    ``idle_ms`` whose middle no host op holds, ``runtime_ms`` the host's
    time in runtime calls) from what ``read`` keeps; {} where the trace
    holds no span, as a program without spans gives."""
    if not trace.get("spans"):
        return {}
    idx = SpanIndex(trace["spans"])
    out = collections.defaultdict(
        lambda: {f: 0.0 if f.endswith("_ms") else 0 for f in FIELDS})

    def add(t, field, value):
        names = None if t is None else idx.names_at(t)
        for name in (NONE,) if names is None else names | {ANY}:
            out[name][field] += value

    for name, *_ in idx.spans:
        out[name]["calls"] += 1
    for launch, dur in trace["device"]:
        add(launch, "dev_ms", dur * 1e-3)
    for a, b, host in trace["gaps"]:
        add((a + b) / 2, "idle_ms", (b - a) * 1e-3)
        if host == NO_OP:
            add((a + b) / 2, "idle_no_op_ms", (b - a) * 1e-3)
    for t in trace["cpu_top"]:
        add(t, "ops", 1)
    for t in trace["syncs"]:
        add(t, "syncs", 1)
    for t, dur in trace["runtime"]:
        add(t, "runtime_ms", dur * 1e-3)
    return dict(out)


def share(spans: dict, field: str):
    """The share (%) of ``field`` that lies inside some span."""
    inside = spans.get(ANY, {}).get(field, 0)
    total = inside + spans.get(NONE, {}).get(field, 0)
    return 100.0 * inside / total if total else None


def report(spans: dict) -> str:
    """One line per span."""
    rows = [f"{'span':<20}" + "".join(f"{f:>14}" for f in FIELDS)]
    for name in sorted(spans):
        v = spans[name]
        rows.append(f"{name:<20}" + "".join(
            f"{v[f]:>14.3f}" if isinstance(v[f], float) else f"{v[f]:>14}"
            for f in FIELDS))
    return "\n".join(rows)


def profiled(fn, device):
    """(events, seconds) of one call of ``fn`` under ``torch.profiler``
    (the host's ops alone on a CPU device)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events, wall


def recorded(fn, device):
    """(seconds, {"calls", "host_ms", "self_ms"} by span name) of one call
    of ``fn`` under the program's recorder; the table is None for a
    program without it."""
    try:
        from gail_carla_tpu_torch.utils.trace import recording
    except ImportError:
        return timed(fn, device), None
    sync(device)
    t0 = time.perf_counter()
    with recording() as rec:
        fn()
        sync(device)
    return time.perf_counter() - t0, {"calls": rec.calls(),
                                      "host_ms": rec.host_ms(),
                                      "self_ms": rec.self_ms()}


def timed(fn, device) -> float:
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def work(cell, mod, su, seed: int):
    """A function that runs the cell's next update or chunk on ``su``
    (``mod``: the cell's entry module)."""
    if cell.workload["entry"] == "train":
        from bench_port.harness import feed as feed_mod

        n = [mod.FOLLOWED]

        def one_update():
            n[0] += 1
            f = feed_mod.train_feed(su.fscene, su.fcfg, su.ftcfg,
                                    su.learner.expert.size, n[0], seed)
            su.state, _ = su.learner.update(su.state, mod.update_draws(f))
        return one_update
    n = [mod.WARM_CHUNKS - 1]

    def one_chunk():
        n[0] += 1
        mod.run_chunk(cell, su, seed, n[0])
    return one_chunk


def run(cell, seed: int, device, pairs: int) -> dict:
    """The cell's set-up, one untraced and one profiled update or chunk,
    and for a rollout ``pairs`` untraced and recorded chunks: the readings,
    with their tables on standard error."""
    mod = importlib.import_module(
        f"bench_port.harness.{cell.workload['entry']}_cell")
    t0 = time.perf_counter()
    su = mod.setup(cell, seed, device)
    sync(device)
    say(f"set-up {time.perf_counter() - t0:.2f} s")
    fn = work(cell, mod, su, seed)
    out = {"workload": cell.name, "seed": seed,
           "untraced_s": timed(fn, device)}
    events, out["profiled_s"] = profiled(fn, device)
    got = attribute(read(events))
    out.update(spans=got, dev_share=share(got, "dev_ms"),
               idle_share=share(got, "idle_ms"),
               no_op_idle_share=share(got, "idle_no_op_ms"))
    say(f"untraced {out['untraced_s']:.4f} s, profiled "
        f"{out['profiled_s']:.4f} s; inside spans: device "
        f"{out['dev_share']}%, idle {out['idle_share']}%, idle outside "
        f"any op {out['no_op_idle_share']}%\n" + report(got))
    if cell.workload["entry"] != "rollout":
        return out
    out["pairs"] = []
    for _ in range(pairs):
        plain = timed(fn, device)
        rec_s, table = recorded(fn, device)
        out["pairs"].append({"untraced_s": plain, "recorded_s": rec_s,
                             "recorded": table})
        say(f"chunk untraced {plain:.4f} s, recorded {rec_s:.4f} s")
    if out["pairs"] and out["pairs"][-1]["recorded"]:
        t = out["pairs"][-1]["recorded"]
        say("recorded chunk: span, calls, host ms, self ms\n" + "\n".join(
            f"{k:<20}{t['calls'][k]:>6}{t['host_ms'][k]:>12.3f}"
            f"{t['self_ms'][k]:>12.3f}" for k in sorted(t["calls"])))
    return out


def main(argv=None) -> int:
    import torch

    from bench_port.harness.main import cache_env
    from bench_port.harness.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3,
                   help="rollout: untraced and recorded chunks, alternating")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    cache_env()
    if not torch.cuda.is_available():
        say("no CUDA device")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run(cell, args.seed, device, args.pairs)
    out["device"] = torch.cuda.get_device_name(device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
