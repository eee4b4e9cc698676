"""One run of a cell, whatever its entry: set-up, the window, the traced
readings or the end-to-end metrics, the program freed, the reference's
numbers against the cell's limits, the JAX guard and the last line.

An entry module (``train_cell``, ``rollout_cell``) gives ``RATE`` (its
end-to-end rate), ``UNIT`` (what its window counts), ``setup``,
``window``, ``traced_context``, ``release`` and ``reference_numbers``."""
from __future__ import annotations

import gc
import sys
import time

import torch

from bench_port.harness import result as res


def say(msg: str) -> None:
    """A progress line on stderr (the checks come last)."""
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_gib(device) -> float:
    return (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else 0.0)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_cell(cell, args, device, entry, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    su = entry.setup(cell, args.seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    say(f"set-up {setup_s:.2f} s")
    reset_peak(device)
    done, steps, dt, bad, kept = entry.window(cell, su, args.seed,
                                              args.seconds, device)
    say(f"window {done} {entry.UNIT}, {steps} env-steps in {dt:.3f} s")
    dev_info = (res.device_info(device, 1) if device.type == "cuda"
                else {"platform": "cpu", "kind": "cpu", "count": 1,
                      "memory_peak_bytes": 0})
    metrics, breakdown = {}, None
    if args.trace:
        ctx = entry.traced_context(cell, su, args.seed, device, done, dt)
        metrics = res.read_per_layer(cell, ctx)
        dev_info.update(busy_s=ctx["trace"]["busy_s"],
                        window_s=ctx["trace"]["window_s"])
        breakdown = ctx["trace"]["breakdown"]
    else:
        vals = {"setup_s": setup_s, entry.RATE: steps / dt,
                "peak_mem_gib": dev_info["memory_peak_bytes"] / 2 ** 30}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    entry.release(su)
    free(device)
    t_ref = time.perf_counter()
    reset_peak(device)
    numbers = entry.reference_numbers(cell, su, kept, args.seed, device,
                                      bool(args.control))
    say(f"reference {time.perf_counter() - t_ref:.2f} s, peak "
        f"{peak_gib(device):.2f} GiB")
    correct, checks = res.judge(numbers, cell.workload["limits"])
    found = res.banned_modules()
    if found:
        print(f"modules that the benchmark must not load: {found}",
              file=sys.stderr)
        return 4
    res.emit(correct and bad == 0, done, bad, metrics, dev_info, checks,
             breakdown)
    return 0
