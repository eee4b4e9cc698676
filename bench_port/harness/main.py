"""Argument parsing, the card check and the dispatch to the cell's entry."""
from __future__ import annotations

import argparse
import os
import sys

from bench_port.harness.spec import BENCH_DIR, load_cell

ENTRIES = ("train", "rollout")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="print the control's readings instead of the check")
    return p.parse_args(argv)


def cache_env() -> None:
    """Build and kernel caches of torch and Triton at fixed places inside
    the checkout (the port's nvcc builds go to its own _build/)."""
    base = os.path.join(BENCH_DIR, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv=None, t_start=None) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    entry = cell.workload["entry"]
    if entry not in ENTRIES:
        print(f"unknown entry {entry!r}", file=sys.stderr)
        return 2
    cache_env()
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return run_entry(cell, args, device, t_start)


def run_entry(cell, args, device, t_start=None) -> int:
    """Runs the cell through its entry's module, past the card check."""
    import importlib

    from bench_port.harness.driver import run_cell

    module = importlib.import_module(
        f"bench_port.harness.{cell.workload['entry']}_cell")
    return run_cell(cell, args, device, module, t_start)
