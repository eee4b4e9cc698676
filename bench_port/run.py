"""The benchmark of gail_carla_tpu_torch on NVIDIA GPUs: one cell per call.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs the cell named in BENCHMARK.json on the card of the machine it is
started on, and prints one JSON line last on stdout (``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
``breakdown``). ``--control 1`` runs the cell's control instead of its
check: the reference in the next lower precision in the program's place,
whose readings are the upper ends of the limits (bench_port/README.md).
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from bench_port.harness.main import main

    sys.exit(main(t_start=T_START))
