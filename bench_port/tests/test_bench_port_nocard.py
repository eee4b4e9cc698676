"""A measurement run never falls back to the CPU, and a checkout that
holds only the benchmark cannot run."""
import os
import shutil
import subprocess
import sys

from bench_port.harness.spec import ROOT

ARGS = ["--workload", "bev6.train.4096", "--seed", "3000000017",
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "bench_port/run.py"] + ARGS,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    out = run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
