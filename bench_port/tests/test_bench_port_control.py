"""The control of each cell, on the card at the cell's own size: the
reference in the next lower precision (fp8 e4m3 convolutions, a bfloat16
simulator state) in the program's place comes out not correct under the
cell's limits. Run on the card with

    python -m pytest --noconftest -m cuda bench_port/tests -q
"""
import json
import os
import subprocess
import sys

import pytest

from bench_port.harness.spec import ROOT

CELLS = ("bev6.train.4096", "bev6.rollout.dense.4096")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", name, "--seed",
         "2718281828459", "--seconds", "6", "--trace", "0", "--control",
         "1"], cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
