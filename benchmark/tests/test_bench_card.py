"""Each cell of BENCHMARK.json once on the card, short: a result line with
correct true. Skips without a CUDA device; on the card run
`python -m pytest benchmark/tests -m gpu -q`."""
import json
import subprocess
import sys

import pytest

from benchmark.harness.common import ROOT
from benchmark.tests import tiny


@pytest.mark.gpu
@pytest.mark.parametrize("name", tiny.workloads(tiny=False))
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
