"""One short run of each cell on the card, as the driver runs it: exit 0
and a correct result line.  Skips without a card; on the card:
``python -m pytest portbench/tests/test_portbench_card.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from pbtest import ROOT

from portbench import registry

pytestmark = pytest.mark.needs_cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark(
    ROOT)["workloads"]])
def test_cell_runs_on_the_card(card, cell, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "4000000007", "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
