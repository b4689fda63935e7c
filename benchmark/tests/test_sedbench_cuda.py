"""Each cell once on the card, short: the command the driver runs, its
result line, and ``correct``. Skips without the cards a cell asks for.

    python -m pytest benchmark/tests -q --noconftest -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common  # noqa: E402

CELLS = {w["name"]: w["chips"]
         for w in common.load_json(common.ROOT, "BENCHMARK.json")["workloads"]}


@pytest.fixture
def cards(request):
    import torch

    need = CELLS[request.node.callspec.params["workload"]]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        pytest.skip(f"needs {need} CUDA card(s), found {have}")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(cards, workload, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         str(2 ** 31 + 101), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=common.ROOT, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["device"]["platform"] == "gpu"
    assert line["metrics"]
