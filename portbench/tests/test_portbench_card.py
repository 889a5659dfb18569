"""Each cell once through the command, on the card (skipped without one):
its result line is correct and reports the cell's end-to-end metrics."""
import json
import subprocess
import sys

import pytest

from portbench import harness

MAN = harness.manifest()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", "4242", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=harness.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    want = {m["name"] for m in harness.metrics_for(MAN, workload, False)}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu"
