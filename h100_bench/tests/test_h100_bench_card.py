"""Each cell run briefly on the card, as the benchmark's command runs it:
exit code 0, ``correct`` true, every end-to-end metric of the cell, the
device's name. Skips where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from h100_bench import run as R

CELLS = [w["name"] for w in R.load_json(R.BENCHMARK)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 12345), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=R.HERE.parent, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    run = R.make_run(workload, seed=1, seconds=0, trace=False, device="cpu")
    assert set(result["metrics"]) == {m["name"] for m in
                                      run.metrics_of("end_to_end")}
