"""One short run of a cell on a card, through the command the driver runs;
skips where no card is visible."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is visible")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tier1-headless",
         "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95",
                                      "peak_mem_gib", "setup_s"}
