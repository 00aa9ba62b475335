"""The cell on the card (`-m cuda`; skips without one): a short run of the
command is correct, and the control at the cell's size fails the
comparison on a seed."""
import json
import subprocess
import sys

import pytest

from port_bench import harness


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_short_run_of_each_cell_is_correct():
    _card()
    for w in harness.benchmark()["workloads"]:
        p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", w["name"],
                            "--seed", "2718281828459", "--seconds", "5", "--trace", "1"],
                           cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu" and 0 < line["device"]["busy_s"]


@pytest.mark.cuda
def test_the_control_fails_at_the_cell_size():
    _card()
    from port_bench.calibrate import readings
    cell, _ = harness.load_cell("tenant-ppo.e4096")
    rows = {r["side"]: r for r in readings("tenant-ppo.e4096", [31415926535], {31415926535},
                                           witness=False)}
    limits = cell["limits"]
    assert all(rows["program"][k] <= limits[k] for k in limits)
    for side in ("control", "half_batch", "altered"):
        assert any(rows[side][k] > limits[k] for k in limits), side
