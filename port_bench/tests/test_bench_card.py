"""The cells on the card (`-m cuda`; skips without one): a short traced run
of each is correct and reads every per-layer metric it lists, a traced PPO
run replays its graphs and reads their device time, and the control at the
cell's size fails the comparison on a seed."""
import io
import json
import subprocess
import sys
import time

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
        # every per-layer metric the cell lists finds something to read
        listed = {m["name"] for m in harness.metrics_of(harness.benchmark(), w["name"],
                                                        "per_layer")}
        assert set(line["metrics"]) == listed, (w["name"], listed - set(line["metrics"]))


@pytest.mark.cuda
def test_a_traced_ppo_run_replays_its_graphs_and_reads_their_device_time(monkeypatch):
    """A traced tenant-ppo run at a small E: its window and its profiled
    iterations replay the rollout's and the update's graphs, as the untraced
    window does, and the replayed kernels count in the span around their
    graph's launch."""
    _card()
    from massive_marl_tpu_torch.utils import profiling
    from port_bench import trace
    from port_bench.trainers import ppo

    build, kept = ppo.build, []
    monkeypatch.setattr(ppo, "build", lambda *a, **k: kept.append(build(*a, **k)) or kept[-1])
    cell, config = harness.load_cell("tenant-ppo.e4096")
    cell = dict(cell, num_envs=512)
    line = harness.run_cell("tenant-ppo.e4096", 1618033988749, 3.0, True, time.perf_counter(),
                            err=io.StringIO(), cell=cell, config=config)
    assert line["correct"] is True, line["checks"]
    assert {"device.rollout_ms", "device.update_ms"} <= set(line["metrics"])
    trainer = kept[0].trainer
    replays = line["window"]["iterations"] + cell["trace_iterations"]
    g = trainer.rollout_graph
    assert (g.eager_rollouts, g.captures, g.replays) == (1, 1, replays)
    u = trainer.update_graph
    assert (u.eager_updates, u.captures, u.replays) == (1, 1, replays)

    profiling.enable()
    try:
        tr = trace.profile_iterations(trainer.train_iter, 1,
                                      (harness.SPAN_PREFIX, profiling.PREFIX))
    finally:
        profiling.disable()
    # a replay runs at least B1's launches of a rollout
    launches, _ = tr.self_spans["rollout.graph"]
    assert launches >= config["train"]["nsteps"] * config["sim"]["substeps"]
    assert tr.self_spans["update.graph"][0] > 0
    phases = tr.span_time("trainer.rollout")[1] + tr.span_time("trainer.update")[1]
    assert phases >= 0.9 * tr.device_s and tr.unattributed_s < 0.05 * tr.device_s


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
