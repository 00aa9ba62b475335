"""The port's utils/profiling.py and utils/logger/ against the JAX package's.

* PhaseTimer: the same summary string and fps from the same totals and
  counts, a phase with a sync tensor counted; trace() writes a Chrome
  trace; measure_rtt and time_scanned give positive times on the CPU;
  assert_finite names the leaf as JAX's does, over a dict and a module;
* tools: convert_tfevents_to_csv and merge_runs on the event files and
  metrics.csv the port's Writer made, the rows equal to what the JAX
  read_tfevents (tensorboard's reader) reads and the merged csv equal to
  the JAX merge_runs' bytes; the port's reader needs no tensorboard;
* plotter: smooth equals JAX's at 1e-12; plot_runs writes a PNG.
"""
import csv
import json

import numpy as np
import pytest
import torch

from massive_marl_tpu.utils import profiling as j_prof
from massive_marl_tpu.utils.logger import plotter as j_plot
from massive_marl_tpu.utils.logger import tools as j_tools
from massive_marl_tpu_torch.utils import profiling as p_prof
from massive_marl_tpu_torch.utils.logger import plotter as p_plot
from massive_marl_tpu_torch.utils.logger import tools as p_tools
from massive_marl_tpu_torch.utils.logging import Writer


def test_phase_timer_summary_and_fps_match_jax():
    j, p = j_prof.PhaseTimer(), p_prof.PhaseTimer()
    for t in (j, p):
        t.totals.update(rollout=0.123456, update=2.5, log=0.0)
        t.counts.update(rollout=3, update=2, log=0)
    assert p.summary() == j.summary() == "log=0.0ms rollout=41.2ms update=1250.0ms"
    for name, steps in (("rollout", 4096 * 8), ("update", 7), ("log", 3), ("none", 1)):
        assert p.fps(name, steps) == j.fps(name, steps)
    with p.phase("step", sync=torch.ones(3) * 2):
        pass
    assert p.counts["step"] == 1 and p.totals["step"] > 0


def test_trace_rtt_and_time_scanned(tmp_path):
    with p_prof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    (path,) = tmp_path.glob("trace_*.json")
    assert json.loads(path.read_text())["traceEvents"]
    assert 0 < p_prof.measure_rtt(3, device="cpu") < 1
    per_call = p_prof.time_scanned(lambda c: c * 0.5 + 1.0, torch.ones(8), n=5)
    assert 0 < per_call < 1


def test_assert_finite_names_the_leaf_as_jax():
    tree = {"actor": {"w": np.ones(3, np.float32)}, "critic": {"b": np.array([0.0, np.nan])}}
    with pytest.raises(FloatingPointError) as j:
        j_prof.assert_finite(tree, "params")
    with pytest.raises(FloatingPointError) as p:
        p_prof.assert_finite({k: {kk: torch.from_numpy(v) for kk, v in d.items()}
                              for k, d in tree.items()}, "params")
    assert str(p.value) == str(j.value) == "non-finite values in params['critic']['b']"
    m = torch.nn.Linear(2, 2)
    p_prof.assert_finite(m)
    with torch.no_grad():
        m.bias[1] = float("inf")
    with pytest.raises(FloatingPointError, match=r"model\['bias'\]"):
        p_prof.assert_finite(m, "model")
    p_prof.assert_finite([torch.arange(3), (torch.zeros(2),)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two seed dirs of the port's Writer: metrics.csv and a tfevents file."""
    root = tmp_path_factory.mktemp("logs")
    for seed in (1, 2):
        w = Writer(str(root / f"seed{seed}"))
        for it in range(6):
            w.add_scalar("train/mean_reward", 0.5 * it + seed + 0.1234567, it)
            w.add_scalar("Loss/value_function", 1.0 / (it + seed), it * 10)
        w.close()
    return root


def test_tfevents_to_csv_and_merge_match_jax(runs, tmp_path):
    events = p_tools.find_event_files(str(runs))
    assert events == j_tools.find_event_files(str(runs)) and len(events) == 2
    for ev in events:
        got, ref = p_tools.read_tfevents(ev), j_tools.read_tfevents(ev)
        assert sorted(got) == sorted(ref) == ["Loss/value_function", "train/mean_reward"]
        for tag in ref:
            assert [r[1:] for r in got[tag]] == [r[1:] for r in ref[tag]]
            np.testing.assert_allclose([r[0] for r in got[tag]], [r[0] for r in ref[tag]],
                                       rtol=0, atol=1e-6)
    written = p_tools.convert_tfevents_to_csv(str(runs))
    assert len(written) == 4 and p_tools.convert_tfevents_to_csv(str(runs)) == []
    assert len(p_tools.convert_tfevents_to_csv(str(runs), refresh=True)) == 4
    for path in written:
        with open(path) as f:
            steps = [int(r["step"]) for r in csv.DictReader(f)]
        assert steps == sorted(steps) and len(steps) == 6
    per_seed = sorted(str(p) for p in runs.glob("seed*/train_mean_reward.csv"))
    p_out, j_out = tmp_path / "p.csv", tmp_path / "j.csv"
    p_tools.merge_runs(per_seed, str(p_out))
    j_tools.merge_runs(per_seed, str(j_out))
    assert p_out.read_bytes() == j_out.read_bytes()
    assert p_out.read_text().splitlines()[1].startswith("seed1,")
    for d in ("seed1", "seed2"):
        assert p_tools.read_metrics_csv(str(runs / d / "metrics.csv")) == \
            j_tools.read_metrics_csv(str(runs / d / "metrics.csv"))


@pytest.mark.parametrize("n, radius", [(40, 5), (11, 5), (10, 5), (3, 1), (0, 2)])
def test_smooth_matches_jax(n, radius):
    y = np.random.default_rng(n).normal(0, 3, n)
    np.testing.assert_allclose(p_plot.smooth(y, radius), j_plot.smooth(y, radius),
                               rtol=1e-12, atol=1e-12)


def test_plot_runs_writes_a_png(runs, tmp_path):
    out = p_plot.plot_runs(str(runs), "train/mean_reward", str(tmp_path / "c.png"), radius=1)
    assert out == str(tmp_path / "c.png")
    assert (tmp_path / "c.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
