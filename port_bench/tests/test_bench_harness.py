"""A whole run of the harness on the CPU at a tiny size (the port's plain
paths), skipping only the command's look for a card: the reference agrees,
and with the timed path broken underneath `correct` comes out false once
for each fault a training cell can have."""
import io
import math
import time

import pytest
import torch

from port_bench import harness
from port_bench.calibrate import readings
from port_bench.reference import compare

from .conftest import tiny

LIMITS = {"loss": 1e-3, "grad": 1e-3, "change": 1e-3}


def _run(cell, config, traced=False):
    cell = dict(cell, limits=LIMITS)
    return harness.run_cell("tenant-ppo.e4096", 1234567890123, 0.5, traced, time.perf_counter(),
                            device="cpu", err=io.StringIO(), cell=cell, config=config)


def test_a_sound_run_is_correct_and_reports_its_metrics(tiny_cell):
    line = _run(*tiny_cell)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1 and line["attempted"] == line["window"]["iterations"]
    assert set(line["metrics"]) == {"env_steps_per_s", "iter_ms.p90", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_a_traced_run_reports_the_host_clock_layers(tiny_cell):
    line = _run(*tiny_cell, traced=True)
    assert line["correct"] is True
    # the device trace's metrics have nothing to read on the CPU, and no PPO
    # cell lists env.step_ms (its wrapper on the env refuses the rollout graph)
    assert set(line["metrics"]) == {"trainer.rollout_ms", "trainer.update_ms", "mfu"}


@pytest.mark.parametrize("traced", [False, True])
def test_the_program_spans_are_off_after_a_run_and_never_on_untraced(monkeypatch, tiny_cell,
                                                                     traced):
    from massive_marl_tpu_torch.utils import profiling
    seen = []
    monkeypatch.setattr(profiling, "enable", lambda: seen.append(True) or
                        setattr(profiling.RECORDER, "on", True))
    line = _run(*tiny_cell, traced=traced)
    assert line["correct"] is True
    assert profiling.RECORDER.on is False
    assert bool(seen) is traced


def test_a_traced_run_installs_no_wrapper_on_the_env(monkeypatch, tiny_cell):
    """A traced PPO run leaves the env's step_batch alone, so on the card
    the rollout graph takes the rollout as in the untraced window."""
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    step, wrapped = TenAntEnv.step_batch, []

    def spied(self, *args, **kw):
        wrapped.append("step_batch" in vars(self))
        return step(self, *args, **kw)
    monkeypatch.setattr(TenAntEnv, "step_batch", spied)
    _run(*tiny_cell, traced=True)
    assert wrapped and not any(wrapped)


def _break(monkeypatch, fault):
    from massive_marl_tpu_torch.algos.rl.ppo import PPO
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    if fault == "state unchanged":
        monkeypatch.setattr(PPO, "_step", lambda self, grads, lr: None)
    elif fault == "half the batch":
        loss = PPO._loss
        monkeypatch.setattr(PPO, "_loss", lambda self, batch, old, n=None: loss(
            self, {k: v[:v.shape[0] // 2] for k, v in batch.items()}, old, n))
    elif fault == "answer altered":
        step = TenAntEnv.step_batch

        def altered(self, state, actions):
            out = step(self, state, actions)
            out.reward = out.reward.clone()
            out.reward[::8] = 0.0
            return out
        monkeypatch.setattr(TenAntEnv, "step_batch", altered)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch", "answer altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, tiny_cell, fault):
    _break(monkeypatch, fault)
    line = _run(*tiny_cell)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_control_and_the_planted_faults_fail_the_comparison():
    """The control (the reference one precision down in the port's place)
    and the reference's planted faults fail the comparison, the port and the
    sound reordered witness pass it, at a size a test run holds; the
    cell-size readings are PERF.md's."""
    cell, config = tiny(hidden=(64, 64), num_envs=16)
    rows = list(readings("tiny", [7], {7}, device="cpu", cell=cell, config=config))
    sides = {r["side"]: r for r in rows}
    assert set(sides) == {"program", "reorder", "control", "half_batch", "altered"}
    for side in ("program", "reorder"):
        assert all(sides[side][k] <= LIMITS[k] for k in compare.NUMBERS), side
    for side in ("control", "half_batch", "altered"):
        assert any(sides[side][k] > LIMITS[k] for k in compare.NUMBERS), side


def test_compare_reads_an_unmoved_state_as_one_and_a_perturbed_one_above_zero():
    g = torch.Generator().manual_seed(0)
    ref = {"loss": 2.0,
           "grad": {f"l{i}": torch.randn(10, generator=g) for i in range(5)},
           "change": {f"l{i}": torch.randn(10, generator=g) for i in range(5)}}
    assert compare.numbers(ref, ref) == {"loss": 0.0, "grad": 0.0, "change": 0.0}
    frozen = dict(ref, change={k: torch.zeros_like(v) for k, v in ref["change"].items()})
    assert compare.numbers(frozen, ref)["change"] == 1.0
    assert compare.numbers(dict(ref, loss=math.nan), ref)["loss"] == math.inf
    assert compare.numbers(dict(ref, loss=2.02), ref)["loss"] == pytest.approx(0.01)
    double = dict(ref, grad={k: 2 * v for k, v in ref["grad"].items()})
    assert compare.numbers(double, ref)["grad"] == pytest.approx(1.0)
    # a leaf whose reference gradient is nought to rounding is left out of the change
    tiny = dict(ref, grad=dict(ref["grad"], l0=ref["grad"]["l0"] * 1e-6))
    wild = dict(tiny, change=dict(ref["change"], l0=ref["change"]["l0"] * 5))
    assert compare.numbers(wild, tiny)["change"] == 0.0
