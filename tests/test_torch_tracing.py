"""The program's spans (massive_marl_tpu_torch/utils/profiling.py's
recorder and the spans at the layer boundaries of TenAnt + PPO).

* Off (the default), span() is one shared no-op object: it records
  nothing, allocates nothing and calls no torch function; a spanned
  function is called as it is.
* One small TenAnt + PPO train_iter on the CPU with the recorder on gives
  each span's call count; each span's self time is its total less its
  children's, never below 0, and the self times sum to the roots' totals;
  the parameters after it are bit-identical with the recorder off.  The
  update's spans are the same on a mesh's branch.
* Under torch.profiler each span is one PREFIX-named event per call,
  nested as recorded, which the recorded span's time holds;
  profiling.trace(logdir)'s Chrome trace holds the spans.
"""
import json
import sys
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.parallel.mesh import Mesh
from massive_marl_tpu_torch.utils import profiling

# the layer map: each span's parent span
PARENT = {"trainer.rollout": None, "trainer.policy": "trainer.rollout",
          "env.step": "trainer.rollout", "env.physics": "env.step",
          "env.substep": "env.physics", "env.box_substep": "env.physics",
          "env.finish_step": "env.step", "trainer.update": None,
          "update.forward": "trainer.update", "update.backward": "trainer.update",
          "update.optimizer": "trainer.update"}
T, SUBSTEPS, EPOCHS, MINIBATCHES = 2, 2, 2, 2


def calls(nsteps, substeps, epochs, minibatches):
    """Each span's calls in one PPO iteration."""
    per = {"trainer.rollout": 1, "trainer.update": 1}
    per.update({k: nsteps for k in ("trainer.policy", "env.step", "env.physics",
                                    "env.finish_step")})
    per.update({k: nsteps * substeps for k in ("env.substep", "env.box_substep")})
    per.update({k: epochs * minibatches for k in
                ("update.forward", "update.backward", "update.optimizer")})
    return per


def _ppo(nsteps=T, substeps=SUBSTEPS, epochs=EPOCHS, minibatches=MINIBATCHES, mesh=None):
    env = TenAntEnv({"sim": {"substeps": substeps}}, device="cpu", seed=3)
    ppo = PPO(env, 4, PPOConfig(hidden=(16, 16), nsteps=nsteps, noptepochs=epochs,
                                nminibatches=minibatches),
              seed=1, device="cpu", print_log=False, mesh=mesh)
    ppo.init_state()
    return ppo


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _recorded_iteration(ppo):
    profiling.enable()
    try:
        ppo.train_iter()
    finally:
        profiling.disable()
    return profiling.totals()


@pytest.fixture(scope="module")
def iteration():
    """(span totals of one iteration with the recorder on, its parameters,
    the parameters of the same iteration with the recorder off)."""
    profiling.reset()
    on = _ppo()
    got = _recorded_iteration(on)
    profiling.reset()
    off = _ppo()
    off.train_iter()
    assert profiling.totals() == {}
    return got, list(on.model.parameters()), list(off.model.parameters())


def test_off_span_is_one_shared_object_that_records_nothing():
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a:
        with b:
            pass

    @profiling.spanned("c")
    def f(x, y=1):
        return x + y
    assert f(1, y=2) == 3 and f.__name__ == "f"
    assert profiling.totals() == {}


def test_off_span_allocates_nothing_and_calls_no_torch_function():
    def body():
        for _ in range(1000):
            with profiling.span("x"):
                pass

    body()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        body()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == profiling.__file__ and s.count_diff > 0]
    assert grown == []

    seen = []

    def watch(frame, event, arg):
        if event == "c_call":
            seen.append(getattr(arg, "__module__", None) or "")
        elif event == "call":
            seen.append(frame.f_globals.get("__name__", ""))

    @profiling.spanned("y")
    def g():
        return 1

    sys.setprofile(watch)
    try:
        with profiling.span("x"):
            g()
    finally:
        sys.setprofile(None)
    assert seen and not [m for m in seen if m.startswith("torch")], seen


def test_one_iteration_records_each_span_of_the_layer_map(iteration):
    got, _, _ = iteration
    assert {k: v[0] for k, v in got.items()} == calls(T, SUBSTEPS, EPOCHS, MINIBATCHES)


def test_self_time_is_total_less_children_and_sums_to_the_roots(iteration):
    got, _, _ = iteration
    for name, (_, total, self_s) in got.items():
        children = sum(got[c][1] for c, p in PARENT.items() if p == name)
        assert 0 <= self_s <= total
        assert self_s == pytest.approx(total - children, rel=1e-9, abs=1e-9), name
    roots = sum(got[n][1] for n, p in PARENT.items() if p is None)
    assert sum(v[2] for v in got.values()) == pytest.approx(roots, rel=1e-9)


def test_parameters_are_bit_identical_with_the_recorder_on_and_off(iteration):
    _, on, off = iteration
    for p, q in zip(on, off):
        assert torch.equal(p, q)


def test_the_mesh_branch_records_the_update_spans():
    """A mesh of one data rank takes update_phase's mesh branch (its sum is
    the identity without a process group)."""
    ppo = _ppo(nsteps=1, substeps=1, epochs=1, minibatches=2, mesh=Mesh(1))
    got = _recorded_iteration(ppo)
    assert {k: v[0] for k, v in got.items()} == calls(1, 1, 1, 2)


def test_profiler_events_are_the_spans_nested_as_recorded():
    ppo = _ppo(nsteps=1, substeps=1, epochs=1, minibatches=2)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ppo.train_iter()
    profiling.disable()
    got = profiling.totals()
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(profiling.PREFIX):])
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.PREFIX)]
    assert {n: sum(1 for e in evs if e[2] == n) for n in got} == {n: c for n, (c, _, _) in
                                                                  got.items()}
    assert {e[2] for e in evs} == set(got) == set(PARENT)
    for a, b, name in evs:
        around = [e for e in evs if e[0] <= a and b <= e[1] and e != (a, b, name)]
        inner = max(around, default=None, key=lambda e: e[0])
        assert (inner[2] if inner else None) == PARENT[name], name
    # the recorded time holds the profiler's ranges, within 2 ms a call
    for name, (n, total, _) in got.items():
        traced = sum(b - a for a, b, m in evs if m == name) * 1e-9
        assert traced - 1e-6 <= total <= traced + 2e-3 * n, name


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4) + 1
    assert not profiling.RECORDER.on
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {profiling.PREFIX + "outer", profiling.PREFIX + "inner"} <= names
    assert profiling.totals()["inner"][0] == 1
