"""The benchmark's MAPPO cell, tenant-mappo.e4096, on the CPU at a tiny size
(TenAnt's 10 agents, 8 envs, hidden 128 so that use_fused_mlp takes the
sequential schedule on B2/B3's plain versions, 2-step rollouts, 2 epochs):

* the port's MarlRunner agrees with the plain MAPPO reference
  (port_bench/reference/mappo.py) on seeded weights, and so does the
  reference's sound reordering; the reference one precision down, its two
  planted faults and an update that leaves the parameters unchanged each
  read over a limit;
* a whole run of the harness is correct and reports the cell's metrics;
* the reference imports nothing of the port or of the JAX stack;
* B2's and B3's bounds and the cell's call shapes (roofline/fused_mlp.py),
  and the two roofline readers on a made-up trace.

The limits here are the tiny size's: with 16 rows a step, one bf16 rounding
of a block's output that the product's summation order flips moves a
leaf's gradient by up to ~1% (the sound reordering reads as much), and
Adam's first steps turn a gradient near nought into a whole step; the
faults read 0.25 and more.  The card's limits are the cell's file's
(PERF.md).
"""
import ast
import copy
import io
import os
import time

import pytest
import torch

from port_bench import harness
from port_bench.reference import compare
from port_bench.reference.ppo import FAULTS
from port_bench.roofline import fused_mlp
from port_bench.trace import Trace

CELL = "tenant-mappo.e4096"
SEED = 1234567890123
LIMITS = {"loss": 1e-3, "grad": 1e-2, "change": 0.05}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A worker shares its host's cores with the others: small CPU ops run
    fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny():
    cell, config = harness.load_cell(CELL)
    config = copy.deepcopy(config)
    config["train"].update(hidden_size=128, episode_length=2, ppo_epoch=2, use_fused_mlp=True)
    return dict(cell, num_envs=8, trace_iterations=1, limits=LIMITS), config


@pytest.fixture(scope="module")
def sides():
    """The port's readings of one seed, and every side's numbers against
    the reference: the port, the reordered reference, the control, the two
    faults, and the port with its parameters unmoved."""
    cell, config = tiny()
    mod = harness.trainer_module(config)
    dev = torch.device("cpu")
    built = mod.build(config, cell, SEED, dev)
    assert built.trainer.sequential and built.trainer.use_fused
    prog = mod.checked(built, config, 1)
    runner = built.trainer
    ref = mod.reference(config, cell, SEED, dev, 1)
    rows = {"prog": prog, "program": compare.numbers(prog, ref),
            "wrappers left": {"_actor_loss", "_critic_loss"} & set(vars(runner))
            | {"step"} & (set(vars(runner.actor_tx)) | set(vars(runner.critic_tx)))}
    for side in ("reorder", "control", *FAULTS):
        kw = {"fault": side} if side in FAULTS else {"precision": side}
        rows[side] = compare.numbers(mod.reference(config, cell, SEED, dev, 1, **kw), ref)
    frozen = dict(prog, change={k: torch.zeros_like(v) for k, v in prog["change"].items()})
    rows["unchanged"] = compare.numbers(frozen, ref)
    return rows


@pytest.mark.parametrize("side", ["program", "reorder"])
def test_the_port_and_a_sound_reordering_agree_with_the_reference(sides, side):
    assert all(sides[side][k] <= LIMITS[k] for k in compare.NUMBERS), sides[side]


@pytest.mark.parametrize("side", ["control", "half_batch", "altered", "unchanged"])
def test_one_precision_down_and_each_fault_read_over_a_limit(sides, side):
    assert any(sides[side][k] > LIMITS[k] for k in compare.NUMBERS), sides[side]


def test_the_readings_name_every_agents_leaves(sides):
    cell, config = tiny()
    prog = sides["prog"]
    names = set(prog["grad"])
    assert names == set(prog["change"])
    assert len(names) == 10 * len(harness.trainer_module(config).leaf_shapes(config["train"]))
    assert "agent3/actor/MLPBase_0/Dense_1/kernel" in names
    assert "agent9/critic/Dense_0/bias" in names
    # the wrappers that read them are gone after the checked iteration
    assert not sides["wrappers left"]


@pytest.fixture
def jax_preloaded(monkeypatch):
    """tests/conftest.py loads JAX before any test runs: the run's own check
    looks for the modules of the JAX stack that are not loaded yet."""
    before, found = set(harness.banned_modules()), harness.banned_modules
    monkeypatch.setattr(harness, "banned_modules", lambda: sorted(set(found()) - before))


def _run(traced):
    cell, config = tiny()
    return harness.run_cell(CELL, SEED, 0.5, traced, time.perf_counter(), device="cpu",
                            err=io.StringIO(), cell=cell, config=config)


def test_a_whole_run_of_the_cell_is_correct(jax_preloaded):
    line = _run(False)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_a_traced_run_reports_the_host_clock_layers(jax_preloaded):
    line = _run(True)
    assert line["correct"] is True
    # the device trace's metrics have nothing to read on the CPU
    assert set(line["metrics"]) == {"trainer.rollout_ms", "trainer.update_ms", "env.step_ms",
                                    "mfu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", ["reference/mappo.py", "trainers/mappo.py",
                                  "roofline/fused_mlp.py", "metrics/kernel.b2_roofline.py",
                                  "metrics/kernel.b3_roofline.py"])
def test_no_module_of_the_jax_stack_and_a_reference_without_the_port(path):
    names = set(_imports(os.path.join(harness.HERE, path)))
    assert not names & {"jax", "jaxlib", "flax", "massive_marl_tpu"}
    if path.startswith("reference/"):
        assert "massive_marl_tpu_torch" not in names


# ------------------------------------------------------------------ roofline
TRAIN = {"hidden_size": 512, "layer_N": 2, "episode_length": 8, "ppo_epoch": 5,
         "num_mini_batch": 1}


@pytest.mark.parametrize("kind, ms, by", [("fwd", 0.0302, "bytes"), ("bwd", 0.0413, "operations")])
def test_the_bound_of_one_512_wide_block_on_32768_rows(kind, ms, by):
    s, what = fused_mlp.bound_s(fused_mlp.Call(kind, 1, 32768, 512, 512, True))
    assert round(1e3 * s, 4) == ms and what == by


def test_a_backward_that_stores_no_input_gradient_writes_fewer_bytes():
    with_dx = fused_mlp.Call("bwd", 1, 32768, 46, 512, True)
    assert fused_mlp.bound_s(with_dx._replace(need_dx=False))[0] <= fused_mlp.bound_s(with_dx)[0]


def test_the_cells_update_makes_300_b2_and_300_b3_calls():
    calls = fused_mlp.mappo_calls(TRAIN, 4096)
    fwd = [c for c in calls if c.kind == "fwd"]
    bwd = [c for c in calls if c.kind == "bwd"]
    assert len(fwd) == len(bwd) == 300
    assert {c.B for c in calls} == {32768} and {c.N for c in calls} == {1}
    # per agent and epoch: the actor's 46-wide input, the critic's 388-wide
    assert [c.Din for c in fwd[:6]] == [46, 512, 512, 388, 512, 512]
    assert sum(not c.need_dx for c in bwd) == 100


@pytest.mark.parametrize("metric", ["kernel.b2_roofline", "kernel.b3_roofline"])
def test_the_roofline_readers(metric):
    cell, config = harness.load_cell(CELL)
    calls = 300 * 2   # two profiled iterations
    kernels = {"void dense_fwd_wgmma_kernel<512>(...)": (calls, 0.060),
               "void ln_bwd_rows_wgmma_kernel<512>(...)": (calls, 0.070),
               "dw_wgmma_kernel": (calls, 0.020), "reduce_dw_kernel": (calls, 0.004),
               "colsum_partial_kernel": (calls, 0.003), "colsum_final_kernel": (calls, 0.003)}
    tr = Trace(iterations=2, window_s=1.0, busy_s=0.2, launches=5 * calls, kernels=kernels)
    r = harness.Readings(cell=cell, config=config, work={}, iter_s=[0.5], trace=tr)
    fwd = [c for c in fused_mlp.mappo_calls(config["train"], 4096) if c.kind == "fwd"]
    bwd = [c for c in fused_mlp.mappo_calls(config["train"], 4096) if c.kind == "bwd"]
    bound = sum(fused_mlp.bound_s(c)[0] for c in (fwd if metric.endswith("b2_roofline") else bwd))
    device_s = 0.060 if metric.endswith("b2_roofline") else 0.100
    assert harness.reader(metric).read(r) == pytest.approx(100.0 * 2 * bound / device_s)
    # nothing to read without a trace, or where the calls are not the update's
    assert harness.reader(metric).read(harness.Readings(cell, config, {}, [0.5])) is None
    short = {k: (c - 1, s) for k, (c, s) in kernels.items()}
    tr_short = Trace(iterations=2, window_s=1.0, busy_s=0.2, launches=0, kernels=short)
    assert harness.reader(metric).read(harness.Readings(cell, config, {}, [0.5],
                                                        trace=tr_short)) is None
