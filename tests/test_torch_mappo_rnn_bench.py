"""The benchmark's recurrent MAPPO cell, tenant-mappo-rnn.e4096, on the CPU at
a tiny size (TenAnt's 10 agents, 8 envs, hidden 32, 4-step rollouts, 2
epochs, one substep a step, episodes of 3 steps so that every env ends one
inside the rollout and the GRU's masks act), and the tenant-ppo.e16384 cell's
files:

* the port's RecurrentMarlRunner agrees with the plain rMAPPO reference
  (port_bench/reference/mappo_rnn.py) on seeded weights, and so does the
  reference's sound reordering; the reference one precision down, its two
  planted faults and an update that leaves the parameters unchanged each
  read over a limit;
* a whole run of the harness is correct and reports the cell's metrics;
* the reference and the adapter import nothing of the JAX stack, and the
  reference nothing of the port;
* the GRU's count (roofline/gru.py) against a hand count at H = 512, and the
  float32 GEMM roofline's reader on a made-up trace;
* the program's spans on the recurrent path, counted over one iteration;
* the new configuration, cells and traffic load and name what exists.

The limits here are tenant-mappo.e4096's tiny-size test's, for the same
reason (a bf16 rounding that a product's summation order flips moves a leaf
by up to ~1% at 32 rows); the card's limits are the cell's file's
(PERF.md).
"""
import ast
import copy
import io
import os
import time

import pytest
import torch

from port_bench import harness, peaks
from port_bench.reference import compare
from port_bench.reference.ppo import FAULTS
from port_bench.roofline import gru
from port_bench.trace import Trace

CELL = "tenant-mappo-rnn.e4096"
SEED = 2345678901234
LIMITS = {"loss": 1e-3, "grad": 1e-2, "change": 0.05}
T, EPOCHS = 4, 2


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
    config["train"].update(hidden_size=32, episode_length=T, ppo_epoch=EPOCHS)
    config["env"]["episodeLength"] = 3
    config["sim"]["substeps"] = 1
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
    prog = mod.checked(built, config, 1)
    runner = built.trainer
    ref = mod.reference(config, cell, SEED, dev, 1)
    rows = {"prog": prog, "program": compare.numbers(prog, ref),
            "episodes ended": int(runner.state.ep_count.sum()),
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


def test_the_readings_name_every_agents_leaves_and_the_masks_act(sides):
    cell, config = tiny()
    prog = sides["prog"]
    names = set(prog["grad"])
    assert names == set(prog["change"])
    assert len(names) == 10 * len(harness.trainer_module(config).leaf_shapes(config["train"]))
    assert {"agent3/actor/GRUCell_0/hz/kernel", "agent9/critic/GRUCell_0/hn/bias",
            "agent0/critic/MLPBase_0/Dense_2/kernel", "agent5/actor/std_param"} <= names
    # every env ended an episode inside the rollout, so a hidden state was zeroed
    assert sides["episodes ended"] >= cell["num_envs"]
    assert not sides["wrappers left"]


@pytest.fixture
def jax_preloaded(monkeypatch):
    """tests/conftest.py loads JAX before any test runs: the run's own check
    looks for the modules of the JAX stack that are not loaded yet."""
    before, found = set(harness.banned_modules()), harness.banned_modules
    monkeypatch.setattr(harness, "banned_modules", lambda: sorted(set(found()) - before))


@pytest.mark.parametrize("traced, reported", [
    (False, {"env_steps_per_s", "setup_s"}),
    # the device trace's metrics have nothing to read on the CPU
    (True, {"trainer.rollout_ms", "trainer.update_ms", "env.step_ms", "mfu"})])
def test_a_whole_run_of_the_cell_is_correct_and_reports_its_metrics(jax_preloaded, traced,
                                                                    reported):
    cell, config = tiny()
    line = harness.run_cell(CELL, SEED, 0.2, traced, time.perf_counter(), device="cpu",
                            err=io.StringIO(), cell=cell, config=config)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == reported
    assert all(v["value"] > 0 for v in line["metrics"].values())


def _imports(path, top_level_only=False):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in (tree.body if top_level_only else ast.walk(tree)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", ["reference/mappo_rnn.py", "trainers/mappo_rnn.py",
                                  "roofline/gru.py", "metrics/kernel.fp32_gemm_roofline.py"])
def test_no_module_of_the_jax_stack_and_a_reference_without_the_port(path):
    full = os.path.join(harness.HERE, path)
    assert not set(_imports(full)) & {"jax", "jaxlib", "flax", "massive_marl_tpu"}
    # the reference never imports the port; the adapter only where it builds it
    port = set(_imports(full, top_level_only=not path.startswith("reference/")))
    assert "massive_marl_tpu_torch" not in port


# ------------------------------------------------------------------ roofline
def test_the_gru_count_at_512():
    f = gru.flops(512, 512)
    # input and recurrent products, 512 -> 1536 each, a multiply-add two
    assert f == {"fwd": 3_145_728, "bwd": 6_291_456, "bwd_first": 4_718_592}
    train = {"hidden_size": 512, "episode_length": 8, "ppo_epoch": 5, "data_chunk_length": None}
    rows = 4096 * 10
    rollout = (8 + 8 + 1) * rows * 3_145_728     # actor and critic steps, the last values
    per_chunk = 8 * 3_145_728 + 7 * 6_291_456 + 4_718_592
    assert gru.mappo_rnn_flop(train, 4096) == rollout + 5 * 2 * rows * per_chunk
    # chunks of 4 steps: twice the chunks, each starting from a hidden state
    halves = dict(train, data_chunk_length=4)
    per_half = 4 * 3_145_728 + 3 * 6_291_456 + 4_718_592
    assert gru.mappo_rnn_flop(halves, 4096) == rollout + 5 * 2 * 2 * rows * per_half


def test_the_fp32_gemm_roofline_reader():
    cell, config = harness.load_cell(CELL)
    work = harness.trainer_module(config).counted_work(config, cell)
    assert work["fp32_flop"] > gru.mappo_rnn_flop(config["train"], 4096)   # and the heads
    kernels = {  # names as the card's trace gives them
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(...)": (100, 0.5),
        "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_"
        "alignc4_execute_kernel__5x_cublas": (50, 0.25),
        "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>": (10, 0.05),
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_nn_n_tilesize128x128x64_cgasize1x1x1": (300, 0.4),
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": (100, 0.1),
        "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>": (900, 0.3)}
    tr = Trace(iterations=2, window_s=4.0, busy_s=3.5, launches=1360, kernels=kernels)
    read = harness.reader("kernel.fp32_gemm_roofline").read
    got = read(harness.Readings(cell, config, work, [2.0], trace=tr))
    assert got == pytest.approx(100.0 * work["fp32_flop"] * 2 / peaks.FP32_OPS_PER_S / 0.8)
    # nothing to read without a trace, or without a float32 GEMM in it
    assert read(harness.Readings(cell, config, work, [2.0])) is None
    bf16_only = {k: v for k, v in kernels.items() if "f32f32_f32f32" not in k and "float, float"
                 not in k and "sgemm" not in k}
    tr_bf16 = Trace(iterations=2, window_s=4.0, busy_s=1.0, launches=1200, kernels=bf16_only)
    assert read(harness.Readings(cell, config, work, [2.0], trace=tr_bf16)) is None


# --------------------------------------------------------------------- spans
def test_the_recurrent_paths_spans_count_one_iterations_calls():
    from massive_marl_tpu_torch.utils import profiling

    cell, config = tiny()
    built = harness.trainer_module(config).build(config, cell, SEED, torch.device("cpu"))
    profiling.reset()
    profiling.enable()
    try:
        built.trainer.train_iter()
    finally:
        profiling.disable()
    totals = profiling.totals()
    profiling.reset()
    want = {"trainer.rollout": 1, "trainer.update": 1, "trainer.policy": T,
            # the actor's and the critic's step in each rollout step, the last values
            "gru.step": 2 * T + 1,
            # one BPTT pass a net and epoch, inside its forward
            "gru.seq": 2 * EPOCHS, "update.forward": 2 * EPOCHS,
            "update.backward": 2 * EPOCHS, "update.optimizer": 2 * EPOCHS}
    assert {k: totals[k][0] for k in want} == want


# --------------------------------------------------------------------- files
@pytest.mark.parametrize("name, config, traffic, envs", [
    ("tenant-mappo-rnn.e4096", "tenant-mappo-rnn", "e4096", 4096),
    ("tenant-ppo.e16384", "tenant-ppo", "e16384", 16384)])
def test_the_new_cells_load_and_name_what_exists(name, config, traffic, envs):
    bench = harness.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (config, traffic, 1)
    cell, cfg = harness.load_cell(name)
    assert cell["num_envs"] == envs and cell["physics"] == "kernel"
    assert cfg["name"] == config and callable(harness.trainer_module(cfg).build)
    c = next(c for c in bench["configs"] if c["name"] == config)
    assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    # every per-layer metric that lists the cell has a reader
    for m in harness.metrics_of(bench, name, "per_layer"):
        assert callable(harness.reader(m["name"]).read)


def test_the_recurrent_configuration_is_cfg_mappo_with_the_recurrent_policy():
    _, rnn = harness.load_cell("tenant-mappo-rnn.e4096")
    _, ff = harness.load_cell("tenant-mappo.e4096")
    assert rnn["trainer"] == "mappo_rnn" and rnn["reduced"] == []
    assert {k: v for k, v in rnn["train"].items()
            if k not in ("use_recurrent_policy", "recurrent_N", "data_chunk_length")} == ff["train"]
    assert (rnn["train"]["use_recurrent_policy"], rnn["train"]["recurrent_N"],
            rnn["train"]["data_chunk_length"]) == (True, 1, None)
    for k in ("source_repo", "source_files", "paper", "task", "clip", "env", "sim"):
        assert rnn[k] == ff[k], k
    # a configuration of its own: rMAPPO's implementation, not the paper tenant-mappo cites
    assert rnn["source"] == "https://github.com/marlbenchmark/on-policy" != ff["source"]
