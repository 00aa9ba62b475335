"""The port's mesh (massive_marl_tpu_torch/parallel/mesh.py) and launcher.

* make_mesh's axis names and shapes, against the JAX package's make_mesh on
  the 8 virtual CPU devices of tests/conftest.py;
* init_distributed is a no-op for one process and refuses a job without
  MMT_COORDINATOR; the 4-rank run below joins through MMT_* alone;
* a rank's env, given its rows by Mesh.shard_env, resets to the rows of
  the single-process state, and the trainers' initial parameters are the
  same bits at any CPU thread count (a rank runs at one thread, a process
  alone at every core); `draw` gives a rank the rows of the
  single-process draw; Mesh.span / local_index cut T-major batches;
* on 4 gloo ranks (parallel/launch.py, this file as the ranks' module):
  the global mean and population std of uneven local batches equal
  torch's on their concatenation at 1e-6, sum / mean / broadcast_int;
* the launcher exits with a failing rank's code and ends the other ranks;
* the CLI on 2 ranks (TenAnt MAPPO, --num_envs 8 --max_iterations 2
  --device cpu --seed -1, hidden 16 and one substep): both ranks print the same [mappo] lines but for
  their own fps, one seed reached both, only rank 0 wrote the logdir, the
  first iteration's reward is a 1-process run's of that seed within 1e-3
  relative (the envs drew the same numbers; on the CPU a rank's
  observations can differ in the last bit from the whole batch's, since
  the vectorized kernels of a batch round its tail apart, while on the
  card a rank's rollout is the same bits, chip_smoke.py phase 8a), and
  the checkpoint restores into a 1-process runner.  The parameters are
  held to the 1-process run by the 4-rank tests at small widths.

`run_ranks` is the harness of the tests/test_torch_distributed_*.py files.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from massive_marl_tpu_torch.parallel import launch as launch_mod
from massive_marl_tpu_torch.parallel import mesh as meshlib

REPO = pathlib.Path(__file__).resolve().parents[1]
R = 4
SIZES = [3, 1, 5, 2]          # uneven local batches of the 4 ranks


def rank_env(out, **extra):
    env = dict(os.environ, MMT_TEST_OUT=str(out), **extra)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return env


def run_ranks(module: str, out, nproc: int = R, timeout: float = 150, **extra):
    """Start `python -m module` on nproc gloo ranks in a thread; returns the
    thread, whose `rc` holds the launcher's exit code once joined."""
    t = threading.Thread(target=lambda: setattr(t, "rc", launch_mod.launch(
        nproc, [], backend="gloo", module=module, timeout=timeout,
        env=rank_env(out, **extra))))
    t.start()
    return t


def gather_digest(tensors) -> list:
    """Every rank's sha256 of `tensors`' bytes (all_gather_object)."""
    import hashlib

    import torch.distributed as dist
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, h.hexdigest())
    return got


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("n, mp", [(8, 1), (8, 2), (4, 4)])
def test_mesh_shape_and_axes_match_jax(n, mp):
    from massive_marl_tpu.parallel import mesh as jmesh
    j = jmesh.make_mesh(n, model_parallel=mp)
    p = meshlib.make_mesh(n, model_parallel=mp)
    assert p.axis_names == j.axis_names == ("data", "model")
    assert p.ranks.shape == j.devices.shape
    assert p.shape == dict(j.shape) and p.size == n // mp
    with pytest.raises(ValueError):
        meshlib.make_mesh(8, model_parallel=3)


def test_init_distributed_single_process(monkeypatch):
    for k in ("MMT_COORDINATOR", "MMT_NUM_PROCESSES", "MMT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert meshlib.init_distributed(device="cpu") is False
    monkeypatch.setenv("MMT_NUM_PROCESSES", "1")
    assert meshlib.init_distributed(device="cpu") is False
    monkeypatch.setenv("MMT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="MMT_COORDINATOR"):
        meshlib.init_distributed(device="cpu")
    assert meshlib.LOCAL.size == 1 and meshlib.LOCAL.rows(6) == slice(0, 6)


def test_shard_env_gives_each_rank_its_rows():
    from tests.test_torch_distributed_sarl import DToy
    E = 8
    whole = DToy().reset(E)
    for rank in range(R):
        env = DToy()
        assert meshlib.Mesh(R, 1, rank).shard_env(env, E) == E // R
        got = env.reset(E // R)
        for a, b in zip(vars(got).values(), vars(whole).values()):
            assert torch.equal(a, b[2 * rank:2 * rank + 2])
    env = DToy()
    assert meshlib.LOCAL.shard_env(env, E) == E and not hasattr(env.generator, "rows")
    with pytest.raises(ValueError):
        meshlib.Mesh(3, 1, 0).rows(E)


def _initial_params(name):
    from massive_marl_tpu_torch.algos.marl.mat import MatConfig, MatRunner
    from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
    from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    env = TenAntEnv(device="cpu", seed=0)
    if name == "ppo":
        return list(PPO(env, 2, PPOConfig(), seed=0, device="cpu", print_log=False)
                    .model.parameters())
    if name == "mat":
        return tree_leaves(MatRunner(env, 2, MatConfig(), seed=0, device="cpu",
                                     print_log=False).init_state().params)
    st = MarlRunner(env, 2, MarlConfig(), seed=0, device="cpu", print_log=False).init_state()
    return tree_leaves(st.actor_params) + tree_leaves(st.critic_params)


@pytest.mark.parametrize("name", ["ppo", "mappo", "mat"])
def test_initial_parameters_at_any_thread_count(name):
    """The full-width trainers' initial parameters (orthogonal weights by
    QR) are the same bits at 1 and 3 CPU threads, so the ranks of a job
    start where a process alone starts."""
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = _initial_params(name)
        torch.set_num_threads(3)
        three = _initial_params(name)
    finally:
        torch.set_num_threads(threads)
    assert len(one) == len(three)
    for a, b in zip(one, three):
        assert torch.equal(a, b)


def test_draw_gives_each_rank_its_rows():
    full = torch.rand((2, 8, 3), generator=torch.Generator().manual_seed(5))
    for rank in range(R):
        m = meshlib.Mesh(R, 1, rank)
        g = m.shard_generator(torch.Generator().manual_seed(5), 8)
        assert g.rows == (2 * rank, 2 * rank + 2, 8)
        got = meshlib.draw(torch.rand, (2, 2, 3), g, axis=1)
        assert torch.equal(got, full[:, 2 * rank:2 * rank + 2])
        with pytest.raises(ValueError):
            meshlib.draw(torch.rand, (3, 3), g)
    plain = torch.Generator().manual_seed(5)
    assert meshlib.LOCAL.shard_generator(plain, 8) is plain
    assert torch.equal(meshlib.draw(torch.rand, (2, 8, 3), plain), full)


def test_span_and_local_index_cut_t_major_batches():
    T, E = 3, 8
    glob = torch.arange(T * E)
    for rank in range(R):
        m = meshlib.Mesh(R, 1, rank)
        mine = glob.reshape(T, E)[:, m.rows(E)].reshape(-1)   # the rank's T-major rows
        for a, b in [(0, 12), (4, 20), (7, 24), (10, 11)]:
            lo, hi = m.span(a, b, E)
            assert mine[lo:hi].tolist() == [g for g in mine.tolist() if a <= g < b]
        idx = torch.randperm(T * E, generator=torch.Generator().manual_seed(1))[:10]
        loc = m.local_index(idx, E)
        assert mine[loc].tolist() == [g for g in idx.tolist() if g in set(mine.tolist())]


# --------------------------------------------------------- 4 ranks, gloo
def _rank_main():
    torch.set_num_threads(1)
    if os.environ.get("MMT_TEST_FAIL"):
        if int(os.environ["MMT_PROCESS_ID"]) == 1:
            sys.exit(3)
        time.sleep(60)          # the launcher must end this rank
        return
    assert meshlib.init_distributed(device="cpu")          # from MMT_* alone
    mesh = meshlib.make_mesh()
    rng = np.random.default_rng(0)
    full = rng.normal(3.0, 2.0, (sum(SIZES), 5)).astype(np.float32)
    lo = sum(SIZES[:mesh.rank])
    x = torch.from_numpy(full[lo:lo + SIZES[mesh.rank]])
    mean_all, std_all = mesh.mean_std(x)
    mean_col, std_col = mesh.mean_std(x.t(), dim=1)
    s, m = mesh.sum([x.sum(0), torch.tensor(mesh.rank)]), mesh.mean(torch.tensor(float(mesh.rank)))
    seed = meshlib.broadcast_int(1234 if mesh.rank == 0 else -1)
    digests = gather_digest([mean_all, std_all, mean_col, std_col, s[0]])
    if mesh.rank == 0:
        pathlib.Path(os.environ["MMT_TEST_OUT"]).write_text(json.dumps(dict(
            mean=float(mean_all), std=float(std_all), mean_col=mean_col.tolist(),
            std_col=std_col.tolist(), colsum=s[0].tolist(), ranksum=int(s[1]),
            rankmean=float(m), seed=seed, digests=digests,
            collectives=mesh.collectives, bytes=mesh.bytes_reduced, size=mesh.size)))


def test_four_ranks_global_statistics(tmp_path):
    out = tmp_path / "stats.json"
    t = run_ranks("tests.test_torch_mesh", out)
    t.join()
    assert t.rc == 0
    got = json.loads(out.read_text())
    full = torch.from_numpy(np.random.default_rng(0).normal(
        3.0, 2.0, (sum(SIZES), 5)).astype(np.float32))
    np.testing.assert_allclose(got["mean"], float(full.mean()), rtol=1e-6)
    np.testing.assert_allclose(got["std"], float(full.std(correction=0)), rtol=1e-6)
    np.testing.assert_allclose(got["mean_col"], full.mean(0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["std_col"], full.std(0, correction=0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["colsum"], full.sum(0).numpy(), rtol=1e-6)
    assert got["ranksum"] == 6 and got["rankmean"] == 1.5 and got["seed"] == 1234
    assert got["size"] == R and len(set(got["digests"])) == 1
    # mean_std: 2 collectives each; sum, mean: one each
    assert got["collectives"] == 6


def test_launcher_exits_with_a_failing_rank_code(tmp_path):
    t0 = time.monotonic()
    rc = launch_mod.launch(2, [], module="tests.test_torch_mesh", timeout=50,
                           env=rank_env(tmp_path / "x", MMT_TEST_FAIL="1"))
    assert rc == 3
    assert time.monotonic() - t0 < 30        # the sleeping rank was ended


def test_cli_two_ranks(tmp_path, capsys):
    from massive_marl_tpu_torch.algos.marl.runner import MarlRunner
    from massive_marl_tpu_torch.cli import train as p_train
    from massive_marl_tpu_torch.utils.config import CFG_ROOT
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    # the YAMLs narrowed as in tests/test_torch_cli_flags.py: hidden 16, one substep
    for name, src, values in (("mappo", "mappo/config", dict(save_interval=1, log_interval=1,
                                                              hidden_size=16)),
                              ("TenAnt", "TenAnt", dict(substeps=1))):
        text = open(f"{CFG_ROOT}/{src}.yaml").read()
        for key, value in values.items():
            text, n = re.subn(rf"^(\s*){key}: .*$", rf"\g<1>{key}: {value}", text, flags=re.M)
            assert n == 1, key
        (tmp_path / f"{name}.yaml").write_text(text)
    argv = ["--task", "TenAnt", "--algo", "mappo", "--num_envs", "8", "--max_iterations", "2",
            "--device", "cpu", "--headless", "--cfg_train", str(tmp_path / "mappo.yaml"),
            "--cfg_env", str(tmp_path / "TenAnt.yaml")]
    r = subprocess.run([sys.executable, "-m", "massive_marl_tpu_torch.parallel.launch",
                        "--nproc", "2", "--backend", "gloo", "--timeout", "120", "--",
                        *argv, "--logdir", str(tmp_path / "ranks"), "--seed", "-1"],
                       env=rank_env(tmp_path / "unused"), capture_output=True, text=True,
                       timeout=150)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    # the ranks share the pipe, so a line may arrive in pieces: match each
    # line's text up to its fps, which is the rank's own
    lines = sorted(re.findall(r"\[mappo\] it \d+/\d+ rew/step [-\d.]+ vloss [-\d.]+", r.stdout))
    assert len(lines) == 4 and lines[0] == lines[1] and lines[2] == lines[3], lines
    (run_dir,) = (tmp_path / "ranks").iterdir()          # one seed for both ranks
    seed = int(run_dir.name[len("seed"):])
    assert sorted(p.name for p in run_dir.iterdir() if not p.name.startswith("events")) == \
        ["marl_1.ckpt", "marl_2.ckpt", "metrics.csv"]
    assert len(list(run_dir.glob("events.out.tfevents.*"))) == 1
    rows = run_dir.joinpath("metrics.csv").read_text().splitlines()[1:]
    keys = [tuple(x.split(",")[1:3]) for x in rows]
    assert len(keys) == len(set(keys))                    # one writer
    threads = torch.get_num_threads()
    torch.set_num_threads(1)                # as a rank runs (launch.py)
    try:
        one = p_train.main(argv + ["--logdir", str(tmp_path / "one"), "--seed", str(seed),
                                   "--max_iterations", "1"])
    finally:
        torch.set_num_threads(threads)
    first = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[mappo]")][0]
    rew = lambda line: float(re.search(r"rew/step (\S+)", line).group(1))
    assert abs(rew(first) - rew(lines[0])) <= 1e-3 * abs(rew(first)) + 1e-3
    restored = MarlRunner(one.env, 8, one.cfg, seed=seed, device="cpu", print_log=False)
    restored.restore(str(run_dir / "marl_2.ckpt"))
    assert restored.state.iteration == 2
    init = MarlRunner(one.env, 8, one.cfg, seed=seed, device="cpu", print_log=False).init_state()
    got, start = tree_leaves(restored.state.actor_params), tree_leaves(init.actor_params)
    assert all(torch.isfinite(a).all() for a in got)
    assert any(not torch.equal(a, b) for a, b in zip(got, start))


if __name__ == "__main__":
    _rank_main()
