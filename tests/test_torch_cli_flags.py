"""The port's CLI flags and modes against the JAX CLI's, on the CPU.

* Every flag of the JAX CLI's get_args parses to the same value in the
  port's (all of them set at once, and all at their defaults); the port
  adds only --device and --fused_kernel.  --horovod and --checkpoint are
  refused with the JAX messages; --rl_device cpu is --device cpu.
* --experiment/--metadata give the JAX logdir with "torchphys" and the
  torch device type in place of "jaxphys" and the JAX backend.
* set_np_formatting and get_agent_index as in the JAX package.
* --random_actions at E = 4 prints and appends one JSON line per report
  (chunks cut from 256 to 2 steps here, since the plain version of the
  substep kernel takes ~0.1 s a step on the CPU).
* --test with and without --headless at E = 4 and --episode_length 4:
  the evaluation's number, and viewer_<task>.html, byte-identical to the
  JAX package's export_interactive on the same arrays.
* Two iterations with save_interval 1, then --model_dir latest (and
  --resume 1) gives the same state bit for bit, for OneAnt + PPO and
  TenAnt + MAPPO (use_eval on, so a MARL run with use_eval and a logdir
  completes); a third iteration trains on from it.
* MarlRunner.eval equals a loop written here over the same env, policy
  and generator, with the first-done masking.
* TRPO, DDPG, TD3 and SAC train through main() from cfg/ (copies with
  narrow widths, short rollouts and a small ring), write model_<it>.ckpt,
  and --model_dir latest --test evaluates the restored policy; MAT, MADDPG
  and recurrent MAPPO the same with mat_/maddpg_/marl_<it>.ckpt, their
  viewer export skipped as in the JAX CLI; OneAnt takes
  every single-agent algorithm; MultiAntCircle and MultiIngenuity build
  and train through main() and make(); a MARL algorithm (MAT included) on
  OneAnt is refused.
"""
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from massive_marl_tpu.utils import config as j_config
from massive_marl_tpu.utils import viewer as j_viewer
from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
from massive_marl_tpu_torch.cli import train as p_train
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.utils import config as p_config
from massive_marl_tpu_torch.utils import viewer as p_viewer
from massive_marl_tpu_torch.utils.tree import tree_leaves
from massive_marl_tpu_torch.wrap.vec_task import split_multi_agent_obs

FULL = ["--task", "OneAnt", "--algo", "happo", "--num_envs", "9", "--episode_length", "11",
        "--seed", "4", "--max_iterations", "3", "--num_env_steps", "77", "--test", "--play",
        "--model_dir", "m/x.ckpt", "--logdir", "L", "--experiment", "Exp", "--metadata",
        "--cfg_train", "a.yaml", "--cfg_env", "b.yaml", "--randomize", "--datatype", "medium",
        "--task_type", "Multi", "--rl_device", "gpu", "--headless", "--torch_deterministic",
        "--resume", "2", "--minibatch_size", "64", "--steps_num", "16", "--num_proc", "4",
        "--random_actions", "--bench_len", "5", "--bench_file", "f.jsonl"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_jax_flag_parses_the_same():
    for argv in (FULL, [], ["--experiment_name", "E2"]):
        j, p = vars(j_config.get_args(argv)), vars(p_config.get_args(argv))
        assert set(p) - set(j) == {"device", "fused_kernel"}
        assert {k: p[k] for k in j} == j
    j_full, j_default = vars(j_config.get_args(FULL)), vars(j_config.get_args([]))
    assert {k for k in j_full if j_full[k] == j_default[k]} == {"horovod", "checkpoint"}


@pytest.mark.parametrize("argv", [["--horovod"], ["--checkpoint", "runs/x.pth"]])
def test_refused_flags(argv):
    with pytest.raises(SystemExit) as j:
        j_config.get_args(argv)
    with pytest.raises(SystemExit) as p:
        p_config.get_args(argv)
    assert "not supported" in str(p.value)
    if argv == ["--horovod"]:   # each names its own package's mesh
        assert str(p.value) == str(j.value).replace(
            "the jax.sharding mesh (massive_marl_tpu.parallel.mesh)",
            "the data-parallel mesh (massive_marl_tpu_torch.parallel.mesh)")
    else:
        assert str(p.value) == str(j.value)


def test_rl_device_cpu_is_device_cpu():
    assert p_config.get_args(["--rl_device", "cpu"]).device == "cpu"
    assert p_config.get_args([]).device is None
    with pytest.raises(SystemExit):
        p_config.get_args(["--rl_device", "cpu", "--device", "cuda"])


@pytest.mark.parametrize("extra", [[], ["--randomize"]])
def test_metadata_suffix(extra):
    argv = ["--task", "TenAnt", "--algo", "mappo", "--experiment", "X", "--metadata", *extra]
    p_logdir = p_config.retrieve_cfg(p_config.get_args(argv + ["--device", "cpu"]))[0]
    j_logdir = j_config.retrieve_cfg(j_config.get_args(argv))[0]
    assert p_logdir == j_logdir.replace("_cpu_jaxphys", "_cpu_torchphys")
    assert p_logdir.endswith("mappo_X_Python_cpu_torchphys" + ("_DR" if extra else ""))
    cuda = p_config.retrieve_cfg(p_config.get_args(argv))[0]
    assert "_X_Python_cuda_torchphys" in cuda
    plain = ["--task", "TenAnt", "--experiment", "X"]
    assert p_config.retrieve_cfg(p_config.get_args(plain)) == \
        j_config.retrieve_cfg(j_config.get_args(plain))


def test_np_formatting_and_agent_index():
    before = np.get_printoptions()
    try:
        j_config.set_np_formatting()
        ref = np.get_printoptions()
        np.set_printoptions(**before)
        p_config.set_np_formatting()
        assert np.get_printoptions() == ref
    finally:
        np.set_printoptions(**before)
    for cfg in ({}, {"env": {"AgentIndex": "[[0, 1, 2], [3]]"}},
                {"env": {"AgentIndex": [[0], [1]]}}):
        assert p_config.get_agent_index(cfg) == j_config.get_agent_index(cfg)


# ------------------------------------------------------------- CLI runs
def _edit_yaml(src, dst, values):
    text = open(src).read()
    for key, value in values.items():
        text, n = re.subn(rf"^(\s*){key}: .*$", rf"\g<1>{key}: {value}", text, flags=re.M)
        assert n == 1, key
    dst.write_text(text)
    return str(dst)


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    """Small trainer and env YAMLs: the cfg/ files with narrow widths, short
    rollouts, save_interval 1 and one substep."""
    d = tmp_path_factory.mktemp("cfg")
    root = p_config.CFG_ROOT
    ppo = open(f"{root}/ppo/config.yaml").read().replace("  - 1024", "  - 32") \
        .replace("  - 512", "  - 16")
    (d / "ppo_src.yaml").write_text(ppo)
    out = {
        "ppo": _edit_yaml(d / "ppo_src.yaml", d / "ppo.yaml",
                          {"save_interval": 1, "nsteps": 2, "noptepochs": 2}),
        "mappo": _edit_yaml(f"{root}/mappo/config.yaml", d / "mappo.yaml",
                            {"hidden_size": 16, "episode_length": 2, "ppo_epoch": 1,
                             "save_interval": 1, "use_eval": "true", "eval_interval": 1,
                             "eval_episodes": 2, "log_interval": 1}),
    }
    trpo = open(f"{root}/trpo/config.yaml").read().replace("  - 1024", "  - 32") \
        .replace("  - 512", "  - 16")
    (d / "trpo_src.yaml").write_text(trpo)
    out["trpo"] = _edit_yaml(d / "trpo_src.yaml", d / "trpo.yaml",
                             {"save_interval": 1, "nsteps": 2})
    for algo in ("ddpg", "td3", "sac"):
        out[algo] = _edit_yaml(f"{root}/{algo}/config.yaml", d / f"{algo}.yaml",
                               {"save_interval": 1, "nsteps": 2, "noptepochs": 1,
                                "hidden_nodes": 16, "replay_size": 6, "batch_size": 2})
    (d / "mat_src.yaml").write_text(open(f"{root}/mat/config.yaml").read()
                                    + "save_interval: 200\n")
    out["mat"] = _edit_yaml(d / "mat_src.yaml", d / "mat.yaml",
                            {"embed": 16, "ppo_epoch": 1, "save_interval": 1,
                             "episode_length": 4})
    out["maddpg"] = _edit_yaml(f"{root}/maddpg/config.yaml", d / "maddpg.yaml",
                               {"save_interval": 1, "nsteps": 2, "hidden_nodes": 16,
                                "hidden_layer": 1, "replay_size": 6, "batch_size": 2})
    out["mappo_rnn"] = _edit_yaml(f"{root}/mappo/config.yaml", d / "mappo_rnn.yaml",
                                  {"hidden_size": 16, "ppo_epoch": 1, "save_interval": 1,
                                   "use_recurrent_policy": "true", "data_chunk_length": 2,
                                   "episode_length": 4})
    for task in ("OneAnt", "TenAnt"):
        out[task] = _edit_yaml(f"{root}/{task}.yaml", d / f"{task}.yaml", {"substeps": 1})
    for task in ("MultiAntCircle", "MultiIngenuity"):
        out[task] = _edit_yaml(f"{root}/{task}.yaml", d / f"{task}.yaml", {"substeps": 1})
    return out


def _argv(cfgs, task, algo, logdir, *extra, cfg_train=None):
    return ["--task", task, "--algo", algo, "--num_envs", "4", "--seed", "2", "--device", "cpu",
            "--logdir", str(logdir), "--cfg_train", cfgs[cfg_train or algo],
            "--cfg_env", cfgs[task], "--episode_length", "4", *extra]


def test_random_actions(cfgs, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(p_train, "BENCH_CHUNK", 2)
    bench = tmp_path / "bench.jsonl"
    argv = _argv(cfgs, "OneAnt", "ppo", tmp_path, "--random_actions", "--bench_len", "2",
                 "--bench_file", str(bench))
    for _ in range(2):
        recs = p_train.main(argv)
        assert [r["report"] for r in recs] == [0, 1]
    lines = [json.loads(x) for x in bench.read_text().splitlines()]
    assert [x["report"] for x in lines] == [0, 1] * 2
    for rec in lines:
        assert rec["num_envs"] == 4 and rec["task"] == "OneAnt" and rec["env_steps_per_s"] > 0
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == lines


def test_test_mode_eval_and_viewer(cfgs, tmp_path, monkeypatch):
    monkeypatch.setenv("VIEWER_STEPS", "3")
    seen = []
    export = p_viewer.export_interactive

    def recording(ant, box=None, **kw):
        seen.append((ant, box))
        return export(ant, box, **kw)
    monkeypatch.setattr(p_viewer, "export_interactive", recording)
    html = tmp_path / "seed2" / "viewer_TenAnt.html"
    headless = p_train.main(_argv(cfgs, "TenAnt", "ppo", tmp_path, "--test", "--headless"))
    assert np.isfinite(headless.last_eval) and not html.exists() and not seen
    shown = p_train.main(_argv(cfgs, "TenAnt", "ppo", tmp_path, "--play"))
    assert shown.last_eval == headless.last_eval
    (ant, box), = seen
    assert ant.shape == (3, 10, 3) and box.shape == (3, 3)
    ref = tmp_path / "jax.html"
    j_viewer.export_interactive(ant, box, out=str(ref))
    assert html.read_bytes() == ref.read_bytes()
    assert not (tmp_path / "seed2" / "model_1.ckpt").exists()      # --test trains nothing


def _ppo_state(t):
    st = t.state
    return ([p.detach() for p in t.model.parameters()] + st.opt.mu + st.opt.nu + [st.lr],
            (st.opt.count, st.iteration))


def _marl_state(r):
    st = r.state
    vn = st.vnorm
    return (tree_leaves(st.actor_params) + tree_leaves(st.critic_params) + st.actor_opt.mu
            + st.actor_opt.nu + st.critic_opt.mu + st.critic_opt.nu
            + [vn.mean, vn.mean_sq, vn.debias],
            (st.actor_opt.count, st.critic_opt.count, st.iteration))


@pytest.mark.parametrize("task,algo,prefix,state_of", [
    ("OneAnt", "ppo", "model", _ppo_state), ("TenAnt", "mappo", "marl", _marl_state)])
def test_train_then_resume(cfgs, tmp_path, task, algo, prefix, state_of):
    run = p_train.main(_argv(cfgs, task, algo, tmp_path, "--max_iterations", "2"))
    d = tmp_path / "seed2"
    files = sorted(os.listdir(d))
    assert [f for f in files if f.endswith(".ckpt")] == [f"{prefix}_1.ckpt", f"{prefix}_2.ckpt"]
    assert "metrics.csv" in files and any(f.startswith("events.out.tfevents") for f in files)
    tags = {row.split(",")[2] for row in (d / "metrics.csv").read_text().splitlines()[1:]}
    if algo == "ppo":
        assert tags == {"Train2/mean_reward/step", "Loss/value_function", "Loss/surrogate",
                        "Policy/mean_noise_std", "Perf/fps"}
    else:
        assert {"train/mean_reward", "train/value_loss", "train/policy_loss", "perf/fps",
                "eval/mean_episode_reward"} <= tags
    want, want_meta = state_of(run)
    for extra in (["--model_dir", "latest"], ["--resume", "1"],
                  ["--model_dir", str(d / f"{prefix}_2.ckpt")]):
        back = p_train.main(_argv(cfgs, task, algo, tmp_path, "--max_iterations", "2", *extra))
        got, got_meta = state_of(back)
        assert got_meta == want_meta and len(got) == len(want)
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    more = p_train.main(_argv(cfgs, task, algo, tmp_path, "--max_iterations", "3",
                              "--model_dir", "latest"))
    assert state_of(more)[1][-1] == 3 and (d / f"{prefix}_3.ckpt").exists()
    tested = p_train.main(_argv(cfgs, task, algo, tmp_path, "--test", "--headless",
                                "--model_dir", "latest"))
    assert np.isfinite(tested.last_eval)


def test_marl_eval_matches_a_loop():
    env = TenAntEnv({"env": {"episodeLength": 3}, "sim": {"substeps": 1}}, device="cpu", seed=5)
    cfg = dataclasses.replace(MarlConfig(), hidden_size=16, eval_episodes=3)
    r = MarlRunner(env, 4, cfg, seed=7, device="cpu", print_log=False)
    r.init_state()
    r.state.iteration = 2
    own = env.generator
    got = r.eval()
    assert env.generator is own

    g = torch.Generator()
    g.manual_seed(((7 + 10_000) << 32) + 2)
    env.generator = g
    try:
        st = env.reset(3)
        ret, alive, dones = torch.zeros(3), torch.ones(3, dtype=torch.bool), []
        for _ in range(3):
            obs = split_multi_agent_obs(torch.clamp(st.obs, -7, 7), 10, 38).transpose(0, 1)
            mean, _ = r.actor.apply(r.state.actor_params, obs)
            st = env.step_batch(st, torch.clamp(mean, -1, 1).transpose(0, 1).reshape(3, -1))
            ret = ret + torch.where(alive, st.reward, 0.0)
            alive = alive & ~st.done
            dones.append(st.done.clone())
    finally:
        env.generator = own
    assert dones[1].all() and not dones[2].any()   # the third step's reward is masked
    assert got == float(ret.mean())


@pytest.mark.parametrize("algo", ["trpo", "ddpg", "td3", "sac"])
def test_sarl_trains_and_tests(cfgs, tmp_path, algo):
    from massive_marl_tpu_torch.algos.rl.offpolicy import OffPolicy
    from massive_marl_tpu_torch.algos.rl.trpo import TRPO
    run = p_train.main(_argv(cfgs, "TenAnt", algo, tmp_path, "--max_iterations", "2"))
    assert isinstance(run, TRPO if algo == "trpo" else OffPolicy)
    assert run.state.iteration == 2 and all(np.isfinite(v) for v in run.last_metrics.values())
    if algo != "trpo":     # 2 slots a step, batch_size 2: the second iteration trains
        assert run.grad_steps == 2 * run.cfg.nminibatches and run.state.replay.count == 4
    d = tmp_path / "seed2"
    assert {"model_1.ckpt", "model_2.ckpt", "metrics.csv"} <= set(os.listdir(d))
    tags = {row.split(",")[2] for row in (d / "metrics.csv").read_text().splitlines()[1:]}
    assert tags == {"train/mean_reward", "perf/fps",
                    "train/value_loss" if algo == "trpo" else "train/q_loss"}
    tested = p_train.main(_argv(cfgs, "TenAnt", algo, tmp_path, "--test", "--headless",
                                "--model_dir", "latest"))
    assert np.isfinite(tested.last_eval) and tested.state.iteration == 2
    same = (lambda t: [p.detach() for p in t.actor.parameters()]) if algo == "trpo" else \
        (lambda t: tree_leaves(t.state.params) + tree_leaves(t.state.target_params))
    assert all(torch.equal(a, b) for a, b in zip(same(run), same(tested)))


@pytest.mark.parametrize("algo,cfg_train,prefix", [("mat", None, "mat"),
                                                   ("maddpg", None, "maddpg"),
                                                   ("mappo", "mappo_rnn", "marl")])
def test_marl_zoo_trains_and_tests(cfgs, tmp_path, monkeypatch, capsys, algo, cfg_train,
                                   prefix):
    """MAT, MADDPG and recurrent MAPPO train 2 iterations through main()
    (MADDPG's first collects only), write their checkpoints, and --model_dir
    latest --test restores them and evaluates; the viewer export, which has
    no policy for these runners, prints that it was skipped."""
    from massive_marl_tpu_torch.algos.marl.recurrent_runner import RecurrentMarlRunner
    run = p_train.main(_argv(cfgs, "TenAnt", algo, tmp_path, "--max_iterations", "2",
                             cfg_train=cfg_train))
    assert run.state.iteration == 2 and all(np.isfinite(v) for v in run.last_metrics.values())
    assert (algo != "mappo") or isinstance(run, RecurrentMarlRunner)
    if algo == "maddpg":
        assert run.grad_steps == 2 and run.state.replay.count == 4
    d = tmp_path / "seed2"
    assert {f"{prefix}_1.ckpt", f"{prefix}_2.ckpt", "metrics.csv"} <= set(os.listdir(d))
    monkeypatch.setenv("VIEWER_STEPS", "3")
    capsys.readouterr()
    tested = p_train.main(_argv(cfgs, "TenAnt", algo, tmp_path, "--test", "--model_dir",
                                "latest", cfg_train=cfg_train))
    out = capsys.readouterr().out
    assert "eval mean episode reward:" in out and "viewer export skipped" in out
    assert np.isfinite(tested.last_eval) and tested.state.iteration == 2
    params = (lambda r: tree_leaves(r.state.params)) if algo == "mat" else \
        (lambda r: tree_leaves(r.state.actor_params) + tree_leaves(r.state.critic_params))
    assert all(torch.equal(a, b) for a, b in zip(params(run), params(tested)))
    assert not os.path.exists(d / "viewer_TenAnt.html")


def test_one_ant_refuses_mat():
    with pytest.raises(SystemExit, match="single-agent task"):
        p_train.main(["--task", "OneAnt", "--algo", "mat", "--device", "cpu"])


def test_one_ant_takes_every_sarl_algorithm(cfgs, tmp_path):
    for algo in ("sac", "trpo"):
        t = p_train.main(_argv(cfgs, "OneAnt", algo, tmp_path, "--max_iterations", "1"))
        assert t.state.iteration == 1 and t.env.num_obs == 60
    with pytest.raises(SystemExit):      # a MARL algorithm on a single-agent task
        p_train.main(_argv(cfgs, "OneAnt", "mappo", tmp_path))


@pytest.mark.parametrize("task", ["MultiAntCircle", "MultiIngenuity"])
def test_other_tasks_build_and_train(cfgs, tmp_path, task):
    import massive_marl_tpu_torch as port
    from massive_marl_tpu_torch.wrap.vec_task import MultiVecTaskPython, VecTaskPython
    runner = p_train.main(_argv(cfgs, task, "mappo", tmp_path / "m", "--max_iterations", "1"))
    assert type(runner.env).__name__ == task + "Env" and runner.state.iteration == 1
    assert runner.obs_dim == runner.env.num_ant_obs and torch.isfinite(
        runner.state.env_state.obs).all()
    ppo = p_train.main(_argv(cfgs, task, "ppo", tmp_path / "p", "--max_iterations", "1"))
    assert np.isfinite(ppo.last_metrics["mean_reward"])
    multi = port.make(task, algo="mappo", num_envs=2, device="cpu")
    obs, share, _ = multi.reset()
    assert isinstance(multi, MultiVecTaskPython) and obs.shape[:2] == (2, multi.num_agents)
    single = port.make(task, num_envs=2, device="cpu")
    o, r, done, _ = single.step(torch.zeros(2, single.num_actions))
    assert isinstance(single, VecTaskPython) and o.shape == (2, single.num_obs)
    assert torch.isfinite(o).all() and torch.isfinite(r).all()
