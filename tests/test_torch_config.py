"""The port's configured CLI against the JAX package's, on the CPU.

* utils/config.load_cfg gives the same cfg, cfg_train and logdir as the JAX
  package's for TenAnt and OneAnt, PPO and MAPPO, with and without
  --randomize (a fixed seed; with seed -1 both draw one in [0, 10000]).
* The env built from that cfg has the JAX env's spec: contact constants,
  dt, substeps, frictions, the DR spec and frequency, episode length.
* PPOConfig.from_cfg_train and MarlConfig.from_cfg_train match the JAX
  package's field by field on cfg/ppo and cfg/{mappo,ippo,happo,hatrpo}.
* `python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo ppo`
  trains what `massive_marl_tpu.cli.train` trains: the same env spec, env
  count and PPOConfig (both trainers' run is replaced by a no-op); the same
  for --algo mat, --algo maddpg and --algo mappo with a
  use_recurrent_policy YAML (the recurrent runner), each to the runner's
  class and configuration.
* The multi-task, meta and offline algorithms (mtppo, mttrpo, mtsac,
  random, mamlppo, ppo_collect, td3_bc, bcq, iql) build through the port's
  main the trainer the JAX CLI's train builds: the same class, config
  fields, task set, env count and seed (run, and the offline trainers'
  eval_online, replaced by no-ops on both sides; the offline trainers read
  a dataset written under ./datasets of a temporary working directory);
  and mtppo with a --cfg_train YAML that lists three tasks.
* The CLI refuses a MARL algorithm on OneAnt.
"""
import dataclasses

import pytest

from massive_marl_tpu.algos.marl.runner import MarlConfig as JMarlConfig
from massive_marl_tpu.algos.rl import ppo as j_ppo
from massive_marl_tpu.cli import train as j_cli
from massive_marl_tpu.utils import config as j_config
from massive_marl_tpu.utils import registry as j_registry
from massive_marl_tpu_torch.algos.marl.runner import MarlConfig as PMarlConfig
from massive_marl_tpu_torch.algos.rl import ppo as p_ppo
from massive_marl_tpu_torch.cli import train as p_cli
from massive_marl_tpu_torch.utils import config as p_config
from massive_marl_tpu_torch.utils import registry as p_registry
from massive_marl_tpu_torch.utils import yaml_lite

SPEC_FIELDS = ("dt", "substeps", "power_scale", "gravity", "plane_friction", "friction_combine",
               "ant_box_mu", "box_ground_mu", "dr_spec", "limit_k", "limit_damp", "num_ants",
               "box_half_extents")
CASES = [(task, algo, rnd) for task in ("TenAnt", "OneAnt") for algo in ("ppo", "mappo")
         for rnd in (False, True)]


def _argv(task, algo, randomize, *extra):
    return ["--task", task, "--algo", algo, *(["--randomize"] if randomize else []), *extra]


@pytest.mark.parametrize("task,algo,randomize", CASES)
def test_load_cfg_matches_jax(task, algo, randomize):
    argv = _argv(task, algo, randomize, "--seed", "7", "--num_envs", "64")
    assert p_config.load_cfg(p_config.get_args(argv)) == \
        j_config.load_cfg(j_config.get_args(argv))
    plain = _argv(task, algo, randomize, "--seed", "3", "--episode_length", "50")
    assert p_config.load_cfg(p_config.get_args(plain)) == \
        j_config.load_cfg(j_config.get_args(plain))


def test_seed_minus_one_draws_one():
    cfg, cfg_train, logdir = p_config.load_cfg(p_config.get_args([]))
    assert 0 <= cfg["seed"] == cfg_train["seed"] <= 10000
    assert logdir.endswith(f"seed{cfg['seed']}")
    assert cfg["env"]["numEnvs"] == 128 and cfg["task"]["randomize"] is False


def _spec_view(env):
    spec = env.spec
    out = {k: getattr(spec, k) for k in SPEC_FIELDS}
    out["gravity"] = tuple(float(g) for g in out["gravity"])
    out["contact"] = spec.contact._asdict()
    out.update(max_episode_length=env.max_episode_length, randomize=env.randomize,
               dr_frequency=env.dr_frequency, mass_setup_only=env._dr_mass_setup_only,
               box=spec.box_sys is not None)
    return out


@pytest.mark.parametrize("task", ["TenAnt", "OneAnt"])
@pytest.mark.parametrize("randomize", [False, True])
def test_env_spec_matches_jax(task, randomize):
    cfg, _, _ = p_config.load_cfg(p_config.get_args(_argv(task, "ppo", randomize, "--seed", "1")))
    jcfg, _, _ = j_config.load_cfg(j_config.get_args(_argv(task, "ppo", randomize, "--seed", "1")))
    assert cfg == jcfg
    penv = p_registry.build_env(task, cfg, multi_agent=False, device="cpu")
    jenv = j_registry.build_env(task, jcfg, multi_agent=False)
    view = _spec_view(penv)
    assert view == _spec_view(jenv)
    assert view["contact"]["stiffness"] == 2500.0 and view["contact"]["damping"] == 25.0
    assert (view["dr_spec"] is not None) == randomize == penv.randomize
    assert cfg["env"]["numEnvs"] == 128


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def test_ppo_config_from_cfg_train_matches_jax():
    cfg_train = yaml_lite.load(f"{p_config.CFG_ROOT}/ppo/config.yaml")
    got = _fields(p_ppo.PPOConfig.from_cfg_train(cfg_train))
    assert got == _fields(j_ppo.PPOConfig.from_cfg_train(cfg_train))
    assert got["hidden"] == (1024, 1024, 512) and got["gamma"] == 0.96
    assert _fields(p_ppo.PPOConfig.from_cfg_train({})) == _fields(p_ppo.PPOConfig())


@pytest.mark.parametrize("algo", ["mappo", "ippo", "happo", "hatrpo"])
def test_marl_config_from_cfg_train_matches_jax(algo):
    cfg_train = yaml_lite.load(f"{p_config.CFG_ROOT}/{algo}/config.yaml")
    assert _fields(PMarlConfig.from_cfg_train(cfg_train, algo)) == \
        _fields(JMarlConfig.from_cfg_train(cfg_train, algo))


def test_cli_trains_what_the_jax_cli_trains(monkeypatch):
    monkeypatch.setattr(p_ppo.PPO, "run", lambda self, n=None: self.state)
    monkeypatch.setattr(j_ppo.PPO, "run", lambda self, n=None, log_interval=1: self.state)
    argv = ["--task", "TenAnt", "--algo", "ppo", "--seed", "5"]
    port = p_cli.main(argv + ["--device", "cpu"])
    ref = j_cli.train(j_config.get_args(argv))
    assert port.num_envs == ref.num_envs == 128
    assert _spec_view(port.env) == _spec_view(ref.env)
    assert _fields(port.cfg) == _fields(ref.cfg)


@pytest.mark.parametrize("algo,recurrent", [("mat", False), ("maddpg", False),
                                            ("mappo", True)])
def test_cli_builds_the_marl_runner_the_jax_cli_builds(algo, recurrent, monkeypatch, tmp_path):
    from massive_marl_tpu.algos.marl import maddpg as j_maddpg, mat as j_mat
    from massive_marl_tpu.algos.marl import recurrent_runner as j_rec
    from massive_marl_tpu_torch.algos.marl import maddpg as p_maddpg, mat as p_mat
    from massive_marl_tpu_torch.algos.marl import recurrent_runner as p_rec
    for cls in (j_mat.MatRunner, j_maddpg.MaddpgRunner, j_rec.RecurrentMarlRunner,
                p_mat.MatRunner, p_maddpg.MaddpgRunner, p_rec.RecurrentMarlRunner):
        monkeypatch.setattr(cls, "run", lambda self, *a, **k: self.state)
    argv = ["--task", "TenAnt", "--algo", algo, "--seed", "5", "--num_envs", "16"]
    if recurrent:
        src = open(f"{p_config.CFG_ROOT}/{algo}/config.yaml").read()
        assert src.count("use_recurrent_policy: false\n") == 1
        path = tmp_path / "recurrent.yaml"
        path.write_text(src.replace("use_recurrent_policy: false\n",
                                    "use_recurrent_policy: true\n"))
        argv += ["--cfg_train", str(path)]
    port = p_cli.main(argv + ["--device", "cpu"])
    ref = j_cli.train(j_config.get_args(argv))
    assert type(port).__name__ == type(ref).__name__ == \
        {"mat": "MatRunner", "maddpg": "MaddpgRunner"}.get(algo, "RecurrentMarlRunner")
    assert port.num_envs == ref.num_envs == 16 and port.seed == ref.seed == 5
    assert (port.N, port.obs_dim, port.act_dim) == (ref.N, ref.obs_dim, ref.act_dim) == (10, 46, 8)
    assert _spec_view(port.env) == _spec_view(ref.env)
    assert _fields(port.cfg) == _fields(ref.cfg)
    assert getattr(port.cfg, "use_recurrent_policy", False) == recurrent


def test_cli_refuses_what_is_not_ported():
    with pytest.raises(SystemExit):
        p_cli.main(["--task", "OneAnt", "--algo", "happo", "--device", "cpu"])


OTHER_ALGOS = ["mtppo", "mttrpo", "mtsac", "random", "mamlppo", "ppo_collect", "td3_bc", "bcq",
               "iql", "mtppo_three_tasks"]


def _patch_other(monkeypatch):
    """No-op runs (and online evaluations) for both packages' multi-task,
    meta and offline trainers."""
    from massive_marl_tpu.algos.metarl import maml as j_maml
    from massive_marl_tpu.algos.mtrl import mtppo as j_mtppo, mtsac as j_mtsac
    from massive_marl_tpu.algos.offrl import collect as j_collect, trainers as j_off
    from massive_marl_tpu_torch.algos.metarl import maml as p_maml
    from massive_marl_tpu_torch.algos.mtrl import mtppo as p_mtppo, mtsac as p_mtsac
    from massive_marl_tpu_torch.algos.offrl import collect as p_collect, trainers as p_off
    for cls in (j_mtppo.MTPPO, j_mtsac.MTSAC, j_mtppo.RandomPolicyRunner, j_maml.MAMLPPO,
                j_collect.PPOCollect, j_off.OfflineTrainer, p_mtppo.MTPPO, p_mtsac.MTSAC,
                p_mtppo.RandomPolicyRunner, p_maml.MAMLPPO, p_collect.PPOCollect,
                p_off.OfflineTrainer):
        monkeypatch.setattr(cls, "run", lambda self, *a, **k: {})
    for cls in (j_off.OfflineTrainer, p_off.OfflineTrainer):
        monkeypatch.setattr(cls, "eval_online", lambda self, *a, **k: 0.0)


def _env_view(env):
    return type(env).__name__, env.num_obs, env.num_actions * env.num_agents


@pytest.mark.parametrize("case", OTHER_ALGOS)
def test_cli_builds_what_the_jax_cli_builds(case, monkeypatch, tmp_path):
    import numpy as np

    from massive_marl_tpu_torch.algos.offrl import datasets as p_data
    _patch_other(monkeypatch)
    monkeypatch.chdir(tmp_path)
    algo = case.split("_three")[0]
    task = "OneAnt" if algo in p_config.OFFRL_ALGOS else "TenAnt"
    argv = ["--task", task, "--algo", algo, "--seed", "5", "--num_envs", "16",
            "--logdir", str(tmp_path / "logs")]
    if case == "mtppo_three_tasks":
        src = open(f"{p_config.CFG_ROOT}/mtppo/config.yaml").read()
        assert src.endswith("tasks:\n- OneAnt\n- MultiAntCircle\n")
        path = tmp_path / "three.yaml"
        path.write_text(src + "- TenAnt\n")
        argv += ["--cfg_train", str(path)]
    if algo in ("td3_bc", "bcq", "iql"):
        rng = np.random.default_rng(0)
        p_data.save_dataset(p_data.dataset_dir("./datasets", "OneAnt", "expert"),
                            states=rng.normal(size=(64, 60)), actions=rng.uniform(-1, 1, (64, 8)),
                            rewards=rng.normal(size=(64, 1)), dones=np.zeros((64, 1)),
                            next_states=rng.normal(size=(64, 60)))
    port = p_cli.main(argv + ["--device", "cpu"])
    ref = j_cli.train(j_config.get_args(argv))
    assert type(port).__name__ == type(ref).__name__
    if algo in p_config.MTRL_ALGOS:
        want = ["OneAnt", "MultiAntCircle"] + (["TenAnt"] if "three" in case else [])
        assert list(port.envs) == list(ref.envs) == want
        assert {t: _env_view(e) for t, e in port.envs.items()} == \
            {t: _env_view(e) for t, e in ref.envs.items()}
        assert port.num_envs == ref.num_envs == 16
        if algo == "random":
            return
        assert port.task_names == ref.task_names == sorted(want)
        assert port.seed == ref.seed == 5 and port.obs_dim == ref.obs_dim
        assert _fields(port.cfg) == _fields(ref.cfg)
    elif algo == "mamlppo":
        assert _env_view(port.env) == _env_view(ref.env) == ("TenAntEnv", 388, 80)
        assert (port.num_envs, port.seed) == (ref.num_envs, ref.seed) == (16, 5)
        assert _fields(port.cfg) == _fields(ref.cfg)
    elif algo == "ppo_collect":
        assert _env_view(port.env) == _env_view(ref.env) == ("OneAntEnv", 60, 8)
        assert port.num_envs == ref.num_envs == 16
        assert (port.out_dir, port.collect_steps) == (ref.out_dir, ref.collect_steps) == \
            ("./datasets/OneAnt_expert", 100_000)
        assert _fields(port.ppo.cfg) == _fields(ref.ppo.cfg)
    else:
        assert _fields(port.cfg) == _fields(ref.cfg) and port.cfg.algo == algo
        assert (port.obs_dim, port.act_dim, port.N, port.seed) == \
            (ref.obs_dim, ref.act_dim, ref.N, ref.seed) == (60, 8, 64, 5)
