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
  count and PPOConfig (both trainers' run is replaced by a no-op).
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


def test_cli_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        p_cli.main(["--algo", "mat", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        p_cli.main(["--algo", "mtppo", "--device", "cpu"])
    with pytest.raises(SystemExit):
        p_cli.main(["--task", "OneAnt", "--algo", "happo", "--device", "cpu"])
