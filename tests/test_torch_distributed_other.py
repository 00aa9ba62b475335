"""The multi-task, meta and offline trainers on 4 gloo ranks against one
process (the port's counterpart of tests/test_distributed.py's MTPPO,
MTTRPO, MTSAC, MAML and offline cases; tests/test_torch_distributed_sarl.py's
harness).

  * MTPPO, MTTRPO and MTSAC on two DToy tasks of E = 8 envs each, one
    iteration: parameters at 2e-4 (MTTRPO 5e-3 / 5e-4, the JAX test's);
  * MAML-PPO, one meta-iteration of 2 slots on E = 8: the meta-gradient is
    second order through the ranks' mean inner gradient (Mesh.mean_diff),
    and agrees with one process's within 1% of its norm (the first-order
    one is tens of percent off, tests/test_torch_maml.py); parameters at
    5e-3 / 5e-4, meta_loss and mean_reward at 2e-3 / 2e-4;
  * TD3+BC, IQL and BCQ, two steps on a 256-row numpy dataset with
    batch_size 32 (8 rows a rank): parameters at 2e-4, q_loss at 1e-3 /
    1e-4;
  * each rank held E / 4 envs (the offline trainers batch_size / 4 rows,
    MTSAC's ring E / 4 columns), and every rank's parameters and optimizer
    state have the same sha256;
  * the CLI on 2 ranks refuses these families with the JAX CLI's message
    (they run single-process there).
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from massive_marl_tpu_torch.algos.metarl.maml import MAMLConfig, MAMLPPO
from massive_marl_tpu_torch.algos.mtrl.mtppo import MTPPO, MTPPOConfig
from massive_marl_tpu_torch.algos.mtrl.mtsac import MTSAC, MTSACConfig
from massive_marl_tpu_torch.algos.mtrl.mttrpo import MTTRPO, MTTRPOConfig
from massive_marl_tpu_torch.algos.offrl.trainers import OfflineConfig, OfflineTrainer
from massive_marl_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_distributed_sarl import DToy, check, launched, rank_main
from tests.test_torch_mesh import R, rank_env

E = 2 * R
_rng = np.random.RandomState(0)
DATA = dict(states=_rng.randn(256, 6).astype(np.float32),
            actions=np.tanh(_rng.randn(256, 2)).astype(np.float32),
            rewards=_rng.randn(256, 1).astype(np.float32),
            dones=(_rng.rand(256, 1) < 0.05).astype(np.float32),
            next_states=_rng.randn(256, 6).astype(np.float32))


def _mt(cls, cfg):
    def run(mesh):
        t = cls({"a": DToy(0), "b": DToy(1)}, E, cfg, seed=0, device="cpu", print_log=False,
                mesh=mesh)
        t.run(1)
        st = t.state
        if cls is MTSAC:
            params = tree_leaves(st.params) + tree_leaves(st.target_params)
            opt = st.opt_q.mu + st.opt_q.nu + st.opt_pi.mu + st.opt_pi.nu
            extra = dict(ring=st.replay.obs.shape[1])
        else:
            params, opt, extra = list(t.model.parameters()), st.opt.mu + st.opt.nu, {}
        return dict(params=params, opt=opt, metrics=t.last_metrics,
                    rows=st.env_states["a"].pos.shape[0], **extra)
    return run


def _maml(mesh):
    cfg = MAMLConfig(support_steps=4, query_steps=4, meta_batch_size=2, adapt_steps=1,
                     hidden=(32, 32))
    t = MAMLPPO(DToy(), E, cfg, seed=0, device="cpu", print_log=False, mesh=mesh)
    t.init_state()
    meta_grads, seen = t.meta_grads, []
    t.meta_grads = lambda **kw: seen.append(meta_grads(**kw)) or seen[-1]
    m = t.meta_iter()
    return dict(params=list(t.model.parameters()), opt=t.state.opt.mu + t.state.opt.nu,
                metrics=m, rows=t.state.env_states[0].pos.shape[0],
                grad=torch.cat([g.reshape(-1) for g in seen[0][0]]))


def _offline(algo):
    def run(mesh):
        cfg = OfflineConfig(algo=algo, batch_size=32, hidden=32, layers=2)
        t = OfflineTrainer("toy", "expert", cfg, seed=0, print_log=False, data=dict(DATA),
                           device="cpu", mesh=mesh)
        t.init_state()
        for _ in range(2):
            q = t.train_step()
        st = t.state
        return dict(params=tree_leaves(st.params) + tree_leaves(st.target_params),
                    opt=[x for o in st.opts.values() for x in o.mu + o.nu],
                    metrics={"q_loss": q}, rows=t.mesh.local(cfg.batch_size))
    return run


CASES = {
    "mtppo": _mt(MTPPO, MTPPOConfig(nsteps=4, noptepochs=2, nminibatches=1, hidden=(32, 32))),
    "mttrpo": _mt(MTTRPO, MTTRPOConfig(nsteps=4, cg_nsteps=4, vf_epochs=2, hidden=(32, 32))),
    "mtsac": _mt(MTSAC, MTSACConfig(algo="sac", nsteps=4, replay_size=16, batch_size=8,
                                    noptepochs=1, nminibatches=1, hidden_nodes=32,
                                    hidden_layer=2)),
    "maml": _maml,
    "td3_bc": _offline("td3_bc"),
    "iql": _offline("iql"),
    "bcq": _offline("bcq"),
}
FIRST = ((2e-4, 2e-4), (1e-3, 1e-4))
TOL = dict({k: FIRST for k in CASES}, mttrpo=((5e-3, 5e-4), (1e-3, 1e-4)),
           maml=((5e-3, 5e-4), (2e-3, 2e-4)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launched("tests.test_torch_distributed_other", CASES, tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_one_process(results, name):
    got, ref = results
    check(got[name], ref[name], TOL[name])
    if "grad" in ref[name]:
        g, r = got[name]["grad"], ref[name]["grad"]
        assert float(torch.linalg.vector_norm(g - r)) < 1e-2 * float(torch.linalg.vector_norm(r))


@pytest.mark.parametrize("algo", ["mtppo", "mamlppo", "td3_bc"])
def test_cli_other_families_raise_on_several_ranks(tmp_path, algo):
    r = subprocess.run([sys.executable, "-m", "massive_marl_tpu_torch.parallel.launch",
                        "--nproc", "2", "--backend", "gloo", "--timeout", "60", "--",
                        "--task", "TenAnt", "--algo", algo, "--device", "cpu",
                        "--logdir", str(tmp_path)],
                       env=rank_env(tmp_path / "unused"), capture_output=True, text=True,
                       timeout=90)
    assert r.returncode != 0
    assert (f"NotImplementedError: multi-process CLI launch supports the SARL and MARL "
            f"families; --algo {algo} runs single-process") in r.stderr


if __name__ == "__main__":
    rank_main(CASES)
