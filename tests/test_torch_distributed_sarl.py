"""The single-agent trainers on 4 gloo ranks against one process (the
port's counterpart of tests/test_distributed.py's PPO, TRPO and off-policy
cases).

One module-scoped launch (parallel/launch.py, this file as the ranks'
module) runs one iteration of each trainer with a mesh of 4 data ranks on
E = 8 envs of `DToy`, tests/test_torch_maml.py's PToy whose reset draws
over the global env axis (parallel/mesh.draw), while this process runs the
same iterations without a mesh.  Per trainer:
  * the parameters against the 1-process run at the JAX test's tolerance
    (PPO rtol 2e-4 / atol 1e-4; SAC, TD3 2e-4 / 2e-4; TRPO 5e-3 / 5e-4:
    conjugate gradient and the line search amplify reduction-order noise),
    the metrics at the JAX test's tolerance;
  * each rank held E / 4 envs (and ring columns);
  * every rank's parameters and optimizer state have the same sha256.
"""
import os

import numpy as np
import pytest
import torch

from massive_marl_tpu_torch.algos.rl.offpolicy import OffPolicy, OffPolicyConfig
from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
from massive_marl_tpu_torch.algos.rl.trpo import TRPO, TRPOConfig
from massive_marl_tpu_torch.parallel import mesh as meshlib
from massive_marl_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_maml import PToy
from tests.test_torch_mesh import R, gather_digest, run_ranks

E = 2 * R


class DToy(PToy):
    """PToy whose reset draws over the global env axis under a mesh (the
    same numbers as PToy's without one)."""

    def reset(self, num_envs):
        return self.state_at(meshlib.draw(torch.rand, (num_envs,), self.generator) * 4.0 - 2.0)


def _ppo(mesh):
    cfg = PPOConfig(nsteps=4, nminibatches=2, noptepochs=2, hidden=(32, 32))
    t = PPO(DToy(), E, cfg, seed=0, device="cpu", print_log=False, mesh=mesh)
    t.init_state()
    m = t.train_iter()
    return dict(params=list(t.model.parameters()), opt=t.state.opt.mu + t.state.opt.nu,
                metrics=m, rows=t.state.env_state.pos.shape[0])


def _trpo(mesh):
    cfg = TRPOConfig(nsteps=4, cg_nsteps=4, vf_epochs=2, hidden=(32, 32))
    t = TRPO(DToy(), E, cfg, seed=0, device="cpu", print_log=False, mesh=mesh)
    t.init_state()
    m = t.train_iter()
    return dict(params=list(t.actor.parameters()) + list(t.critic.parameters()),
                opt=t.state.vf_opt.mu + t.state.vf_opt.nu, metrics=m,
                rows=t.state.env_state.pos.shape[0])


def _offpolicy(algo):
    def run(mesh):
        cfg = OffPolicyConfig(algo=algo, nsteps=4, noptepochs=1, nminibatches=2,
                              replay_size=16, batch_size=4, hidden_nodes=32, hidden_layer=2)
        t = OffPolicy(DToy(), E, cfg, seed=0, device="cpu", print_log=False, mesh=mesh)
        t.init_state()
        m = t.train_iter()
        st = t.state
        return dict(params=tree_leaves(st.params) + tree_leaves(st.target_params),
                    opt=st.opt_q.mu + st.opt_q.nu + st.opt_pi.mu + st.opt_pi.nu, metrics=m,
                    rows=st.env_state.pos.shape[0], ring=st.replay.obs.shape[1])
    return run


CASES = {"ppo": _ppo, "trpo": _trpo, "sac": _offpolicy("sac"), "td3": _offpolicy("td3")}
# (params rtol, atol), (metrics rtol, atol): tests/test_distributed.py's
TOL = {"ppo": ((2e-4, 1e-4), (5e-4, 5e-5)), "trpo": ((5e-3, 5e-4), (1e-3, 1e-4)),
       "sac": ((2e-4, 2e-4), (1e-3, 1e-4)), "td3": ((2e-4, 2e-4), (1e-3, 1e-4))}


def host(res):
    """A case's result with tensors on the host and metrics as floats."""
    out = dict(res, params=[p.detach().clone() for p in res["params"]],
               metrics={k: float(v) for k, v in res["metrics"].items()})
    if "grad" in res:
        out["grad"] = res["grad"].detach().clone()
    return out


def rank_main(cases):
    """Each rank: every case with the 4-rank mesh; rank 0 saves the results
    and every rank's digest of its parameters and optimizer state."""
    torch.set_num_threads(1)
    assert meshlib.init_distributed(device="cpu")
    mesh = meshlib.make_mesh()
    out = {}
    for name, fn in cases.items():
        res = fn(mesh)
        res["digests"] = gather_digest(list(res["params"]) + list(res.pop("opt")))
        out[name] = host(res)
    if mesh.rank == 0:
        torch.save(out, os.environ["MMT_TEST_OUT"])


def launched(module, cases, tmp_path_factory):
    """(the ranks' results, this process's 1-process results) per case."""
    out = tmp_path_factory.mktemp("ranks") / "results.pt"
    t = run_ranks(module, out)
    ref = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the ranks' CPU kernels, to the bit
    try:
        for name, fn in cases.items():
            res = fn(None)
            res.pop("opt")
            ref[name] = host(res)
    finally:
        torch.set_num_threads(threads)
    t.join()
    assert t.rc == 0, f"a rank failed (exit code {t.rc})"
    return torch.load(out), ref


def check(got, ref, tol):
    (prt, pat), (mrt, mat) = tol
    assert len(got["params"]) == len(ref["params"])
    for i, (a, b) in enumerate(zip(got["params"], ref["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=prt, atol=pat,
                                   err_msg=f"leaf {i}")
    for k, v in ref["metrics"].items():
        assert np.isfinite(got["metrics"][k]), k
        np.testing.assert_allclose(got["metrics"][k], v, rtol=mrt, atol=mat, err_msg=k)
    assert got["rows"] == ref["rows"] // R
    if "ring" in ref:
        assert got["ring"] == ref["ring"] // R
    assert len(got["digests"]) == R and len(set(got["digests"])) == 1


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launched("tests.test_torch_distributed_sarl", CASES, tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_one_process(results, name):
    got, ref = results
    check(got[name], ref[name], TOL[name])


if __name__ == "__main__":
    rank_main(CASES)
