"""The MARL trainers on 4 gloo ranks against one process (the port's
counterpart of tests/test_distributed.py's MARL, MAT, MADDPG and recurrent
cases).

One module-scoped launch runs one iteration of each trainer with a mesh of
4 data ranks on E = 8 envs of `DTeam`, tests/test_torch_recurrent.py's
PTeamEnv whose draws are over the global env axis, while this process runs
the same iterations without a mesh (tests/test_torch_distributed_sarl.py's
harness).  The cases:
  * MAPPO (2 minibatches) and HAPPO (2 minibatches) on the flax-mirror path,
    whose global permutation leaves each rank a different share of a
    minibatch: parameters at the JAX test's 2e-4, metrics at 1e-3 / 1e-4;
  * HATRPO on the flax-mirror path: every agent's trust-region step took
    the same number of Fisher products and accepted the same line-search
    candidate, the metrics agree at 1e-3 / 1e-4, and each actor leaf's
    difference, over the distance the 1-process step moved it, is within
    3 x the 1-process spread (`hatrpo_spread`), rtol 5e-3 with an atol of
    3 x that spread's largest entry.  The JAX test's 2e-4 is below the
    port's own spread: its 1-process HATRPO moves entries by more than
    2e-4 when its gradient and Fisher products are perturbed by 1e-7
    relative, since conjugate gradient on the Fisher product through bf16
    layers amplifies any change of rounding (`test_hatrpo_spread`);
  * MAPPO on the fused path (the kernels' plain versions) with 2
    minibatches: shard-local minibatches and averaged gradients, as JAX's
    shard_map, against a 1-process oracle (`ShardLocalOracle`) whose
    minibatches are the union of the 4 ranks' shard-local ones;
  * MAT, MADDPG (one collect-only and one training iteration), recurrent
    MAPPO (chunks of 2, 2 minibatches) and recurrent HAPPO at 2e-4;
  * each rank held E / 4 envs (and MADDPG ring columns), and every rank's
    parameters and optimizer state have the same sha256.
"""
import pytest
import torch

from massive_marl_tpu_torch.algos.marl.maddpg import MaddpgConfig, MaddpgRunner
from massive_marl_tpu_torch.algos.marl.mat import MatConfig, MatRunner
from massive_marl_tpu_torch.algos.marl.recurrent_runner import RecurrentMarlRunner
from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
from massive_marl_tpu_torch.parallel import mesh as meshlib
from massive_marl_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_distributed_sarl import check, launched, rank_main
from tests.test_torch_mesh import R
from tests.test_torch_recurrent import PTeamEnv

E = 2 * R


class DTeam(PTeamEnv):
    """PTeamEnv drawing its resets over the global env axis under a mesh."""

    def __init__(self):
        super().__init__(fresh=None)

    def _draw(self, n):
        return meshlib.draw(torch.rand, (n, 3), self.generator) * 4.0 - 2.0


class ShardLocalOracle(MarlRunner):
    """One process forming each minibatch as the union of the R ranks'
    shard-local ones: the same permutation of every rank's B / R rows."""

    def _minibatches(self, B, nmb):
        Bl, El = B // R, self.num_envs // R
        mbs = Bl // nmb
        p = torch.randperm(Bl, generator=self.generator)[: nmb * mbs].reshape(nmb, mbs)
        t, e = p // El, p % El
        return [torch.cat([t[m] * self.num_envs + s * El + e[m] for s in range(R)])
                for m in range(nmb)]


def _marl(algo, oracle=MarlRunner, **kw):
    def run(mesh):
        fused = kw.get("use_fused_mlp", False)
        cfg = MarlConfig(algorithm_name=algo, episode_length=4, ppo_epoch=2,
                         hidden_size=128 if fused else 32, layer_n=1, **kw)
        cls = RecurrentMarlRunner if cfg.use_recurrent_policy else \
            (MarlRunner if mesh is not None else oracle)
        r = cls(DTeam(), E, cfg, seed=0, device="cpu", print_log=False, mesh=mesh)
        r.init_state()
        start = [x.clone() for x in tree_leaves(r.state.actor_params)]
        m = r.train_iter()
        st = r.state
        assert r.use_fused == fused
        search = [(d["fvps"], d["accepted"]) for d in r.trpo_log]
        return dict(search=search, start=start,
                    params=tree_leaves(st.actor_params) + tree_leaves(st.critic_params)
                    + [st.vnorm.mean, st.vnorm.mean_sq],
                    opt=st.actor_opt.mu + st.actor_opt.nu + st.critic_opt.mu + st.critic_opt.nu,
                    metrics={k: m[k] for k in ("mean_reward", "value_loss", "policy_loss")},
                    rows=st.env_state.pipeline.shape[0])
    return run


def _mat(mesh):
    r = MatRunner(DTeam(), E, MatConfig(episode_length=4, ppo_epoch=2, embed=16, blocks=1),
                  seed=0, device="cpu", print_log=False, mesh=mesh)
    r.init_state()
    m = r.train_iter()
    return dict(params=tree_leaves(r.state.params), opt=r.state.opt.mu + r.state.opt.nu,
                metrics={k: m[k] for k in ("mean_reward", "value_loss")},
                rows=r.state.env_state.pipeline.shape[0])


def _maddpg(mesh):
    cfg = MaddpgConfig(nsteps=4, replay_size=16, batch_size=4, hidden=32, layers=2)
    r = MaddpgRunner(DTeam(), E, cfg, seed=0, device="cpu", print_log=False, mesh=mesh)
    r.init_state()
    r.train_iter(update=False)
    m = r.train_iter()
    st = r.state
    return dict(params=tree_leaves(st.actor_params) + tree_leaves(st.critic_params),
                opt=st.actor_opt.mu + st.actor_opt.nu + st.critic_opt.mu + st.critic_opt.nu,
                metrics={k: m[k] for k in ("mean_reward", "critic_loss")},
                rows=st.env_state.pipeline.shape[0], ring=st.replay.obs.shape[1])


CASES = {
    "mappo": _marl("mappo", num_mini_batch=2),
    "happo": _marl("happo", num_mini_batch=2),
    "hatrpo": _marl("hatrpo"),
    "mappo_fused": _marl("mappo", ShardLocalOracle, num_mini_batch=2, use_fused_mlp=True),
    "mat": _mat,
    "maddpg": _maddpg,
    "rmappo": _marl("mappo", num_mini_batch=2, use_recurrent_policy=True,
                    data_chunk_length=2),
    "rhappo": _marl("happo", use_recurrent_policy=True, data_chunk_length=2),
}
FIRST = ((2e-4, 2e-4), (1e-3, 1e-4))
TOL = {k: FIRST for k in CASES}


def _moved(res, ref):
    """Per actor leaf: |res - ref| over the distance ref's step moved it."""
    return [float((a - b).norm() / (b - s).norm())
            for a, b, s in zip(res["params"], ref["params"], ref["start"])]


@pytest.fixture(scope="module")
def hatrpo_spread():
    """The 1-process HATRPO iteration against itself with its gradient and
    every Fisher-vector product perturbed by 1e-7 relative (3 draws): the
    largest entry moved and the largest per-leaf `_moved` ratio."""
    import massive_marl_tpu_torch.algos.marl.runner as runner_mod
    base = _marl("hatrpo")(None)
    flat, mp = runner_mod._flat, pytest.MonkeyPatch()
    most, rel = 0.0, 0.0
    try:
        for seed in (1, 2, 3):
            g = torch.Generator().manual_seed(seed)
            mp.setattr(runner_mod, "_flat", lambda ts, g=g: (lambda v: v * (
                1 + 1e-7 * torch.randn(v.shape, generator=g)))(flat(ts)))
            res = _marl("hatrpo")(None)
            most = max([most] + [float((a - b).abs().max())
                                 for a, b in zip(res["params"], base["params"])])
            rel = max([rel] + _moved(res, base))
    finally:
        mp.undo()
    return most, rel


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launched("tests.test_torch_distributed_marl", CASES, tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_one_process(results, name, request):
    got, ref = results
    tol = TOL[name]
    if name == "hatrpo":
        most, rel = request.getfixturevalue("hatrpo_spread")
        tol = ((5e-3, 3 * most), FIRST[1])
        assert max(_moved(got[name], ref[name])) <= 3 * rel
    check(got[name], ref[name], tol)
    assert got[name].get("search") == ref[name].get("search")


def test_hatrpo_spread(hatrpo_spread):
    """The 1-process spread exceeds the JAX test's 2e-4, and stays a small
    part of the step: the 4-rank tolerance still fails an update that
    moved the parameters elsewhere."""
    most, rel = hatrpo_spread
    assert most > 2e-4 and rel < 0.2, hatrpo_spread


if __name__ == "__main__":
    rank_main(CASES)
