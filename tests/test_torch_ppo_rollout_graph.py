"""PPO's rollout as one CUDA graph (algos/rl/rollout_graph.py).

CPU tests, on a stub env (no TenAnt build): every reason the graph refuses
a rollout is named by `PPORolloutGraph.refusal` (the device pretended to be
a CUDA one for all but the CPU case), and the ant tasks declare a step
without host reads only on the fused substep path; rollouts on the CPU run
eagerly, counted in `eager_rollouts` with no capture or replay; the graph's
key holds after a rollout and changes after `load`, `init_state`, a new
generator, and an env state of another shape or layout; the static env state keeps each leaf's layout in buffers
of its own; and the body the graph holds, run on the host, gives the eager
rollout's trajectory and leaves its final state in the static buffers.

Tests marked `cuda`: TenAnt + PPO at the tenant-ppo cell's widths with a few
dozen envs and episodes of 6 steps (so envs reset inside every rollout),
twice from the same seeds, once graphed and once with the rollout graph held
off: every trajectory tensor, the final env state and both generators'
states equal bit for bit after each rollout (eager, capture, replays);
after `load` and after a new `init_state` the graphed trainer captures
anew and still matches; a wrapper on `step_batch` keeps its rollout eager,
and once it is gone the next rollout replays from the eager state, copied
in.  They import nothing of JAX, so on the GPU host they run without the
repository's JAX conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ppo_rollout_graph.py -m cuda
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
from massive_marl_tpu_torch.algos.rl.rollout_graph import (PPORolloutGraph, state_leaves,
                                                           static_copy)
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.parallel.mesh import LOCAL, Mesh

SMALL = dict(hidden=(8, 8), nsteps=3, noptepochs=1, nminibatches=2)
E_SMALL = 4


@dataclasses.dataclass
class StubCarry:
    before: torch.Tensor     # a view of the pipeline, as the ant tasks' carry


class StubEnv:
    """A batched env of the ant tasks' EnvState layout: a [E, 2, 3] pipeline,
    a carry that views it, auto-reset from fresh draws on its generator."""
    num_agents, num_actions, num_obs = 1, 2, 6
    max_episode_length = 2
    randomize = False
    device_only_step = True

    def __init__(self, seed=0):
        self.device = torch.device("cpu")
        self.generator = torch.Generator().manual_seed(seed)

    def _fresh(self, n):
        return torch.rand((n, 2, 3), generator=self.generator)

    def _state(self, pipeline, progress, reward):
        return EnvState(pipeline=pipeline, carry=StubCarry(before=pipeline[:, 0, 1:]),
                        progress=progress, done=progress >= self.max_episode_length,
                        obs=pipeline.reshape(pipeline.shape[0], 6), reward=reward)

    def reset(self, n):
        return self._state(self._fresh(n), torch.zeros(n, dtype=torch.int32), torch.zeros(n))

    def step_batch(self, state, actions):
        stepped = state.pipeline + 0.1 * actions.sum(-1)[:, None, None]
        reset = state.done[:, None, None]
        pipeline = torch.where(reset, self._fresh(actions.shape[0]), stepped)
        progress = torch.where(state.done, 0, state.progress + 1).to(torch.int32)
        return self._state(pipeline, progress, (pipeline[:, 0, 1:] - state.carry.before).sum(1))


def _trainer(seed=1):
    trainer = PPO(StubEnv(seed=3), E_SMALL, PPOConfig(**SMALL), seed=seed, device="cpu",
                  print_log=False)
    trainer.init_state()
    return trainer


def _wrap_step(env):
    step = env.step_batch
    env.step_batch = lambda *a, **kw: step(*a, **kw)


def _undeclared(env):
    env.device_only_step = False


# case: (what to do to the trainer, the refusal with a CUDA device)
CASES = {
    "cpu": (None, None),
    "mesh": (lambda t: setattr(t, "mesh", Mesh(1)), "a mesh"),
    "domain_randomization": (lambda t: setattr(t.env, "randomize", True),
                             "domain randomization"),
    "step_batch_overridden": (lambda t: _wrap_step(t.env), "step_batch overridden on the env"),
    "step_not_declared": (lambda t: _undeclared(t.env),
                          "the env's step may read the device on the host"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_refusal_names_what_keeps_the_rollout_eager(case):
    change, want = CASES[case]
    trainer = SimpleNamespace(device=torch.device("cpu"), mesh=LOCAL, env=StubEnv())
    if case == "cpu":
        assert PPORolloutGraph.refusal(trainer) == "not a CUDA device"
    else:
        change(trainer)
    trainer.device = torch.device("cuda")     # pretended: only the predicate runs
    assert PPORolloutGraph.refusal(trainer) == want


@pytest.mark.parametrize("env_cls", [TenAntEnv, OneAntEnv])
@pytest.mark.parametrize("fused", [True, False])
def test_ant_tasks_declare_a_device_only_step_on_the_fused_path(env_cls, fused):
    env = env_cls.__new__(env_cls)     # no build: the declaration reads use_fused alone
    env.use_fused = fused
    assert env.device_only_step is fused


def test_rollouts_on_the_cpu_run_eagerly():
    trainer = _trainer()
    for _ in range(3):
        traj = trainer.rollout_phase()
        assert tuple(traj["obs"].shape) == (SMALL["nsteps"], E_SMALL, 6)
        trainer.update_phase(traj, trainer.state.env_state.obs)
    g = trainer.rollout_graph
    assert (g.eager_rollouts, g.captures, g.replays, g.graph, g.static) == (3, 0, 0, None, None)


def test_key_follows_what_a_replay_relies_on(tmp_path):
    trainer = _trainer()
    key = PPORolloutGraph._key
    k0 = key(trainer)
    trainer.train_iter()
    # a rollout leaves a state of the same layout; the update changes its
    # state in place
    assert key(trainer) == k0
    path = str(tmp_path / "model.ckpt")
    trainer.save(path)
    trainer.load(path)
    k1 = key(trainer)
    assert k1 != k0
    trainer.init_state()
    k2 = key(trainer)
    assert k2 not in (k0, k1)
    trainer.env.generator = torch.Generator().manual_seed(0)
    k3 = key(trainer)
    trainer.generator = torch.Generator().manual_seed(0)
    k4 = key(trainer)
    st = trainer.state
    st.env_state = trainer.env.reset(E_SMALL - 1)
    k5 = key(trainer)
    st.env_state = dataclasses.replace(st.env_state, obs=st.env_state.obs.t().contiguous().t())
    k6 = key(trainer)
    assert len({k2, k3, k4, k5, k6}) == 5


def test_static_copy_keeps_each_leafs_layout_in_buffers_of_its_own():
    state = StubEnv().reset(E_SMALL)
    static = static_copy(state)
    pairs = list(zip(state_leaves(state), state_leaves(static)))
    assert len(pairs) == 6
    assert not state.carry.before.is_contiguous()
    for x, s in pairs:
        assert (s.shape, s.stride(), s.dtype) == (x.shape, x.stride(), x.dtype)
        assert torch.equal(s, x) and s.data_ptr() != x.data_ptr()
    # the carry's view of the pipeline is a buffer of its own in the copy
    assert static.carry.before.untyped_storage().data_ptr() != \
        static.pipeline.untyped_storage().data_ptr()


def test_graph_body_is_the_eager_rollout_into_the_static_buffers():
    graphed, eager = _trainer(), _trainer()
    g = graphed.rollout_graph
    for _ in range(2):
        g.static = static_copy(graphed.state.env_state)
        graphed.state.env_state = g.static
        got = g._body(graphed)
        want = eager.rollout_phase()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert all(torch.equal(a, b) for a, b in zip(state_leaves(g.static),
                                                     state_leaves(eager.state.env_state)))
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    assert torch.equal(graphed.env.generator.get_state(), eager.env.generator.get_state())


# --------------------------------------------------------------------- card

E = 48
EPISODE = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_pair(dev, monkeypatch):
    """Two TenAnt + PPO trainers from the same seeds at the tenant-ppo
    cell's widths (PPOConfig's defaults), the second with its rollout graph
    held off."""
    out = []
    for _ in range(2):
        env = TenAntEnv({"env": {"episodeLength": EPISODE}}, device=dev, seed=7)
        trainer = PPO(env, E, PPOConfig(), seed=5, device=dev, print_log=False)
        trainer.init_state()
        out.append(trainer)
    graphed, eager = out
    monkeypatch.setattr(eager.rollout_graph, "refusal", lambda t: "held off by the test")
    assert PPORolloutGraph.refusal(graphed) is None
    return graphed, eager


def _same_iteration(graphed, eager, tag):
    """A rollout of each, then an update of each on it; the trajectories,
    the final env states and both generators' states the same bits.
    Returns whether an env reset inside the rollout."""
    tg, te = graphed.rollout_phase(), eager.rollout_phase()
    torch.cuda.synchronize()
    assert tg.keys() == te.keys(), tag
    differ = [k for k in te if not torch.equal(tg[k], te[k])]
    assert not differ, f"{tag}: trajectory {differ} differ"
    sg, se = (state_leaves(t.state.env_state) for t in (graphed, eager))
    differ = [i for i, (a, b) in enumerate(zip(sg, se)) if not torch.equal(a, b)]
    assert len(sg) == len(se) and not differ, f"{tag}: env state leaves {differ} differ"
    for name, gen in (("policy", lambda t: t.generator), ("env", lambda t: t.env.generator)):
        assert torch.equal(gen(graphed).get_state(), gen(eager).get_state()), \
            f"{tag}: the {name} generator's state differs"
    for t, traj in ((graphed, tg), (eager, te)):
        t.update_phase(traj, t.state.env_state.obs)
    return bool(te["done"].any())


def _counts(trainer):
    g = trainer.rollout_graph
    return g.eager_rollouts, g.captures, g.replays


@pytest.mark.cuda
def test_replayed_rollouts_equal_eager_ones_bit_for_bit(cuda, monkeypatch):
    graphed, eager = _card_pair(cuda, monkeypatch)
    resets = []
    for it, counts in enumerate([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3)]):
        resets.append(_same_iteration(graphed, eager, f"rollout {it}"))
        assert _counts(graphed) == counts, it
    assert all(resets)
    assert _counts(eager) == (5, 0, 0)
    # the env state stays in the graph's buffers between replays
    assert graphed.state.env_state is graphed.rollout_graph.static


@pytest.mark.cuda
def test_load_and_init_state_capture_anew(cuda, monkeypatch, tmp_path):
    graphed, eager = _card_pair(cuda, monkeypatch)
    for it in range(3):
        _same_iteration(graphed, eager, f"rollout {it}")
    assert _counts(graphed) == (1, 1, 1)
    path = str(tmp_path / "model.ckpt")
    graphed.save(path)
    for t in (graphed, eager):
        t.load(path)
    for it, counts in enumerate([(1, 2, 1), (1, 2, 2)], start=3):
        _same_iteration(graphed, eager, f"rollout {it} after load")
        assert _counts(graphed) == counts, it
    for t in (graphed, eager):
        t.init_state()
    for it, counts in enumerate([(1, 3, 2), (1, 3, 3)], start=5):
        _same_iteration(graphed, eager, f"rollout {it} after init_state")
        assert _counts(graphed) == counts, it


@pytest.mark.cuda
def test_a_wrapped_step_keeps_the_rollout_eager(cuda, monkeypatch):
    graphed, eager = _card_pair(cuda, monkeypatch)
    for it in range(2):
        _same_iteration(graphed, eager, f"rollout {it}")
    _wrap_step(graphed.env)
    assert PPORolloutGraph.refusal(graphed) == "step_batch overridden on the env"
    _same_iteration(graphed, eager, "rollout 2, step wrapped")
    assert _counts(graphed) == (2, 1, 0)
    assert graphed.state.env_state is not graphed.rollout_graph.static
    del graphed.env.step_batch
    # the eager rollout's state is copied into the graph's buffers
    for it, counts in enumerate([(2, 1, 1), (2, 1, 2)], start=3):
        _same_iteration(graphed, eager, f"rollout {it}, wrapper gone")
        assert _counts(graphed) == counts, it
