"""PPO's update as one CUDA graph (algos/rl/update_graph.py) and the Adam
step it relies on.

CPU tests: every reason the graph refuses an update is named by
`PPOUpdateGraph.refusal` (the device pretended to be a CUDA one for all but
the CPU case), and two small TenAnt updates of each case run eagerly on the
CPU, counted in `eager_updates` with no capture or replay, with state.lr
overwritten in place; adam_update fed the bias corrections' reciprocals
as float32 tensors takes Adam's step to within two float32 ulps of the
Python floats' path, step by step over counts 0-2,000, with and without the
clip (on the CPU a Python float divides; the bits are the card's test);
the table the host writes before a replay holds at row k the reciprocals
of step count + k, and an update body run as the capture
runs it hands row k to its k-th Adam step and leaves the host count where
it was; the graph's key holds after an update and changes after `load` and
`init_state`.

Tests marked `cuda`: the same Adam steps on the card, where the tensor
form gives the Python floats' bits; TenAnt + PPO at the tenant-ppo cell's widths
(hidden 1024-1024-512, E = 4096) twice from the same seeds, once graphed
and once with the graph held off (the holder's eligibility check replaced
for that trainer alone): every parameter, Adam moment, the host step count,
the lr and every returned metric equal bit for bit after each of 4
iterations (eager, capture, replay, replay); after `load` from a checkpoint
the graphed trainer captures anew and 2 more iterations still match.  They
import nothing of JAX, so on the GPU host they run without the repository's
JAX conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ppo_update_graph.py -m cuda
"""
import pytest
import torch

from massive_marl_tpu_torch.algos.rl import ppo as ppo_mod
from massive_marl_tpu_torch.algos.rl.ppo import (PPO, AdamState, PPOConfig, adam_scalars,
                                                 adam_update)
from massive_marl_tpu_torch.algos.rl.update_graph import PPOUpdateGraph, state_tensors
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.parallel.mesh import Mesh

SMALL = dict(hidden=(32, 32), nsteps=2, noptepochs=2, nminibatches=2)
E_SMALL = 4


def _override(name):
    """An instance attribute in place of PPO.<name> that calls it."""
    def install(trainer):
        method = getattr(trainer, name)
        setattr(trainer, name, lambda *a, **kw: method(*a, **kw))
    return install


# case: (trainer keywords, what to do to the trainer, the refusal with a CUDA device)
CASES = {
    "cpu": ({}, None, None),
    "mesh": ({"mesh": Mesh(1)}, None, "a mesh"),
    "loss_overridden": ({}, _override("_loss"), "_loss overridden on the trainer"),
    "step_overridden": ({}, _override("_step"), "_step overridden on the trainer"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A worker shares its host's cores with the others: small CPU ops run
    fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_trainer(case="cpu"):
    kw, change, _ = CASES[case]
    env = TenAntEnv({"sim": {"substeps": 1}}, device="cpu", seed=3)
    trainer = PPO(env, E_SMALL, PPOConfig(**SMALL), seed=1, device="cpu", print_log=False, **kw)
    trainer.init_state()
    if change is not None:
        change(trainer)
    return trainer


@pytest.mark.parametrize("case", list(CASES))
def test_refusal_names_what_keeps_the_update_eager(case):
    trainer = _small_trainer(case)
    if case == "cpu":
        assert PPOUpdateGraph.refusal(trainer) == "not a CUDA device"
        trainer.device = torch.device("cuda")     # pretended: only the predicate runs
        assert PPOUpdateGraph.refusal(trainer) is None
    else:
        trainer.device = torch.device("cuda")
        assert PPOUpdateGraph.refusal(trainer) == CASES[case][2]


@pytest.mark.parametrize("case", list(CASES))
def test_updates_on_the_cpu_run_eagerly(case):
    trainer = _small_trainer(case)
    lr_ptr = trainer.state.lr.data_ptr()
    for _ in range(2):
        m = trainer.train_iter()
        assert all(torch.isfinite(v) for v in m.values())
    g = trainer.update_graph
    assert (g.eager_updates, g.captures, g.replays, g.graph) == (2, 0, 0, None)
    assert trainer.state.iteration == 2
    steps = 2 * SMALL["noptepochs"] * SMALL["nminibatches"]
    assert trainer.state.opt.count == steps
    # the lr is a fixed buffer that the update overwrites
    assert trainer.state.lr.data_ptr() == lr_ptr
    assert torch.equal(trainer.state.lr, m["lr"])


def _adam_pair(device, seed=11):
    """Two copies of (params, Adam state) from one draw, and the draw's
    generator for the gradients."""
    g = torch.Generator().manual_seed(seed)
    start = [torch.randn(s, generator=g).to(device) for s in SHAPES]
    return g, [([p.clone() for p in start],
                AdamState(mu=[torch.zeros_like(p) for p in start],
                          nu=[torch.zeros_like(p) for p in start])) for _ in range(2)]


def _grads(g, count, device):
    """A step's gradients: a large one now and then, so the clip binds."""
    return [(torch.randn(s, generator=g) * (40.0 if count % 7 == 0 else 0.5)).to(device)
            for s in SHAPES]


SHAPES = [(5, 3), (3,), (7,)]


@pytest.mark.parametrize("max_grad_norm", [None, 1.0])
def test_adam_scalars_step_is_the_python_floats_step_within_rounding(max_grad_norm):
    """On the CPU `_foreach_div` by a Python float divides, so the form
    that multiplies by the reciprocals is Adam's step only to float32
    rounding here: each step taken from the same state by both forms."""
    g, ((p0, o0), (p1, o1)) = _adam_pair("cpu")
    lr = torch.tensor(3e-4)
    for count in range(2001):
        grads = _grads(g, count, "cpu")
        adam_update(p0, [x.clone() for x in grads], o0, lr, max_grad_norm)
        scalars = tuple(torch.tensor(x, dtype=torch.float32) for x in adam_scalars(count))
        adam_update(p1, [x.clone() for x in grads], o1, lr, max_grad_norm, scalars=scalars)
        assert o0.count == o1.count == count + 1
        for ref, got in zip(p0 + o0.mu + o0.nu, p1 + o1.mu + o1.nu):
            # two float32 ulps; in the first steps a wrong count or a
            # swapped pair moves a parameter by a quarter of the lr or more
            torch.testing.assert_close(got, ref, rtol=2 ** -22, atol=1e-9,
                                       msg=lambda m: f"count {count}: {m}")
            got.copy_(ref)


def test_replay_table_holds_each_steps_scalars_where_the_capture_reads_them(monkeypatch):
    trainer = _small_trainer()
    opt, g = trainer.state.opt, trainer.update_graph
    K = SMALL["noptepochs"] * SMALL["nminibatches"]
    opt.count = 37
    g.scalars = PPOUpdateGraph.schedule(opt.count, K)
    assert tuple(g.scalars.shape) == (K, 2) and g.scalars.dtype == torch.float32
    # outside a capture the step computes its own
    assert g.step_scalars(opt.count) is None
    g.base = opt.count
    for k in range(K):
        want = torch.tensor(adam_scalars(37 + k), dtype=torch.float32)
        assert torch.equal(torch.stack(g.step_scalars(37 + k)), want)
    # the table holds the bias corrections' reciprocals, which the step
    # multiplies by
    assert torch.equal(g.scalars[1], torch.tensor([1 / (1 - 0.9 ** 39), 1 / (1 - 0.999 ** 39)]))

    # the update's body, as the capture runs it: its k-th Adam step gets row k
    seen = []

    def recording(params, grads, opt, lr, max_grad_norm=None, eps=1e-8, scalars=None):
        seen.append((opt.count, torch.stack(scalars)))
        adam_update(params, grads, opt, lr, max_grad_norm, eps, scalars)

    monkeypatch.setattr(ppo_mod, "adam_update", recording)
    traj = trainer.rollout_phase()
    trainer._update(traj, trainer.state.env_state.obs)
    assert [c for c, _ in seen] == [37 + k for k in range(K)]
    assert all(torch.equal(s, g.scalars[k]) for k, (_, s) in enumerate(seen))


def test_capture_leaves_the_host_count_and_the_key_follows_the_state(tmp_path):
    trainer = _small_trainer()
    traj = trainer.rollout_phase()
    obs = trainer.state.env_state.obs
    key = PPOUpdateGraph._key(trainer, traj, obs)
    trainer.update_phase(traj, obs)
    # the update changes its state in place: a captured graph stays valid
    assert PPOUpdateGraph._key(trainer, traj, obs) == key
    path = str(tmp_path / "model.ckpt")
    trainer.save(path)
    trainer.load(path)
    after_load = PPOUpdateGraph._key(trainer, traj, obs)
    assert after_load != key
    trainer.init_state()
    assert PPOUpdateGraph._key(trainer, traj, obs) not in (key, after_load)
    # another trajectory shape drops it too
    short = {k: v[:1] for k, v in traj.items()}
    assert PPOUpdateGraph._key(trainer, short, obs) != PPOUpdateGraph._key(trainer, traj, obs)


# --------------------------------------------------------------------- card

E = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("max_grad_norm", [None, 1.0])
def test_adam_scalars_as_tensors_give_the_python_floats_bits(cuda, max_grad_norm):
    """The form a replay runs: the reciprocals as float32 device tensors,
    multiplied in, against the Python floats the eager step divides by."""
    g, ((p0, o0), (p1, o1)) = _adam_pair(cuda)
    lr = torch.tensor(3e-4, device=cuda)
    for count in range(2001):
        grads = _grads(g, count, cuda)
        adam_update(p0, [x.clone() for x in grads], o0, lr, max_grad_norm)
        scalars = tuple(torch.tensor(x, dtype=torch.float32, device=cuda)
                        for x in adam_scalars(count))
        adam_update(p1, [x.clone() for x in grads], o1, lr, max_grad_norm, scalars=scalars)
        assert o0.count == o1.count == count + 1
        for ref, got in zip(p0 + o0.mu + o0.nu, p1 + o1.mu + o1.nu):
            assert torch.equal(ref, got), count


def _card_trainer(dev):
    """TenAnt + PPO at the tenant-ppo cell's widths (PPOConfig's defaults:
    hidden 1024-1024-512, nsteps 8, 5 epochs x 4 minibatches)."""
    trainer = PPO(TenAntEnv(device=dev, seed=7), E, PPOConfig(), seed=5, device=dev,
                  print_log=False)
    trainer.init_state()
    return trainer


def _same(graphed, eager, tag):
    """An iteration of each; every state tensor, the host count and every
    metric the same bits."""
    mg, me = graphed.train_iter(), eager.train_iter()
    torch.cuda.synchronize()
    assert mg.keys() == me.keys(), tag
    differ = [k for k in mg if not torch.equal(mg[k], me[k])]
    assert not differ, f"{tag}: metrics {differ} differ"
    assert graphed.state.opt.count == eager.state.opt.count, tag
    differ = [i for i, (a, b) in enumerate(zip(state_tensors(graphed), state_tensors(eager)))
              if not torch.equal(a, b)]
    assert not differ, f"{tag}: state leaves {differ} differ"


@pytest.mark.cuda
def test_graphed_updates_equal_eager_ones_bit_for_bit(cuda, monkeypatch, tmp_path):
    graphed, eager = _card_trainer(cuda), _card_trainer(cuda)
    monkeypatch.setattr(eager.update_graph, "refusal", lambda t: "held off by the test")
    assert PPOUpdateGraph.refusal(graphed) is None
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(graphed), state_tensors(eager)))
    g = graphed.update_graph
    for it, counts in enumerate([(0, 0, 1), (1, 0, 1), (1, 1, 1), (1, 2, 1)]):
        _same(graphed, eager, f"iteration {it}")
        assert (g.captures, g.replays, g.eager_updates) == counts, it
    assert eager.update_graph.eager_updates == 4
    steps = PPOConfig().noptepochs * PPOConfig().nminibatches
    assert graphed.state.opt.count == 4 * steps

    path = str(tmp_path / "model.ckpt")
    graphed.save(path)
    for t in (graphed, eager):
        t.load(path)
    # the restored state lies elsewhere: the next update captures anew
    for it, counts in enumerate([(2, 2, 1), (2, 3, 1)], start=4):
        _same(graphed, eager, f"iteration {it} after load")
        assert (g.captures, g.replays, g.eager_updates) == counts, it
