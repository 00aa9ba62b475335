"""The MARL runner's update as one CUDA graph (algos/marl/update_graph.py)
and the Adam step it relies on.

CPU tests: every configuration the graph refuses is named by
`UpdateGraph.refusal` (the device pretended to be a CUDA one for all but
the CPU case), and one small TenAnt update of each runs eagerly on the CPU,
counted in `eager_updates` with no capture or replay, RecurrentMarlRunner
too; ClipAdam's step fed its bias corrections and learning rate as float32
tensors gives the bits of the step written with them as Python floats
(kept here as the reference), over counts 0-2,000, with the learning rate
constant and under linear decay; the table the host writes before a replay
holds at [optimizer, agent, k] the scalars of that agent's count + k, where
the captured steps read them.

Tests marked `cuda` run TenAnt + MAPPO at cfg/mappo's widths (N = 10,
hidden 512, observations 46, shared 388) and E = 256 twice from the same
seeds, once graphed and once with the graph held off (the holder's
eligibility check replaced for that runner alone): every parameter, Adam
moment, value-normaliser statistic, host step count and returned loss equal
bit for bit after each of 4 iterations; 1 capture, 2 replays and 1 eager
update; the B2-B5 wrappers are called on the host alike in the eager and
the capturing update and not at all in a replay, whose row-pass kernels,
counted in a torch.profiler trace, are the eager update's and the calls
the capture counted; after `restore` from a checkpoint the graphed runner
captures anew and 2 more iterations still match; the same over 3
iterations under FUSED_TOWER=1 (B4/B5).  They import
nothing of JAX, so on the GPU host they run without the repository's JAX
conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_marl_update_graph.py -m cuda
"""
import contextlib
import types

import pytest
import torch

from massive_marl_tpu_torch.algos.marl.recurrent_runner import RecurrentMarlRunner
from massive_marl_tpu_torch.algos.marl.runner import ClipAdam, MarlConfig, MarlRunner, _lead
from massive_marl_tpu_torch.algos.marl.update_graph import KERNELS, UpdateGraph, state_tensors
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.parallel.mesh import Mesh

SMALL = dict(hidden_size=128, layer_n=1, episode_length=2, ppo_epoch=2, use_fused_mlp=True)
# case: (MarlConfig changes, runner keywords, the refusal with a CUDA device)
CASES = {
    "cpu": ({}, {}, None),
    "stacked": ({"update_schedule": "stacked"}, {},
                "not the sequential schedule on the fused path"),
    "unfused": ({"use_fused_mlp": False}, {}, "not the sequential schedule on the fused path"),
    "happo": ({"algorithm_name": "happo"}, {}, "HAPPO or HATRPO"),
    "hatrpo": ({"algorithm_name": "hatrpo"}, {}, "HAPPO or HATRPO"),
    "mesh": ({}, {"mesh": Mesh(1)}, "a mesh"),
    "minibatches": ({"num_mini_batch": 2}, {}, "more than one minibatch an epoch"),
    "agent_order": ({}, {}, "an agent order given"),
    "recurrent": ({"use_recurrent_policy": True}, {"cls": RecurrentMarlRunner},
                  "not the sequential schedule on the fused path"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A worker shares its host's cores with the others: small CPU ops run
    fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_runner(case):
    changes, kw, _ = CASES[case]
    kw = dict(kw)
    cls = kw.pop("cls", MarlRunner)
    env = TenAntEnv({"sim": {"substeps": 1}}, device="cpu", seed=3)
    runner = cls(env, 2, MarlConfig(**{**SMALL, **changes}), seed=1, device="cpu",
                 print_log=False, **kw)
    runner.init_state()
    return runner


def _perm(case, runner):
    return torch.arange(runner.N) if case == "agent_order" else None


@pytest.mark.parametrize("case", list(CASES))
def test_refusal_names_what_keeps_the_update_eager(case):
    runner = _small_runner(case)
    perm = _perm(case, runner)
    if case == "cpu":
        assert UpdateGraph.refusal(runner, perm) == "not a CUDA device"
        runner.device = torch.device("cuda")     # pretended: only the predicate runs
        assert UpdateGraph.refusal(runner, perm) is None
    else:
        runner.device = torch.device("cuda")
        assert UpdateGraph.refusal(runner, perm) == CASES[case][2]


@pytest.mark.parametrize("case", list(CASES))
def test_updates_on_the_cpu_run_eagerly(case):
    runner = _small_runner(case)
    for _ in range(2):
        traj = runner.rollout_phase()
        m = runner.update_phase(traj, runner.state.env_state.obs, perm=_perm(case, runner))
        assert torch.isfinite(m["value_loss"]) and torch.isfinite(m["policy_loss"])
    g = runner.update_graph
    assert (g.eager_updates, g.captures, g.replays, g.graph) == (2, 0, 0, None)


def _python_float_step(tx, params, grads, mu, nu, count):
    """The reference: ClipAdam's step with its bias corrections and
    learning rate computed inside it as Python floats."""
    b1, b2, eps = tx.b1, tx.b2, tx.eps
    n = grads[0].shape[0]
    norms = torch._foreach_norm([g[i] for i in range(n) for g in grads])
    gnorm = torch.linalg.vector_norm(torch.stack(norms).reshape(n, -1), dim=1)
    scale = torch.where(gnorm < tx.clip, 1.0, tx.clip / torch.where(gnorm == 0.0, 1.0, gnorm))
    gs = torch._foreach_mul(grads, [_lead(scale, g) for g in grads])
    if tx.wd:
        torch._foreach_add_(gs, params, alpha=tx.wd)
    c = count + 1
    bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
    lr = tx.lr(count) if callable(tx.lr) else tx.lr
    m = [x.float() for x in mu] if tx.mu_bf16 else mu
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, gs, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, denom)
    torch._foreach_mul_(upd, lr)
    with torch.no_grad():
        torch._foreach_sub_(params, upd)
    if tx.mu_bf16:
        for dst, src in zip(mu, m):
            dst.copy_(src)


def _tx(schedule: str, mu_bf16: bool) -> ClipAdam:
    """The runner's own optimizer: a constant lr, or linear decay over 300
    episodes of 5 steps, so counts 0-2,000 reach its end."""
    cfg = MarlConfig(use_linear_lr_decay=schedule == "linear_decay", ppo_epoch=5,
                     num_env_steps=300 * 8 * 16, episode_length=8, bf16_adam_mu=mu_bf16,
                     weight_decay=1e-4 if mu_bf16 else 0.0)
    return MarlRunner._make_tx(types.SimpleNamespace(cfg=cfg), 5e-4, 16)


@pytest.mark.parametrize("schedule,mu_bf16", [("constant", False), ("linear_decay", False),
                                              ("linear_decay", True)])
def test_adam_scalars_as_tensors_give_the_python_floats_bits(schedule, mu_bf16):
    tx = _tx(schedule, mu_bf16)
    g = torch.Generator().manual_seed(11)
    shapes = [(2, 5, 3), (2, 3), (2, 7)]
    start = [torch.randn(s, generator=g) for s in shapes]
    # three copies of (params, mu, nu): the reference, ClipAdam.step with
    # Python floats, ClipAdam.step with float32 tensors
    states = [([p.clone() for p in start], tx.init(start, 2).mu, tx.init(start, 2).nu)
              for _ in range(3)]
    for count in range(2001):
        # a large gradient now and then, so the clip binds
        grads = [torch.randn(s, generator=g) * (40.0 if count % 7 == 0 else 0.5)
                 for s in shapes]
        (p0, m0, v0), (p1, m1, v1), (p2, m2, v2) = states
        _python_float_step(tx, p0, [x.clone() for x in grads], m0, v0, count)
        tx.step(p1, [x.clone() for x in grads], m1, v1, count)
        scalars = tuple(torch.tensor(x, dtype=torch.float32) for x in tx.scalars(count, "cpu"))
        tx.step(p2, [x.clone() for x in grads], m2, v2, count, scalars)
        for ref, got_f, got_t in zip(*(sum(map(list, s), []) for s in states)):
            assert torch.equal(ref, got_f) and torch.equal(ref, got_t), count


def test_replay_table_holds_each_steps_scalars_where_the_capture_reads_them():
    runner = _small_runner("cpu")
    st = runner.state
    st.actor_opt.count[:] = [3 * i for i in range(runner.N)]
    st.critic_opt.count[:] = [1000 + i for i in range(runner.N)]
    K = runner.cfg.ppo_epoch
    g = runner.update_graph
    g.scalars = UpdateGraph.schedule(runner, K)
    assert tuple(g.scalars.shape) == (2, runner.N, K, 3)
    g.base = [list(st.actor_opt.count), list(st.critic_opt.count)]
    for which, (tx, opt) in enumerate(((runner.actor_tx, st.actor_opt),
                                       (runner.critic_tx, st.critic_opt))):
        for i in range(runner.N):
            for k in range(K):
                got = torch.stack(g.step_scalars(which, i, opt.count[i] + k))
                want = torch.tensor(tx.scalars(opt.count[i] + k, "cpu"), dtype=torch.float32)
                assert torch.equal(got, want)
    # on CUDA the table holds the bias corrections' reciprocals, which the
    # step multiplies by there
    runner.device = torch.device("cuda")     # pretended: only the host table is made
    cuda_table = UpdateGraph.schedule(runner, K)
    bc1, bc2, lr = runner.actor_tx.scalars(st.actor_opt.count[1] + 1, "cpu")
    assert torch.equal(cuda_table[0, 1, 1], torch.tensor([1 / bc1, 1 / bc2, lr]))
    assert torch.equal(cuda_table[:, :, :, 2], g.scalars[:, :, :, 2])
    # outside a capture the optimizer gets the host count alone
    g.base = None
    assert runner._adam_count(0, st.actor_opt, slice(2, 3)) == (6,)


# --------------------------------------------------------------------- card

E = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_runner(dev):
    env = TenAntEnv(device=dev, seed=7)
    runner = MarlRunner(env, E, MarlConfig(), seed=5, device=dev, print_log=False)
    runner.init_state()
    return runner


# per KERNELS entry, the name of the kernel it launches once a call
ROW_PASS = ("dense_fwd_wgmma", "ln_bwd_rows_wgmma", "tower_fwd_wgmma", "tower_bwd_wgmma")


def _iteration(runner, profiled):
    """(losses, counts, the KERNELS' host calls, and with `profiled` their
    row-pass kernels on the device in a torch.profiler trace) of one
    train_iter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = [k.launches for k in KERNELS]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled \
        else contextlib.nullcontext()
    with prof:
        m = runner.train_iter()
        torch.cuda.synchronize()
    device = None
    if profiled:
        names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        device = [sum(k in n for n in names) for k in ROW_PASS]
    st = runner.state
    return ((m["policy_loss"].clone(), m["value_loss"].clone()),
            (list(st.actor_opt.count), list(st.critic_opt.count)),
            [k.launches - b for k, b in zip(KERNELS, before)], device)


def _same(graphed, eager, tag, profiled=False):
    """Run an iteration of each and assert the same bits everywhere;
    (graphed, eager) of the KERNELS' host calls and, with `profiled`, of
    their row-pass kernels on the device."""
    (lg, cg, kg, dg), (le, ce, ke, de) = (_iteration(graphed, profiled),
                                          _iteration(eager, profiled))
    assert all(torch.equal(a, b) for a, b in zip(lg, le)), tag
    assert cg == ce, tag
    differ = [i for i, (a, b) in enumerate(zip(state_tensors(graphed), state_tensors(eager)))
              if not torch.equal(a, b)]
    assert not differ, f"{tag}: state leaves {differ} differ"
    return (kg, ke), (dg, de)


def _graph_held_off(runner, monkeypatch):
    monkeypatch.setattr(runner.update_graph, "refusal",
                        lambda r, perm=None: "held off by the test")


def _check_graph(graphed, eager, calls, kinds):
    """An iteration of each runner per entry of `kinds`, what the graphed
    runner's update is ("eager", "capture" or "replay"): the eager and the
    capturing update call the wrappers on the host as the eager runner
    does; a replay calls none, and its row-pass kernels, profiled in the
    last iteration, are the eager update's and the calls its capture
    counted."""
    for it, kind in enumerate(kinds):
        last = it == len(kinds) - 1
        host, device = _same(graphed, eager, f"{kind} update {it}", profiled=last)
        assert host == ([0] * 4 if kind == "replay" else calls, calls), (it, kind)
        if last:
            assert kind == "replay" and device == (calls, calls), (it, kind)
    assert graphed.update_graph.calls == calls


@pytest.mark.cuda
def test_graphed_updates_equal_eager_ones_bit_for_bit(cuda, monkeypatch, tmp_path):
    graphed, eager = _card_runner(cuda), _card_runner(cuda)
    _graph_held_off(eager, monkeypatch)
    assert UpdateGraph.refusal(graphed) is None
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(graphed), state_tensors(eager)))
    blocks = 1 + graphed.cfg.layer_n
    n = 2 * graphed.N * graphed.cfg.ppo_epoch * blocks        # actor and critic
    _check_graph(graphed, eager, [n, n, 0, 0], ["eager", "capture", "replay", "replay"])
    g = graphed.update_graph
    assert (g.captures, g.replays, g.eager_updates) == (1, 2, 1)
    assert eager.update_graph.eager_updates == 4

    path = str(tmp_path / "marl.ckpt")
    graphed.save(path)
    for r in (graphed, eager):
        r.restore(path)
    # the restored state lies elsewhere: the next update captures anew
    _check_graph(graphed, eager, [n, n, 0, 0], ["capture", "replay"])
    assert (g.captures, g.replays, g.eager_updates) == (2, 3, 1)


@pytest.mark.cuda
def test_graphed_tower_updates_equal_eager_ones_bit_for_bit(cuda, monkeypatch):
    monkeypatch.setenv("FUSED_TOWER", "1")
    graphed, eager = _card_runner(cuda), _card_runner(cuda)
    _graph_held_off(eager, monkeypatch)
    towers = 2 * graphed.N * graphed.cfg.ppo_epoch
    _check_graph(graphed, eager, [0, 0, towers, towers], ["eager", "capture", "replay"])
    g = graphed.update_graph
    assert (g.captures, g.replays, g.eager_updates) == (1, 1, 1)
