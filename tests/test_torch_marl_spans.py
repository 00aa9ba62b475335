"""The program's spans in the on-policy MARL runner (algos/marl/runner.py):
one small TenAnt + MAPPO iteration on the CPU, on the sequential schedule
of B2/B3's plain versions, with the recorder on records each span as often
as the iteration makes the call; with it off nothing is recorded, and the
parameters after the iteration are bit-identical either way."""
import pytest
import torch

from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.utils import profiling
from massive_marl_tpu_torch.utils.tree import tree_leaves

T, EPOCHS, MINIBATCHES, N = 8, 2, 2, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A worker shares its host's cores with the others: small CPU ops run
    fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _iteration(record: bool):
    """(span totals, parameters) after one train_iter."""
    env = TenAntEnv({"sim": {"substeps": 1}}, device="cpu", seed=3)
    cfg = MarlConfig(hidden_size=128, layer_n=1, episode_length=T, ppo_epoch=EPOCHS,
                     num_mini_batch=MINIBATCHES, use_fused_mlp=True)
    runner = MarlRunner(env, 4, cfg, seed=1, device="cpu", print_log=False)
    runner.init_state()
    assert runner.sequential
    profiling.reset()
    if record:
        profiling.enable()
    try:
        runner.train_iter()
    finally:
        profiling.disable()
    st = runner.state
    params = [p.clone() for p in tree_leaves(st.actor_params) + tree_leaves(st.critic_params)]
    totals = profiling.totals()
    profiling.reset()
    return totals, params


@pytest.fixture(scope="module")
def runs():
    return {"on": _iteration(True), "off": _iteration(False)}


def test_each_span_counts_the_iterations_calls(runs):
    totals, _ = runs["on"]
    steps = N * EPOCHS * MINIBATCHES
    want = {"trainer.rollout": 1, "trainer.update": 1, "trainer.policy": T, "update.agent": N,
            # an actor and a critic step each
            "update.forward": 2 * steps, "update.backward": 2 * steps,
            "update.optimizer": 2 * steps}
    assert {k: totals[k][0] for k in want} == want
    assert all(totals[k][2] >= 0.0 for k in want)


def test_off_nothing_is_recorded_and_the_parameters_are_the_same(runs):
    (_, on), (totals, off) = runs["on"], runs["off"]
    assert totals == {}
    assert all(torch.equal(a, b) for a, b in zip(on, off))
