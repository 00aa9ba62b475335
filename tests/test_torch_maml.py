"""The port's MAML-PPO against the JAX package's on the CPU.

`PToy` is the torch twin of tests/test_ppo.py's ToyEnv (a 1-d point mass,
obs [pos, pos^2, 1], the `pos` field that selects MAML's toy task reward).
* `_task_reward`, all three branches (a fake ant pipeline whose steps
  include an auto-reset and a progress that does not advance, a `pos`
  state, a plain reward), equals JAX's at rtol 1e-6.
* `pg_loss` (JAX's closure, taken from eval_adapt's free variables) and its
  gradient on one numpy trajectory from bridged parameters: the loss at
  rtol 1e-2 and the gradient's cosine above 0.999 with its norm within
  1% (the ActorCritic's hidden layers compute in bf16 on both sides, at
  different rounding points, so gradients are held relative to their
  size).
* One meta-iteration on ToyEnv / PToy from identical env states and task
  angles, jax.random.normal stood in by one numpy draw (each traced scan
  body calls it once; the port's `_normal` returns the same draw): the
  meta-gradient (JAX's captured as it enters the optimizer, run eagerly)
  has cosine above 0.999 with the port's and a norm within 1%; the port's
  first-order gradient (create_graph=False) misses JAX's by more than 5%
  of its norm, so the agreement shows the second-order term.
* The twin of tests/test_algo_zoo.py::test_maml_adaptation_helps: after
  60 meta-iterations at hidden 32, post > pre + 0.02.
* With inner_lr = 0, eval_adaptation returns pre == post exactly (the
  generator snapshot makes the two query rollouts identical).
"""
import dataclasses
import inspect
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from massive_marl_tpu.algos.metarl import maml as j_maml
from massive_marl_tpu_torch.algos.metarl import maml as p_maml
from massive_marl_tpu_torch.utils import bridge, yaml_lite
from massive_marl_tpu_torch.utils.config import CFG_ROOT
from tests.test_ppo import ToyEnv, _ToyState

E, M, T = 8, 2, 4
RNG = np.random.default_rng(21)


@dataclasses.dataclass
class PToyState:
    pos: torch.Tensor
    progress: torch.Tensor
    done: torch.Tensor
    obs: torch.Tensor
    reward: torch.Tensor


class PToy:
    """ToyEnv of tests/test_ppo.py, batched: reward -pos^2, the action
    moves the point by 0.2 a (clipped to +-3), episodes of 32 steps, resets
    uniform in [-2, 2) from the env's generator."""
    num_obs, num_actions, num_agents = 3, 1, 1
    max_len = 32
    device = torch.device("cpu")

    def __init__(self, seed=0):
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)

    @staticmethod
    def _obs(pos):
        return torch.stack([pos, pos * pos, torch.ones_like(pos)], -1)

    def state_at(self, pos):
        pos = torch.as_tensor(pos, dtype=torch.float32)
        n = pos.shape[0]
        return PToyState(pos=pos, progress=torch.zeros(n, dtype=torch.int32),
                         done=torch.zeros(n, dtype=torch.bool), obs=self._obs(pos),
                         reward=torch.zeros(n))

    def reset(self, num_envs):
        return self.state_at(torch.rand(num_envs, generator=self.generator) * 4.0 - 2.0)

    def step_batch(self, st, actions):
        fresh = torch.rand(st.pos.shape, generator=self.generator) * 4.0 - 2.0
        pos = torch.where(st.done, fresh, torch.clamp(st.pos + 0.2 * actions[:, 0], -3.0, 3.0))
        progress = torch.where(st.done, 0, st.progress + 1).to(torch.int32)
        return PToyState(pos=pos, progress=progress, done=progress >= self.max_len - 1,
                         obs=self._obs(pos), reward=-pos * pos)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_config_from_yaml_matches_jax():
    cfg_train = yaml_lite.load(f"{CFG_ROOT}/mamlppo/config.yaml")
    got = p_maml.MAMLConfig.from_cfg_train(cfg_train)
    assert vars(got) == vars(j_maml.MAMLConfig.from_cfg_train(cfg_train))
    # no policy block is read: (256, 256), although the YAML names 1024-1024-512
    assert got.hidden == (256, 256) and got.meta_batch_size == 4


# ------------------------------------------------------------ task reward
class _Spec:
    dt = 0.05


def test_task_reward_matches_jax():
    jt = j_maml.MAMLPPO(ToyEnv(), num_envs=E, cfg=j_maml.MAMLConfig(hidden=(16,)),
                        print_log=False)
    pt = p_maml.MAMLPPO(PToy(), E, p_maml.MAMLConfig(hidden=(16,)), device="cpu",
                        print_log=False)
    jt.env.spec = pt.env.spec = _Spec()
    q1, q2 = (RNG.normal(0, 1, (E, 2, 15)).astype(np.float32) for _ in range(2))
    rew = RNG.normal(0, 1, E).astype(np.float32)
    done = np.array([0, 1, 0, 0, 0, 0, 1, 0], bool)
    p_prog = np.array([3, 5, 7, 0, 2, 9, 1, 4], np.int32)
    n_prog = np.array([4, 0, 7, 1, 3, 0, 0, 5], np.int32)   # env 2 does not advance
    angle = np.float32(0.7)
    def both(make):
        (jp, jn), (pp, pn) = make(jnp.asarray), make(torch.as_tensor)
        j = np.asarray(jt._task_reward(jp, jn, jnp.asarray(angle)))
        p = pt._task_reward(pp, pn, torch.tensor(angle)).numpy()
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6)
        return p

    ant = both(lambda x: (
        SimpleNamespace(pipeline=SimpleNamespace(ant_qpos=x(q1)), done=x(done),
                        progress=x(p_prog)),
        SimpleNamespace(pipeline=SimpleNamespace(ant_qpos=x(q2)), done=x(done),
                        progress=x(n_prog), reward=x(rew))))
    masked = done | (n_prog <= p_prog)
    assert masked.sum() == 4
    np.testing.assert_allclose(ant[masked], 0.05 * rew[masked], rtol=1e-6)
    pos = RNG.normal(0, 1, E).astype(np.float32)
    toy = both(lambda x: (SimpleNamespace(pos=x(pos)), SimpleNamespace(pos=x(pos), reward=x(rew))))
    np.testing.assert_allclose(toy, -(pos - angle / math.pi) ** 2, rtol=1e-5)
    plain = both(lambda x: (SimpleNamespace(pipeline=None),
                            SimpleNamespace(pipeline=None, reward=x(rew))))
    np.testing.assert_array_equal(plain, rew)


# ---------------------------------------------------------------- pg_loss
def _cos_norm(a, b):
    a, b = a.double(), b.double()
    return float(a @ b / (a.norm() * b.norm())), float((a.norm() - b.norm()).abs() / b.norm())


def _flat(sd, keys):
    return torch.cat([sd[k].reshape(-1) for k in keys])


def test_pg_loss_and_gradient_match_jax():
    cfg = dict(hidden=(32, 32))
    jt = j_maml.MAMLPPO(ToyEnv(), num_envs=E, cfg=j_maml.MAMLConfig(**cfg), print_log=False)
    params = jt.init_state().params
    pg_loss = inspect.getclosurevars(jt._meta_iter_raw.eval_adapt).nonlocals["pg_loss"]
    obs = RNG.normal(0, 1, (T, E, 3)).astype(np.float32)
    traj = dict(obs=obs, actions=RNG.normal(0, 1, (T, E, 1)).astype(np.float32),
                logp=RNG.normal(-1, 0.3, (T, E)).astype(np.float32),
                value=RNG.normal(0, 1, (T, E)).astype(np.float32),
                reward=RNG.normal(0, 1, (T, E)).astype(np.float32),
                done=(RNG.random((T, E)) < 0.2).astype(np.float32))
    last = RNG.normal(0, 1, (E, 3)).astype(np.float32)
    j_loss, j_grad = jax.value_and_grad(pg_loss)(params, {k: jnp.asarray(v) for k, v in
                                                          traj.items()}, jnp.asarray(last))
    pt = p_maml.MAMLPPO(PToy(), E, p_maml.MAMLConfig(**cfg), device="cpu", print_log=False)
    pt.model.load_state_dict(bridge.actor_critic_from_flax(_np(params)))
    p = pt.params()
    loss = pt.pg_loss(p, {k: torch.from_numpy(v) for k, v in traj.items()},
                      torch.from_numpy(last))
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-2)
    jg = bridge.actor_critic_from_flax(_np(j_grad))
    cos, dnorm = _cos_norm(_flat(grads, jg), _flat(jg, jg))
    assert cos > 0.999 and dnorm < 0.01, (cos, dnorm)


# ------------------------------------------------------------ meta-iteration
CFG = dict(support_steps=T, query_steps=T, meta_batch_size=M, inner_lr=0.5, hidden=(32, 32))
POS = RNG.uniform(-2, 2, (M, E)).astype(np.float32)
ANGLES = np.array([2.1, -1.3], np.float32)
NOISE = RNG.standard_normal((E, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_meta_grad():
    """(initial params, JAX's meta-gradient) of one eager meta-iteration."""
    jt = j_maml.MAMLPPO(ToyEnv(), num_envs=E, cfg=j_maml.MAMLConfig(**CFG), print_log=False)
    ts = jt.init_state()
    pos = jnp.asarray(POS)
    env_state = _ToyState(pos=pos, progress=jnp.zeros((M, E), jnp.int32),
                          done=jnp.zeros((M, E), bool), key=ts.env_state.key,
                          obs=jnp.stack([pos, pos * pos, jnp.ones_like(pos)], -1),
                          reward=jnp.zeros((M, E)))
    ts = ts.replace(env_state=env_state, task_params=jnp.asarray(ANGLES))
    seen = {}
    update = jt.tx.update

    def recording(grads, state, params=None):
        seen["g"] = grads
        return update(grads, state, params)
    jt.tx = optax.GradientTransformation(jt.tx.init, recording)
    orig = jax.random.normal
    jax.random.normal = lambda key, shape=(), dtype=None: jnp.asarray(NOISE).reshape(shape)
    try:
        jt._meta_iter_raw(ts)
    finally:
        jax.random.normal = orig
    return ts.params, seen["g"]


def _port_meta_grad(params, create_graph):
    pt = p_maml.MAMLPPO(PToy(), E, p_maml.MAMLConfig(**CFG), device="cpu", print_log=False)
    pt.model.load_state_dict(bridge.actor_critic_from_flax(_np(params)))
    st = pt.init_state()
    st.env_states = [pt.env.state_at(POS[i]) for i in range(M)]
    st.task_params = torch.from_numpy(ANGLES)
    pt._normal = lambda shape, generator=None: torch.from_numpy(NOISE).reshape(shape)
    grads, loss, _ = pt.meta_grads(create_graph=create_graph)
    assert np.isfinite(float(loss))
    return dict(zip(pt.params(), grads))


def test_meta_gradient_matches_jax_second_order(jax_meta_grad):
    params, j_grad = jax_meta_grad
    jg = bridge.actor_critic_from_flax(_np(j_grad))
    keys = list(jg)
    g2 = _flat(_port_meta_grad(params, True), keys)
    cos, dnorm = _cos_norm(g2, _flat(jg, keys))
    assert cos > 0.999 and dnorm < 0.01, (cos, dnorm)
    g1 = _flat(_port_meta_grad(params, False), keys)
    miss_2 = float((g2 - _flat(jg, keys)).norm() / _flat(jg, keys).norm())
    miss_1 = float((g1 - _flat(jg, keys)).norm() / _flat(jg, keys).norm())
    assert miss_1 > 0.05 and miss_1 > 5 * miss_2, (miss_1, miss_2)


# ---------------------------------------------------------------- adaptation
def test_maml_adaptation_helps():
    cfg = p_maml.MAMLConfig(support_steps=8, query_steps=8, meta_batch_size=4, adapt_steps=1,
                            inner_lr=0.1, hidden=(32, 32))
    torch.manual_seed(0)
    pt = p_maml.MAMLPPO(PToy(), 16, cfg, seed=0, device="cpu", print_log=False)
    pt.run(60)
    assert pt.state.iteration == 60 and np.isfinite(pt.last_metrics["meta_loss"])
    pre, post = pt.eval_adaptation(n_tasks=8)
    assert post > pre + 0.02, (pre, post)


def test_eval_adaptation_without_inner_step_is_exact():
    pt = p_maml.MAMLPPO(PToy(), E, p_maml.MAMLConfig(inner_lr=0.0, hidden=(16, 16)),
                        device="cpu", print_log=False)
    pt.init_state()
    before = pt.generator.get_state()
    env_before = pt.env.generator.get_state()
    pre, post = pt.eval_adaptation(n_tasks=3)
    assert pre == post and np.isfinite(pre)
    assert torch.equal(pt.env.generator.get_state(), env_before)
    assert torch.equal(pt.generator.get_state(), before)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _tensors(getattr(tree, f.name))]
    if isinstance(tree, tuple):
        return [x for leaf in tree for x in _tensors(leaf)]
    return []


@pytest.mark.parametrize("fused", [True, False], ids=["kernel-path", "array-engine"])
def test_tenant_step_leaves_its_input_state(fused):
    """eval_adapt starts the pre- and post-adaptation rollouts from one env
    state without copying it, so a step must build a new state and write
    nothing into its input.  TenAnt (MAML's default task) on each physics
    path, one env flagged done so the reset select runs, stepped twice from
    the same state: every tensor of that state is unchanged, bit for bit,
    and both steps give the same next state."""
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    env = TenAntEnv({"sim": {"substeps": 1, "fused_kernel": fused}}, device="cpu")
    s0 = dataclasses.replace(env.reset(2), done=torch.tensor([True, False]))
    before = [x.clone() for x in _tensors(s0)]
    a = torch.rand((2, 80), generator=torch.Generator().manual_seed(0)) * 2 - 1
    g_env = env.generator.get_state()
    s1 = env.step_batch(s0, a)
    env.generator.set_state(g_env)
    s2 = env.step_batch(s0, a)
    assert all(torch.equal(x, y) for x, y in zip(_tensors(s0), before))
    assert all(torch.equal(x, y) for x, y in zip(_tensors(s1), _tensors(s2)))
