"""The port's MARL runner (MAPPO/IPPO/HAPPO on TenAnt) against the JAX
package on the CPU.

One trajectory is made with numpy from a seed (obs, share obs, actions,
rewards, dones; log-probs and values from the flax nets at the bridged
parameters) and goes through both update phases: JAX's
`MarlRunner(..., use_fused_mlp=True)._make_train_iter().update_phase` with
its Pallas kernels in interpret mode, and the port's `update_phase` with the
kernels' plain versions.  HAPPO's agent order is JAX's permutation,
recomputed from the same key and handed to the port.

Tolerances and why:
  * the first minibatch's gradients: 6e-2 of each leaf's scale, as
    tests/test_fused_mlp.py:38-62 (bf16 activation streams on both sides);
  * metrics at tests/test_fused_mlp.py:83-85: mean reward to 1e-5, the
    value and policy losses to rel 0.15 / abs 0.05;
  * the PopArt statistics: rel 1e-3, because the returns bootstrap from
    the last values of each package's bf16 critic;
  * parameters after 5 epochs of Adam: Adam moves each weight by about lr
    per step whatever the gradient's size, so a bf16 gradient near 0 may
    take the other sign: every weight within 3 * lr * ppo_epoch, the median
    difference below lr / 10.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.marl import fused_nets as j_fused_nets
from massive_marl_tpu.algos.marl import nets as j_nets
from massive_marl_tpu.algos.marl.runner import MarlConfig as JConfig
from massive_marl_tpu.algos.marl.runner import MarlRunner as JRunner
from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu.ops import fused_mlp as j_fm
from massive_marl_tpu_torch.algos.marl import runner as p_runner
from massive_marl_tpu_torch.algos.marl.runner import MarlConfig as PConfig
from massive_marl_tpu_torch.algos.marl.runner import MarlRunner as PRunner
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt
from massive_marl_tpu_torch.utils.bridge import marl_params_from_flax
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map

ENV_CFG = {"sim": {"substeps": 1}}
N, E, T, HIDDEN = 10, 4, 8, 128
LR = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(algo, **kw):
    base = {"hidden_size": HIDDEN, "use_fused_mlp": True}
    return (dataclasses.replace(JConfig.from_cfg_train(base, algo), **kw),
            dataclasses.replace(PConfig.from_cfg_train(base, algo), **kw))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def envs():
    return JTenAnt(ENV_CFG), PTenAnt(ENV_CFG, device="cpu")


def _make_traj(runner: JRunner, ts, seed=0):
    """A [T, E, ...] trajectory made with numpy; logp and values come from
    the flax nets at ts's parameters, so the importance ratios start at 1."""
    rng = np.random.default_rng(seed)
    share = np.clip(rng.normal(0, 1.5, (T, E, 388)), -7, 7).astype(np.float32)
    blocks = share[..., :380].reshape(T, E, N, 38)
    obs = np.concatenate([blocks, np.broadcast_to(share[:, :, None, 380:], (T, E, N, 8))], -1)
    agent_major = lambda x: np.moveaxis(x, 2, 0).reshape(N, T * E, x.shape[-1])
    mean, std = jax.vmap(runner.actor.apply)(ts.actor_params, agent_major(obs))
    actions = np.asarray(mean + std * rng.normal(size=mean.shape).astype(np.float32))
    logp = np.asarray(j_nets.normal_log_prob(mean, std, actions))
    cin = agent_major(np.broadcast_to(share[:, :, None], (T, E, N, 388))) \
        if runner.cfg.use_centralized_v else agent_major(obs)
    values = np.asarray(jax.vmap(runner.critic.apply)(ts.critic_params, cin))
    back = lambda x: np.moveaxis(x.reshape(N, T, E, *x.shape[2:]), 0, 2)
    done = np.zeros((T, E), np.float32)
    done[3, 1] = done[6, 2] = 1.0
    traj = dict(obs=obs.astype(np.float32), share=share, actions=back(actions),
                logp=back(logp), values=back(values),
                reward=rng.normal(3.0, 2.0, (T, E)).astype(np.float32),
                done=done, bad=np.ones((T, E), np.float32))
    last_obs = np.clip(rng.normal(0, 1.5, (E, 388)), -7, 7).astype(np.float32)
    return traj, last_obs


@pytest.fixture(scope="module")
def cases(envs):
    """Per critic input (centralized share obs / IPPO's own obs): the JAX
    train state, the trajectory and the last obs."""
    jenv, _ = envs
    out = {}
    for algo in ("mappo", "ippo"):
        jcfg, _ = _configs(algo)
        r = JRunner(jenv, num_envs=E, cfg=jcfg, seed=0, print_log=False)
        ts = r.init_state()
        traj, last_obs = _make_traj(r, ts)
        out[algo] = (ts, traj, last_obs)
    return out


def _port_runner(penv, pcfg, ts):
    r = PRunner(penv, E, pcfg, seed=0, device="cpu", print_log=False)
    r.init_state()
    pa, pc = marl_params_from_flax(_np_tree(ts.actor_params), _np_tree(ts.critic_params))
    copy = lambda dst, src: dst.copy_(src)
    tree_map(copy, r.state.actor_params, pa)
    tree_map(copy, r.state.critic_params, pc)
    return r


def _jax_update(jenv, jcfg, ts, traj, last_obs):
    r = JRunner(jenv, num_envs=E, cfg=jcfg, seed=0, print_log=False)
    env_state = ts.env_state.replace(obs=jnp.asarray(last_obs))
    return jax.jit(r._make_train_iter().update_phase)(ts, env_state, ts.key, traj)


def _happo_perm(key):
    """JAX's agent order: split -> k_mb, split -> k_perm, permutation."""
    key, _ = jax.random.split(key)
    _, k_perm = jax.random.split(key)
    return [int(i) for i in np.asarray(jax.random.permutation(k_perm, N))]


def _assert_params_close(j_tree, p_tree, before, lr, epochs, tag):
    jp, _ = marl_params_from_flax({"params": _np_tree(j_tree)}, {"params": {}})
    diffs = []
    for (name, j), p, b in zip(_named_leaves(jp), tree_leaves_like(jp, p_tree),
                               tree_leaves_like(jp, before)):
        d = (p - j).abs()
        assert float(d.max()) <= 3 * lr * epochs, f"{tag} {name}: {float(d.max())}"
        assert float((j - b).abs().max()) > 0.5 * lr, f"{tag} {name} did not move"
        diffs.append(d.reshape(-1))
    assert float(torch.cat(diffs).median()) < 0.1 * lr, tag


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def tree_leaves_like(ref, tree):
    """tree's leaves in ref's key order."""
    return [leaf for _, leaf in _named_leaves(tree_map(lambda _, x: x, ref, tree))]


@pytest.mark.parametrize("algo,schedule", [("mappo", "sequential"), ("mappo", "stacked"),
                                           ("ippo", "sequential"), ("happo", "sequential")])
def test_update_phase_matches_jax(envs, cases, algo, schedule):
    jenv, penv = envs
    ts, traj, last_obs = cases["ippo" if algo == "ippo" else "mappo"]
    jcfg, pcfg = _configs(algo, update_schedule=schedule)
    j_ts, j_m = _jax_update(jenv, jcfg, ts, traj, last_obs)
    runner = _port_runner(penv, pcfg, ts)
    before = (tree_map(torch.clone, runner.state.actor_params),
              tree_map(torch.clone, runner.state.critic_params))
    perm = _happo_perm(ts.key) if algo == "happo" else None
    p_m = runner.update_phase({k: torch.from_numpy(np.array(v)) for k, v in traj.items()},
                              torch.from_numpy(last_obs), perm=perm)
    p_m = {k: float(v) for k, v in p_m.items()}
    j_m = {k: float(v) for k, v in j_m.items()}
    assert p_m["mean_reward"] == pytest.approx(j_m["mean_reward"], abs=1e-5)
    for k in ("value_loss", "policy_loss"):
        assert p_m[k] == pytest.approx(j_m[k], rel=0.15, abs=0.05), (k, p_m[k], j_m[k])
    assert p_m["episodes_done"] == j_m["episodes_done"] == 2
    assert p_m["episode_rewards"] == pytest.approx(j_m["episode_rewards"], rel=1e-5)
    vn = runner.state.vnorm
    for name in ("mean", "mean_sq", "debias"):
        np.testing.assert_allclose(getattr(vn, name).numpy(),
                                   np.asarray(getattr(j_ts.vnorm, name)), rtol=1e-3,
                                   err_msg=name)
    epochs = jcfg.ppo_epoch
    _assert_params_close(j_ts.actor_params["params"], runner.state.actor_params, before[0],
                         LR, epochs, f"{algo}/{schedule} actor")
    _assert_params_close(j_ts.critic_params["params"], runner.state.critic_params, before[1],
                         LR, epochs, f"{algo}/{schedule} critic")


def test_first_minibatch_grads_match_jax(envs, cases):
    """MAPPO's first update (agent 0, the whole batch): the port's actor and
    critic gradients against jax.grad of the reference's losses through the
    Pallas custom VJP, on the same batch."""
    jenv, penv = envs
    ts, traj, last_obs = cases["mappo"]
    jcfg, pcfg = _configs("mappo")
    runner = _port_runner(penv, pcfg, ts)
    tt = {k: torch.from_numpy(np.array(v)) for k, v in traj.items()}
    st = runner.state
    with torch.no_grad():
        _, last_cin = runner._agent_views(torch.from_numpy(last_obs).clamp(-7, 7))
        adv, returns = runner._gae(tt, runner.critic.apply(st.critic_params, last_cin), st.vnorm)
    B = T * E
    take0 = lambda x: np.asarray(x)[:, :, 0].reshape(B, *np.asarray(x).shape[3:])
    batch_np = dict(obs=take0(traj["obs"]), actions=take0(traj["actions"]),
                    logp=take0(traj["logp"]), values=take0(traj["values"]),
                    adv=adv[0].reshape(B).numpy(), returns=returns[0].reshape(B).numpy())
    obs_hat = j_fm.feature_norm(jnp.asarray(batch_np["obs"]))
    cin_hat = j_fm.feature_norm(jnp.asarray(traj["share"].reshape(B, -1)))
    one = lambda tree: jax.tree_util.tree_map(lambda x: x[0:1], tree)

    def actor_loss_j(p):
        mean, std = j_fused_nets.actor_apply(p, obs_hat[None], prenormed=True, interpret=True)
        ratio = jnp.exp(j_nets.normal_log_prob(mean, std, batch_np["actions"][None])
                        - batch_np["logp"][None])
        adv_b = batch_np["adv"][None]
        return -jnp.mean(jnp.minimum(ratio * adv_b, jnp.clip(ratio, 0.8, 1.2) * adv_b))

    vn0 = jax.tree_util.tree_map(lambda x: x[0], ts.vnorm)
    _, rn_c, rn_o = j_nets.norm_targets(vn0, batch_np["returns"], "popart")

    def critic_loss_j(p):
        v = j_fused_nets.critic_apply(p, cin_hat[None], prenormed=True, interpret=True)[0]
        v_clip = batch_np["values"] + jnp.clip(v - batch_np["values"], -0.2, 0.2)
        return jnp.mean(jnp.maximum(j_nets.huber(rn_o - v, 10.0),
                                    j_nets.huber(rn_c - v_clip, 10.0)))

    grads_j = (jax.grad(actor_loss_j)(one(ts.actor_params)),
               jax.grad(critic_loss_j)(one(ts.critic_params)))

    mb = {k: torch.from_numpy(np.array(v))[None] for k, v in batch_np.items()}
    mb["obs"] = torch.from_numpy(np.asarray(obs_hat, np.float32)).to(torch.bfloat16)[None]
    mb["cin"] = torch.from_numpy(np.asarray(cin_hat, np.float32)).to(torch.bfloat16)[None]
    mb["active"] = torch.ones(1, B)
    a_apply = lambda p, o: p_runner.fused_nets.actor_apply(p, o, prenormed=True)
    c_apply = lambda p, x: p_runner.fused_nets.critic_apply(p, x, prenormed=True)
    sl = lambda tree: tree_map(lambda x: x[0:1], tree)
    ga, _ = runner._grads(lambda p: runner._actor_loss(a_apply, p, mb), sl(st.actor_params))
    vn_p = st.vnorm.index(slice(0, 1))
    _, rc, ro = p_runner.nets.norm_targets(vn_p, mb["returns"], "popart")
    gc, _ = runner._grads(lambda p: runner._critic_loss(c_apply, p, mb, rc, ro),
                          sl(st.critic_params))
    for tag, gj, gp, tree in (("actor", grads_j[0], ga, st.actor_params),
                              ("critic", grads_j[1], gc, st.critic_params)):
        gj_t, _ = marl_params_from_flax(_np_tree(gj), {"params": {}})
        named = dict(_named_leaves(tree_map(lambda _, x: x, tree, gj_t)))
        ported = dict(zip([n for n, _ in _named_leaves(tree)], gp))
        assert named.keys() == ported.keys()
        for name, ref in named.items():
            ref = ref.numpy()
            np.testing.assert_allclose(ported[name].numpy(), ref, rtol=0,
                                       atol=6e-2 * max(np.abs(ref).max(), 1e-3),
                                       err_msg=f"{tag} {name}")


def test_sequential_matches_stacked():
    """The port's two MAPPO schedules give the same parameters (agents are
    independent), as tests/test_fused_mlp.py:330-378 asserts for JAX's.
    Batched and per-agent products and sums add in other orders, and Adam's
    normalised step amplifies that for gradients near 0: the actor, and the
    critic with PopArt off, within 1e-5 (lr / 50; up to 2.4e-6 seen on one
    element); the PopArt statistics within 1e-5; the critic with PopArt on
    within 5e-3, the noise PopArt's reduction order feeds through Adam."""
    def one_iter(schedule, **kw):
        cfg = dataclasses.replace(PConfig(hidden_size=HIDDEN, use_fused_mlp=True,
                                          episode_length=4, ppo_epoch=2,
                                          update_schedule=schedule), **kw)
        # a fresh env each time: its generator draws the resets
        r = PRunner(PTenAnt(ENV_CFG, device="cpu", seed=3), 8, cfg, seed=3, device="cpu",
                    print_log=False)
        r.init_state()
        m = r.train_iter()
        return r.state, {k: float(v) for k, v in m.items()}

    def assert_tree(a, b, atol, tag):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=atol, err_msg=tag)

    s1, m1 = one_iter("sequential")
    s2, m2 = one_iter("stacked")
    assert_tree(s1.actor_params, s2.actor_params, 1e-5, "actor")
    for name in ("mean", "mean_sq", "debias"):
        np.testing.assert_allclose(getattr(s1.vnorm, name).numpy(),
                                   getattr(s2.vnorm, name).numpy(), rtol=0, atol=1e-5)
    assert_tree(s1.critic_params, s2.critic_params, 5e-3, "critic(popart)")
    for k in ("mean_reward", "value_loss", "policy_loss"):
        np.testing.assert_allclose(m1[k], m2[k], rtol=1e-3, atol=1e-3, err_msg=k)
    s1, _ = one_iter("sequential", use_popart=False)
    s2, _ = one_iter("stacked", use_popart=False)
    assert_tree(s1.actor_params, s2.actor_params, 1e-5, "actor(no-popart)")
    assert_tree(s1.critic_params, s2.critic_params, 1e-5, "critic(no-popart)")


def test_fused_path_choice_and_unported_parts(envs):
    _, penv = envs
    mk = lambda **kw: PRunner(penv, 2, PConfig(**kw), device="cpu", print_log=False)
    assert not mk().use_fused                        # "auto": off on the CPU
    assert mk(use_fused_mlp=True).use_fused
    assert not mk(use_fused_mlp=True, hidden_size=96).use_fused   # hidden % 128
    assert mk(use_fused_mlp=True).sequential and not mk().sequential
    assert mk(algorithm_name="happo").sequential
    for kw, match in ((dict(cfg=PConfig(algorithm_name="hatrpo")), "HATRPO"),
                      (dict(mesh=object()), "A.8f"), (dict(log_dir="x"), "A.8d")):
        cfg = kw.pop("cfg", PConfig())
        with pytest.raises(NotImplementedError, match=match):
            PRunner(penv, 2, cfg, device="cpu", **kw)
    r = mk()
    for call in (r.eval, lambda: r.save("x"), lambda: r.restore("x")):
        with pytest.raises(NotImplementedError, match="A.8d"):
            call()
    with pytest.raises(ValueError, match="update_schedule"):
        mk(update_schedule="joint")


def test_port_run_and_cli_train_mappo(envs, capsys):
    _, penv = envs
    r = PRunner(penv, 2, PConfig(hidden_size=HIDDEN, episode_length=4, ppo_epoch=1,
                                 algorithm_name="happo", num_mini_batch=2),
                device="cpu", print_log=False)
    r.run(16)
    assert r.state.iteration == 2
    assert all(np.isfinite(v) for v in r.last_metrics.values())
    assert all(torch.isfinite(x).all() for x in tree_leaves(r.state.actor_params))
    from massive_marl_tpu_torch.cli.train import main
    main(["--algo", "mappo", "--device", "cpu", "--num_envs", "2", "--num_env_steps", "16"])
    assert "[mappo] it 0/1 rew/step" in capsys.readouterr().out
