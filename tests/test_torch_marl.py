"""The port's MARL runner (MAPPO/IPPO/HAPPO/HATRPO on TenAnt) against the
JAX package on the CPU.

One trajectory is made with numpy from a seed (obs, share obs, actions,
rewards, dones; log-probs and values from the flax nets at the bridged
parameters) and goes through both update phases: JAX's
`MarlRunner(..., use_fused_mlp=True)._make_train_iter().update_phase` with
its Pallas kernels in interpret mode, and the port's `update_phase` with the
kernels' plain versions.  HAPPO's and HATRPO's agent order is JAX's
permutation, recomputed from the same key and handed to the port.  One case
runs MAPPO with FUSED_TOWER=1 on both sides (the whole-tower kernels' plain
versions against the Pallas tower in interpret mode).

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
    difference below lr / 10;
  * HATRPO's actor step (new - old) per agent: the norm of the difference
    within 1% of the norm of JAX's step (0.02-0.18% seen), what a
    10-iteration conjugate gradient on Fisher-vector products with bf16
    activations keeps of the two packages' summation-order noise.  The line
    search's choice of candidate is discrete; the test prints each agent's
    margins (the KL's is ~1e-4 below kl_threshold at the accepted step);
  * the manual JVP at tests/test_fused_mlp.py:234-240's tolerances, the
    Gauss-Newton Fisher-vector product at 8e-2 of its scale (:295-296).
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
from massive_marl_tpu_torch.ops import fused_mlp as p_fm
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


def _run_both(envs, cases, algo, **kw):
    """One update phase of each package on the same trajectory: (JAX
    state, JAX metrics, port runner, port metrics, port parameters before)."""
    jenv, penv = envs
    ts, traj, last_obs = cases["ippo" if algo == "ippo" else "mappo"]
    jcfg, pcfg = _configs(algo, **kw)
    j_ts, j_m = _jax_update(jenv, jcfg, ts, traj, last_obs)
    runner = _port_runner(penv, pcfg, ts)
    before = (tree_map(torch.clone, runner.state.actor_params),
              tree_map(torch.clone, runner.state.critic_params))
    perm = _happo_perm(ts.key) if algo in ("happo", "hatrpo") else None
    p_m = runner.update_phase({k: torch.from_numpy(np.array(v)) for k, v in traj.items()},
                              torch.from_numpy(last_obs), perm=perm)
    return (j_ts, {k: float(v) for k, v in j_m.items()}, runner,
            {k: float(v) for k, v in p_m.items()}, before)


def _check_metrics_and_stats(j_ts, j_m, runner, p_m):
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


@pytest.mark.parametrize("algo,schedule", [("mappo", "sequential"), ("mappo", "stacked"),
                                           ("ippo", "sequential"), ("happo", "sequential")])
def test_update_phase_matches_jax(envs, cases, algo, schedule):
    j_ts, j_m, runner, p_m, before = _run_both(envs, cases, algo, update_schedule=schedule)
    _check_metrics_and_stats(j_ts, j_m, runner, p_m)
    epochs = runner.cfg.ppo_epoch
    _assert_params_close(j_ts.actor_params["params"], runner.state.actor_params, before[0],
                         LR, epochs, f"{algo}/{schedule} actor")
    _assert_params_close(j_ts.critic_params["params"], runner.state.critic_params, before[1],
                         LR, epochs, f"{algo}/{schedule} critic")


def test_fused_tower_update_phase_matches_jax(envs, cases, monkeypatch):
    """MAPPO, sequential schedule, with FUSED_TOWER=1 set on both sides
    before JAX traces: every tower of the update goes through the whole-tower
    path (B % 8 == 0, H = 128), and the update agrees as the per-layer one
    does."""
    monkeypatch.setenv("FUSED_TOWER", "1")
    calls = []
    real = p_fm.mlp_tower
    monkeypatch.setattr(p_fm, "mlp_tower", lambda *a, **k: calls.append(1) or real(*a, **k))
    j_ts, j_m, runner, p_m, before = _run_both(envs, cases, "mappo", ppo_epoch=2)
    assert len(calls) == 2 * 2 * N        # epochs x (actor, critic) x agents
    _check_metrics_and_stats(j_ts, j_m, runner, p_m)
    _assert_params_close(j_ts.actor_params["params"], runner.state.actor_params, before[0],
                         LR, 2, "tower actor")
    _assert_params_close(j_ts.critic_params["params"], runner.state.critic_params, before[1],
                         LR, 2, "tower critic")


@pytest.fixture(scope="module")
def hatrpo_run(envs, cases):
    """One HATRPO update phase of each package (ppo_epoch 1, ls_step 3), as
    tests/test_fused_mlp.py:310-311 cuts it."""
    return _run_both(envs, cases, "hatrpo", ppo_epoch=1, ls_step=3)


def test_hatrpo_update_phase_matches_jax(hatrpo_run):
    """Metrics, PopArt statistics and the critic's one Adam step per agent;
    the actor's optimizer does not advance."""
    j_ts, j_m, runner, p_m, before = hatrpo_run
    _check_metrics_and_stats(j_ts, j_m, runner, p_m)
    _assert_params_close(j_ts.critic_params["params"], runner.state.critic_params, before[1],
                         LR, 1, "hatrpo critic")
    assert runner.state.actor_opt.count == [0] * N
    assert runner.state.critic_opt.count == [1] * N


def test_hatrpo_trust_region_step_matches_jax(hatrpo_run):
    j_ts, _, runner, _, before = hatrpo_run
    jp, _ = marl_params_from_flax({"params": _np_tree(j_ts.actor_params["params"])},
                                  {"params": {}})
    step = lambda tree: torch.cat([x.reshape(N, -1) for x in tree_leaves_like(jp, tree)], 1) \
        - torch.cat([x.reshape(N, -1) for x in tree_leaves_like(jp, before[0])], 1)
    d_p, d_j = step(runner.state.actor_params), step(jp)
    for i, log in enumerate(runner.trpo_log):
        print(f"agent step {i}: {log['fvps']} Fisher-vector products, candidate "
              f"{log['accepted']} accepted; (improve, ratio - accept_ratio, kl_threshold - kl) "
              f"per candidate: {[(c[0], c[1] - 0.5, 0.016 - c[2]) for c in log['candidates']]}")
    rel = (d_p - d_j).norm(dim=1) / d_j.norm(dim=1)
    print("relative step differences per agent:", rel.tolist())
    assert (d_j.norm(dim=1) > 0).all()
    assert (rel < 0.01).all(), rel


def test_actor_apply_jvp_matches_jax(cases):
    ts, traj, _ = cases["mappo"]
    obs = np.moveaxis(np.asarray(traj["obs"]), 2, 0).reshape(N, T * E, -1)
    rng = np.random.default_rng(5)
    tangent = jax.tree_util.tree_map(
        lambda x: (0.05 * rng.normal(size=x.shape)).astype(np.float32), _np_tree(ts.actor_params))
    m_j, s_j, dm_j, ds_j = j_fused_nets.actor_apply_jvp(ts.actor_params, tangent, obs,
                                                        interpret=True)
    pa, _ = marl_params_from_flax(_np_tree(ts.actor_params), {"params": {}})
    dpa, _ = marl_params_from_flax(tangent, {"params": {}})
    m_p, s_p, dm_p, ds_p = p_runner.fused_nets.actor_apply_jvp(pa, dpa, torch.from_numpy(obs))
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j), rtol=0, atol=3e-2)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=1e-5, atol=0)
    scale = max(float(np.abs(np.asarray(dm_j)).max()), 1e-3)
    np.testing.assert_allclose(dm_p.numpy(), np.asarray(dm_j), rtol=0, atol=5e-2 * scale)
    np.testing.assert_allclose(ds_p.numpy(), np.asarray(ds_j), rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_fisher_vector_product_matches_jax(envs, cases, fused):
    """Agent 0 at its initial parameters: the port's `_fvp` (Gauss-Newton on
    the fused path, double backward on the flax mirror) against the JAX
    runner's compositions: J^T M (J v) of the fused actor in interpret mode,
    or jvp(grad(mean_kl)) of the flax actor; both + 0.1 v."""
    from jax.flatten_util import ravel_pytree
    _, penv = envs
    ts, traj, _ = cases["mappo"]
    obs = np.moveaxis(np.asarray(traj["obs"]), 2, 0).reshape(N, T * E, -1)[0]
    ap_j = jax.tree_util.tree_map(lambda x: x[0], ts.actor_params)
    flat, unravel = ravel_pytree(ap_j)
    v = 0.1 * jax.random.normal(jax.random.PRNGKey(9), flat.shape)
    Bn = obs.shape[0]
    if fused:
        obs_in = j_fm.feature_norm(jnp.asarray(obs))
        one = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)
        _, s_o, dm, ds = j_fused_nets.actor_apply_jvp(one(ap_j), one(unravel(v)), obs_in[None],
                                                      prenormed=True, interpret=True)

        def apply_j(p):
            m, s = j_fused_nets.actor_apply(one(p), obs_in[None], prenormed=True,
                                            interpret=True)
            return m[0], s[0]
        _, pull = jax.vjp(apply_j, ap_j)
        (gt,) = pull((dm[0] / s_o[0] ** 2 / Bn, 2.0 * ds[0] / s_o[0] ** 2 / Bn))
        ref = ravel_pytree(gt)[0] + 0.1 * v
    else:
        actor = JRunner(envs[0], num_envs=E, cfg=_configs("mappo")[0], seed=0,
                        print_log=False).actor
        m_o, s_o = actor.apply(ap_j, obs)

        def mean_kl(pf):
            m, s = actor.apply(unravel(pf), obs)
            return jnp.mean(jnp.sum(jnp.log(s / s_o) + (s_o ** 2 + (m_o - m) ** 2)
                                    / (2.0 * s ** 2) - 0.5, axis=-1))
        ref = jax.jvp(jax.grad(mean_kl), (flat,), (v,))[1] + 0.1 * v
    ref_t, _ = marl_params_from_flax(_np_tree(unravel(ref)), {"params": {}})
    v_t, _ = marl_params_from_flax(_np_tree(unravel(v)), {"params": {}})

    runner = _port_runner(penv, _configs("hatrpo", use_fused_mlp=fused)[1], ts)
    ap = tree_map(lambda x: x[0:1], runner.state.actor_params)
    a_apply, _, norm = runner._update_nets()
    obs_p = norm(torch.from_numpy(obs)[None])
    req = [x.detach().clone().requires_grad_() for x in tree_leaves(ap)]
    mean, std = a_apply(p_runner.tree_unflatten(ap, req), obs_p)
    fvp = runner._fvp(ap, obs_p, req, mean, std)
    v_p = torch.cat([x.reshape(-1) for x in tree_leaves(tree_map(lambda _, x: x, ap, v_t))])
    out = torch.split(fvp(v_p), [x.numel() for x in req])
    want = tree_leaves(tree_map(lambda _, x: x, ap, ref_t))
    scale = max(float(np.abs(np.asarray(ref)).max()), 1e-4)
    for (name, _), got, w in zip(_named_leaves(ap), out, want):
        np.testing.assert_allclose(got.reshape(w.shape).detach().numpy(), w.numpy(), rtol=0,
                                   atol=8e-2 * scale, err_msg=name)


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
    hatrpo = mk(algorithm_name="hatrpo")
    assert hatrpo.sequential and hatrpo.is_happo and hatrpo.is_trpo
    cfg = PConfig.from_cfg_train({}, "hatrpo")
    assert (cfg.kl_threshold, cfg.ls_step, cfg.accept_ratio, cfg.ppo_epoch, cfg.hidden_size) \
        == (0.016, 10, 0.5, 5, 512)
    # a mesh is taken; one of two data ranks without torch.distributed holds
    # one env and raises at its first collective
    from massive_marl_tpu_torch.parallel.mesh import make_mesh
    two = PRunner(PTenAnt(ENV_CFG, device="cpu"), 2, PConfig(), device="cpu",
                  mesh=make_mesh(2), print_log=False)
    assert two.local_envs == 1
    two.init_state()
    with pytest.raises(RuntimeError, match="init_distributed"):
        two.train_iter()
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
