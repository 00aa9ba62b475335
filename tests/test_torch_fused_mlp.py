"""The port's fused Dense->ELU->LayerNorm block and MARL nets against the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  JAX's
Pallas kernels run in interpret mode, as tests/test_fused_mlp.py runs them;
the port's wrappers take their plain PyTorch versions on CPU tensors.

Tolerances and why:
  * bf16 outputs of one block (y, a, dx): within one bf16 ulp (relative
    2^-7), because both sides round the same f32 values and only the f32
    summation order of the products and statistics differs;
  * f32 sums of f32 values (db, dgamma, dbeta): 1e-5 of the output's scale
    (summation order);
  * dW, dg0, db0: 1e-3 of the output's scale, because they sum products of
    dh rounded to bf16, and the summation order of the LayerNorm backward
    flips a few of those roundings by one ulp;
  * whole towers (actor/critic heads): the one-ulp flips of each layer feed
    the next, so the heads agree to 2e-2 of their scale;
  * the flax-mirror nets against flax.apply: the same bf16 roundings in the
    same places, so rtol 2^-7 on the bf16 stream's outputs, 2e-2 of the
    scale on the float32 heads;
  * ValueNorm/norm_targets: float32 means taken in another order, so
    rtol 1e-6 and atol 2e-6 for the normalized targets near 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.marl import fused_nets as j_fused_nets
from massive_marl_tpu.algos.marl import nets as j_nets
from massive_marl_tpu.ops import fused_mlp as j_fm
from massive_marl_tpu_torch.algos.marl import fused_nets as p_fused_nets
from massive_marl_tpu_torch.algos.marl import nets as p_nets
from massive_marl_tpu_torch.ops import fused_mlp as p_fm
from massive_marl_tpu_torch.utils.bridge import marl_params_from_flax

BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _block_inputs(seed, N, B, Din, H):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, off=0.0: (off + scale * rng.normal(size=s)).astype(np.float32)
    x = np.asarray(j_fm.feature_norm(jnp.asarray(f(N, B, Din - 10))), np.float32)  # bf16 values
    return dict(x=x, w=f(N, Din, H, scale=(2.0 / Din) ** 0.5), b=f(N, H, scale=0.1),
                g=f(N, H, scale=0.1, off=1.0), be=f(N, H, scale=0.1),
                g0=f(N, Din, scale=0.1, off=1.0), b0=f(N, Din, scale=0.1),
                dy=f(N, B, H))


def _port_block_args(d):
    bf = torch.bfloat16
    return (_t(d["x"], bf), _t(d["w"]).to(bf), _t(d["b"]), _t(d["g"]), _t(d["be"]),
            _t(d["g0"]), _t(d["b0"]))


def _assert_bf16(got, ref, name):
    got, ref = _f32(got), _f32(ref)
    np.testing.assert_allclose(got, ref, rtol=BF16_ULP, atol=1e-3 * np.abs(ref).max(),
                               err_msg=name)


def _assert_sum(got, ref, name):
    """f32 sums; those over products of dh16 carry its one-ulp flips."""
    got, ref = _f32(got), _f32(ref)
    scale = 1e-3 if name in ("dw", "w", "dg0", "gamma0", "db0", "beta0") else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=scale * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("din", [128, 512])
def test_plain_forward_matches_pallas(din):
    d = _block_inputs(0, 2, 64, din, 128)
    xj = jnp.asarray(d["x"]).astype(jnp.bfloat16)
    yj, aj = j_fm._fwd_call(xj, d["w"], d["b"], d["g"], d["be"], d["g0"], d["b0"], 32, True)
    yp, ap = p_fm.fwd_plain(*_port_block_args(d))
    assert yp.dtype == ap.dtype == torch.bfloat16 and tuple(yp.shape) == (2, 64, 128)
    _assert_bf16(yp, yj, "y")
    _assert_bf16(ap, aj, "a")


@pytest.mark.parametrize("din", [128, 512])
def test_plain_backward_matches_pallas(din):
    d = _block_inputs(1, 2, 64, din, 128)
    xj = jnp.asarray(d["x"]).astype(jnp.bfloat16)
    _, aj = j_fm._fwd_call(xj, d["w"], d["b"], d["g"], d["be"], d["g0"], d["b0"], 32, True)
    dyj = jnp.asarray(d["dy"]).astype(jnp.bfloat16)
    ref = j_fm._bwd_call(dyj, aj, xj, d["w"], d["g"], d["g0"], d["b0"], 32, True)
    x, w16, _, g, _, g0, b0 = _port_block_args(d)
    got = p_fm.bwd_plain(_t(d["dy"], torch.bfloat16), _t(_f32(aj), torch.bfloat16), x, w16,
                         g, g0, b0)
    names = ["dx", "dw", "db", "dgamma", "dbeta", "dg0", "db0"]
    _assert_bf16(got[0], ref[0], "dx")
    for name, gp, rj in zip(names[1:], got[1:], ref[1:]):
        _assert_sum(gp, rj, name)


def test_dense_elu_ln_grads_match_jax_grad():
    """DenseEluLN (autograd.Function over the plain versions on the CPU)
    against jax.grad through the custom-VJP dense_elu_ln."""
    d = _block_inputs(2, 2, 64, 128, 128)
    c = np.random.default_rng(3).normal(size=(2, 64, 128)).astype(np.float32)

    def loss_j(x, w, b, g, be, g0, b0):
        y = j_fm.dense_elu_ln(x, w, b, g, be, g0, b0, 32, True)
        return jnp.sum(y.astype(jnp.float32) * c)

    args_j = (jnp.asarray(d["x"]), d["w"], d["b"], d["g"], d["be"], d["g0"], d["b0"])
    gj = jax.grad(loss_j, argnums=tuple(range(7)))(*args_j)
    args_p = [_t(d["x"]).requires_grad_()] + [_t(d[k]).requires_grad_()
                                              for k in ("w", "b", "g", "be", "g0", "b0")]
    y = p_fm.dense_elu_ln(args_p[0].to(torch.bfloat16), *args_p[1:])
    assert y.dtype == torch.bfloat16
    gp = torch.autograd.grad((y.float() * torch.from_numpy(c)).sum(), args_p)
    names = ["x", "w", "b", "gamma", "beta", "gamma0", "beta0"]
    _assert_bf16(gp[0], gj[0], "dx")
    for name, p, j in zip(names[1:], gp[1:], gj[1:]):
        _assert_sum(p, j, name)


@pytest.mark.parametrize("dim", [46, 388])
def test_feature_norm_matches_jax(dim):
    x = np.random.default_rng(dim).normal(0, 2, size=(2, 48, dim)).astype(np.float32)
    got, ref = p_fm.feature_norm(torch.from_numpy(x)), j_fm.feature_norm(jnp.asarray(x))
    assert tuple(got.shape) == (2, 48, 128 * -(-dim // 128)) and got.dtype == torch.bfloat16
    _assert_bf16(got, ref, "feature_norm")
    assert not _f32(got)[..., dim:].any()


@pytest.fixture(scope="module")
def stacked_nets():
    """jax.vmap-initialised actor (obs 46) and critic (share obs 388) at
    hidden 128 for N = 3 agents, their port twins, and inputs."""
    N, B = 3, 64
    actor = j_nets.MarlActor(act_dim=8, hidden_size=128)
    critic = j_nets.MarlCritic(hidden_size=128)
    ka, kc = jax.random.split(jax.random.PRNGKey(0))
    av = jax.vmap(lambda k: actor.init(k, jnp.zeros((1, 46))))(jax.random.split(ka, N))
    cv = jax.vmap(lambda k: critic.init(k, jnp.zeros((1, 388))))(jax.random.split(kc, N))
    # non-trivial LayerNorm affines, so the padded g0/b0 path is exercised
    rng = np.random.default_rng(4)
    perturb = lambda tree: jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
        if "LayerNorm" in jax.tree_util.keystr(p) else x, tree)
    av, cv = perturb(av), perturb(cv)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    pa, pc = marl_params_from_flax(np_tree(av), np_tree(cv))
    obs = np.clip(rng.normal(0, 2, size=(N, B, 46)), -7, 7).astype(np.float32)
    share = np.clip(rng.normal(0, 2, size=(N, B, 388)), -7, 7).astype(np.float32)
    return dict(actor=actor, critic=critic, av=av, cv=cv, pa=pa, pc=pc, obs=obs, share=share)


def _assert_head(got, ref, name):
    got, ref = _f32(got), _f32(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * np.abs(ref).max(), err_msg=name)


def test_mlp_base_stacked_matches_jax(stacked_nets):
    s = stacked_nets
    for p, jv, x in ((s["pa"], s["av"], s["obs"]), (s["pc"], s["cv"], s["share"])):
        ref = j_fm.mlp_base_stacked(jv["params"]["MLPBase_0"], jnp.asarray(x), interpret=True)
        got = p_fm.mlp_base_stacked(p["MLPBase_0"], torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(ref.shape)
        _assert_head(got, ref, f"MLPBase at in={x.shape[-1]}")


def test_mlp_base_stacked_jvp_matches_jax(stacked_nets):
    """The parameter-directional tangent of the critic's tower (share obs,
    so the padded feature-LayerNorm tangent is exercised) along a
    numpy-made tangent: h within 2e-2 of its scale, as the towers; dh within
    5e-2 of its scale, tests/test_fused_mlp.py:236-238's tolerance."""
    s = stacked_nets
    rng = np.random.default_rng(6)
    base = s["cv"]["params"]["MLPBase_0"]
    tangent = jax.tree_util.tree_map(
        lambda x: (0.05 * rng.normal(size=x.shape)).astype(np.float32), base)
    hj, dhj = j_fm.mlp_base_stacked_jvp(base, tangent, jnp.asarray(s["share"]), interpret=True)
    dt, _ = marl_params_from_flax({"params": tangent}, {"params": {}})
    hp, dhp = p_fm.mlp_base_stacked_jvp(s["pc"]["MLPBase_0"], dt, torch.from_numpy(s["share"]))
    _assert_head(hp, hj, "h")
    np.testing.assert_allclose(_f32(dhp), _f32(dhj), rtol=0,
                               atol=5e-2 * np.abs(_f32(dhj)).max(), err_msg="dh")


def test_fused_actor_and_critic_apply_match_jax(stacked_nets):
    s = stacked_nets
    mj, sj = j_fused_nets.actor_apply(s["av"], jnp.asarray(s["obs"]), interpret=True)
    mp, sp = p_fused_nets.actor_apply(s["pa"], torch.from_numpy(s["obs"]))
    _assert_head(mp, mj, "mean")
    np.testing.assert_allclose(_f32(sp), _f32(sj), rtol=1e-6)
    vj = j_fused_nets.critic_apply(s["cv"], jnp.asarray(s["share"]), interpret=True)
    vp = p_fused_nets.critic_apply(s["pc"], torch.from_numpy(s["share"]))
    assert tuple(vp.shape) == (3, 64)
    _assert_head(vp, vj, "value")


def test_fused_actor_grads_match_jax(stacked_nets):
    """Gradients of a logp-weighted loss through the fused actor, port
    autograd against jax.grad, at tests/test_fused_mlp.py:38-62's
    tolerance (6e-2 of each leaf's scale: bf16 streams in both)."""
    s = stacked_nets
    rng = np.random.default_rng(5)
    actions = rng.normal(size=(3, 64, 8)).astype(np.float32)
    adv = rng.normal(size=(3, 64)).astype(np.float32)

    def loss_j(p):
        mean, std = j_fused_nets.actor_apply(p, jnp.asarray(s["obs"]), interpret=True)
        return jnp.sum(jnp.mean(j_nets.normal_log_prob(mean, std, actions) * adv, axis=-1))

    gj = jax.grad(loss_j)(s["av"])["params"]
    leaves = {}

    def req(path, x):
        leaves[path] = x.clone().requires_grad_()
        return leaves[path]

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else req(path + (k,), v)
                for k, v in tree.items()}

    pp = walk(s["pa"])
    mean, std = p_fused_nets.actor_apply(pp, torch.from_numpy(s["obs"]))
    loss = (p_nets.normal_log_prob(mean, std, torch.from_numpy(actions))
            * torch.from_numpy(adv)).mean(-1).sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert len(grads) == len(jax.tree_util.tree_leaves(gj))
    for path, g in grads.items():
        ref = gj
        for k in path:
            ref = ref[k]
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=6e-2 * max(np.abs(ref).max(), 1e-3),
                                   err_msg="/".join(path))


def test_flax_mirror_nets_match_flax_apply(stacked_nets):
    s = stacked_nets
    mj, sj = jax.vmap(s["actor"].apply)(s["av"], s["obs"])
    actor = p_nets.MarlActor(act_dim=8, hidden_size=128)
    mp, sp = actor.apply(s["pa"], torch.from_numpy(s["obs"]))
    _assert_head(mp, mj, "mean")
    np.testing.assert_allclose(_f32(sp), _f32(sj), rtol=1e-6)
    # the bf16 stream itself, one layer deep
    base_j = j_nets.MLPBase(hidden_size=128)
    hj = jax.vmap(lambda v, x: base_j.apply({"params": v}, x))(
        s["av"]["params"]["MLPBase_0"], s["obs"])
    hp = p_nets.MLPBase(hidden_size=128).apply(s["pa"]["MLPBase_0"], torch.from_numpy(s["obs"]))
    assert hp.dtype == torch.bfloat16
    _assert_head(hp, hj, "MLPBase")
    vj = jax.vmap(s["critic"].apply)(s["cv"], s["share"])
    vp = p_nets.MarlCritic(hidden_size=128).apply(s["pc"], torch.from_numpy(s["share"]))
    _assert_head(vp, vj, "value")


def test_port_init_matches_flax_layout(stacked_nets):
    """The port's own init gives the flax tree's keys and shapes, the
    orthogonal gains (sqrt 2 hidden, 0.01 actor head, sqrt 2 critic head)
    and std_param = std_x_coef."""
    s = stacked_nets
    g = torch.Generator().manual_seed(0)
    pa = p_nets.MarlActor(act_dim=8, hidden_size=128).init(3, 46, g)
    pc = p_nets.MarlCritic(hidden_size=128).init(3, 388, g)
    shapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
    assert shapes(pa) == shapes(s["pa"]) and shapes(pc) == shapes(s["pc"])
    for w, gain in ((pa["MLPBase_0"]["Dense_1"]["kernel"][0], 2 ** 0.5),
                    (pa["Dense_0"]["kernel"][0], 0.01), (pc["Dense_0"]["kernel"][1], 2 ** 0.5)):
        wtw = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(wtw.numpy(), gain ** 2 * np.eye(wtw.shape[0]), atol=1e-5)
    assert torch.equal(pa["std_param"], torch.ones(3, 8))


@pytest.mark.parametrize("mode", ["popart", "valuenorm", "none"])
def test_norm_targets_match_jax(mode):
    rng = np.random.default_rng(6)
    vj = jax.vmap(lambda _: j_nets.ValueNorm.create())(jnp.arange(3))
    vp = p_nets.ValueNorm.create((3,))
    for _ in range(3):   # three loss calls: the stats' cadence accumulates
        ret = rng.normal(4.0, 3.0, size=(3, 64)).astype(np.float32)
        vj, rcj, roj = jax.vmap(lambda v, r: j_nets.norm_targets(v, r, mode))(vj, ret)
        vp, rcp, rop = p_nets.norm_targets(vp, torch.from_numpy(ret), mode)
        for got, ref in ((rcp, rcj), (rop, roj), (vp.mean, vj.mean), (vp.mean_sq, vj.mean_sq),
                         (vp.debias, vj.debias)):
            np.testing.assert_allclose(_f32(got), _f32(ref), rtol=1e-6, atol=2e-6)
    np.testing.assert_allclose(_f32(vp.denormalize(torch.ones(3, 5))),
                               _f32(jax.vmap(lambda v: v.denormalize(jnp.ones(5)))(vj)),
                               rtol=1e-6)
