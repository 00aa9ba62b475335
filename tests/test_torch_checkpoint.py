"""The port's checkpoint files against flax's, on the CPU.

* utils/msgpack_lite against flax.serialization: the port's bytes are
  flax's bytes (msgpack_serialize of the same tree, byte for byte) and load
  with msgpack_restore; flax's bytes decode with msgpack_lite; for f32,
  int32, bf16, 0-d arrays, numpy scalars, nested and empty maps.  What the
  codec does not support (complex numbers, flax's chunked arrays) raises.
* PPO: the port's `save` loads with flax.serialization.from_bytes into a
  template made from the JAX trainer's own model and optax chain, and a
  file written by flax from a JAX state `load`s into the port.  The leaves
  agree exactly (weights transposed); the restored policy's deterministic
  actions equal those of the port's policy bridged from the same flax
  parameters (exactly) and flax's own (rtol 2e-2 plus 2% of the scale,
  tests/test_torch_ppo.py's tolerance for bf16 towers).
* MARL: the same both ways under optimizer "adam" (the default chain),
  "adam" with weight_decay and use_linear_lr_decay, "fused_adam" and
  bf16_adam_mu; the restored actor's means against flax's vmapped apply at
  tests/test_torch_marl.py's 3e-2.  A file of the other optimizer's
  structure is refused with ValueError.
* AsyncCheckpointer, restore_latest, the atomic overwrite, and a killed
  write (a stale .tmp) ignored by restore_latest and latest_checkpoint.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from massive_marl_tpu.algos.marl import nets as j_marl_nets
from massive_marl_tpu.algos.marl.runner import MarlConfig as JMarlConfig
from massive_marl_tpu.algos.marl.runner import MarlRunner as JRunner
from massive_marl_tpu.algos.rl.ppo import PPO as JPPO
from massive_marl_tpu.algos.rl.ppo import PPOConfig as JPPOConfig
from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu_torch.algos.marl.runner import MarlConfig as PMarlConfig
from massive_marl_tpu_torch.algos.marl.runner import MarlRunner as PRunner
from massive_marl_tpu_torch.algos.rl.ppo import PPO as PPPO
from massive_marl_tpu_torch.algos.rl.ppo import PPOConfig as PPPOConfig
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt
from massive_marl_tpu_torch.utils import checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.bridge import actor_critic_from_flax, marl_state_to_flax
from massive_marl_tpu_torch.utils.config import latest_checkpoint
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map

ENV_CFG = {"sim": {"substeps": 1}}
E = 4
PPO_HIDDEN = (32, 16)
MARL_HIDDEN = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    return JTenAnt(ENV_CFG), PTenAnt(ENV_CFG, device="cpu")


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# ------------------------------------------------------------------- codec
def _codec_cases():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    i32 = rng.integers(-70000, 70000, size=(7,)).astype(np.int32)
    bf = rng.normal(size=(4, 2)).astype(np.float32)
    return {
        "f32": ({"w": f32}, {"w": torch.from_numpy(f32)}),
        "int32": ({"c": i32}, {"c": torch.from_numpy(i32)}),
        "bf16": ({"mu": jnp.asarray(bf, jnp.bfloat16)}, {"mu": _bf16(bf)}),
        "0-d": ({"lr": np.asarray(3e-4, np.float32), "it": np.asarray(7, np.int32)},
                {"lr": torch.tensor(3e-4), "it": torch.tensor(7, dtype=torch.int32)}),
        "nested": ({"a": {"b": {"k": f32[:1]}, "x": 1.5, "n": -3, "big": 2 ** 40, "t": True,
                          "none": None, "s": "name" * 10}},
                   {"a": {"b": {"k": torch.from_numpy(f32[:1])}, "x": 1.5, "n": -3,
                          "big": 2 ** 40, "t": True, "none": None, "s": "name" * 10}}),
        "empty": ({"opt": {"0": {}, "1": {"count": i32[:1]}}, "e": {}},
                  {"opt": {"0": {}, "1": {"count": torch.from_numpy(i32[:1])}}, "e": {}}),
        "many-keys": ({f"k{i}": np.full((2,), i, np.float32) for i in range(20)},
                      {f"k{i}": torch.full((2,), float(i)) for i in range(20)}),
    }


def _sorted(tree):
    """Keys in sorted order at every level: flax's msgpack_serialize copies
    the tree with jax.tree_util.tree_map, which sorts them (to_bytes
    serializes in place and keeps the order)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


CODEC = {k: tuple(_sorted(t) for t in v) for k, v in _codec_cases().items()}


def _assert_tree_equal(port, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), path
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, torch.Tensor):
        ref = np.asarray(ref)
        if port.dtype == torch.bfloat16:
            assert ref.dtype == jnp.bfloat16, path
            np.testing.assert_array_equal(port.float().numpy(), ref.astype(np.float32), path)
        else:
            assert port.numpy().dtype == ref.dtype, path
            np.testing.assert_array_equal(port.numpy(), ref, path)
        assert tuple(port.shape) == ref.shape, path
    else:
        assert type(port) is type(ref) and port == ref, path


@pytest.mark.parametrize("case", sorted(CODEC))
def test_codec_matches_flax_both_ways(case):
    ref, port = CODEC[case]
    blob = msgpack_lite.packb(port)
    assert blob == serialization.msgpack_serialize(ref)
    _assert_tree_equal(msgpack_lite.unpackb(blob), ref)
    restored = serialization.msgpack_restore(blob)
    _assert_tree_equal(msgpack_lite.unpackb(serialization.msgpack_serialize(restored)), ref)


def test_codec_numpy_scalars_and_refusals():
    blob = serialization.to_bytes({"s": np.float32(2.5), "i": np.int32(-4)})
    got = msgpack_lite.unpackb(blob)
    assert got == {"s": np.float32(2.5), "i": np.int32(-4)}
    assert type(got["s"]) is np.float32 and type(got["i"]) is np.int32
    assert msgpack_lite.packb({"s": np.float32(2.5), "i": np.int32(-4)}) == blob
    with pytest.raises(ValueError, match="complex"):
        msgpack_lite.packb({"z": torch.zeros(2, dtype=torch.complex64)})
    with pytest.raises(ValueError, match="complex"):
        msgpack_lite.unpackb(serialization.msgpack_serialize({"z": 1 + 2j}))
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {"0": 1},
                                   "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack_lite.unpackb(chunked)
    with pytest.raises(ValueError, match="object"):
        msgpack_lite.packb({"o": object()})
    with pytest.raises(ValueError, match="not a string"):
        msgpack_lite.packb({1: 2})


# --------------------------------------------------------------------- PPO
def _jax_ppo_template(jenv):
    jppo = JPPO(jenv, num_envs=E, cfg=JPPOConfig(hidden=PPO_HIDDEN), seed=0, print_log=False)
    params = jppo.model.init(jax.random.PRNGKey(1), jnp.zeros((1, jppo.obs_dim)))
    return jppo, {"params": params, "opt_state": jppo.tx.init(params),
                  "lr": jnp.asarray(jppo.cfg.lr), "iteration": jnp.asarray(0, jnp.int32)}


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):  # step counts: one per agent, as in a real run
            return jnp.asarray(np.arange(x.size).reshape(x.shape) + 7, x.dtype)
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32), x.dtype)
    return jax.tree_util.tree_map(leaf, tree)


def _port_ppo(penv):
    ppo = PPPO(penv, E, PPPOConfig(hidden=PPO_HIDDEN), seed=3, device="cpu", print_log=False)
    ppo.init_state()
    return ppo


def test_ppo_port_file_loads_in_flax(envs, tmp_path):
    jenv, penv = envs
    _, template = _jax_ppo_template(jenv)
    ppo = _port_ppo(penv)
    g = torch.Generator().manual_seed(0)
    ppo.state.opt.mu = [torch.randn(p.shape, generator=g) for p in ppo.model.parameters()]
    ppo.state.opt.nu = [torch.rand(p.shape, generator=g) for p in ppo.model.parameters()]
    ppo.state.opt.count, ppo.state.iteration = 13, 5
    ppo.state.lr = torch.tensor(1.25e-4)
    path = str(tmp_path / "model_5.ckpt")
    ppo.save(path)
    restored = serialization.from_bytes(template, open(path, "rb").read())
    names = [n for n, _ in ppo.model.named_parameters()]
    ported = {"params": dict(zip(names, ppo.model.parameters())),
              "mu": dict(zip(names, ppo.state.opt.mu)), "nu": dict(zip(names, ppo.state.opt.nu))}
    for key, tree in (("params", restored["params"]), ("mu", restored["opt_state"][1].mu),
                      ("nu", restored["opt_state"][1].nu)):
        back = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        for n in names:
            assert torch.equal(back[n], ported[key][n].detach()), (key, n)
    assert int(restored["opt_state"][1].count) == 13 and int(restored["iteration"]) == 5
    assert np.asarray(restored["lr"]).dtype == np.float32
    assert float(restored["lr"]) == np.float32(1.25e-4)


def test_ppo_flax_file_loads_in_port(envs, tmp_path):
    jenv, penv = envs
    jppo, template = _jax_ppo_template(jenv)
    state = dict(template)
    state["opt_state"] = _random_like(template["opt_state"], 1)
    state["lr"], state["iteration"] = jnp.asarray(2e-3), jnp.asarray(9, jnp.int32)
    path = str(tmp_path / "model_9.ckpt")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(state))
    ppo = _port_ppo(penv)
    ppo.load(path)
    np_tree = jax.tree_util.tree_map(np.asarray, state)
    names = [n for n, _ in ppo.model.named_parameters()]
    for got, ref in ((dict(ppo.model.named_parameters()), np_tree["params"]),
                     (dict(zip(names, ppo.state.opt.mu)), np_tree["opt_state"][1].mu),
                     (dict(zip(names, ppo.state.opt.nu)), np_tree["opt_state"][1].nu)):
        want = actor_critic_from_flax(ref)
        for n in names:
            assert torch.equal(got[n].detach(), want[n]), n
    assert ppo.state.opt.count == int(state["opt_state"][1].count)
    assert ppo.state.iteration == 9 and float(ppo.state.lr) == np.float32(2e-3)

    obs = np.clip(np.random.default_rng(2).normal(0, 3, (16, jppo.obs_dim)), -8, 8) \
        .astype(np.float32)
    act = ppo.act_inference(torch.from_numpy(obs)).numpy()
    bridged = _port_ppo(penv)
    bridged.model.load_state_dict(actor_critic_from_flax(np_tree["params"]))
    np.testing.assert_array_equal(act, bridged.act_inference(torch.from_numpy(obs)).numpy())
    j_mean = np.asarray(jppo.model.apply(state["params"], jnp.clip(obs, -5.0, 5.0))[0])
    np.testing.assert_allclose(act, j_mean, rtol=2e-2, atol=2e-2 * np.abs(j_mean).max())


# -------------------------------------------------------------------- MARL
OPTIMIZERS = {
    "adam": {},
    "adam_wd_decay": {"weight_decay": 1e-4, "use_linear_lr_decay": True},
    "fused_adam": {"optimizer": "fused_adam"},
    "bf16_mu": {"bf16_adam_mu": True},
}


def _marl_configs(kw):
    base = {"hidden_size": MARL_HIDDEN}
    return (dataclasses.replace(JMarlConfig.from_cfg_train(base, "mappo"), **kw),
            dataclasses.replace(PMarlConfig.from_cfg_train(base, "mappo"), **kw))


def _jax_marl_template(jenv, jcfg):
    r = JRunner(jenv, num_envs=E, cfg=jcfg, seed=0, print_log=False)
    ka, kc = jax.random.split(jax.random.PRNGKey(4))
    ap = jax.vmap(lambda k: r.actor.init(k, jnp.zeros((1, r.obs_dim))))(jax.random.split(ka, r.N))
    cp = jax.vmap(lambda k: r.critic.init(k, jnp.zeros((1, r.critic_in_dim))))(
        jax.random.split(kc, r.N))
    vn = jax.vmap(lambda _: j_marl_nets.ValueNorm.create())(jnp.arange(r.N))
    return r, {"actor_params": ap, "critic_params": cp,
               "actor_opt": jax.vmap(r.actor_tx.init)(ap),
               "critic_opt": jax.vmap(r.critic_tx.init)(cp),
               "vnorm": vn, "iteration": jnp.asarray(0, jnp.int32)}


def _flat_state_dict(tree):
    """path -> numpy leaf of a flax state dict."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        else:
            out[path] = np.asarray(x)
    walk(serialization.to_state_dict(tree), "")
    return out


def _port_marl(penv, pcfg):
    r = PRunner(penv, E, pcfg, seed=0, device="cpu", print_log=False)
    r.init_state()
    return r


def _randomize_port(r, seed):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda x: torch.randn(x.shape, generator=g).to(x.dtype)
    st = r.state
    st.actor_params = tree_map(rnd, st.actor_params)
    st.critic_params = tree_map(rnd, st.critic_params)
    for opt in (st.actor_opt, st.critic_opt):
        opt.mu = [rnd(m) for m in opt.mu]
        opt.nu = [rnd(m).abs() for m in opt.nu]
        opt.count = [3 + i for i in range(r.N)]
    st.vnorm.mean, st.vnorm.mean_sq, st.vnorm.debias = (rnd(st.vnorm.mean) for _ in range(3))
    st.iteration = 11


def _port_flat(r, pcfg):
    """The port runner's state as path -> tensor leaf, in the JAX tree's paths."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, torch.Tensor):
            out[path] = x.detach()
        else:
            out[path] = torch.from_numpy(np.asarray(x))
    walk(marl_state_to_flax(pcfg, r.state), "")
    return out


def _assert_flat_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        p = port[k]
        if v.dtype == jnp.bfloat16:
            assert p.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(p.float().numpy(), v.astype(np.float32), k)
        else:
            np.testing.assert_array_equal(p.numpy(), v, k)
            assert p.numpy().dtype == v.dtype, k


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_marl_checkpoint_both_ways(envs, tmp_path, opt):
    jenv, penv = envs
    jcfg, pcfg = _marl_configs(OPTIMIZERS[opt])
    jr, template = _jax_marl_template(jenv, jcfg)

    port = _port_marl(penv, pcfg)
    _randomize_port(port, 0)
    path = str(tmp_path / "marl_11.ckpt")
    port.save(path)
    restored = serialization.from_bytes(template, open(path, "rb").read())
    _assert_flat_equal(_port_flat(port, pcfg), _flat_state_dict(restored))

    ref = _random_like(template, 5)
    jpath = str(tmp_path / "jax.ckpt")
    with open(jpath, "wb") as f:
        f.write(serialization.to_bytes(ref))
    back = _port_marl(penv, pcfg)
    back.restore(jpath)
    _assert_flat_equal(_port_flat(back, pcfg), _flat_state_dict(ref))
    assert back.state.iteration == int(ref["iteration"])

    obs = np.clip(np.random.default_rng(3).normal(0, 2, (jr.N, 6, back.obs_dim)), -7, 7) \
        .astype(np.float32)
    mean_p, _ = back.actor.apply(back.state.actor_params, torch.from_numpy(obs))
    mean_j, _ = jax.vmap(jr.actor.apply)(ref["actor_params"], obs)
    np.testing.assert_allclose(mean_p.numpy(), np.asarray(mean_j), rtol=0, atol=3e-2)


@pytest.mark.parametrize("saved,loaded", [("adam", "fused_adam"), ("fused_adam", "adam"),
                                          ("adam", "adam_wd_decay")])
def test_marl_other_optimizer_refused(envs, tmp_path, saved, loaded):
    _, penv = envs
    writer = _port_marl(penv, _marl_configs(OPTIMIZERS[saved])[1])
    path = str(tmp_path / "marl_1.ckpt")
    writer.save(path)
    reader = _port_marl(penv, _marl_configs(OPTIMIZERS[loaded])[1])
    before = [x.clone() for x in tree_leaves(reader.state.actor_params)]
    with pytest.raises(ValueError, match="cfg.optimizer"):
        reader.restore(path)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(reader.state.actor_params)))


# ------------------------------------------------------- files on the disk
def test_async_checkpointer_and_restore_latest(tmp_path):
    d = str(tmp_path / "ck")
    ck = checkpoint.AsyncCheckpointer(d, keep=2)
    w = torch.zeros(3)
    for step in (1, 2, 3):
        w += 1
        ck.save(step, {"w": w, "step": torch.tensor(step, dtype=torch.int32), "e": {}})
    w += 100           # after save returned: the pending writes hold their own copies
    ck.close()
    assert sorted(os.listdir(d)) == ["ckpt_2.ckpt", "ckpt_3.ckpt"]
    template = {"w": torch.zeros(3), "step": torch.tensor(0, dtype=torch.int32), "e": {}}
    tree, step = checkpoint.restore_latest(d, template)
    assert step == 3 and torch.equal(tree["w"], torch.full((3,), 3.0)) and int(tree["step"]) == 3
    assert checkpoint.restore_latest(str(tmp_path / "none"), template) == (None, None)
    with pytest.raises(ValueError, match="lacks keys"):
        checkpoint.restore_into({"w": torch.zeros(3), "z": torch.zeros(1)}, tree)
    with pytest.raises(ValueError, match=r"\(3,\)"):
        checkpoint.restore_into({"w": torch.zeros(4)}, tree)
    ck = checkpoint.AsyncCheckpointer(d, keep=2)
    ck.save(4, {"o": object()})         # a write that fails reaches the caller
    with pytest.raises(ValueError, match="cannot encode object"):
        ck.wait()
    ck.close()
    assert sorted(os.listdir(d)) == ["ckpt_2.ckpt", "ckpt_3.ckpt"]


def test_killed_write_and_atomic_overwrite(tmp_path, monkeypatch):
    d = tmp_path / "seed1"
    path = str(d / "model_2.ckpt")
    checkpoint.atomic_write_bytes(path, msgpack_lite.packb({"v": torch.tensor([1.0])}))
    checkpoint.atomic_write_bytes(path, msgpack_lite.packb({"v": torch.tensor([2.0])}))
    assert sorted(os.listdir(d)) == ["model_2.ckpt"]
    assert float(checkpoint.load_tree(path)["v"]) == 2.0

    def killed(src, dst):
        raise KeyboardInterrupt("killed before the rename")
    monkeypatch.setattr(os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.atomic_write_bytes(str(d / "model_3.ckpt"), b"\x81\xa1v")
    monkeypatch.undo()
    assert sorted(os.listdir(d)) == ["model_2.ckpt", "model_3.ckpt.tmp"]
    assert latest_checkpoint(str(tmp_path)) == path
    (d / "ckpt_9.ckpt.tmp").write_bytes(b"truncated")
    checkpoint.atomic_write_bytes(str(d / "ckpt_4.ckpt"),
                                  msgpack_lite.packb({"v": torch.tensor([4.0])}))
    tree, step = checkpoint.restore_latest(str(d), {"v": torch.zeros(1)})
    assert step == 4 and float(tree["v"]) == 4.0
