"""The port's domain randomization (phys/dr.py and the envs' DR bookkeeping)
against the JAX package's on the CPU.

JAX draws from threefry keys, which torch cannot replay, so these tests
feed both packages the same standard draws: the JAX functions run with
jax.random.normal / uniform replaced by functions that hand out numpy
arrays in the order the JAX code asks for them, and the port's transforms
(`_factor`, `apply_noise`, `dr_from_draws`) take the same arrays.
Tolerances: 1e-6 (float32 rounding of the same arithmetic).

* sched_scaling, _sched_range and the factor over dist x op x schedule;
  _apply; noise_fn with its correlated part and a schedule; sample_dr per
  articulation (with and without `maps_to: armature`, with a frame);
  get_actor_params_info.
* sample_dr under a fixed torch.Generator: each field's range and moments;
  skip_setup_only.
* The envs' _dr_reset (TenAnt and OneAnt) against JAX's on numpy-made
  states: the frequency gate, the setup_only mass, the correlated noise
  chosen with the parameters; and through the port's step_batch, the
  correlated noise held between re-randomizations.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.envs.one_ant import OneAntEnv as JOneAnt
from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu.phys import dr as j_dr
from massive_marl_tpu.phys import mjcf as j_mjcf
from massive_marl_tpu_torch.envs.one_ant import OneAntEnv as POneAnt
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt
from massive_marl_tpu_torch.phys import dr as p_dr
from massive_marl_tpu_torch.phys import mjcf as p_mjcf
from massive_marl_tpu_torch.utils import yaml_lite
from test_torch_yaml_lite import ROOT

FIELDS = ("mass", "damping", "armature", "jnt_lo", "jnt_hi")
TENANT_RP = yaml_lite.load(str(ROOT / "cfg" / "TenAnt.yaml"))["task"]["randomization_params"]


def _spec(armature=False):
    spec = copy.deepcopy(TENANT_RP["actor_params"]["ant"])
    if armature:
        spec["dof_properties"]["stiffness"]["maps_to"] = "armature"
    return spec


class Draws:
    """Stand-ins for jax.random.normal / uniform that return the queued
    numpy draws in order (uniform: minval + (maxval - minval) * u)."""

    def __init__(self, draws):
        self.queue = list(draws)

    def normal(self, key, shape=(), dtype=None):
        z = self.queue.pop(0)
        assert z.shape == tuple(shape)
        return jnp.asarray(z)

    def uniform(self, key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = jnp.asarray(self.queue.pop(0))
        assert u.shape == tuple(shape)
        return minval + (maxval - minval) * u


@pytest.fixture
def feed(monkeypatch):
    def install(draws):
        d = Draws(draws)
        monkeypatch.setattr(jax.random, "normal", d.normal)
        monkeypatch.setattr(jax.random, "uniform", d.uniform)
        return d
    return install


def _std(dist, shape, rng):
    return (rng.standard_normal(shape) if dist == "gaussian" else rng.random(shape)) \
        .astype(np.float32)


SCHEDULES = [(None, None), ("linear", 1500), ("linear", 6000), ("constant", 100),
             ("constant", 5000)]


@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
@pytest.mark.parametrize("op", ["additive", "scaling"])
@pytest.mark.parametrize("sched,frame", SCHEDULES)
def test_factor_and_schedule_match_jax(feed, dist, op, sched, frame):
    prop = {"range": [0.2, 0.1] if dist == "gaussian" else [0.7, 1.3], "operation": op,
            "distribution": dist}
    if sched:
        prop.update(schedule=sched, schedule_steps=3000)
    z = _std(dist, (64,), np.random.default_rng(1))
    feed([z])
    want = np.asarray(j_dr._sample(None, prop, (64,), frame))
    frame_t = None if frame is None else torch.full((64,), frame, dtype=torch.int32)
    got = p_dr._factor(prop, torch.from_numpy(z), frame_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    s_j = j_dr.sched_scaling(prop, frame if frame is not None else 0)
    s_p = p_dr.sched_scaling(prop, frame if frame is not None else 0)
    np.testing.assert_allclose(np.asarray(s_p, np.float32), np.asarray(s_j, np.float32))
    base = np.linspace(0.5, 1.5, 64, dtype=np.float32)
    np.testing.assert_allclose(p_dr._apply(prop, torch.from_numpy(base), got).numpy(),
                               np.asarray(j_dr._apply(prop, jnp.asarray(base), jnp.asarray(want))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
@pytest.mark.parametrize("corr", [False, True])
def test_noise_matches_jax(feed, dist, corr):
    spec = {"range": [0.0, 0.02] if dist == "gaussian" else [-0.01, 0.03],
            "range_correlated": [0.05, 0.2], "operation": "additive", "distribution": dist,
            "schedule": "linear", "schedule_steps": 100}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 388)).astype(np.float32)
    frame = np.array([10, 50, 400], np.int32)
    white, cz = _std(dist, (388,), rng), rng.standard_normal((3, 388)).astype(np.float32)
    jf = j_dr.noise_fn(spec)
    want = []
    for e in range(3):
        feed([white] + ([cz[e]] if corr else []))
        want.append(np.asarray(jf(None, jnp.asarray(x[e]), frame[e],
                                  jax.random.PRNGKey(0) if corr else None)))
    got = p_dr.apply_noise(spec, torch.from_numpy(x), torch.from_numpy(np.tile(white, (3, 1))),
                           torch.from_numpy(frame), torch.from_numpy(cz) if corr else None)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-6, atol=1e-6)
    x_t = torch.from_numpy(x)
    assert p_dr.noise_fn(None)(x_t) is x_t
    out = p_dr.noise_fn(spec)(torch.from_numpy(x), torch.Generator().manual_seed(0),
                              torch.from_numpy(frame))
    assert out.shape == x.shape and not torch.equal(out, torch.from_numpy(x))


@pytest.fixture(scope="module")
def systems():
    return (j_mjcf.parse_mjcf(j_mjcf.asset_path("ant.xml")).system,
            p_mjcf.parse_mjcf(p_mjcf.asset_path("ant.xml")).system)


@pytest.mark.parametrize("armature", [False, True])
@pytest.mark.parametrize("frame", [None, 700])
def test_sample_dr_matches_jax(feed, systems, armature, frame):
    jsys, psys = systems
    spec = _spec(armature)
    if frame is not None:
        spec["dof_properties"]["damping"].update(schedule="linear", schedule_steps=1400)
    sizes = {"mass": 9, "damping": 8, "armature": 8, "jnt_lo": 8, "jnt_hi": 8}
    rng = np.random.default_rng(3)
    props = p_dr.dr_props(spec)
    assert [n for n, _ in props] == [n for n in FIELDS if armature or n != "armature"]
    draws = {n: _std(p.get("distribution", "uniform"), (4, sizes[n]), rng) for n, p in props}
    want = []
    for a in range(4):
        feed([draws[n][a] for n, _ in props])
        want.append(j_dr.sample_dr(jsys, jax.random.PRNGKey(a), spec, frame))
    frame_t = None if frame is None else torch.full((4,), frame, dtype=torch.int32)
    got = p_dr.dr_from_draws(psys, spec, {n: torch.from_numpy(v) for n, v in draws.items()},
                             (4,), frame_t)
    for n in FIELDS:
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   np.stack([np.asarray(getattr(w, n)) for w in want]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    moved = (got.armature != psys.armature).any()
    assert bool(moved) == armature


def test_sample_dr_ranges_and_moments(systems):
    _, psys = systems
    g = torch.Generator().manual_seed(0)
    d = p_dr.sample_dr(psys, _spec(True), (4000, 10), g)
    assert d.mass.shape == (4000, 10, 9) and d.jnt_lo.shape == (4000, 10, 8)
    for name, nominal in (("mass", psys.mass), ("damping", psys.damping),
                          ("armature", psys.armature)):
        f = getattr(d, name) / nominal                      # U[0.5, 1.5]
        assert 0.5 <= float(f.min()) and float(f.max()) < 1.5, name
        assert abs(float(f.mean()) - 1.0) < 5e-3, name
        assert abs(float(f.var()) - 1 / 12) < 2e-3, name
    for name, nominal in (("jnt_lo", psys.jnt_range[:, 0]), ("jnt_hi", psys.jnt_range[:, 1])):
        z = getattr(d, name) - nominal                      # N(0, 0.01)
        assert abs(float(z.mean())) < 2e-4 and abs(float(z.std()) - 0.01) < 2e-4, name
    # without maps_to the stiffness entry changes nothing
    assert torch.equal(p_dr.sample_dr(psys, _spec(), (3, 10), g).armature,
                       psys.armature.expand(3, 10, 8))
    # skip_setup_only: the setup_only mass stays nominal and takes no draw
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    skip = p_dr.sample_dr(psys, _spec(), (3, 10), g1, skip_setup_only=True)
    assert torch.equal(skip.mass, psys.mass.expand(3, 10, 9))
    no_mass = _spec()
    del no_mass["rigid_body_properties"]["mass"]
    assert torch.equal(skip.damping, p_dr.sample_dr(psys, no_mass, (3, 10), g2).damping)


@pytest.mark.parametrize("armature", [False, True])
def test_get_actor_params_info_matches_jax(systems, armature):
    jsys, psys = systems
    spec = _spec(armature)
    spec["dof_properties"]["damping"]["distribution"] = "gaussian"
    got, want = p_dr.get_actor_params_info(spec, psys), j_dr.get_actor_params_info(spec, jsys)
    assert got[1] == want[1] and got[2] == want[2] and got[3] == want[3]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert len(got[0]) == 9 + 4 * 8


def _dr_states(E, A, seed):
    """{role: {field: numpy}} for fresh / prev DR samples, dr_count."""
    rng = np.random.default_rng(seed)
    mk = lambda: {n: rng.uniform(0.1, 2.0, (E, A, 9 if n == "mass" else 8)).astype(np.float32)
                  for n in FIELDS}
    return mk(), mk(), rng.integers(0, 12, E).astype(np.int32)


@pytest.mark.parametrize("task", ["TenAnt", "OneAnt"])
def test_dr_reset_matches_jax(task):
    cfg = {"sim": {"fused_kernel": False},
           "task": {"randomize": True, "randomization_params": dict(TENANT_RP, frequency=6)}}
    JEnv, PEnv = (JTenAnt, PTenAnt) if task == "TenAnt" else (JOneAnt, POneAnt)
    jenv, penv = JEnv(cfg), PEnv(cfg, device="cpu")
    assert penv.dr_frequency == jenv.dr_frequency == 6 and penv._dr_mass_setup_only
    E, A = 5, penv.spec.num_ants
    fresh_dr, prev_dr, count = _dr_states(E, A, 7)
    count[:2] = [5, 6]                                     # either side of the gate
    jst = jax.vmap(jenv._fresh_pipeline)(jax.random.split(jax.random.PRNGKey(0), E))
    keys = {"fresh": jnp.tile(jnp.array([1, 1], jnp.uint32), (E, 1)),
            "prev": jnp.tile(jnp.array([2, 2], jnp.uint32), (E, 1))}
    jmk = lambda d, role, c: jst.replace(dr=j_dr.DrSample(**{k: jnp.asarray(v) for k, v in d.items()}),
                                         corr_key=keys[role], dr_count=jnp.asarray(c))
    ref = jax.vmap(jenv._dr_reset)(jmk(fresh_dr, "fresh", 0 * count), jmk(prev_dr, "prev", count),
                                   jmk(prev_dr, "prev", count))
    pst = penv._fresh_pipeline(E)
    pmk = lambda d, fill, c: type(pst)(**{**pst.__dict__,
                                        "dr": p_dr.DrSample(**{k: torch.from_numpy(v)
                                                               for k, v in d.items()}),
                                        "corr_act": torch.full_like(pst.corr_act, fill),
                                        "corr_obs": torch.full_like(pst.corr_obs, fill),
                                        "dr_count": torch.from_numpy(c)})
    got = penv._dr_reset(pmk(fresh_dr, 1.0, 0 * count), pmk(prev_dr, 2.0, count),
                         pmk(prev_dr, 2.0, count))
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(got.dr, n).numpy(), np.asarray(getattr(ref.dr, n)),
                                      err_msg=n)
    np.testing.assert_array_equal(got.dr_count.numpy(), np.asarray(ref.dr_count))
    took_fresh = np.asarray(ref.corr_key)[:, 0] == 1
    assert took_fresh.tolist() == (count >= 6).tolist() and took_fresh.any() and not took_fresh.all()
    for corr in (got.corr_act, got.corr_obs):
        np.testing.assert_array_equal(corr.flatten(1)[:, 0].numpy(),
                                      np.where(took_fresh, 1.0, 2.0).astype(np.float32))


def test_step_holds_correlated_noise_between_rerandomizations():
    """Through the port's TenAnt step_batch (array path): pure correlated
    observation noise is the same offset at every step of an episode; a
    forced reset before `frequency` steps keeps the parameters and the
    offset, one after it draws new ones except the setup_only mass."""
    rp = {"frequency": 3, "observations": {"range": [0.0, 0.0], "range_correlated": [0.0, 0.1],
                                           "operation": "additive", "distribution": "gaussian"},
          "actor_params": {"ant": _spec()}}
    mk = lambda rnd: PTenAnt({"sim": {"substeps": 1, "fused_kernel": False},
                              "task": {"randomize": rnd, "randomization_params": rp}},
                             device="cpu", seed=0)
    env = mk(True)
    st = env.reset(2)
    a = torch.zeros(2, 80)
    corr0, dr0 = st.pipeline.corr_obs.clone(), copy.deepcopy(st.pipeline.dr)
    st1 = env.step_batch(st, a)
    clean = env._obs(st1.pipeline, a.reshape(2, 10, 8))
    assert float((st1.obs - clean).abs().max()) > 1e-4
    torch.testing.assert_close(st1.obs - clean, 0.1 * corr0, rtol=1e-4, atol=1e-5)
    st1.done[:] = True                                      # reset at dr_count 1 < 3
    st2 = env.step_batch(st1, a)
    assert torch.equal(st2.pipeline.corr_obs, corr0) and torch.equal(st2.pipeline.dr.damping,
                                                                     dr0.damping)
    for _ in range(3):
        st2 = env.step_batch(st2, a)
    st2.done[:] = True                                      # reset at dr_count >= 3
    st3 = env.step_batch(st2, a)
    assert torch.equal(st3.pipeline.dr.mass, dr0.mass)
    assert not torch.equal(st3.pipeline.dr.damping, dr0.damping)
    assert not torch.equal(st3.pipeline.corr_obs, corr0)
    assert st3.pipeline.dr_count.tolist() == [0, 0]
