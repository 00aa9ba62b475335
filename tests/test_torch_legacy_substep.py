"""B1's legacy branch (ContactParams(beta=None)), B6's plain version and the
debug tool (cli/debug_fused.py) against the JAX package on the CPU.

* The port's plain substep on the legacy branch against JAX's scalar
  substep with beta=None, called eagerly: over tests/test_torch_phys.py's
  four state families (friction 'average'), and over the debug tool's three
  scenarios with the box off and on (its settings: 'multiply', no box
  inverse inertia).
* The tool's engine_substep (the port's array engine) against the script's
  own (scripts/debug_fused_tpu.py, loaded from its file, run under an
  eager jax.vmap: four jit compiles would take longer) in all four
  clamp x box cases, on one batch of all three scenarios.
* debug_fused.main on the CPU prints its four case lines; on CPU tensors
  B6's dispatch reaches its plain version without launching anything.

The legacy scenarios drive qvel onto the integrator's 200 m/s clamp and the
explicit contact forces to ~1e6 N, so the tolerances are relative to each
output's scale: |got - ref| <= 1e-4 |ref| + 1e-4 max|ref|; and the
non-finite masks must be the same.
"""
import importlib.util
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.ops import scalar_phys as j_sp
from massive_marl_tpu.phys import mjcf as j_mjcf
from massive_marl_tpu_torch.cli import debug_fused
from massive_marl_tpu_torch.ops import fused_substep as p_fs
from massive_marl_tpu_torch.ops import scalar_phys as p_sp
from massive_marl_tpu_torch.phys import mjcf as p_mjcf
from test_torch_phys import FAMILIES, make_family

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAV, H, CP = debug_fused.GRAV, debug_fused.H, debug_fused.CP
BOX_HE = (0.5, 14.0, 0.5)
B = 24


@pytest.fixture(scope="module")
def models():
    return (j_mjcf.parse_mjcf(j_mjcf.asset_path("ant.xml")),
            p_mjcf.parse_mjcf(p_mjcf.asset_path("ant.xml")))


def assert_close_to_scale(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref), err_msg=f"{name}: mask")
    fin = np.isfinite(ref)
    scale = float(np.abs(ref[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def compare_legacy(models, qpos, qvel, tau, bq, bv, he, combine):
    jm, pm = models
    jl = lambda x: [jnp.asarray(x[:, k]) for k in range(x.shape[1])]
    j_out = j_sp.substep(
        j_sp.bake_consts(jm.system), jl(qpos), jl(qvel), jl(tau), jl(bq) if he else None,
        jl(bv) if he else None, he, GRAV, H, CP.stiffness, CP.damping, CP.friction_vel,
        plane_friction=1.0, box_friction=0.0, friction_combine=combine, beta=None)
    c = p_sp.bake_consts(pm.system, p_sp.SubstepParams(
        h=H, gravity=GRAV, contact=CP._replace(beta=None), plane_friction=1.0,
        box_friction=0.0, friction_combine=combine, box_he=he))
    assert c.legacy
    pl = lambda x: list(torch.from_numpy(np.ascontiguousarray(x.T)))
    p_out = p_sp.substep(c, pl(qpos), pl(qvel), pl(tau), pl(bq) if he else None,
                         pl(bv) if he else None)
    for name, j, p in zip(["qpos", "qvel", "wrench", "sensors"], j_out, p_out):
        if name == "wrench" and he is None:
            assert j is None and p is None
            continue
        if name == "sensors":
            j, p = [x for s in j for x in s], [x for s in p for x in s]
        assert_close_to_scale(np.stack([x.numpy() for x in p]),
                              np.stack([np.asarray(x) for x in j]), name)
    return p_out


@pytest.mark.parametrize("kind,has_box", FAMILIES)
def test_legacy_plain_substep_matches_jax_families(models, kind, has_box):
    qpos, qvel, tau, bq, bv = make_family(kind, B, 7 + len(kind), models[0].system)
    compare_legacy(models, qpos, qvel, tau, bq, bv, BOX_HE if has_box else None, "average")


@pytest.mark.parametrize("use_box", [False, True], ids=["nobox", "box"])
@pytest.mark.parametrize("scenario", sorted(debug_fused.SCENARIOS))
def test_legacy_plain_substep_matches_jax_scenarios(models, scenario, use_box):
    pm = models[1]
    states = [x.numpy() for x in debug_fused.make_states(pm.system, pm.init_hinge, B, scenario)]
    out = compare_legacy(models, *states, debug_fused.HE if use_box else None, "multiply")
    sensors = torch.stack([x for s in out[3] for x in s])
    if scenario == "chaotic" or (scenario == "standing" and use_box):
        assert float(sensors.abs().max()) > 1e3   # the explicit contacts really fire
    else:
        assert float(sensors.abs().max()) == 0.0  # airborne, or standing clear of the ground


def load_script():
    """scripts/debug_fused_tpu.py as a module, with the environment and
    sys.path it changes at import restored."""
    env, path = dict(os.environ), list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "debug_fused_tpu", ROOT / "scripts" / "debug_fused_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k in set(os.environ) - set(env):
            del os.environ[k]
        os.environ.update(env)
        sys.path[:] = path
    return mod


def test_engine_substep_matches_the_script(models):
    jm, pm = models
    env, path = dict(os.environ), list(sys.path)
    script = load_script()
    assert dict(os.environ) == env and sys.path == path
    # one batch of all three scenarios, 8 states each
    states = [torch.cat(xs) for xs in zip(*[
        debug_fused.make_states(pm.system, pm.init_hinge, 8, sc, seed=2)
        for sc in sorted(debug_fused.SCENARIOS)])]
    for clamp in (False, True):
        for use_box in (False, True):
            rq, rv = jax.vmap(lambda a, b, c, d, e: script.engine_substep(
                jm.system, a, b, c, d, e, use_box, clamp))(*[x.numpy() for x in states])
            gq, gv = debug_fused.engine_substep(pm.system, *states, use_box, clamp)
            label = f"clamp={clamp} box={use_box}"
            assert_close_to_scale(gq.numpy(), rq, label + " qpos")
            assert_close_to_scale(gv.numpy(), rv, label + " qvel")


def test_debug_tool_main_prints_four_cases(capsys):
    rows = debug_fused.main(["--device", "cpu", "--B", "32", "--scenario", "standing"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("clamp=")]
    assert lines == [f"clamp={r['clamp']} box={r['box']}:  max|dqpos|={r['dqpos']:.3e}  "
                     f"max|dqvel|={r['dqvel']:.3e}" for r in rows]
    assert [(r["clamp"], r["box"]) for r in rows] == [(False, False), (False, True),
                                                       (True, False), (True, True)]
    assert all(np.isfinite(r["dqpos"]) for r in rows)
    rows = debug_fused.main(["--device", "cpu", "--B", "32", "--mode", "scalar"])
    assert len(rows) == 1 and "scalar vs engine (clamp, no box)" in capsys.readouterr().out


def test_debug_substep_cpu_dispatch_takes_the_plain_version(models):
    pm = models[1]
    c = debug_fused.kernel_consts(pm.system, True, clamp=False)
    ops = [x.t().contiguous() for x in debug_fused.make_states(pm.system, pm.init_hinge, 16,
                                                                "chaotic")]
    before = p_fs.debug_substep_kernel.launches, p_fs.substep_kernel.launches
    got = p_fs.debug_substep_soa(c, *ops)
    assert (p_fs.debug_substep_kernel.launches, p_fs.substep_kernel.launches) == before
    assert [tuple(x.shape) for x in got] == [(15, 16), (14, 16), (6, 16)]
    ref = p_fs.substep_plain(c, 1, *ops)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert float(got[2].abs().max()) > 0   # the ants push on the box
