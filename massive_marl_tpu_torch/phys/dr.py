"""Domain randomization (twin of massive_marl_tpu/phys/dr.py).

The randomized physical parameters of every ant live in a `DrSample` in the
scene state; both physics paths read them as an input: the array engine
through `DrSample.apply`, the substep kernel as one [41, B] operand
(ops/fused_substep.py).

Semantics, as in the reference:
  * uniform/gaussian distributions, additive/scaling operations; a gaussian
    range is (mu, var) and the factor is mu + var * N(0, 1);
  * linear/constant schedules: the range ramps in over `schedule_steps`
    frames (additive ranges scale toward full, scaling ranges interpolate
    from the identity);
  * `setup_only` properties (TenAnt's mass) are drawn at the env's first
    reset and kept across re-randomizations (the envs' `_dr_reset`);
  * an env re-randomizes at reset, once `frequency` steps have passed since
    its last randomization;
  * per-step observation and action noise with a correlated part
    (`range_correlated`) drawn from a standard-normal tensor that is held
    between re-randomizations.  The JAX package holds a PRNG key and draws
    from it at each step; the port holds the draw itself.
  * the dof `stiffness` entry is PhysX drive stiffness, inert under effort
    control, so it changes nothing unless it carries `maps_to: armature`.

Randomness comes from an explicit torch.Generator.  The draws (standard
normal or uniform on [0, 1)) are kept apart from the transform
(`_factor`), in the JAX package's order, so a test can feed both packages
the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from massive_marl_tpu_torch.parallel.mesh import draw

from .system import System


@dataclasses.dataclass
class DrSample:
    """Randomized physical parameters; leaves [..., nb] / [..., nj]."""
    mass: torch.Tensor
    damping: torch.Tensor
    armature: torch.Tensor
    jnt_lo: torch.Tensor
    jnt_hi: torch.Tensor

    @classmethod
    def identity(cls, sys: System, shape=()) -> "DrSample":
        """The nominal parameters, broadcast to leading `shape`."""
        ex = lambda x: x.expand(tuple(shape) + x.shape).clone()
        return cls(mass=ex(sys.mass), damping=ex(sys.damping), armature=ex(sys.armature),
                   jnt_lo=ex(sys.jnt_range[:, 0]), jnt_hi=ex(sys.jnt_range[:, 1]))

    def apply(self, sys: System) -> System:
        """The System with this sample's parameters substituted (leading
        dimensions are the engine's batch)."""
        return dataclasses.replace(sys, mass=self.mass, damping=self.damping,
                                   armature=self.armature,
                                   jnt_range=torch.stack([self.jnt_lo, self.jnt_hi], dim=-1))


def sched_scaling(prop: Dict[str, Any], frame):
    """Schedule ramp in [0, 1]: 'linear' ramps over schedule_steps frames,
    'constant' switches on at schedule_steps, no schedule = 1.  frame: a
    number or an int tensor; the result has its shape."""
    sched = prop.get("schedule")
    if not sched:
        return 1.0
    steps = float(prop.get("schedule_steps", 1))
    f = torch.as_tensor(frame).to(torch.float32)
    if sched == "linear":
        return torch.clamp(f, max=steps) / steps
    return (f >= steps).to(torch.float32)   # 'constant'


def _sched_range(prop: Dict[str, Any], lo, hi, s):
    """Schedule-scaled (lo, hi): gaussian (mu, var): additive -> both * s,
    scaling -> var * s with mu interpolated toward 1; uniform: additive ->
    both * s, scaling -> both interpolated toward 1."""
    op = prop.get("operation", "scaling")
    if prop.get("distribution", "uniform") == "gaussian":
        if op == "scaling":
            return lo * s + 1.0 * (1 - s), hi * s
        return lo * s, hi * s
    if op == "scaling":
        return lo * s + 1.0 * (1 - s), hi * s + 1.0 * (1 - s)
    return lo * s, hi * s


def _lead(s, ndim: int):
    """A schedule scaling (number, or tensor over leading dims) made
    broadcastable against a draw of `ndim` dimensions."""
    if isinstance(s, torch.Tensor):
        return s.reshape(s.shape + (1,) * (ndim - s.dim()))
    return s


def _draw(prop: Dict[str, Any], shape, generator: torch.Generator, device) -> torch.Tensor:
    """The standard draw behind a factor: N(0, 1) for a gaussian, U[0, 1)
    for a uniform distribution; axis 0 of `shape` is the env axis."""
    fn = torch.randn if prop.get("distribution", "uniform") == "gaussian" else torch.rand
    return draw(fn, shape, generator, device=device)


def _factor(prop: Dict[str, Any], z: torch.Tensor, frame=None) -> torch.Tensor:
    """The randomization factor from its standard draw z, with the range
    scaled by the schedule at `frame` (None: the full range)."""
    lo, hi = (float(x) for x in prop["range"])
    s = _lead(sched_scaling(prop, frame), z.dim()) if frame is not None else 1.0
    lo, hi = _sched_range(prop, lo, hi, s)
    if prop.get("distribution", "uniform") == "gaussian":
        return lo + hi * z
    return lo + (hi - lo) * z


def _apply(prop: Dict[str, Any], value, factor):
    return value * factor if prop.get("operation", "scaling") == "scaling" else value + factor


def dr_props(spec: Dict[str, Any], skip_setup_only: bool = False):
    """(DrSample field, spec entry) in the order the draws are taken:
    mass, damping, armature (only under `maps_to: armature`), lower, upper."""
    out = []
    rb = spec.get("rigid_body_properties", {})
    if "mass" in rb and not (skip_setup_only and rb["mass"].get("setup_only", False)):
        out.append(("mass", rb["mass"]))
    dof = spec.get("dof_properties", {})
    if "damping" in dof:
        out.append(("damping", dof["damping"]))
    if "stiffness" in dof and dof["stiffness"].get("maps_to") == "armature":
        out.append(("armature", dof["stiffness"]))
    if "lower" in dof:
        out.append(("jnt_lo", dof["lower"]))
    if "upper" in dof:
        out.append(("jnt_hi", dof["upper"]))
    return out


def dr_from_draws(sys: System, spec: Dict[str, Any], draws: Dict[str, torch.Tensor], shape,
                  frame=None, skip_setup_only: bool = False) -> DrSample:
    """The DrSample of `shape` articulations from standard draws {field:
    [*shape, n]} (see `dr_props`); frame: None or a tensor of `shape`."""
    out = DrSample.identity(sys, shape)
    for name, prop in dr_props(spec, skip_setup_only):
        setattr(out, name, _apply(prop, getattr(out, name), _factor(prop, draws[name], frame)))
    return out


def sample_dr(sys: System, spec: Dict[str, Any], shape, generator: torch.Generator,
              frame=None, skip_setup_only: bool = False) -> DrSample:
    """A DrSample for `shape` articulations (leaves [*shape, n]).

    spec: the `actor_params.ant` subtree of randomization_params.  frame:
    None or a tensor broadcastable to `shape`, for the schedules.
    skip_setup_only: leave `setup_only` properties at their nominal values
    (the caller keeps the earlier sample's)."""
    shape = tuple(shape)
    sizes = {"mass": sys.nb, "damping": sys.nj, "armature": sys.nj, "jnt_lo": sys.nj,
             "jnt_hi": sys.nj}
    dev = sys.mass.device
    draws = {name: _draw(prop, shape + (sizes[name],), generator, dev)
             for name, prop in dr_props(spec, skip_setup_only)}
    if frame is not None:
        frame = torch.as_tensor(frame, device=dev).expand(shape)
    return dr_from_draws(sys, spec, draws, shape, frame, skip_setup_only)


def noise_fn(spec: Dict[str, Any] | None):
    """Per-step noise on observations or actions, schedule-aware, with the
    correlated part (`range_correlated`, default [0, 0]).

    Returns f(x, generator, frame=None, corr=None) -> noised x, the identity
    when spec is None.  corr is the held N(0, 1) tensor of x's shape (None:
    only the white part); frame a tensor over x's leading dimensions.  The
    reference uses randn for the correlated part in the uniform branch too:
    corr * (hi_c - lo_c) + lo_c."""
    if not spec:
        return lambda x, generator=None, frame=None, corr=None: x

    def f(x, generator, frame=None, corr=None):
        return apply_noise(spec, x, _draw(spec, x.shape, generator, x.device), frame, corr)

    return f


def apply_noise(spec: Dict[str, Any], x, white, frame=None, corr=None):
    """noise_fn's transform on given standard draws: `white` for the white
    part (N(0, 1) or U[0, 1) by the spec's distribution), `corr` (N(0, 1))
    for the correlated part."""
    noise = _factor(spec, white, frame)
    if corr is not None:
        lo_c, hi_c = (float(v) for v in spec.get("range_correlated", [0.0, 0.0]))
        s = _lead(sched_scaling(spec, frame), x.dim()) if frame is not None else 1.0
        lo, hi = _sched_range(spec, lo_c, hi_c, s)
        if spec.get("distribution", "uniform") == "gaussian":
            noise = noise + (lo + hi * corr)
        else:
            noise = noise + (lo + (hi - lo) * corr)
    return _apply(spec, x, noise)


def get_actor_params_info(spec: Dict[str, Any], sys: System):
    """(params, names, lows, highs) for every randomizable scalar: flat
    per-attribute lists named `<property>_<i>_<attr>`; a non-uniform
    distribution reports infinite bounds.  The stiffness entry reports what
    it randomizes: armature under `maps_to: armature`, else the inert (zero)
    drive stiffness."""
    params, names, lows, highs = [], [], [], []

    def emit(prop_name, attr, values, prop_cfg):
        lo_hi = prop_cfg["range"]
        if "uniform" not in prop_cfg.get("distribution", "uniform"):
            lo_hi = (-float("inf"), float("inf"))
        vals = np.asarray(values.detach().cpu() if isinstance(values, torch.Tensor)
                          else values).reshape(-1)
        for i, v in enumerate(vals):
            params.append(float(v))
            names.append(f"{prop_name}_{i}_{attr}")
            lows.append(float(lo_hi[0]))
            highs.append(float(lo_hi[1]))

    rb = spec.get("rigid_body_properties", {})
    if "mass" in rb:
        emit("rigid_body_properties", "mass", sys.mass, rb["mass"])
    dof = spec.get("dof_properties", {})
    stiff_src = (sys.armature if dof.get("stiffness", {}).get("maps_to") == "armature"
                 else np.zeros(sys.nj))
    for attr, source in (("damping", sys.damping), ("stiffness", stiff_src),
                         ("lower", sys.jnt_range[:, 0] if sys.nj else []),
                         ("upper", sys.jnt_range[:, 1] if sys.nj else [])):
        if attr in dof:
            emit("dof_properties", attr, source, dof[attr])
    return params, names, lows, highs
