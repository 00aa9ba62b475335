"""Carry weights and models across from the JAX package.

Both functions take plain numpy data (or anything np.asarray accepts), so
this module needs nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def actor_critic_from_flax(params_np) -> Dict[str, torch.Tensor]:
    """The flax ActorCritic tree {"params": {"MLP_0": {"Dense_i": {kernel,
    bias}}, "MLP_1": ..., "log_std"}} -> a state_dict of
    algos.nets.ActorCritic.  Flax kernels are [in, out], torch weights
    [out, in]; the last Dense of each MLP is its head."""
    p = params_np["params"]
    out = {}
    for flax_name, torch_name in (("MLP_0", "actor"), ("MLP_1", "critic")):
        mlp = p[flax_name]
        n = len(mlp)
        for i in range(n):
            dense = mlp[f"Dense_{i}"]
            prefix = f"{torch_name}.head" if i == n - 1 else f"{torch_name}.hidden.{i}"
            out[f"{prefix}.weight"] = torch.from_numpy(
                np.asarray(dense["kernel"], np.float32).T.copy())
            out[f"{prefix}.bias"] = torch.from_numpy(np.asarray(dense["bias"], np.float32).copy())
    out["log_std"] = torch.from_numpy(np.asarray(p["log_std"], np.float32).copy())
    return out


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def marl_params_from_flax(actor_vars, critic_vars):
    """jax.vmap-initialised MarlActor / MarlCritic variables ({"params":
    {...}}, every leaf with a leading agent axis N) -> the port's
    agent-stacked (actor, critic) parameter trees.  Both packages keep
    flax's layout ([N, in, out] Dense kernels, the same key names), so the
    leaves carry over as they are; copy them into a runner's state by key
    (utils.tree.tree_map) to keep its leaf order."""
    return _tree_to_torch(actor_vars["params"]), _tree_to_torch(critic_vars["params"])


SYSTEM_FIELDS = ("parent", "point_body", "point_sensor", "num_sensors",
                 "body_pos", "body_quat", "mass", "com", "inertia",
                 "jnt_axis", "jnt_pos", "jnt_range", "armature", "damping", "gear",
                 "point_local", "point_radius", "point_friction")


def system_arrays(sys) -> Dict[str, np.ndarray]:
    """Every field of a System (of either package) as a numpy array."""
    out = {}
    for name in SYSTEM_FIELDS:
        x = getattr(sys, name)
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        out[name] = np.asarray(x)
    return out
