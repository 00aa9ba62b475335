"""Carry weights, models and train states across from the JAX package.

The functions take plain numpy data, CPU tensors or anything np.asarray
accepts, so this module needs nothing of the JAX package.  The checkpoint
trees are the JAX trainers' own (`flax.serialization.to_state_dict` of
their state), so a file written by either package restores in the other:

* PPO: {"params": the flax ActorCritic tree, "opt_state": {"0": {}, "1":
  {"count", "mu", "nu"}} (optax.chain(clip_by_global_norm, scale_by_adam)),
  "lr", "iteration"} (massive_marl_tpu/algos/rl/ppo.py:310-330);
* MARL: {"actor_params", "critic_params", "actor_opt", "critic_opt",
  "vnorm", "iteration"} (massive_marl_tpu/algos/marl/runner.py:1242-1279),
  where the optimizer state has the structure of the JAX runner's
  cfg.optimizer (`marl_opt_skeleton`), its first moment in bf16 under
  bf16_adam_mu.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from massive_marl_tpu_torch.utils.tree import tree_unflatten


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


def actor_critic_to_flax(state: Dict[str, torch.Tensor]):
    """The inverse of actor_critic_from_flax: tensors under the names of
    ActorCritic's state_dict (parameters, or Adam moments laid out like
    them) -> the flax tree, weights transposed to [in, out]."""
    p = {}
    for flax_name, torch_name in (("MLP_0", "actor"), ("MLP_1", "critic")):
        n_hidden = sum(1 for k in state if k.startswith(f"{torch_name}.hidden.")
                       and k.endswith(".weight"))
        mlp = {}
        for i in range(n_hidden + 1):
            prefix = f"{torch_name}.head" if i == n_hidden else f"{torch_name}.hidden.{i}"
            mlp[f"Dense_{i}"] = {"kernel": state[f"{prefix}.weight"].t(),
                                 "bias": state[f"{prefix}.bias"]}
        p[flax_name] = mlp
    p["log_std"] = state["log_std"]
    return {"params": p}


def _int32(x):
    return np.asarray(x, np.int32)


def check_keys(expected, got, path: str = "", what: str = "checkpoint"):
    """Raise ValueError unless `got` has exactly the dict keys of
    `expected` at every level `expected` spells out (a None leaf of
    `expected` matches anything)."""
    if expected is None:
        return
    if not isinstance(got, dict) or set(got) != set(expected):
        have = sorted(got) if isinstance(got, dict) else type(got).__name__
        raise ValueError(f"{what} holds {have} at {path or '/'}, expected {sorted(expected)}")
    for k, v in expected.items():
        check_keys(v, got[k], f"{path}/{k}", what)


PPO_SKELETON = {"params": None, "lr": None, "iteration": None,
                "opt_state": {"0": {}, "1": {"count": None, "mu": None, "nu": None}}}


def ppo_state_to_flax(names, params, mu, nu, count: int, lr, iteration: int):
    """The JAX PPO checkpoint tree from the port's parameters and Adam
    moments (lists in `names` order, ActorCritic's named_parameters)."""
    tree = lambda leaves: actor_critic_to_flax(dict(zip(names, leaves)))
    return {"params": tree(params),
            "opt_state": {"0": {}, "1": {"count": _int32(count), "mu": tree(mu), "nu": tree(nu)}},
            "lr": lr, "iteration": _int32(iteration)}


def ppo_state_from_flax(state):
    """A decoded JAX PPO checkpoint -> (params, mu, nu) as ActorCritic
    state_dicts, and count, lr (a 0-d tensor) and iteration."""
    check_keys(PPO_SKELETON, state, what="PPO checkpoint")
    adam = state["opt_state"]["1"]
    return (actor_critic_from_flax(state["params"]), actor_critic_from_flax(adam["mu"]),
            actor_critic_from_flax(adam["nu"]), int(adam["count"]),
            torch.as_tensor(state["lr"], dtype=torch.float32), int(state["iteration"]))


def _marl_opt_tree(cfg, adam, count):
    """The JAX runner's optimizer state around the {count, mu, nu} node
    `adam`: FusedClipAdam's is that node; optax's chain is
    [clip_by_global_norm] [add_decayed_weights] adam, where adam is
    chain(scale_by_adam, scale_by_learning_rate) and the latter holds a
    count only under a schedule (massive_marl_tpu/algos/marl/runner.py:345-376)."""
    if cfg.optimizer == "fused_adam":
        return adam
    chain = [{}] * (bool(cfg.use_max_grad_norm) + bool(cfg.weight_decay))
    chain.append({"0": adam, "1": {"count": count} if cfg.use_linear_lr_decay else {}})
    return {str(i): s for i, s in enumerate(chain)}


def marl_opt_skeleton(cfg):
    """The keys of the JAX runner's optimizer state under `cfg` (a
    MarlConfig of either package)."""
    return _marl_opt_tree(cfg, {"count": None, "mu": None, "nu": None}, None)


def marl_opt_to_flax(cfg, params_tree, mu, nu, count):
    """The port's per-agent Adam state (moment lists in tree_leaves order
    of the agent-stacked `params_tree`, per-agent counts) in the JAX
    runner's structure for `cfg`."""
    adam = {"count": _int32(count), "mu": {"params": tree_unflatten(params_tree, mu)},
            "nu": {"params": tree_unflatten(params_tree, nu)}}
    return _marl_opt_tree(cfg, adam, _int32(count))


def marl_opt_from_flax(cfg, opt_state, what: str = "optimizer state"):
    """A decoded JAX optimizer state -> (mu tree, nu tree, per-agent
    counts); ValueError when its structure is not the one of
    cfg.optimizer (a file written under the other optimizer)."""
    skeleton = marl_opt_skeleton(cfg)
    check_keys(skeleton, opt_state, what=what)
    adam = opt_state if cfg.optimizer == "fused_adam" else opt_state[str(len(skeleton) - 1)]["0"]
    return (adam["mu"]["params"], adam["nu"]["params"],
            [int(c) for c in torch.as_tensor(adam["count"]).reshape(-1).tolist()])


MARL_SKELETON = {"actor_params": {"params": None}, "critic_params": {"params": None},
                 "actor_opt": None, "critic_opt": None,
                 "vnorm": {"mean": None, "mean_sq": None, "debias": None}, "iteration": None}


def marl_state_to_flax(cfg, st):
    """The JAX runner's checkpoint tree from a port MarlTrainState `st`
    (agent-stacked parameter trees in flax's layout, per-agent Adam states,
    the value normalizer's [N] statistics)."""
    opt = lambda params, o: marl_opt_to_flax(cfg, params, o.mu, o.nu, o.count)
    vn = st.vnorm
    return {"actor_params": {"params": st.actor_params},
            "critic_params": {"params": st.critic_params},
            "actor_opt": opt(st.actor_params, st.actor_opt),
            "critic_opt": opt(st.critic_params, st.critic_opt),
            "vnorm": {"mean": vn.mean, "mean_sq": vn.mean_sq, "debias": vn.debias},
            "iteration": _int32(st.iteration)}


def marl_state_from_flax(cfg, state):
    """A decoded JAX MARL checkpoint -> {actor_params, critic_params:
    parameter trees; actor_opt, critic_opt: (mu tree, nu tree, counts);
    vnorm: {mean, mean_sq, debias}; iteration: int}.  ValueError when its
    structure is not the one of `cfg`'s optimizer."""
    check_keys(MARL_SKELETON, state, what="MARL checkpoint")
    return {"actor_params": state["actor_params"]["params"],
            "critic_params": state["critic_params"]["params"],
            "actor_opt": marl_opt_from_flax(cfg, state["actor_opt"], "actor_opt"),
            "critic_opt": marl_opt_from_flax(cfg, state["critic_opt"], "critic_opt"),
            "vnorm": state["vnorm"], "iteration": int(state["iteration"])}


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
