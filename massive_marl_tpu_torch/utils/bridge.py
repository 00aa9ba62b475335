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
  bf16_adam_mu;
* TRPO: {"actor_params", "critic_params", "iteration"}
  (massive_marl_tpu/algos/rl/trpo.py:310-316), no optimizer state;
* DDPG/TD3/SAC: {"params", "target_params", "iteration"}
  (massive_marl_tpu/algos/rl/offpolicy.py:460-465), the networks in flax's
  own layout, which the port's off-policy trainer keeps.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from massive_marl_tpu_torch.utils.tree import tree_unflatten


def mlp_from_flax(mlp, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax MLP tree {"Dense_i": {kernel, bias}} -> the state_dict entries
    of algos.nets.MLP under `prefix`.  Flax kernels are [in, out], torch
    weights [out, in]; the last Dense is the head."""
    out, n = {}, len(mlp)
    for i in range(n):
        dense = mlp[f"Dense_{i}"]
        name = f"{prefix}.head" if i == n - 1 else f"{prefix}.hidden.{i}"
        out[f"{name}.weight"] = torch.from_numpy(np.asarray(dense["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(np.asarray(dense["bias"], np.float32).copy())
    return out


def mlp_to_flax(state: Dict[str, torch.Tensor], prefix: str):
    """The inverse of mlp_from_flax: the entries of `state` under `prefix`
    (parameters, or Adam moments laid out like them) -> the flax MLP tree,
    weights transposed to [in, out]."""
    n_hidden = sum(1 for k in state if k.startswith(f"{prefix}.hidden.") and k.endswith(".weight"))
    mlp = {}
    for i in range(n_hidden + 1):
        name = f"{prefix}.head" if i == n_hidden else f"{prefix}.hidden.{i}"
        mlp[f"Dense_{i}"] = {"kernel": state[f"{name}.weight"].t(), "bias": state[f"{name}.bias"]}
    return mlp


def _f32_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def actor_critic_from_flax(params_np) -> Dict[str, torch.Tensor]:
    """The flax ActorCritic tree {"params": {"MLP_0": {"Dense_i": {kernel,
    bias}}, "MLP_1": ..., "log_std"}} -> a state_dict of
    algos.nets.ActorCritic (MLP_0 the actor, MLP_1 the critic)."""
    p = params_np["params"]
    return {**mlp_from_flax(p["MLP_0"], "actor"), **mlp_from_flax(p["MLP_1"], "critic"),
            "log_std": _f32_tensor(p["log_std"])}


def actor_critic_to_flax(state: Dict[str, torch.Tensor]):
    """The inverse of actor_critic_from_flax: tensors under the names of
    ActorCritic's state_dict (parameters, or Adam moments laid out like
    them) -> the flax tree, weights transposed to [in, out]."""
    return {"params": {"MLP_0": mlp_to_flax(state, "actor"), "MLP_1": mlp_to_flax(state, "critic"),
                       "log_std": state["log_std"]}}


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


TRPO_SKELETON = {"actor_params": {"params": {"MLP_0": None, "log_std": None}},
                 "critic_params": {"params": {"MLP_0": None}}, "iteration": None}


def trpo_state_to_flax(actor_state, critic_state, iteration: int):
    """The JAX TRPO checkpoint tree (massive_marl_tpu/algos/rl/trpo.py:
    310-316) from the state_dicts of the port's actor (an MLP under "mlp"
    and "log_std") and critic (an MLP under "mlp")."""
    return {"actor_params": {"params": {"MLP_0": mlp_to_flax(actor_state, "mlp"),
                                        "log_std": actor_state["log_std"]}},
            "critic_params": {"params": {"MLP_0": mlp_to_flax(critic_state, "mlp")}},
            "iteration": _int32(iteration)}


def trpo_state_from_flax(state):
    """A decoded JAX TRPO checkpoint -> (actor state_dict, critic
    state_dict, iteration)."""
    check_keys(TRPO_SKELETON, state, what="TRPO checkpoint")
    a, c = state["actor_params"]["params"], state["critic_params"]["params"]
    return ({**mlp_from_flax(a["MLP_0"], "mlp"), "log_std": _f32_tensor(a["log_std"])},
            mlp_from_flax(c["MLP_0"], "mlp"), int(state["iteration"]))


def offpolicy_state_to_flax(params, target_params, iteration: int):
    """The JAX off-policy checkpoint tree {"params", "target_params",
    "iteration"} (massive_marl_tpu/algos/rl/offpolicy.py:460-465).  The
    port keeps both trees in flax's layout ({"pi": {"params": {"Dense_i":
    {kernel [in, out], bias}}}, "q1", ["q2"], ["alpha": {"log_alpha"}]}), so
    they go into the file as they are."""
    return {"params": params, "target_params": target_params, "iteration": _int32(iteration)}


def offpolicy_state_from_flax(state, params, target_params):
    """A decoded JAX off-policy checkpoint -> (params, target_params,
    iteration), checked key for key against the trainer's own trees: a file
    of another algorithm (another set of networks, another number of
    layers, a learned temperature or none) raises ValueError."""
    skeleton = lambda tree: {k: skeleton(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else None
    check_keys({"params": skeleton(params), "target_params": skeleton(target_params),
                "iteration": None}, state, what="off-policy checkpoint")
    return state["params"], state["target_params"], int(state["iteration"])


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
