"""MAPPO on TenAnt: builds the port's MarlRunner for a cell, drives its
checked first iterations, follows them with the plain reference, and counts
an iteration's work.

The benchmark makes every input and hands the same to both sides: the
weights (drawn on the device from the seed and loaded into the runner's
agent-stacked trees in place of its host-side orthogonal ones), and the
seeds of the env's and the runner's random streams.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from port_bench.roofline import b1, mlp
from port_bench.trainers.ppo import Built, env_cfg, iterate, seeds

NUM_AGENTS, OBS_DIM, SHARE_DIM, ACT_DIM = 10, 46, 388, 8


def _mlp_base(H: int, layer_n: int, din: int):
    """(path, shape, init) of an MLPBase's leaves in the port's order: the
    feature LayerNorm, then Dense_k and LayerNorm_{k+1} per block."""
    out = [("LayerNorm_0/scale", (din,), "ones"), ("LayerNorm_0/bias", (din,), "zeros")]
    for k in range(1 + layer_n):
        out += [(f"Dense_{k}/kernel", (din, H), math.sqrt(2)),
                (f"Dense_{k}/bias", (H,), "zeros"), (f"LayerNorm_{k + 1}/scale", (H,), "ones"),
                (f"LayerNorm_{k + 1}/bias", (H,), "zeros")]
        din = H
    return out


def leaf_shapes(train: dict) -> List[Tuple[str, tuple, object]]:
    """(name, per-agent shape, init) of every leaf, actor then critic, in
    the order of the port's tree_leaves: a gain for a Dense kernel (normal
    with std gain / sqrt(fan_in)), else "ones", "zeros" or "std" (the
    std parameter at std_x_coef)."""
    H, L = train["hidden_size"], train["layer_N"]
    actor = [("MLPBase_0/" + p, s, i) for p, s, i in _mlp_base(H, L, OBS_DIM)]
    actor += [("Dense_0/kernel", (H, ACT_DIM), train["gain"]),
              ("Dense_0/bias", (ACT_DIM,), "zeros"), ("std_param", (ACT_DIM,), "std")]
    critic = [("MLPBase_0/" + p, s, i) for p, s, i in _mlp_base(H, L, SHARE_DIM)]
    critic += [("Dense_0/kernel", (H, 1), 1.0), ("Dense_0/bias", (1,), "zeros")]
    return ([("actor/" + n, s, i) for n, s, i in actor]
            + [("critic/" + n, s, i) for n, s, i in critic])


def make_leaves(train: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial agent-stacked weights [N, ...], from one draw on the
    device."""
    shapes = leaf_shapes(train)
    N = NUM_AGENTS
    mats = [s for _, s, i in shapes if not isinstance(i, str)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(N * sum(a * b for a, b in mats), generator=gen, device=device)
    leaves, off = {}, 0
    for name, shape, init in shapes:
        full = (N, *shape)
        if init == "ones":
            leaves[name] = torch.ones(full, device=device)
        elif init == "zeros":
            leaves[name] = torch.zeros(full, device=device)
        elif init == "std":
            leaves[name] = torch.full(full, float(train["std_x_coef"]), device=device)
        else:
            n = math.prod(full)
            leaves[name] = flat[off:off + n].view(full) * (init / math.sqrt(shape[0]))
            off += n
    return leaves


def _paths(tree: dict, pre: str = "") -> List[str]:
    out = []
    for k, v in tree.items():
        out += _paths(v, f"{pre}{k}/") if isinstance(v, dict) else [pre + k]
    return out


def marl_config(config: dict):
    """cfg/mappo's keys as MarlConfig reads them, with the runner's clips."""
    from massive_marl_tpu_torch.algos.marl.runner import MarlConfig
    cfg = MarlConfig.from_cfg_train(config["train"], "mappo")
    return dataclasses.replace(cfg, clip_obs=config["clip"]["obs"],
                               clip_actions=config["clip"]["actions"])


def _trees(runner):
    st = runner.state
    return {"actor": st.actor_params, "critic": st.critic_params}


def build(config: dict, cell: dict, seed: int, device) -> Built:
    """The port's env and MarlRunner on `device`, with the benchmark's
    weights."""
    from massive_marl_tpu_torch.algos.marl.runner import MarlRunner
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.utils.tree import tree_leaves

    s = seeds(seed)
    env = TenAntEnv(env_cfg(config, cell), device=device, seed=s["env"])
    runner = MarlRunner(env, cell["num_envs"], marl_config(config), seed=s["policy"],
                        device=device, print_log=False)
    runner.init_state()
    leaves = make_leaves(config["train"], s["weights"], device)
    with torch.no_grad():
        for net, tree in _trees(runner).items():
            for path, leaf in zip(_paths(tree), tree_leaves(tree)):
                leaf.copy_(leaves[f"{net}/{path}"])
    return Built(runner, env)


def _per_agent(runner) -> Dict[str, torch.Tensor]:
    """Every agent's leaves, named agent<i>/<net>/<path>."""
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    out = {}
    for net, tree in _trees(runner).items():
        for path, leaf in zip(_paths(tree), tree_leaves(tree)):
            for i in range(leaf.shape[0]):
                out[f"agent{i}/{net}/{path}"] = leaf[i]
    return out


def checked(built: Built, config: dict, iterations: int) -> dict:
    """The first `iterations` iterations through the window's own call,
    with the readings that compare.py takes (on the host), read by wrapping
    the runner's calls: agent 0's first actor loss plus its first critic
    loss (which carries value_loss_coef) as `_actor_loss` / `_critic_loss`
    return them, every agent's first actor and critic gradient as its
    ClipAdam got it after the clip (from the first moment after that step),
    and each agent's leaves' change."""
    runner = built.trainer
    st = runner.state
    paths = {net: _paths(tree) for net, tree in _trees(runner).items()}
    start = {n: v.detach().clone() for n, v in _per_agent(runner).items()}
    first: Dict = {"grad": {}}
    losses_fn = {"actor": runner._actor_loss, "critic": runner._critic_loss}

    def loss_once(net):
        def wrapped(*args, **kw):
            out = losses_fn[net](*args, **kw)
            if net not in first:
                first[net] = float(out[0].detach())
            return out
        return wrapped

    def step_once(net, tx, opt):
        step = tx.step

        def wrapped(params, grads, mu, nu, count):
            agent = opt.count.index(0) if count == 0 else None
            step(params, grads, mu, nu, count)
            if agent is not None:
                first["grad"].update({f"agent{agent}/{net}/{p}": (m[0] / (1 - tx.b1)).cpu()
                                      for p, m in zip(paths[net], mu)})
        return wrapped

    runner._actor_loss, runner._critic_loss = loss_once("actor"), loss_once("critic")
    runner.actor_tx.step = step_once("actor", runner.actor_tx, st.actor_opt)
    runner.critic_tx.step = step_once("critic", runner.critic_tx, st.critic_opt)
    coef = config["train"]["value_loss_coef"]
    losses, lrs = [], []
    try:
        for _ in range(iterations):
            m = iterate(built)
            losses.append(m["policy_loss"] + coef * m["value_loss"])
            lrs.append(float(config["train"]["lr"]))
    finally:
        del runner._actor_loss, runner._critic_loss, runner.actor_tx.step, runner.critic_tx.step
    change = {n: (v.detach() - start[n]).cpu() for n, v in _per_agent(runner).items()}
    return dict(loss=first["actor"] + first["critic"], grad=first["grad"], change=change,
                iteration_loss=losses, lr=lrs)


def reference(config: dict, cell: dict, seed: int, device, iterations: int,
              precision: str = "stated", fault: str | None = None) -> dict:
    """The plain reference's readings of the same iterations from the same
    inputs (the weights drawn again from the seed)."""
    from port_bench.reference.mappo import MAPPORef

    s = seeds(seed)
    leaves = make_leaves(config["train"], s["weights"], device)
    env_gen = torch.Generator(device=device)
    env_gen.manual_seed(s["env"])
    pol_gen = torch.Generator(device=device)
    pol_gen.manual_seed(s["policy"])
    ref = MAPPORef(config["train"], config["clip"], config["env"], config["sim"],
                   cell["num_envs"], leaves, env_gen, pol_gen, precision=precision, fault=fault)
    r = ref.readings(iterations)
    return dict(r, grad={n: t.cpu() for n, t in r["grad"].items()},
                change={n: t.cpu() for n, t in r["change"].items()})


def env_steps_per_iter(config: dict, cell: dict) -> int:
    return config["train"]["episode_length"] * cell["num_envs"]


def counted_work(config: dict, cell: dict) -> dict:
    """An iteration's counted work: the actors' and critics' matmul FLOPs
    by precision (the rollout's forwards, the last values, every update
    step's forward and backward over its rows, for every agent), and B1's
    operations."""
    tr = config["train"]
    T, E, N = tr["episode_length"], cell["num_envs"], NUM_AGENTS
    hidden = [tr["hidden_size"]] * (1 + tr["layer_N"])
    rows_upd = tr["ppo_epoch"] * T * E * N
    actor = mlp.flops(OBS_DIM, hidden, ACT_DIM)
    critic = mlp.flops(SHARE_DIM, hidden, 1)
    bf16 = fp32 = 0
    for net, fwd_rows in ((actor, T * E * N), (critic, T * E * N + E * N)):
        bf16 += fwd_rows * net["fwd_hidden"] + rows_upd * (net["fwd_hidden"] + net["bwd_hidden"])
        fp32 += fwd_rows * net["fwd_head"] + rows_upd * (net["fwd_head"] + net["bwd_head"])
    launches = T * config["sim"]["substeps"]
    return {"bf16_flop": bf16, "fp32_flop": fp32,
            "b1_ops": launches * b1.OPS_PER_ARTICULATION * E * 10, "b1_launches": launches}
