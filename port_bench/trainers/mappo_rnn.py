"""Recurrent MAPPO (rMAPPO: GRU policies, BPTT through the rollout) on
TenAnt: builds the port's RecurrentMarlRunner for a cell, drives its checked
first iterations, follows them with the plain reference, and counts an
iteration's work.

The benchmark makes every input and hands the same to both sides: the
weights (drawn on the device from the seed and loaded into the runner's
agent-stacked trees in place of its host-side initialisation), and the
seeds of the env's and the runner's random streams.  The runner updates all
agents in one stacked step (MAPPO's agents are independent); the reference
updates them one after another.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from port_bench.roofline import gru
from port_bench.trainers import mappo
from port_bench.trainers.mappo import (ACT_DIM, NUM_AGENTS, OBS_DIM, SHARE_DIM, _mlp_base,
                                       _paths, _per_agent, _trees, env_steps_per_iter,
                                       marl_config)
from port_bench.trainers.ppo import Built, env_cfg, iterate, seeds


def _gru(H: int) -> List[Tuple[str, tuple, object]]:
    """flax GRUCell's leaves in the port's order: the input kernels' gain
    1 (lecun_normal), the recurrent kernels' std 1 / sqrt(H)."""
    out = []
    for gate in ("r", "z", "n"):
        out += [(f"GRUCell_0/i{gate}/kernel", (H, H), 1.0),
                (f"GRUCell_0/i{gate}/bias", (H,), "zeros"),
                (f"GRUCell_0/h{gate}/kernel", (H, H), 1.0)]
    out.append(("GRUCell_0/hn/bias", (H,), "zeros"))
    return out


def leaf_shapes(train: dict) -> List[Tuple[str, tuple, object]]:
    """(name, per-agent shape, init) of every leaf, actor then critic, in
    the order of the port's tree_leaves: MLPBase_0, GRUCell_0, the heads."""
    H, L = train["hidden_size"], train["layer_N"]
    actor = [("MLPBase_0/" + p, s, i) for p, s, i in _mlp_base(H, L, OBS_DIM)] + _gru(H)
    actor += [("Dense_0/kernel", (H, ACT_DIM), train["gain"]),
              ("Dense_0/bias", (ACT_DIM,), "zeros"), ("std_param", (ACT_DIM,), "std")]
    critic = [("MLPBase_0/" + p, s, i) for p, s, i in _mlp_base(H, L, SHARE_DIM)] + _gru(H)
    critic += [("Dense_0/kernel", (H, 1), 1.0), ("Dense_0/bias", (1,), "zeros")]
    return ([("actor/" + n, s, i) for n, s, i in actor]
            + [("critic/" + n, s, i) for n, s, i in critic])


def make_leaves(train: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial agent-stacked weights [N, ...], from one draw on the
    device: a kernel normal with std gain / sqrt(fan_in)."""
    shapes = leaf_shapes(train)
    N = NUM_AGENTS
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(N * sum(math.prod(s) for _, s, i in shapes if not isinstance(i, str)),
                       generator=gen, device=device)
    fills = {"ones": 1.0, "zeros": 0.0, "std": float(train["std_x_coef"])}
    leaves, off = {}, 0
    for name, shape, init in shapes:
        full = (N, *shape)
        if isinstance(init, str):
            leaves[name] = torch.full(full, fills[init], device=device)
        else:
            n = math.prod(full)
            leaves[name] = flat[off:off + n].view(full) * (init / math.sqrt(shape[0]))
            off += n
    return leaves


def build(config: dict, cell: dict, seed: int, device) -> Built:
    """The port's env and RecurrentMarlRunner on `device` (the runner that
    cli/train.py picks for cfg/mappo with use_recurrent_policy), with the
    benchmark's weights."""
    from massive_marl_tpu_torch.algos.marl.recurrent_runner import RecurrentMarlRunner
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.utils.tree import tree_leaves

    cfg = marl_config(config)
    if not cfg.use_recurrent_policy:
        raise ValueError("the configuration does not set use_recurrent_policy")
    s = seeds(seed)
    env = TenAntEnv(env_cfg(config, cell), device=device, seed=s["env"])
    runner = RecurrentMarlRunner(env, cell["num_envs"], cfg, seed=s["policy"], device=device,
                                 print_log=False)
    runner.init_state()
    leaves = make_leaves(config["train"], s["weights"], device)
    with torch.no_grad():
        for net, tree in _trees(runner).items():
            for path, leaf in zip(_paths(tree), tree_leaves(tree)):
                leaf.copy_(leaves[f"{net}/{path}"])
    return Built(runner, env)


def checked(built: Built, config: dict, iterations: int) -> dict:
    """The first `iterations` iterations through the window's own call,
    with the readings that compare.py takes (on the host), read by wrapping
    the runner's calls: agent 0's first actor loss (its clipped surrogate)
    plus value_loss_coef times its first critic loss, as the stacked
    `_actor_loss` / `_critic_loss` return them per agent; every agent's
    first actor and critic gradient as ClipAdam got it after the clip (the
    first step's first moment, indexed by agent); each agent's leaves'
    change."""
    runner = built.trainer
    paths = {net: _paths(tree) for net, tree in _trees(runner).items()}
    start = {n: v.detach().clone() for n, v in _per_agent(runner).items()}
    first: Dict = {"grad": {}}
    losses_fn = {"actor": runner._actor_loss, "critic": runner._critic_loss}

    def loss_once(net):
        def wrapped(*args, **kw):
            out = losses_fn[net](*args, **kw)
            first.setdefault(net, float(out[1][0]))
            return out
        return wrapped

    def step_once(net, tx):
        step = tx.step

        def wrapped(params, grads, mu, nu, count, *rest):
            step(params, grads, mu, nu, count, *rest)
            if count == 0:
                first["grad"].update({f"agent{i}/{net}/{p}": (m[i] / (1 - tx.b1)).cpu()
                                      for p, m in zip(paths[net], mu)
                                      for i in range(m.shape[0])})
        return wrapped

    runner._actor_loss, runner._critic_loss = loss_once("actor"), loss_once("critic")
    runner.actor_tx.step = step_once("actor", runner.actor_tx)
    runner.critic_tx.step = step_once("critic", runner.critic_tx)
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
    return dict(loss=first["actor"] + coef * first["critic"], grad=first["grad"],
                change=change, iteration_loss=losses, lr=lrs)


def reference(config: dict, cell: dict, seed: int, device, iterations: int,
              precision: str = "stated", fault: str | None = None) -> dict:
    """The plain reference's readings of the same iterations from the same
    inputs (the weights drawn again from the seed)."""
    from port_bench.reference.mappo_rnn import MAPPORNNRef

    s = seeds(seed)
    leaves = make_leaves(config["train"], s["weights"], device)
    env_gen = torch.Generator(device=device)
    env_gen.manual_seed(s["env"])
    pol_gen = torch.Generator(device=device)
    pol_gen.manual_seed(s["policy"])
    ref = MAPPORNNRef(config["train"], config["clip"], config["env"], config["sim"],
                      cell["num_envs"], leaves, env_gen, pol_gen, precision=precision,
                      fault=fault)
    r = ref.readings(iterations)
    return dict(r, grad={n: t.cpu() for n, t in r["grad"].items()},
                change={n: t.cpu() for n, t in r["change"].items()})


def counted_work(config: dict, cell: dict) -> dict:
    """An iteration's counted work: tenant-mappo's (the bases' bf16 and the
    heads' float32 matmul FLOPs over the rollout, the last values and every
    epoch's rows, and B1's operations), plus the GRU's float32 products
    (roofline/gru.py)."""
    work = mappo.counted_work(config, cell)
    work["fp32_flop"] += gru.mappo_rnn_flop(config["train"], cell["num_envs"], NUM_AGENTS)
    return work
