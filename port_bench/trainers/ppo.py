"""PPO on an ant task: builds the port's trainer for a cell, drives its
checked first iterations, follows them with the plain reference, and counts
an iteration's work.

The benchmark makes every input and hands the same to both sides: the
weights (drawn on the device from the seed and loaded into the port's
model), and the seeds of the env's and the policy's random streams.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from port_bench.roofline import b1, mlp


def seeds(seed: int) -> Dict[str, int]:
    """The three random streams of a run, derived from its --seed."""
    return {"weights": 3 * seed, "env": 3 * seed + 1, "policy": 3 * seed + 2}


def leaf_shapes(cfg: dict, obs_dim: int, act_dim: int):
    """(name, shape, init gain or None for a bias) of every leaf, in the
    order of the port's ActorCritic.named_parameters()."""
    out = []
    for net, n_out, head_gain in (("actor", act_dim, 0.01), ("critic", 1, 1.0)):
        dims = [obs_dim, *cfg["hidden"]]
        for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
            out += [(f"{net}.hidden.{k}.weight", (o, i), math.sqrt(2)),
                    (f"{net}.hidden.{k}.bias", (o,), None)]
        out += [(f"{net}.head.weight", (n_out, dims[-1]), head_gain),
                (f"{net}.head.bias", (n_out,), None)]
    out.append(("log_std", (act_dim,), None))
    return out


def make_leaves(cfg: dict, obs_dim: int, act_dim: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights, from one draw on the device: each matrix normal
    with std gain / sqrt(fan_in), biases zero, log_std log(init_noise_std)."""
    shapes = leaf_shapes(cfg, obs_dim, act_dim)
    mats = [(n, s, g) for n, s, g in shapes if g is not None]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(s[0] * s[1] for _, s, _ in mats), generator=gen, device=device)
    leaves, off = {}, 0
    for name, shape, gain in shapes:
        if gain is not None:
            n = shape[0] * shape[1]
            leaves[name] = flat[off:off + n].view(shape) * (gain / math.sqrt(shape[1]))
            off += n
        elif name == "log_std":
            leaves[name] = torch.full(shape, math.log(cfg["init_noise_std"]), device=device)
        else:
            leaves[name] = torch.zeros(shape, device=device)
    return leaves


@dataclass
class Built:
    trainer: Any
    env: Any


def env_cfg(config: dict, cell: dict) -> dict:
    sim = dict(config["sim"], fused_kernel=cell.get("physics", "kernel") == "kernel")
    return {"env": config["env"], "sim": sim, "task": {"randomize": False}}


def build(config: dict, cell: dict, seed: int, device) -> Built:
    """The port's env and trainer on `device`, with the benchmark's weights."""
    from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv

    s = seeds(seed)
    env = TenAntEnv(env_cfg(config, cell), device=device, seed=s["env"])
    trainer = PPO(env, cell["num_envs"], PPOConfig(**{k: tuple(v) if k == "hidden" else v
                                                     for k, v in config["train"].items()}),
                  seed=s["policy"], device=device, print_log=False)
    leaves = make_leaves(config["train"], env.num_obs, env.num_actions * env.num_agents,
                         s["weights"], device)
    trainer.model.load_state_dict(leaves, strict=True)
    trainer.init_state()
    return Built(trainer, env)


def iterate(built: Built) -> Dict[str, float]:
    """One iteration as the window drives it: train_iter, then the metrics
    to the host (which ends in the device's sync)."""
    from massive_marl_tpu_torch.utils.logging import fetch_metrics
    return fetch_metrics(built.trainer.train_iter())


def checked(built: Built, config: dict, iterations: int) -> dict:
    """The first `iterations` iterations through the window's own call, with
    the readings that compare.py takes (on the host): the first optimizer
    step's loss as `_loss` returns it and its gradient as the optimizer
    got it (from Adam's first moment after that step), read by wrapping the
    two calls for that step only, and each leaf's change."""
    trainer = built.trainer
    vf = config["train"]["vf_coef"]
    names = [n for n, _ in trainer.model.named_parameters()]
    start = [p.detach().clone() for p in trainer.model.parameters()]
    first = {}
    loss_fn, step_fn = trainer._loss, trainer._step

    def loss_once(*args, **kw):
        out = loss_fn(*args, **kw)
        first.setdefault("loss", float(out[0].detach()))
        return out

    def step_once(*args, **kw):
        step_fn(*args, **kw)
        if "grad" not in first:
            first["grad"] = {n: (m / (1 - 0.9)).cpu()
                             for n, m in zip(names, trainer.state.opt.mu)}
            del trainer._loss, trainer._step

    trainer._loss, trainer._step = loss_once, step_once
    losses, lrs = [], []
    for _ in range(iterations):
        m = iterate(built)
        losses.append(m["mean_surrogate_loss"] + vf * m["mean_value_loss"])
        lrs.append(m["lr"])
    change = {n: (p.detach() - s).cpu()
              for n, p, s in zip(names, trainer.model.parameters(), start)}
    return dict(loss=first["loss"], grad=first["grad"], change=change,
                iteration_loss=losses, lr=lrs)


def reference(config: dict, cell: dict, seed: int, device, iterations: int,
              precision: str = "stated", fault: str | None = None) -> dict:
    """The plain reference's readings of the same iterations from the same
    inputs (the weights drawn again from the seed)."""
    from port_bench.reference.ppo import PPORef
    from port_bench.reference.tenant import NACT, NOBS

    s = seeds(seed)
    leaves = make_leaves(config["train"], NOBS, NACT, s["weights"], device)
    env_gen = torch.Generator(device=device)
    env_gen.manual_seed(s["env"])
    pol_gen = torch.Generator(device=device)
    pol_gen.manual_seed(s["policy"])
    ref = PPORef(config["train"], config["env"], config["sim"], cell["num_envs"],
                 list(leaves.values()), env_gen, pol_gen, precision=precision, fault=fault)
    r = ref.readings(iterations)
    return dict(r, grad={n: t.cpu() for n, t in zip(leaves, r["grad"])},
                change={n: t.cpu() for n, t in zip(leaves, r["change"])})


def env_steps_per_iter(config: dict, cell: dict) -> int:
    return config["train"]["nsteps"] * cell["num_envs"]


def counted_work(config: dict, cell: dict, obs_dim: int = 388, act_dim: int = 80) -> dict:
    """An iteration's counted work: the policy's and value's matmul FLOPs by
    precision (the rollout's forward passes, the last value, each update
    sample's forward and backward), and B1's operations."""
    tr = config["train"]
    T, E = tr["nsteps"], cell["num_envs"]
    hidden = tr["hidden"]
    samples_upd = tr["noptepochs"] * T * E
    actor = mlp.flops(obs_dim, hidden, act_dim)
    critic = mlp.flops(obs_dim, hidden, 1)
    bf16 = fp32 = 0
    for net, fwd_rows in ((actor, T * E), (critic, T * E + E)):
        bf16 += fwd_rows * net["fwd_hidden"] + samples_upd * (net["fwd_hidden"] + net["bwd_hidden"])
        fp32 += fwd_rows * net["fwd_head"] + samples_upd * (net["fwd_head"] + net["bwd_head"])
    launches = T * config["sim"]["substeps"]
    return {"bf16_flop": bf16, "fp32_flop": fp32,
            "b1_ops": launches * b1.OPS_PER_ARTICULATION * E * 10, "b1_launches": launches}
