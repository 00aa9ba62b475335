"""Agent-stacked MarlActor/MarlCritic forwards on the fused Dense->ELU->LN
block (twin of massive_marl_tpu/algos/marl/fused_nets.py).

Used by the MARL update phase, where batches are [N_agents, B, ...]: every
Dense->ELU->LayerNorm block runs as kernel B2 forward and B3 backward, or
under FUSED_TOWER=1 the whole tower as kernels B4/B5 (ops/fused_mlp.py).
Parameters are the same agent-stacked trees that algos/marl/nets.py
initialises, so both paths read one set of weights.  The heads are plain
float32 products.

`actor_linearize` gives HATRPO's Fisher-vector products their J v: one
forward on kernel B2 and a tangent closure in plain PyTorch, evaluated
many times at that point; J^T comes from autograd through the kernels'
backward (algos/marl/runner.py).
"""
from __future__ import annotations

import torch

from massive_marl_tpu_torch.algos.marl.nets import dense_f32
from massive_marl_tpu_torch.ops.fused_mlp import (mlp_base_stacked, mlp_base_stacked_linearize,
                                                  mlp_base_stacked_tangent)


def actor_apply(params: dict, obs, *, std_x_coef: float = 1.0, std_y_coef: float = 0.5,
                layer_n: int = 2, prenormed: bool = False):
    """MarlActor.apply, agent-stacked: obs [N,B,obs_dim] -> (mean, std) [N,B,act]."""
    h = mlp_base_stacked(params["MLPBase_0"], obs, layer_n=layer_n, prenormed=prenormed)
    mean = dense_f32(params["Dense_0"], h)
    std = torch.sigmoid(params["std_param"] / std_x_coef) * std_y_coef  # [N, act]
    return mean, std[:, None, :].expand(mean.shape)


def actor_linearize(params: dict, obs, *, std_x_coef: float = 1.0, std_y_coef: float = 0.5,
                    layer_n: int = 2, prenormed: bool = False):
    """actor_apply and a reusable parameter-directional tangent: returns
    (mean, std, tangent) with tangent(dparams) -> (dmean, dstd), each
    [N,B,act] f32; the obs tangent is zero.  The forward (kernel B2) and
    every operand the tangent needs are computed once."""
    h, saved = mlp_base_stacked_linearize(params["MLPBase_0"], obs, layer_n=layer_n,
                                          prenormed=prenormed)
    head = params["Dense_0"]
    hf = h.float()
    mean = dense_f32(head, hf)
    s = torch.sigmoid(params["std_param"] / std_x_coef)
    std = (s * std_y_coef)[:, None, :].expand(mean.shape)

    def tangent(dparams: dict):
        dh = mlp_base_stacked_tangent(dparams["MLPBase_0"], saved, layer_n=layer_n)
        dhead = dparams["Dense_0"]
        dmean = torch.bmm(dh, head["kernel"]) + torch.bmm(hf, dhead["kernel"]) \
            + dhead["bias"][:, None, :]
        dstd = s * (1.0 - s) * dparams["std_param"] / std_x_coef * std_y_coef
        return dmean, dstd[:, None, :].expand(dmean.shape)

    return mean, std, tangent


def actor_apply_jvp(params: dict, dparams: dict, obs, *, std_x_coef: float = 1.0,
                    std_y_coef: float = 0.5, layer_n: int = 2, prenormed: bool = False):
    """(mean, std, dmean, dstd): actor_linearize and one tangent."""
    mean, std, tangent = actor_linearize(params, obs, std_x_coef=std_x_coef,
                                         std_y_coef=std_y_coef, layer_n=layer_n,
                                         prenormed=prenormed)
    return (mean, std) + tangent(dparams)


def critic_apply(params: dict, x, *, layer_n: int = 2, prenormed: bool = False):
    """MarlCritic.apply, agent-stacked: x [N,B,in_dim] -> values [N,B]."""
    h = mlp_base_stacked(params["MLPBase_0"], x, layer_n=layer_n, prenormed=prenormed)
    return dense_f32(params["Dense_0"], h).squeeze(-1)
