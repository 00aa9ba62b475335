"""Agent-stacked MarlActor/MarlCritic forwards on the fused Dense->ELU->LN
block (twin of massive_marl_tpu/algos/marl/fused_nets.py).

Used by the MARL update phase, where batches are [N_agents, B, ...]: every
Dense->ELU->LayerNorm block runs as kernel B2 forward and B3 backward
(ops/fused_mlp.py).  Parameters are the same agent-stacked trees that
algos/marl/nets.py initialises, so both paths read one set of weights.
The heads are plain float32 products.

Still to port with HATRPO (ROADMAP A.8a): `actor_linearize` and
`actor_apply_jvp`, the manual-JVP tangent of the Gauss-Newton
Fisher-vector product.
"""
from __future__ import annotations

import torch

from massive_marl_tpu_torch.algos.marl.nets import dense_f32
from massive_marl_tpu_torch.ops.fused_mlp import mlp_base_stacked


def actor_apply(params: dict, obs, *, std_x_coef: float = 1.0, std_y_coef: float = 0.5,
                layer_n: int = 2, prenormed: bool = False):
    """MarlActor.apply, agent-stacked: obs [N,B,obs_dim] -> (mean, std) [N,B,act]."""
    h = mlp_base_stacked(params["MLPBase_0"], obs, layer_n=layer_n, prenormed=prenormed)
    mean = dense_f32(params["Dense_0"], h)
    std = torch.sigmoid(params["std_param"] / std_x_coef) * std_y_coef  # [N, act]
    return mean, std[:, None, :].expand(mean.shape)


def critic_apply(params: dict, x, *, layer_n: int = 2, prenormed: bool = False):
    """MarlCritic.apply, agent-stacked: x [N,B,in_dim] -> values [N,B]."""
    h = mlp_base_stacked(params["MLPBase_0"], x, layer_n=layer_n, prenormed=prenormed)
    return dense_f32(params["Dense_0"], h).squeeze(-1)
