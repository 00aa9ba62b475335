"""Matmul FLOPs of a dense MLP per sample (a multiply-add counts two),
split into the hidden layers and the head, for the forward pass and for
the backward pass that training needs: every layer's weight gradient, and
the input gradient of every layer but the first (the observations take no
gradient)."""
from __future__ import annotations

from typing import Sequence


def flops(in_dim: int, hidden: Sequence[int], out_dim: int) -> dict:
    dims = [in_dim, *hidden]
    layers = [i * o for i, o in zip(dims[:-1], dims[1:])]
    head = dims[-1] * out_dim
    return {"fwd_hidden": 2 * sum(layers), "fwd_head": 2 * head,
            "bwd_hidden": 2 * sum(layers) + 2 * sum(layers[1:]),
            "bwd_head": 4 * head}
