"""Float32 matmul FLOPs of flax's GRUCell (a multiply-add counts two), and
of the cell in one iteration of recurrent MAPPO.

A step of the cell on one row makes the input products x [din] -> r, z, n
[3H] and the recurrent products h [H] -> [3H].  Training needs each
product's weight gradient and its input's gradient: twice the forward,
except that the hidden state a sequence starts from takes no gradient, so
the first step of each chunk computes the recurrent products' weight
gradient alone.
"""
from __future__ import annotations


def flops(din: int, H: int) -> dict:
    """One row's step: forward, backward, and the backward of a chunk's
    first step."""
    inp, rec = 2 * din * 3 * H, 2 * H * 3 * H
    return {"fwd": inp + rec, "bwd": 2 * (inp + rec), "bwd_first": 2 * inp + rec}


def mappo_rnn_flop(train: dict, num_envs: int, num_agents: int = 10) -> int:
    """The GRU's products in one iteration, for actor and critic: the
    rollout's T steps and the critic's last values (forward), then every
    epoch's BPTT through each agent's chunks of L steps (data_chunk_length,
    or the whole rollout), forward and backward.  The base's output is H
    wide, so din = H."""
    H, T = train["hidden_size"], train["episode_length"]
    L = train.get("data_chunk_length") or T
    rows = num_envs * num_agents
    f = flops(H, H)
    rollout = (T * rows + T * rows + rows) * f["fwd"]
    chunks = (T // L) * rows
    per_chunk = L * (f["fwd"] + f["bwd"]) - f["bwd"] + f["bwd_first"]
    epochs = train["ppo_epoch"] * 2 * chunks * per_chunk
    return rollout + epochs
