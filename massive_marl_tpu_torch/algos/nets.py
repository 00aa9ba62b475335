"""Actor-critic networks (twin of massive_marl_tpu/algos/nets.py).

ELU MLPs [1024, 1024, 512] with orthogonal init (gain sqrt(2) hidden, 0.01
actor head, 1.0 critic head) and a state-independent log_std.  As in the
reference, the hidden layers compute in bf16 (input, weight and bias cast
to bf16, the matmul result rounded to bf16 before the bias is added, the
ELU in bf16) while parameters stay float32, and the output head runs in
float32.  The reference's quirk std = exp(log_std)**2 is kept.

Under `f32_weight_grads()` a bf16 layer's weight and bias gradients are
float32 sums over the batch rows instead of bf16-rounded ones (its forward
and input gradient are unchanged): a mesh all-reduces the ranks' f32
partial sums and rounds the total to bf16 once (`round_bf16`), as a single
process rounds its whole-batch sum, rather than summing R rounded partial
sums whose rounding errors need not cancel.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACT = {"elu": F.elu, "relu": F.relu, "selu": F.selu, "tanh": torch.tanh,
        "lrelu": F.leaky_relu, "sigmoid": torch.sigmoid}


_MODE = threading.local()     # per thread, as torch's grad mode


@contextlib.contextmanager
def f32_weight_grads():
    """Within the block, the bf16 layers (MLP here, the MARL bases' Dense
    blocks) give float32 weight and bias gradients (see the module doc)."""
    prev, _MODE.f32_wgrad = f32_wgrad_on(), True
    try:
        yield
    finally:
        _MODE.f32_wgrad = prev


def f32_wgrad_on() -> bool:
    return getattr(_MODE, "f32_wgrad", False)


def round_bf16(grads, mask):
    """grads with the leaves where `mask` is true rounded to bf16 (and back
    to float32): what a bf16 layer's gradient is outside
    f32_weight_grads()."""
    return [g.to(torch.bfloat16).to(g.dtype) if m else g for g, m in zip(grads, mask)]


def orthogonal_(w: torch.Tensor, gain: float, generator: torch.Generator | None = None):
    """nn.init.orthogonal_ with its QR on one thread: LAPACK's blocked QR
    rounds with the number of threads, and every rank of a job must build
    the bits a process alone builds (parallel/launch.py starts its ranks
    at one thread, a process alone takes every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return nn.init.orthogonal_(w, gain=gain, generator=generator)
    finally:
        torch.set_num_threads(threads)


class _LinearBf16(torch.autograd.Function):
    """F.linear(x, bf16(w)) + bf16(b) on a bf16 x: the forward and dx of
    the plain expression, float32 row sums for dw and db."""

    @staticmethod
    def forward(ctx, x, w, b):
        wb = w.to(torch.bfloat16)
        ctx.save_for_backward(x, wb)
        return F.linear(x, wb) + b.to(torch.bfloat16)

    @staticmethod
    def backward(ctx, dy):
        x, wb = ctx.saved_tensors
        d2 = dy.reshape(-1, dy.shape[-1]).float()
        return dy.matmul(wb), d2.t() @ x.reshape(-1, x.shape[-1]).float(), d2.sum(0)


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 activation: str = "elu", out_gain: float = 0.01,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.act = _ACT[activation]
        dims = [in_dim, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.head = nn.Linear(dims[-1], out_dim)
        for lin, gain in [(l, math.sqrt(2)) for l in self.hidden] + [(self.head, out_gain)]:
            orthogonal_(lin.weight, gain, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        for lin in self.hidden:
            if f32_wgrad_on():
                x = self.act(_LinearBf16.apply(x, lin.weight, lin.bias))
            else:
                x = self.act(F.linear(x, lin.weight.to(torch.bfloat16))
                             + lin.bias.to(torch.bfloat16))
        return self.head(x.to(torch.float32))

    @staticmethod
    def bf16_mask(module: nn.Module):
        """Per parameter of `module` (named_parameters order): whether it is
        a bf16 hidden layer's."""
        return [".hidden." in f".{n}" for n, _ in module.named_parameters()]


class ActorCritic(nn.Module):
    """Actor and critic MLPs on the same input, plus a state-independent
    log_std.  forward(obs) -> (mean [N, act], value [N], log_std [act])."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden_actor: Sequence[int] = (1024, 1024, 512),
                 hidden_critic: Sequence[int] = (1024, 1024, 512),
                 activation: str = "elu", init_noise_std: float = 0.8,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.actor = MLP(obs_dim, hidden_actor, act_dim, activation, 0.01, generator)
        self.critic = MLP(obs_dim, hidden_critic, 1, activation, 1.0, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), math.log(init_noise_std)))

    def forward(self, obs: torch.Tensor):
        return self.actor(obs), self.critic(obs).squeeze(-1), self.log_std


def dist_std(log_std):
    """Reference quirk: the distribution's std is exp(log_std)**2."""
    return torch.exp(log_std) ** 2


def gaussian_log_prob(mean, log_std, actions):
    std = dist_std(log_std)
    z = (actions - mean) / std
    return torch.sum(-0.5 * z ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)


def gaussian_entropy(log_std, batch_shape=()):
    std = dist_std(log_std)
    ent = torch.sum(torch.log(std) + 0.5 * math.log(2 * math.pi * math.e))
    return ent.expand(batch_shape)


def gaussian_sample(mean, log_std, generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None):
    """mean + std * noise, with noise drawn from `generator` unless given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return mean + dist_std(log_std) * noise


def gaussian_kl(mu_old, log_std_old, mu_new, log_std_new):
    """KL(old || new) per sample, the reference's adaptive-KL formula (with
    exp(log_std)**2 read as the variance)."""
    return torch.sum(
        log_std_new - log_std_old
        + (torch.exp(log_std_old) ** 2 + (mu_old - mu_new) ** 2)
        / (2.0 * torch.exp(log_std_new) ** 2)
        - 0.5,
        dim=-1)
