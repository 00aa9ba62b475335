"""MARL actor/critic networks (twin of massive_marl_tpu/algos/marl/nets.py).

  * MLPBase: LayerNorm feature normalization, then (1 + layer_N) blocks of
    Dense -> ELU -> LayerNorm, hidden 512;
  * MarlActor: MLPBase, an orthogonal(0.01) mean head and a
    state-independent parameter with std = sigmoid(p / std_x_coef) *
    std_y_coef (init p = std_x_coef);
  * MarlCritic: the same base and an orthogonal(sqrt 2) value head.

Parameters are agent-stacked: nested dicts in the flax variable layout
("MLPBase_0" / "LayerNorm_0" / "Dense_0" / ...), every leaf with a leading
agent axis N and Dense kernels as [N, in, out].  `apply` takes inputs with
the agent axis leading, [N, ..., in], and equals the reference's
`jax.vmap(module.apply)` over agents.

The roundings follow flax exactly:
  * the feature LayerNorm runs in float32;
  * Dense(dtype=bf16) casts input, kernel and bias to bf16, rounds the
    product to bf16 and adds the bias in bf16;
  * ELU runs on the bf16 stream (expm1, as flax);
  * LayerNorm(dtype=bf16) takes float32 statistics with flax's fast
    variance E[x^2] - E[x]^2 (clipped at 0), scales by rsqrt(var + eps) *
    scale and rounds the result to bf16; eps is 1e-6 everywhere.
The heads compute in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

EPS = 1e-6  # flax.linen.LayerNorm default epsilon


def orthogonal(num_agents: int, shape, gain: float, generator: torch.Generator):
    """[N, in, out]: one orthogonal matrix per agent, scaled by gain."""
    out = torch.empty((num_agents,) + tuple(shape))
    for n in range(num_agents):
        torch.nn.init.orthogonal_(out[n], gain=gain, generator=generator)
    return out


def _ln_params(num_agents: int, dim: int):
    return {"scale": torch.ones(num_agents, dim), "bias": torch.zeros(num_agents, dim)}


def _dense_params(num_agents: int, din: int, dout: int, gain: float, generator):
    return {"kernel": orthogonal(num_agents, (din, dout), gain, generator),
            "bias": torch.zeros(num_agents, dout)}


def _bmm(x, w):
    """x [N, ..., in] @ w [N, in, out] -> [N, ..., out]."""
    n, lead = x.shape[0], x.shape[1:-1]
    return torch.bmm(x.reshape(n, -1, x.shape[-1]), w).reshape(n, *lead, w.shape[-1])


def _vec(v, x):
    """[N, d] -> broadcastable against x [N, ..., d]."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[-1])


def layer_norm(p, x, out_dtype=None):
    """flax LayerNorm on x [N, ..., d] with p {"scale","bias"} [N, d]."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp_min(mu2 - mu * mu, 0.0)
    mul = torch.rsqrt(var + EPS) * _vec(p["scale"], x)
    y = (xf - mu) * mul + _vec(p["bias"], x)
    return y if out_dtype is None else y.to(out_dtype)


def dense_bf16(p, x):
    """flax Dense(dtype=bf16): bf16 product and bias."""
    bf = torch.bfloat16
    return _bmm(x.to(bf), p["kernel"].to(bf)) + _vec(p["bias"].to(bf), x)


def dense_f32(p, x):
    return _bmm(x.float(), p["kernel"]) + _vec(p["bias"], x)


@dataclass(frozen=True)
class MLPBase:
    """The feature LayerNorm is always on, as in every reference config."""
    hidden_size: int = 512
    layer_n: int = 2

    def init(self, num_agents: int, in_dim: int, generator: torch.Generator):
        p = {"LayerNorm_0": _ln_params(num_agents, in_dim)}
        d = in_dim
        for i in range(1 + self.layer_n):
            p[f"Dense_{i}"] = _dense_params(num_agents, d, self.hidden_size,
                                            math.sqrt(2), generator)
            p[f"LayerNorm_{i + 1}"] = _ln_params(num_agents, self.hidden_size)
            d = self.hidden_size
        return p

    def apply(self, p, x):
        """x [N, ..., in] float32 -> [N, ..., H] bf16."""
        x = layer_norm(p["LayerNorm_0"], x)
        for i in range(1 + self.layer_n):
            x = F.elu(dense_bf16(p[f"Dense_{i}"], x))
            x = layer_norm(p[f"LayerNorm_{i + 1}"], x, torch.bfloat16)
        return x


@dataclass(frozen=True)
class MarlActor:
    act_dim: int
    hidden_size: int = 512
    layer_n: int = 2
    gain: float = 0.01
    std_x_coef: float = 1.0
    std_y_coef: float = 0.5

    @property
    def base(self) -> MLPBase:
        return MLPBase(self.hidden_size, self.layer_n)

    def init(self, num_agents: int, obs_dim: int, generator: torch.Generator):
        return {"MLPBase_0": self.base.init(num_agents, obs_dim, generator),
                "Dense_0": _dense_params(num_agents, self.hidden_size, self.act_dim,
                                         self.gain, generator),
                "std_param": torch.full((num_agents, self.act_dim), float(self.std_x_coef))}

    def std(self, p):
        return torch.sigmoid(p["std_param"] / self.std_x_coef) * self.std_y_coef

    def apply(self, p, obs):
        """obs [N, ..., obs_dim] -> (mean, std), each [N, ..., act_dim]."""
        mean = dense_f32(p["Dense_0"], self.base.apply(p["MLPBase_0"], obs))
        return mean, _vec(self.std(p), mean).expand(mean.shape)


@dataclass(frozen=True)
class MarlCritic:
    hidden_size: int = 512
    layer_n: int = 2

    @property
    def base(self) -> MLPBase:
        return MLPBase(self.hidden_size, self.layer_n)

    def init(self, num_agents: int, in_dim: int, generator: torch.Generator):
        return {"MLPBase_0": self.base.init(num_agents, in_dim, generator),
                "Dense_0": _dense_params(num_agents, self.hidden_size, 1, math.sqrt(2),
                                         generator)}

    def apply(self, p, x):
        """x [N, ..., in] -> values [N, ...]."""
        return dense_f32(p["Dense_0"], self.base.apply(p["MLPBase_0"], x)).squeeze(-1)


def normal_log_prob(mean, std, actions):
    z = (actions - mean) / std
    return torch.sum(-0.5 * z ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)


def normal_entropy(std):
    return torch.sum(torch.log(std) + 0.5 * math.log(2 * math.pi * math.e), dim=-1)


def huber(err, delta):
    a = torch.abs(err)
    return torch.where(a <= delta, 0.5 * err ** 2, delta * (a - 0.5 * delta))


# ---------------------------------------------------------------------------
# running value normalizer (reference PopArt/ValueNorm, marl/utils/popart.py:
# debiased running mean / mean-square, variance clamped at 1e-2)
# ---------------------------------------------------------------------------

def _lead(v, x):
    """Stats of shape S -> broadcastable against x of shape S + (...)."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


@dataclass
class ValueNorm:
    """Running statistics with any leading shape S (one entry per agent
    when S = [N]).  `update(batch)` reduces batch [S..., B...] over its
    trailing axes; `normalize`/`denormalize` broadcast over them."""
    mean: torch.Tensor
    mean_sq: torch.Tensor
    debias: torch.Tensor
    beta: float = 0.99999

    @classmethod
    def create(cls, shape=(), beta: float = 0.99999, device=None):
        z = lambda: torch.zeros(shape, device=device)
        return cls(mean=z(), mean_sq=z(), debias=z(), beta=beta)

    def stats(self):
        m = self.mean / torch.clamp_min(self.debias, 1e-5)
        msq = self.mean_sq / torch.clamp_min(self.debias, 1e-5)
        var = torch.clamp_min(msq - m ** 2, 1e-2)
        return m, var

    def update(self, batch) -> "ValueNorm":
        flat = batch.reshape(*self.mean.shape, -1)
        m, msq = flat.mean(-1), (flat ** 2).mean(-1)
        w = self.beta
        return ValueNorm(mean=self.mean * w + m * (1 - w),
                         mean_sq=self.mean_sq * w + msq * (1 - w),
                         debias=self.debias * w + (1 - w), beta=w)

    def normalize(self, x):
        m, var = self.stats()
        return (x - _lead(m, x)) / _lead(torch.sqrt(var), x)

    def denormalize(self, x):
        m, var = self.stats()
        return x * _lead(torch.sqrt(var), x) + _lead(m, x)

    def index(self, i: slice) -> "ValueNorm":
        return ValueNorm(self.mean[i], self.mean_sq[i], self.debias[i], self.beta)

    def assign(self, i: slice, other: "ValueNorm"):
        """Write `other` (the stats of index i) back in place."""
        self.mean[i] = other.mean
        self.mean_sq[i] = other.mean_sq
        self.debias[i] = other.debias


def norm_targets(vn: ValueNorm, ret, mode: str):
    """Stats update + normalized value targets with the per-loss-call
    cadence of the reference trainers.  Returns (vn', rn_clipped, rn_original).

    mode='popart': the reference PopArt updates its stats on every forward
      call (popart.py:35-61) and cal_value_loss calls it twice
      (happo_trainer.py:62-63): error_clipped sees the stats after the first
      update, error_original after the second.  It never rescales the
      critic's output layer.
    mode='valuenorm': one update(), both errors share the stats
      (mappo_trainer.py:74-78).
    mode='none': raw returns pass through.
    """
    if mode == "popart":
        vn1 = vn.update(ret)
        rn_c = vn1.normalize(ret)
        vn2 = vn1.update(ret)
        return vn2, rn_c, vn2.normalize(ret)
    if mode == "valuenorm":
        vn = vn.update(ret)
        rn = vn.normalize(ret)
        return vn, rn, rn
    return vn, ret, ret
