"""MARL actor/critic networks (twin of massive_marl_tpu/algos/marl/nets.py).

  * MLPBase: LayerNorm feature normalization, then (1 + layer_N) blocks of
    Dense -> ELU -> LayerNorm, hidden 512;
  * MarlActor: MLPBase, an orthogonal(0.01) mean head and a
    state-independent parameter with std = sigmoid(p / std_x_coef) *
    std_y_coef (init p = std_x_coef);
  * MarlCritic: the same base and an orthogonal(sqrt 2) value head;
  * MarlActorRNN / MarlCriticRNN: the same bases, then flax's GRUCell
    ("GRUCell_0": ir/iz/in Dense with bias, hr/hz without, hn with; r and z
    gate the input and hidden products, n = tanh(in(x) + r * hn(h)), h' =
    (1 - z) n + z h), then the same heads.  The hidden state is multiplied
    by `mask` (0 at an episode start) before the cell.

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
The heads, and the GRU cell on the bf16 base output, compute in float32
(flax Dense(dtype=None) promotes bf16 inputs to the float32 parameters).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from massive_marl_tpu_torch.algos.nets import f32_wgrad_on, orthogonal_
from massive_marl_tpu_torch.algos.rl.offpolicy import init_dense
from massive_marl_tpu_torch.utils.profiling import span

EPS = 1e-6  # flax.linen.LayerNorm default epsilon


def orthogonal(num_agents: int, shape, gain: float, generator: torch.Generator):
    """[N, in, out]: one orthogonal matrix per agent, scaled by gain."""
    out = torch.empty((num_agents,) + tuple(shape))
    for n in range(num_agents):
        orthogonal_(out[n], gain, generator)
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


class _WeightGradF32(torch.autograd.Function):
    """x^T dy of bf16 rows x [N, M, K] and dy [N, M, H] as a float32 row sum
    [N, K, H].  Its backward is the plain bf16 product's (the cotangent
    rounded to bf16, bf16 products), so a double backward through it does
    the plain graph's arithmetic."""

    @staticmethod
    def forward(ctx, x3, d3):
        ctx.save_for_backward(x3, d3)
        return torch.bmm(x3.transpose(1, 2).float(), d3.float())

    @staticmethod
    def backward(ctx, g):
        x3, d3 = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        return torch.bmm(d3, gb.transpose(1, 2)), torch.bmm(x3, gb)


class _BmmBf16(torch.autograd.Function):
    """bmm(x, bf16(w)) of a bf16 x [N, M, K] and a float32 w [N, K, H]: the
    plain product, with w's gradient a float32 row sum (_WeightGradF32)."""

    @staticmethod
    def forward(ctx, x3, w):
        ctx.save_for_backward(x3, w)
        return torch.bmm(x3, w.to(torch.bfloat16))

    @staticmethod
    def backward(ctx, g):
        x3, w = ctx.saved_tensors
        return _BmmBf16.apply(g, w.transpose(1, 2)), _WeightGradF32.apply(x3, g)


class _DenseBf16(torch.autograd.Function):
    """dense_bf16 on a bf16 x: the forward and dx of the plain expression,
    float32 row sums for the kernel and bias (algos/nets.f32_weight_grads).
    The backward is built of differentiable products (_BmmBf16,
    _WeightGradF32), so a double backward (HATRPO's Fisher-vector product)
    gives float32 row sums as well."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _bmm(x, w.to(torch.bfloat16)) + _vec(b.to(torch.bfloat16), x)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        n = x.shape[0]
        d3 = dy.reshape(n, -1, dy.shape[-1])
        x3 = x.reshape(n, -1, x.shape[-1])
        dx = _BmmBf16.apply(d3, w.transpose(1, 2)).reshape(x.shape)
        return dx, _WeightGradF32.apply(x3, d3), d3.float().sum(1)


def dense_bf16(p, x):
    """flax Dense(dtype=bf16): bf16 product and bias."""
    bf = torch.bfloat16
    if f32_wgrad_on():
        return _DenseBf16.apply(x.to(bf), p["kernel"], p["bias"])
    return _bmm(x.to(bf), p["kernel"].to(bf)) + _vec(p["bias"].to(bf), x)


def bf16_mask(tree):
    """Per leaf of a parameter tree (tree_leaves order): whether it is the
    kernel or bias of a base's bf16 Dense block."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out.append(len(path) >= 3 and path[-3].startswith("MLPBase")
                       and path[-2].startswith("Dense_"))
    walk(tree, ())
    return out


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


def lecun_dense(num_agents: int, din: int, dout: int, generator):
    """flax's default Dense init, agent-stacked: lecun_normal kernels [N, in,
    out] and zero biases [N, out]."""
    ds = [init_dense(din, dout, generator) for _ in range(num_agents)]
    return {k: torch.stack([d[k] for d in ds]) for k in ("kernel", "bias")}


def gru_init(num_agents: int, din: int, hidden: int, generator: torch.Generator):
    """flax GRUCell's variables, agent-stacked: lecun_normal input kernels,
    orthogonal recurrent ones, zero biases; hr and hz have no bias."""
    p = {}
    for gate in ("r", "z", "n"):
        p["i" + gate] = lecun_dense(num_agents, din, hidden, generator)
        p["h" + gate] = {"kernel": orthogonal(num_agents, (hidden, hidden), 1.0, generator)}
    p["hn"]["bias"] = torch.zeros(num_agents, hidden)
    return {k: p[k] for k in ("ir", "hr", "iz", "hz", "in", "hn")}


def gru_inputs(p, x):
    """flax GRUCell's input products ir(x), iz(x), in(x), biases included,
    of agent-stacked x [N, ..., in] (float32)."""
    return tuple(dense_f32(p[k], x) for k in ("ir", "iz", "in"))


def gru_step(p, h, xr, xz, xn):
    """flax GRUCell's update of h [N, ..., H] from its input products."""
    hh = lambda name: _bmm(h, p[name]["kernel"])
    r = torch.sigmoid(xr + hh("hr"))
    z = torch.sigmoid(xz + hh("hz"))
    n = torch.tanh(xn + r * (hh("hn") + _vec(p["hn"]["bias"], h)))
    return (1.0 - z) * n + z * h


def _masked(h, mask):
    """h [N, ..., H] zeroed where mask [...] is 0 (an episode start)."""
    return h * mask[..., None]


def gru_seq(p, x, h, mask):
    """The cell over a sequence: x [N, L, B, in], h [N, B, H] at its start,
    mask [N or 1, L, B] -> hidden states [N, L, B, H].  The input products
    run over all L steps at once (the span gru.seq)."""
    with span("gru.seq"):
        xs = gru_inputs(p, x)
        out = []
        for t in range(x.shape[1]):
            h = gru_step(p, _masked(h, mask[:, t]), *(g[:, t] for g in xs))
            out.append(h)
        return torch.stack(out, 1)


def _gru_once(p, x, h, mask):
    """One step of the cell from h, masked (the span gru.step)."""
    with span("gru.step"):
        return gru_step(p, _masked(h, mask), *gru_inputs(p, x))


@dataclass(frozen=True)
class MarlActorRNN(MarlActor):
    """MLPBase -> GRUCell -> MarlActor's heads."""

    def init(self, num_agents: int, obs_dim: int, generator: torch.Generator):
        p = super().init(num_agents, obs_dim, generator)
        return {"MLPBase_0": p["MLPBase_0"],
                "GRUCell_0": gru_init(num_agents, self.hidden_size, self.hidden_size, generator),
                "Dense_0": p["Dense_0"], "std_param": p["std_param"]}

    def apply(self, p, obs, h, mask):
        """obs [N, ..., obs_dim], h [N, ..., H], mask [...] -> (mean, std,
        new h)."""
        h = _gru_once(p["GRUCell_0"], self.base.apply(p["MLPBase_0"], obs), h, mask)
        mean = dense_f32(p["Dense_0"], h)
        return mean, _vec(self.std(p), mean).expand(mean.shape), h

    def apply_seq(self, p, obs, h, mask):
        """obs [N, L, B, obs_dim] from hiddens h [N, B, H], mask [N or 1, L,
        B] -> (mean, std), each [N, L, B, act_dim]."""
        hs = gru_seq(p["GRUCell_0"], self.base.apply(p["MLPBase_0"], obs), h, mask)
        mean = dense_f32(p["Dense_0"], hs)
        return mean, _vec(self.std(p), mean).expand(mean.shape)


@dataclass(frozen=True)
class MarlCriticRNN(MarlCritic):
    """MLPBase -> GRUCell -> MarlCritic's value head."""

    def init(self, num_agents: int, in_dim: int, generator: torch.Generator):
        p = super().init(num_agents, in_dim, generator)
        return {"MLPBase_0": p["MLPBase_0"],
                "GRUCell_0": gru_init(num_agents, self.hidden_size, self.hidden_size, generator),
                "Dense_0": p["Dense_0"]}

    def apply(self, p, x, h, mask):
        """x [N, ..., in], h [N, ..., H], mask [...] -> (values [N, ...],
        new h)."""
        h = _gru_once(p["GRUCell_0"], self.base.apply(p["MLPBase_0"], x), h, mask)
        return dense_f32(p["Dense_0"], h).squeeze(-1), h

    def apply_seq(self, p, x, h, mask):
        """x [N, L, B, in] from hiddens h [N, B, H], mask [N or 1, L, B] ->
        values [N, L, B]."""
        hs = gru_seq(p["GRUCell_0"], self.base.apply(p["MLPBase_0"], x), h, mask)
        return dense_f32(p["Dense_0"], hs).squeeze(-1)


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

    def update(self, batch, moments=None) -> "ValueNorm":
        """The stats after one batch; `moments` gives the batch's (mean,
        mean of squares) when they are not its own (a mesh's global
        ones)."""
        if moments is None:
            flat = batch.reshape(*self.mean.shape, -1)
            moments = flat.mean(-1), (flat ** 2).mean(-1)
        m, msq = moments
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


def norm_targets(vn: ValueNorm, ret, mode: str, moments=None):
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
    moments: None, or a function of ret giving the (mean, mean of squares)
    that update() takes (a mesh's global ones), called once.
    """
    mom = moments(ret) if moments is not None and mode != "none" else None
    if mode == "popart":
        vn1 = vn.update(ret, mom)
        rn_c = vn1.normalize(ret)
        vn2 = vn1.update(ret, mom)
        return vn2, rn_c, vn2.normalize(ret)
    if mode == "valuenorm":
        vn = vn.update(ret, mom)
        rn = vn.normalize(ret)
        return vn, rn, rn
    return vn, ret, ret
