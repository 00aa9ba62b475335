"""MAPPO in plain PyTorch: the reference that the benchmark holds the port's
first MAPPO iterations to.

MAPPO as Yu et al. publish it ("The Surprising Effectiveness of PPO in
Cooperative Multi-Agent Games", arXiv:2103.01955), with the settings of
SafeRL-Lab/Massive-MARL-Benchmark's cfg/mappo/config.yaml, on TenAnt
(tenant.py): N = 10 agents, each with an actor on its own observation (its
38 ant values and the 8 shared ones) and a critic on the 388-value state
(use_centralized_V).  Both nets are MLPBase: a feature LayerNorm, then
1 + layer_N blocks of Dense(hidden) -> ELU -> LayerNorm (eps 1e-6).  The
actor's mean head is a float32 Dense; its std is sigmoid(p / std_x_coef) *
std_y_coef with one parameter vector p per agent.  An iteration is an
episode_length rollout, then per agent GAE on the PopArt-denormalised
values and the advantages normalised over the agent's rows, then the
sequential schedule: agent after agent, ppo_epoch steps each on one
minibatch of every row (cfg/mappo's num_mini_batch 1), every step an actor
step on the clipped surrogate and a critic step on the clipped Huber value
loss, each with its own Adam (eps opti_eps, its own step count) after a
global-norm clip at max_grad_norm over that agent's net.

Where this departs from the published MAPPO (and follows the system it
checks, the benchmark's source repository):
  * ELU where cfg/mappo says use_ReLU, and the feature LayerNorm is always on;
  * PopArt updates its statistics on every call and the value loss calls it
    twice: the clipped error is taken against the targets normalised after
    the first update, the unclipped one after the second; the critic's
    output layer is never rescaled;
  * the global-norm clip scales by max_grad_norm / norm with no epsilon;
  * the advantages' normaliser adds 1e-5 to the population std;
  * the team reward is every agent's reward; no active or bad masks.

Precision, as the configuration states it:
  * acting (the rollout and the last values): flax's Dense(dtype=bf16) in
    every hidden block (input, kernel and bias rounded to bf16, the product
    rounded to bf16 before the bias is added in bf16), ELU on bf16,
    LayerNorms with float32 statistics E[x^2] - E[x]^2, the hidden ones
    rounded to bf16;
  * the update's forward: the feature LayerNorm's normalised input in
    float32, rounded to bf16, then its scale and bias, rounded to bf16 again;
    each block's product of bf16 operands summed in float32, the bias, ELU
    and LayerNorm (population variance) in float32, its output rounded to
    bf16; the update's backward: every product of a hidden block takes bf16
    operands (the cotangent rounded to bf16) and sums in float32, the weight
    gradients float32;
  * heads, value math, GAE and Adam in float32, TF32 off.

`precision="control"` is the next precision down: the hidden blocks'
operands in fp8 (e4m3, one scale per tensor), the heads in TF32.
`precision="reorder"` is a sound program that rounds otherwise: the acting
blocks' products summed in float32 and rounded to bf16 once, the update's
summed over two halves of the inputs and added.

`fault` plants one of the faults that the comparison must catch, with this
reference in the program's place (reference/ppo.py FAULTS): "half_batch"
(each step's actor and critic loss over the first half of its rows),
"altered" (the reward of every eighth env zeroed where the env produces it).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.ppo import FAULTS, _fp8
from port_bench.reference.tenant import A, TenAnt

EPS = 1e-6
BF16 = torch.bfloat16
OWN = 38   # an ant's own observation values; the rest of the 388 are shared


def _rows(v, x):
    """A per-agent [N, d] vector broadcast against x [N, ..., d]."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[-1])


# ------------------------------------------------------------------- acting
def _ln_acting(x, scale, bias, out_dtype=None):
    """flax LayerNorm: float32 statistics E[x^2] - E[x]^2, then (x - mean) *
    (rsqrt(var + eps) * scale) + bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
    y = (xf - mu) * (torch.rsqrt(var + EPS) * _rows(scale, x)) + _rows(bias, x)
    return y if out_dtype is None else y.to(out_dtype)


def _dense_acting(x, w, b, precision):
    """flax Dense(dtype=bf16) of x [N, M, in] and w [N, in, out]."""
    x16, w16 = x.to(BF16), w.to(BF16)
    if precision == "control":
        y = torch.bmm(_fp8(x16), _fp8(w16))
    elif precision == "reorder":
        y = torch.bmm(x16.float(), w16.float()).to(BF16)
    else:
        y = torch.bmm(x16, w16)
    return y + _rows(b.to(BF16), y)


# ------------------------------------------------------------------- update
class _Bf16Product(torch.autograd.Function):
    """x [M, in] (bf16 values) times bf16(w) [in, out], summed in float32;
    the backward's products take the cotangent rounded to bf16 and sum in
    float32: the weight's gradient is float32, the input's comes back in
    the input's dtype."""

    @staticmethod
    def forward(ctx, x, w, precision):
        w16 = w.to(BF16)
        if precision == "control":
            x, w16 = _fp8(x.to(BF16)).to(x.dtype).detach(), _fp8(w16).detach()
        ctx.save_for_backward(x, w16)
        xf, wf = x.float(), w16.float()
        if precision == "reorder":
            k = xf.shape[-1] // 2
            return xf[:, :k] @ wf[:k] + xf[:, k:] @ wf[k:]
        return xf @ wf

    @staticmethod
    def backward(ctx, g):
        x, w16 = ctx.saved_tensors
        g = g.to(BF16).float()
        return (g @ w16.float().t()).to(x.dtype), x.float().t() @ g, None


def _ln(a, scale, bias):
    mu = a.mean(-1, keepdim=True)
    var = ((a - mu) ** 2).mean(-1, keepdim=True)
    return (a - mu) * torch.rsqrt(var + EPS) * scale + bias


def _block_update(x, p, k, precision):
    """Dense_k -> ELU -> LayerNorm_{k+1} of the update on rows x of bf16
    values.  The forward is float32 from the product on; the backward takes
    the LayerNorm's statistics and ELU's slope (a + 1 below zero) from the
    activation a stored in bf16, as a block that keeps no float32
    activation between its passes does: each is the float32 value with the
    gradient of the bf16 one."""
    d, ln = p[f"Dense_{k}"], p[f"LayerNorm_{k + 1}"]
    h = _Bf16Product.apply(x, d["kernel"], precision) + d["bias"]
    a = F.elu(h)
    a16 = a.detach().to(BF16).float()
    a = a.detach() + (h - h.detach()) * torch.where(a16 > 0, 1.0, a16 + 1.0)
    y, y16 = _ln(a.detach(), ln["scale"], ln["bias"]), _ln(a16 + (a - a.detach()), ln["scale"],
                                                            ln["bias"])
    return (y.detach() + (y16 - y16.detach())).to(BF16)


def feature_hat(x):
    """The feature LayerNorm's normalised input of the update, in bf16."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + EPS)).to(BF16)


def base_update(p, xhat16, layer_n, precision):
    """One agent's MLPBase in the update: p its {name: leaf} tree, xhat16
    [M, in] from feature_hat; returns [M, H] bf16.  The first block's input
    bf16(xhat * scale + bias) is held in float32 so that the feature
    LayerNorm's scale and bias take their gradient from the unrounded
    cotangent."""
    ln0 = p["LayerNorm_0"]
    x = xhat16.float() * ln0["scale"] + ln0["bias"]
    h = x + (x.detach().to(BF16).float() - x.detach())
    for k in range(1 + layer_n):
        h = _block_update(h, p, k, precision)
    return h


class MAPPORef:
    """The reference trainer, started from the benchmark's agent-stacked
    leaves ({"actor/MLPBase_0/Dense_0/kernel": [N, in, out], ...}) and
    random streams."""

    def __init__(self, cfg: dict, clip: dict, env_cfg: dict, sim_cfg: dict, num_envs: int,
                 leaves: Dict[str, torch.Tensor], env_gen: torch.Generator,
                 pol_gen: torch.Generator, precision: str = "stated", fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        if precision not in ("stated", "control", "reorder"):
            raise ValueError(f"unknown precision {precision!r}")
        wanted = dict(use_popart=True, use_centralized_V=True, use_huber_loss=True,
                      use_clipped_value_loss=True, num_mini_batch=1)
        if any(cfg.get(k, v) != v for k, v in wanted.items()):
            raise ValueError(f"the reference computes MAPPO with {wanted} only")
        self.cfg, self.clip, self.E = cfg, clip, num_envs
        self.precision, self.fault = precision, fault
        dev = next(iter(leaves.values())).device
        self.env = TenAnt(env_cfg, sim_cfg, dev)
        self.env_gen, self.pol_gen = env_gen, pol_gen
        self.params = {n: v.detach().clone() for n, v in leaves.items()}
        self.N = self.params["actor/std_param"].shape[0]
        self.opt = {net: {"mu": {n: torch.zeros_like(v) for n, v in self.of(net).items()},
                          "nu": {n: torch.zeros_like(v) for n, v in self.of(net).items()},
                          "count": [0] * self.N}
                    for net in ("actor", "critic")}
        zeros = torch.zeros(self.N, device=dev)
        self.popart = {"mean": zeros.clone(), "mean_sq": zeros.clone(), "debias": zeros.clone()}
        self.state = self.env.reset(env_gen, num_envs)
        self.first: Dict = {}   # agent 0's first losses, every agent's first gradients

    def of(self, net: str, agent: int | None = None) -> Dict[str, torch.Tensor]:
        """A net's leaves by their path under it, agent-stacked, or one
        agent's (views)."""
        pre = net + "/"
        return {n[len(pre):]: (v if agent is None else v[agent])
                for n, v in self.params.items() if n.startswith(pre)}

    @staticmethod
    def tree(flat: Dict[str, torch.Tensor]) -> dict:
        out: dict = {}
        for path, v in flat.items():
            node = out
            *keys, last = path.split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = v
        return out

    # --------------------------------------------------------------- acting
    def _base_acting(self, p, x):
        h = _ln_acting(x, p["LayerNorm_0"]["scale"], p["LayerNorm_0"]["bias"])
        for k in range(1 + self.cfg["layer_N"]):
            d, ln = p[f"Dense_{k}"], p[f"LayerNorm_{k + 1}"]
            h = F.elu(_dense_acting(h, d["kernel"], d["bias"], self.precision))
            h = _ln_acting(h, ln["scale"], ln["bias"], BF16)
        return h

    def _std(self, p_std):
        return torch.sigmoid(p_std / self.cfg["std_x_coef"]) * self.cfg["std_y_coef"]

    def _act(self, obs_buf):
        """Every agent's (mean, std, value) of the envs' clipped obs [E, 388]."""
        E = obs_buf.shape[0]
        own = obs_buf[:, :A * OWN].reshape(E, A, OWN)
        shared = obs_buf[:, A * OWN:][:, None, :].expand(E, A, obs_buf.shape[1] - A * OWN)
        obs = torch.cat([own, shared], dim=-1).transpose(0, 1)                 # [N, E, 46]
        actor, critic = self.tree(self.of("actor")), self.tree(self.of("critic"))
        h = self._base_acting(actor["MLPBase_0"], obs).float()
        mean = torch.bmm(h, actor["Dense_0"]["kernel"]) + _rows(actor["Dense_0"]["bias"], h)
        std = _rows(self._std(actor["std_param"]), mean).expand(mean.shape)
        cin = obs_buf[None].expand(self.N, *obs_buf.shape).contiguous()
        hc = self._base_acting(critic["MLPBase_0"], cin).float()
        value = (torch.bmm(hc, critic["Dense_0"]["kernel"])
                 + _rows(critic["Dense_0"]["bias"], hc)).squeeze(-1)
        return obs, mean, std, value

    @staticmethod
    def log_prob(mean, std, actions):
        z = (actions - mean) / std
        return torch.sum(-0.5 * z ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)

    @torch.no_grad()
    def rollout(self) -> Dict[str, torch.Tensor]:
        clip_obs, clip_act = self.clip["obs"], self.clip["actions"]
        s, steps = self.state, []
        for _ in range(self.cfg["episode_length"]):
            obs_buf = torch.clamp(s.obs, -clip_obs, clip_obs)
            obs, mean, std, value = self._act(obs_buf)
            noise = torch.randn(mean.shape, generator=self.pol_gen, device=mean.device)
            actions = mean + std * noise
            logp = self.log_prob(mean, std, actions)
            a = torch.clamp(actions, -clip_act, clip_act).transpose(0, 1).reshape(self.E, -1)
            s = self.env.step(s, a, self.env_gen)
            if self.fault == "altered":
                s.reward = s.reward.clone()
                s.reward[::8] = 0.0
            steps.append(dict(obs=obs, share=obs_buf, actions=actions, logp=logp, values=value,
                              reward=s.reward, done=s.done.float()))
        self.state = s
        return {k: torch.stack([st[k] for st in steps], dim=1 if k in ("obs", "actions", "logp",
                                                                          "values") else 0)
                for k in steps[0]}

    # -------------------------------------------------------------- PopArt
    def _stats(self, st):
        m = st["mean"] / torch.clamp_min(st["debias"], 1e-5)
        var = torch.clamp_min(st["mean_sq"] / torch.clamp_min(st["debias"], 1e-5) - m ** 2, 1e-2)
        return m, torch.sqrt(var)

    @staticmethod
    def _popart_step(st, ret, beta=0.99999):
        return {"mean": st["mean"] * beta + ret.mean() * (1 - beta),
                "mean_sq": st["mean_sq"] * beta + (ret ** 2).mean() * (1 - beta),
                "debias": st["debias"] * beta + (1 - beta)}

    # -------------------------------------------------------------- update
    def _adam(self, net: str, agent: int, grads: Dict[str, torch.Tensor]):
        """Global-norm clip over the agent's net, then Adam, in place."""
        cfg, opt = self.cfg, self.opt[net]
        lr = float(cfg["lr"] if net == "actor" else cfg["critic_lr"])
        eps, clip, b1, b2 = float(cfg["opti_eps"]), float(cfg["max_grad_norm"]), 0.9, 0.999
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads.values()]))
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        opt["count"][agent] += 1
        c = opt["count"][agent]
        for name, g in grads.items():
            g = g * scale
            m, v = opt["mu"][name][agent], opt["nu"][name][agent]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / (1 - b1 ** c)) / (torch.sqrt(v / (1 - b2 ** c)) + eps) * lr
            self.params[f"{net}/{name}"][agent] -= upd
        if c == 1:
            self.first.setdefault("grad", {}).update(
                {f"agent{agent}/{net}/{n}": m[agent] / (1 - b1) for n, m in opt["mu"].items()})

    def _half(self, *ts):
        return [t[:t.shape[0] // 2] for t in ts] if self.fault == "half_batch" else list(ts)

    def _actor_step(self, agent, mb):
        cfg = self.cfg
        leaves = {n: v.detach().clone().requires_grad_(True)
                  for n, v in self.of("actor", agent).items()}
        p = self.tree(leaves)
        obs, actions, old_logp, adv = self._half(mb["obs"], mb["actions"], mb["logp"], mb["adv"])
        h = base_update(p["MLPBase_0"], obs, cfg["layer_N"], self.precision).float()
        mean = h @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
        std = self._std(p["std_param"]).expand(mean.shape)
        ratio = torch.exp(self.log_prob(mean, std, actions) - old_logp)
        clip = cfg["clip_param"]
        obj = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        ent = torch.sum(torch.log(std) + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
        loss = -obj.mean() - cfg["entropy_coef"] * ent.mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        self._adam("actor", agent, dict(zip(leaves, grads)))
        return loss.detach()

    def _critic_step(self, agent, mb):
        cfg = self.cfg
        pa = {k: v[agent] for k, v in self.popart.items()}
        st1 = self._popart_step(pa, mb["returns"])
        m1, s1 = self._stats(st1)
        st2 = self._popart_step(st1, mb["returns"])
        m2, s2 = self._stats(st2)
        for k in self.popart:
            self.popart[k][agent] = st2[k]
        leaves = {n: v.detach().clone().requires_grad_(True)
                  for n, v in self.of("critic", agent).items()}
        p = self.tree(leaves)
        cin, old, ret = self._half(mb["cin"], mb["values"], mb["returns"])
        h = base_update(p["MLPBase_0"], cin, cfg["layer_N"], self.precision).float()
        values = (h @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]).squeeze(-1)
        clip = cfg["clip_param"]
        v_clip = old + torch.clamp(values - old, -clip, clip)
        loss_o = self._huber((ret - m2) / s2 - values)
        loss_c = self._huber((ret - m1) / s1 - v_clip)
        v_loss = torch.maximum(loss_o, loss_c).mean()
        grads = torch.autograd.grad(cfg["value_loss_coef"] * v_loss, list(leaves.values()))
        self._adam("critic", agent, dict(zip(leaves, grads)))
        return v_loss.detach()

    def _huber(self, err):
        d = self.cfg["huber_delta"]
        a = torch.abs(err)
        return torch.where(a <= d, 0.5 * err ** 2, d * (a - 0.5 * d))

    def update(self, traj) -> Dict[str, torch.Tensor]:
        cfg, N = self.cfg, self.N
        T, E = traj["reward"].shape
        with torch.no_grad():
            _, _, _, last = self._act(torch.clamp(self.state.obs, -self.clip["obs"],
                                                  self.clip["obs"]))
            m, s = self._stats(self.popart)
            den = lambda x: x * s.reshape(N, *[1] * (x.dim() - 1)) + m.reshape(
                N, *[1] * (x.dim() - 1))
            v, last = den(traj["values"]), den(last)                       # [N, T, E], [N, E]
            nv = torch.cat([v[:, 1:], last[:, None]], dim=1)
            r, d = traj["reward"], traj["done"]
            adv, advs = torch.zeros_like(last), []
            for t in reversed(range(T)):
                delta = r[t] + cfg["gamma"] * nv[:, t] * (1 - d[t]) - v[:, t]
                adv = delta + cfg["gamma"] * cfg["gae_lambda"] * (1 - d[t]) * adv
                advs.append(adv)
            raw = torch.stack(advs[::-1], dim=1)
            returns = (raw + v).reshape(N, T * E)
            flat = raw.reshape(N, T * E)
            adv = (flat - flat.mean(1, keepdim=True)) / (flat.std(1, correction=0,
                                                                  keepdim=True) + 1e-5)
            data = dict(obs=feature_hat(traj["obs"].reshape(N, T * E, -1)),
                        actions=traj["actions"].reshape(N, T * E, -1),
                        logp=traj["logp"].reshape(N, T * E),
                        values=traj["values"].reshape(N, T * E), adv=adv, returns=returns)
            cin = feature_hat(traj["share"].reshape(T * E, -1))
        a_losses, v_losses = [], []
        for i in range(N):
            # one minibatch of every row: the runner draws no permutation
            mb = dict({k: x[i] for k, x in data.items()}, cin=cin)
            al, vl = [], []
            for _ in range(cfg["ppo_epoch"]):
                al.append(self._actor_step(i, mb))
                vl.append(self._critic_step(i, mb))
                if i == 0 and "loss" not in self.first:
                    self.first["loss"] = float(al[0]) + cfg["value_loss_coef"] * float(vl[0])
            a_losses.append(torch.stack(al).mean())
            v_losses.append(torch.stack(vl).mean())
        return dict(policy_loss=torch.stack(a_losses).mean(),
                    value_loss=torch.stack(v_losses).mean(),
                    mean_reward=traj["reward"].mean())

    def train_iter(self) -> Dict[str, float]:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.precision == "control"
        try:
            m = self.update(self.rollout())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return {k: float(v) for k, v in m.items()}

    def per_agent(self) -> Dict[str, torch.Tensor]:
        """Every agent's leaves, named agent<i>/<net>/<path>."""
        return {f"agent{i}/{n}": v[i] for n, v in self.params.items() for i in range(self.N)}

    def readings(self, iterations: int) -> dict:
        """What the comparison reads of the first `iterations` iterations:
        agent 0's first actor loss plus value_loss_coef times its first
        critic loss, every agent's first actor and critic gradient after
        the clip (from Adam's first moment after that step), each agent's
        leaves' change over the iterations, and for the record each
        iteration's policy_loss + value_loss_coef x value_loss and the step
        size."""
        start = {n: v.detach().clone() for n, v in self.per_agent().items()}
        losses, lrs = [], []
        for _ in range(iterations):
            m = self.train_iter()
            losses.append(m["policy_loss"] + self.cfg["value_loss_coef"] * m["value_loss"])
            lrs.append(float(self.cfg["lr"]))
        change = {n: v.detach() - start[n] for n, v in self.per_agent().items()}
        return dict(loss=self.first["loss"], grad=self.first["grad"], change=change,
                    iteration_loss=losses, lr=lrs)
