"""PPO in plain PyTorch: the reference that the benchmark holds the port's
first training iterations to.

SafeRL-Lab/Massive-MARL-Benchmark's PPO (cfg/ppo/config.yaml): actor and
critic ELU MLPs on the same observation, a state-independent log_std whose
distribution std is exp(log_std)**2 (the reference's quirk), an nsteps
rollout, GAE with (1 - done) masking, advantages normalised by their
population std, noptepochs x nminibatches sequential minibatches of the
clipped surrogate and the clipped value loss, global-norm clipping to
max_grad_norm, Adam (0.9, 0.999, 1e-8) and the adaptive-KL step size
(x1.5 or /1.5 inside [1e-5, 1e-2], from each minibatch's pre-step KL).

Precision, as the configuration states it: the hidden layers compute in
bfloat16 (input, weight and bias rounded to bf16, the product rounded before
the bias is added, the ELU in bf16) and the heads in float32 with TF32 off.
`precision="control"` is the next precision down, the step that would tempt
a faster program: the hidden layers' operands in fp8 (e4m3, one scale per
tensor) and the heads in TF32.

`precision="reorder"` is a sound program that rounds otherwise: the hidden
products of the same bf16 operands summed in float32 in another order than
the tensor cores' and rounded to bf16 once, the precision stated.

`fault` plants one of the faults that the comparison must catch, with this
reference in the program's place: "half_batch" (each minibatch's loss over
its first half only), "altered" (the reward of every eighth env zeroed where
the env produces it).  A step that leaves the state unchanged needs no run:
its parameter change reads exactly 1 (see compare.py).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference.tenant import TenAnt

FAULTS = ("half_batch", "altered")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with one scale per tensor, back in bf16; the
    gradient passes straight through to t."""
    with torch.no_grad():
        scale = t.abs().amax().float().clamp(min=1e-30) / 448.0
        q = ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)
    t16 = t.to(torch.bfloat16)
    return t16 + (q - t16).detach()


class Nets:
    """Actor and critic from a flat list of float32 leaves, in the order
    actor hidden (w, b)..., actor head (w, b), critic likewise, log_std."""

    def __init__(self, leaves: List[torch.Tensor], n_hidden: int, precision: str = "stated"):
        self.params = [p.detach().clone().requires_grad_(True) for p in leaves]
        self.n_hidden = n_hidden
        self.precision = precision

    def _mlp(self, ps, x):
        low = self.precision == "control"
        x = x.to(torch.bfloat16)
        for k in range(self.n_hidden):
            w, b = ps[2 * k], ps[2 * k + 1]
            if low:
                y = F.linear(_fp8(x), _fp8(w))
            elif self.precision == "reorder":
                y = F.linear(x.float(), w.to(torch.bfloat16).float()).to(torch.bfloat16)
            else:
                y = F.linear(x, w.to(torch.bfloat16))
            x = F.elu(y + b.to(torch.bfloat16))
        w, b = ps[2 * self.n_hidden], ps[2 * self.n_hidden + 1]
        return F.linear(x.to(torch.float32), w, b)

    def __call__(self, obs):
        n = 2 * self.n_hidden + 2
        mean = self._mlp(self.params[:n], obs)
        value = self._mlp(self.params[n:2 * n], obs).squeeze(-1)
        return mean, value, self.params[-1]


def dist_std(log_std):
    return torch.exp(log_std) ** 2


def log_prob(mean, log_std, actions):
    std = dist_std(log_std)
    z = (actions - mean) / std
    return torch.sum(-0.5 * z ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)


def entropy(log_std, batch_shape):
    std = dist_std(log_std)
    ent = torch.sum(torch.log(std) + 0.5 * math.log(2 * math.pi * math.e))
    return ent.expand(batch_shape)


def kl(mu_old, log_std_old, mu_new, log_std_new):
    return torch.sum(log_std_new - log_std_old
                     + (torch.exp(log_std_old) ** 2 + (mu_old - mu_new) ** 2)
                     / (2.0 * torch.exp(log_std_new) ** 2) - 0.5, dim=-1)


class Adam:
    """Global-norm clip, then Adam with bias correction, in place."""

    def __init__(self, params):
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params, grads, lr, max_grad_norm):
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(g_norm < max_grad_norm, torch.ones_like(g_norm),
                            max_grad_norm / g_norm)
        grads = torch._foreach_mul(grads, scale)
        b1, b2 = 0.9, 0.999
        self.count += 1
        torch._foreach_lerp_(self.mu, grads, 1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1 - b2)
        denom = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, lr)
        with torch.no_grad():
            torch._foreach_sub_(params, upd)


class PPORef:
    """The reference trainer, started from the benchmark's leaves and
    random streams."""

    def __init__(self, cfg: dict, env_cfg: dict, sim_cfg: dict, num_envs: int,
                 leaves: List[torch.Tensor], env_gen: torch.Generator,
                 pol_gen: torch.Generator, precision: str = "stated", fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        if (cfg["activation"], cfg["schedule"], cfg["use_clipped_value_loss"]) != \
                ("elu", "adaptive", True):
            raise ValueError("the reference computes ELU nets, the adaptive-KL schedule and "
                             "the clipped value loss only")
        self.cfg, self.E, self.fault = cfg, num_envs, fault
        self.env = TenAnt(env_cfg, sim_cfg, leaves[0].device)
        self.env_gen, self.pol_gen = env_gen, pol_gen
        self.nets = Nets(leaves, len(cfg["hidden"]), precision)
        self.opt = Adam(self.nets.params)
        self.lr = torch.tensor(float(cfg["lr"]), device=leaves[0].device)
        self.state = self.env.reset(env_gen, num_envs)
        self.first = None     # the first optimizer step's loss and gradient

    @torch.no_grad()
    def rollout(self) -> Dict[str, torch.Tensor]:
        cfg, steps = self.cfg, []
        s = self.state
        for _ in range(cfg["nsteps"]):
            obs = torch.clamp(s.obs, -cfg["clip_obs"], cfg["clip_obs"])
            mean, value, log_std = self.nets(obs)
            noise = torch.randn(mean.shape, generator=self.pol_gen, device=mean.device,
                                dtype=mean.dtype)
            actions = mean + dist_std(log_std) * noise
            logp = log_prob(mean, log_std, actions)
            s = self.env.step(s, torch.clamp(actions, -cfg["clip_actions"], cfg["clip_actions"]),
                              self.env_gen)
            reward = s.reward
            if self.fault == "altered":
                reward = reward.clone()
                reward[::8] = 0.0
                s.reward = reward
            steps.append(dict(obs=obs, actions=actions, logp=logp, value=value, mean=mean,
                              reward=reward, done=s.done.to(torch.float32)))
        self.state = s
        return {k: torch.stack([st[k] for st in steps]) for k in steps[0]}

    def _loss(self, batch, old_log_std):
        cfg = self.cfg
        if self.fault == "half_batch":
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        mean, value, log_std = self.nets(batch["obs"])
        logp = log_prob(mean, log_std, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        clip = cfg["cliprange"]
        surrogate = torch.mean(torch.maximum(-adv * ratio,
                                             -adv * torch.clamp(ratio, 1 - clip, 1 + clip)))
        v_clip = batch["value"] + torch.clamp(value - batch["value"], -clip, clip)
        value_loss = torch.mean(torch.maximum((value - batch["returns"]) ** 2,
                                              (v_clip - batch["returns"]) ** 2))
        ent = entropy(log_std, batch["obs"].shape[:1]).mean()
        loss = surrogate + cfg["vf_coef"] * value_loss - cfg["ent_coef"] * ent
        with torch.no_grad():
            k = torch.mean(kl(batch["mean"], old_log_std.expand_as(mean), mean,
                              log_std.expand_as(mean)))
        return loss, surrogate.detach(), value_loss.detach(), k

    def update(self, traj) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        T, E = traj["reward"].shape
        params = self.nets.params
        with torch.no_grad():
            _, last_value, _ = self.nets(torch.clamp(self.state.obs, -cfg["clip_obs"],
                                                     cfg["clip_obs"]))
            next_values = torch.cat([traj["value"][1:], last_value[None]], dim=0)
            adv = torch.zeros_like(last_value)
            advs = []
            for t in reversed(range(T)):
                d = traj["done"][t]
                delta = traj["reward"][t] + cfg["gamma"] * next_values[t] * (1 - d) \
                    - traj["value"][t]
                adv = delta + cfg["gamma"] * cfg["lam"] * (1 - d) * adv
                advs.append(adv)
            raw = torch.stack(advs[::-1])
            norm = (raw - raw.mean((0, 1))) / (raw.std((0, 1), correction=0) + 1e-8)
            returns = raw + traj["value"]
        old_log_std = params[-1].detach().clone()
        flat = dict(obs=traj["obs"].reshape(T * E, -1), actions=traj["actions"].reshape(T * E, -1),
                    logp=traj["logp"].reshape(T * E), value=traj["value"].reshape(T * E),
                    mean=traj["mean"].reshape(T * E, -1), adv=norm.reshape(T * E),
                    returns=returns.reshape(T * E))
        n_mb = cfg["nminibatches"]
        mb = T * E // n_mb
        lr, desired = self.lr, cfg["desired_kl"]
        surr, vals = [], []
        for _ in range(cfg["noptepochs"]):
            for m in range(n_mb):
                batch = {k: v[m * mb:(m + 1) * mb] for k, v in flat.items()}
                loss, s_loss, v_loss, k = self._loss(batch, old_log_std)
                if self.first is None:
                    self.first = {"loss": float(loss.detach())}
                grads = list(torch.autograd.grad(loss, params))
                lr = torch.where(k > desired * 2.0, torch.clamp(lr / 1.5, min=1e-5), lr)
                lr = torch.where((k < desired / 2.0) & (k > 0.0),
                                 torch.clamp(lr * 1.5, max=1e-2), lr)
                self.opt.step(params, grads, lr, cfg["max_grad_norm"])
                if "grad" not in self.first:   # worked out from Adam's state after one step
                    self.first["grad"] = [m / (1 - 0.9) for m in self.opt.mu]
                surr.append(s_loss)
                vals.append(v_loss)
        self.lr = lr
        return dict(mean_value_loss=torch.stack(vals).mean(),
                    mean_surrogate_loss=torch.stack(surr).mean(),
                    mean_reward=traj["reward"].mean(), lr=lr)

    def train_iter(self) -> Dict[str, float]:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.nets.precision == "control"
        try:
            m = self.update(self.rollout())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return {k: float(v) for k, v in m.items()}

    def readings(self, iterations: int) -> dict:
        """What the comparison reads of the first `iterations` training
        iterations: the first optimizer step's loss and gradient (from
        Adam's first moment after that step), each leaf's change over the
        iterations, and for the record each iteration's loss (mean
        surrogate + vf_coef x mean value loss) and closing step size."""
        start = [p.detach().clone() for p in self.nets.params]
        losses, lrs = [], []
        for _ in range(iterations):
            m = self.train_iter()
            losses.append(m["mean_surrogate_loss"] + self.cfg["vf_coef"] * m["mean_value_loss"])
            lrs.append(m["lr"])
        change = [p.detach() - s for p, s in zip(self.nets.params, start)]
        return dict(loss=self.first["loss"], grad=self.first["grad"], change=change,
                    iteration_loss=losses, lr=lrs)
