"""TRPO, single-agent (twin of massive_marl_tpu/algos/rl/trpo.py).

One iteration = an nsteps rollout of policy forward + batched env step (as
in PPO), then GAE and a natural-gradient policy step:
  * the advantage normalised by its population std plus 1e-8;
  * g, the gradient of the surrogate mean(exp(logp - old_logp) * adv);
  * cg_nsteps conjugate-gradient iterations on F s = g, where F v is the
    Hessian of the mean KL at the old parameters times v, plus damping * v
    (a double backward over the actor's flat parameter vector), with the
    reference's 1e-10 guards;
  * the step sqrt(2 max_kl / max(s F s, 1e-10)) s, then a backtracking
    search over the scales backtrack_coeff**i, i < max_num_backtrack, that
    takes the first candidate whose surrogate improves and whose KL is at
    most 1.5 max_kl, and else keeps the old parameters.  The reference
    scans all candidates and keeps the first accepted one; the search here
    stops at it, which gives the same parameters;
  * vf_epochs full-batch Adam steps (lr vf_lr, no gradient clipping) on the
    clipped value loss.
The actor is the bf16-tower MLP of algos/nets.py (head gain 0.01) with a
state-independent log_std, the critic the same MLP with head gain 1.0; as in
the reference, both take the policy widths (pi_hid_sizes).  With a
`log_dir`, `run` logs train/mean_reward, train/value_loss and perf/fps and
saves `model_<it>.ckpt` every `save_interval` iterations, the JAX trainer's
own file (utils/bridge.trpo_state_to_flax).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos import nets
from massive_marl_tpu_torch.algos.rl.ppo import AdamState, adam_update
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer, fetch_metrics


@dataclass
class TRPOConfig:
    nsteps: int = 8
    gamma: float = 0.96
    lam: float = 0.95
    max_kl: float = 0.016
    cg_nsteps: int = 10
    damping: float = 0.1
    max_num_backtrack: int = 10
    backtrack_coeff: float = 0.8
    vf_lr: float = 3e-4
    vf_epochs: int = 5
    cliprange: float = 0.2
    init_noise_std: float = 0.8
    hidden: tuple = (1024, 1024, 512)
    activation: str = "elu"
    clip_obs: float = 5.0
    clip_actions: float = 1.0
    max_iterations: int = 6500
    save_interval: int = 1000

    @classmethod
    def from_cfg_train(cls, cfg_train: dict) -> "TRPOConfig":
        """Build from a train YAML (cfg/trpo/config.yaml) with the JAX
        package's key map: cfg/trpo's cg_iters, cg_damping, backtrack_iters,
        backtrack_coeff and optim_stepsize are not read (the JAX code looks
        for cg_nsteps, damping and max_num_backtrack), and the critic takes
        pi_hid_sizes."""
        learn = cfg_train.get("learn", {})
        pol = cfg_train.get("policy", {})
        kw = {k: learn[k] for k in ("nsteps", "gamma", "lam", "max_kl", "cg_nsteps", "damping",
                                    "max_num_backtrack", "init_noise_std", "max_iterations",
                                    "save_interval") if k in learn}
        if "pi_hid_sizes" in pol:
            kw["hidden"] = tuple(pol["pi_hid_sizes"])
        if "activation" in pol:
            kw["activation"] = pol["activation"]
        return cls(**kw)


class Actor(nn.Module):
    """obs -> (mean, log_std): nets.MLP (head gain 0.01) and a
    state-independent log_std."""

    def __init__(self, obs_dim, act_dim, hidden, activation, init_noise_std, generator=None):
        super().__init__()
        self.mlp = nets.MLP(obs_dim, hidden, act_dim, activation, 0.01, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), math.log(init_noise_std)))

    def forward(self, obs):
        return self.mlp(obs), self.log_std


class Critic(nn.Module):
    def __init__(self, obs_dim, hidden, activation, generator=None):
        super().__init__()
        self.mlp = nets.MLP(obs_dim, hidden, 1, activation, 1.0, generator)

    def forward(self, obs):
        return self.mlp(obs).squeeze(-1)


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def assign(params, vec: torch.Tensor):
    """Copy the flat vector `vec` into `params` in place."""
    i = 0
    for p in params:
        p.copy_(vec[i:i + p.numel()].view_as(p))
        i += p.numel()


@dataclass
class TRPOTrainState:
    vf_opt: AdamState
    env_state: Any
    iteration: int = 0


class TRPO:
    """TRPO(env, num_envs, cfg).run(max_iterations)."""

    def __init__(self, env, num_envs: int, cfg: TRPOConfig | None = None, seed: int = 0,
                 log_dir: str | None = None, device=None, print_log: bool = True, mesh=None):
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, trainer on {self.device}")
        if mesh is not None:
            raise NotImplementedError("multi-device TRPO training is not ported yet "
                                      "(ROADMAP A.9)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env = env
        self.num_envs = num_envs
        self.cfg = c = cfg or TRPOConfig()
        self.log_dir = log_dir
        self.print_log = print_log
        self.act_dim = env.num_actions * env.num_agents
        self.obs_dim = env.num_obs
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        init_gen = torch.Generator()
        init_gen.manual_seed(seed)
        self.actor = Actor(self.obs_dim, self.act_dim, c.hidden, c.activation,
                           c.init_noise_std, init_gen).to(self.device)
        self.critic = Critic(self.obs_dim, c.hidden, c.activation, init_gen).to(self.device)
        self.state: TRPOTrainState | None = None
        self.last_metrics: Dict[str, float] = {}
        # per update_phase: Fisher-vector products and line-search candidates
        self.last_search: Dict[str, int] = {}

    def init_state(self) -> TRPOTrainState:
        cp = list(self.critic.parameters())
        self.state = TRPOTrainState(
            vf_opt=AdamState(mu=[torch.zeros_like(p) for p in cp],
                             nu=[torch.zeros_like(p) for p in cp]),
            env_state=self.env.reset(self.num_envs))
        return self.state

    def _normal(self, shape):
        """The action noise of one rollout step."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    # ---------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout_phase(self) -> Dict[str, torch.Tensor]:
        """nsteps of policy + env; advances state.env_state and returns the
        trajectory dict ([T, E, ...]: obs, actions, logp, value, mean,
        reward, done)."""
        cfg = self.cfg
        env_state = self.state.env_state
        steps = []
        for _ in range(cfg.nsteps):
            obs = torch.clamp(env_state.obs, -cfg.clip_obs, cfg.clip_obs)
            mean, log_std = self.actor(obs)
            actions = nets.gaussian_sample(mean, log_std, noise=self._normal(mean.shape))
            logp = nets.gaussian_log_prob(mean, log_std, actions)
            value = self.critic(obs)
            env_state = self.env.step_batch(
                env_state, torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions))
            steps.append(dict(obs=obs, actions=actions, logp=logp, value=value, mean=mean,
                              reward=env_state.reward, done=env_state.done.to(torch.float32)))
        self.state.env_state = env_state
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    # ----------------------------------------------------------------- update
    def gae(self, traj, last_value):
        """(advantages normalised by their population std, returns)."""
        cfg = self.cfg
        next_values = torch.cat([traj["value"][1:], last_value[None]], dim=0)
        adv = torch.zeros_like(last_value)
        advs = []
        for t in reversed(range(traj["reward"].shape[0])):
            d = traj["done"][t]
            delta = traj["reward"][t] + cfg.gamma * next_values[t] * (1 - d) - traj["value"][t]
            adv = delta + cfg.gamma * cfg.lam * (1 - d) * adv
            advs.append(adv)
        adv = torch.stack(advs[::-1])
        returns = adv + traj["value"]
        return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8), returns

    def _policy_step(self, obs, actions, old_logp, old_mean, adv):
        """The natural-gradient step on the actor, in place; returns (old
        surrogate, accepted) as 0-d tensors."""
        cfg = self.cfg
        params = list(self.actor.parameters())
        old_log_std = self.actor.log_std.detach().clone()

        def surrogate():
            mean, log_std = self.actor(obs)
            return torch.mean(torch.exp(nets.gaussian_log_prob(mean, log_std, actions) - old_logp)
                              * adv)

        def mean_kl():
            mean, log_std = self.actor(obs)
            return nets.gaussian_kl(old_mean, old_log_std.expand_as(mean), mean,
                                    log_std.expand_as(mean)).mean()

        g = flat(torch.autograd.grad(surrogate(), params))
        grad_kl = flat(torch.autograd.grad(mean_kl(), params, create_graph=True))
        n_fvp = 0

        def fvp(v):
            nonlocal n_fvp
            n_fvp += 1
            hv = torch.autograd.grad(grad_kl @ v, params, retain_graph=True)
            return flat(hv) + cfg.damping * v

        x, r, p = torch.zeros_like(g), g, g
        rs = g @ g
        for _ in range(cfg.cg_nsteps):
            Ap = fvp(p)
            alpha = rs / (p @ Ap + 1e-10)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = r @ r
            p = r + (rs_new / (rs + 1e-10)) * p
            rs = rs_new
        sAs = x @ fvp(x)
        full_step = torch.sqrt(2.0 * cfg.max_kl / torch.clamp(sAs, min=1e-10)) * x
        del grad_kl

        with torch.no_grad():
            old_flat = flat(params)
            old_surr = surrogate()
            accepted, n_cand = False, 0
            for i in range(cfg.max_num_backtrack):
                n_cand += 1
                assign(params, old_flat + cfg.backtrack_coeff ** i * full_step)
                take = (surrogate() - old_surr > 0) & (mean_kl() <= cfg.max_kl * 1.5)
                if bool(take):
                    accepted = True
                    break
            if not accepted:
                assign(params, old_flat)
        self.last_search = {"fvps": n_fvp, "candidates": n_cand}
        return old_surr, torch.tensor(float(accepted), device=self.device)

    def _critic_epochs(self, obs, v_old, returns):
        """vf_epochs full-batch Adam steps on the clipped value loss; the
        mean of the epochs' losses."""
        cfg = self.cfg
        params = list(self.critic.parameters())
        losses = []
        for _ in range(cfg.vf_epochs):
            v = self.critic(obs)
            v_clip = v_old + torch.clamp(v - v_old, -cfg.cliprange, cfg.cliprange)
            loss = torch.mean(torch.maximum((v - returns) ** 2, (v_clip - returns) ** 2))
            adam_update(params, list(torch.autograd.grad(loss, params)), self.state.vf_opt,
                        cfg.vf_lr)
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def update_phase(self, traj: Dict[str, torch.Tensor], last_obs: torch.Tensor):
        """GAE, the policy step and the critic's epochs on one trajectory;
        returns the iteration's metrics (device tensors)."""
        cfg = self.cfg
        T, E = traj["reward"].shape
        with torch.no_grad():
            last_value = self.critic(torch.clamp(last_obs, -cfg.clip_obs, cfg.clip_obs))
            adv, returns = self.gae(traj, last_value)
        obs = traj["obs"].reshape(T * E, -1)
        old_surr, accepted = self._policy_step(
            obs, traj["actions"].reshape(T * E, -1), traj["logp"].reshape(T * E),
            traj["mean"].reshape(T * E, -1), adv.reshape(T * E))
        value_loss = self._critic_epochs(obs, traj["value"].reshape(T * E),
                                         returns.reshape(T * E))
        self.state.iteration += 1
        return dict(mean_reward=traj["reward"].mean(), surrogate=old_surr, accepted=accepted,
                    value_loss=value_loss)

    def train_iter(self):
        traj = self.rollout_phase()
        return self.update_phase(traj, self.state.env_state.obs)

    # ---------------------------------------------------------------- driving
    def run(self, num_learning_iterations: int | None = None, log_interval: int = 1):
        n = num_learning_iterations or self.cfg.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        spi = self.cfg.nsteps * self.num_envs
        for it in range(self.state.iteration, n):
            t0 = time.perf_counter()
            metrics = self.train_iter()
            if it % log_interval == 0:
                m = fetch_metrics(metrics)
                m["fps"] = spi / (time.perf_counter() - t0)
                self.last_metrics = m
                if writer:
                    writer.add_scalar("train/mean_reward", m["mean_reward"], it)
                    writer.add_scalar("train/value_loss", m["value_loss"], it)
                    writer.add_scalar("perf/fps", m["fps"], it)
                if self.print_log:
                    print(f"[trpo] it {it}: rew {m['mean_reward']:.3f} "
                          f"accept {m['accepted']:.0f} fps {m['fps']:.0f}", flush=True)
            if self.log_dir and self.cfg.save_interval and (it + 1) % self.cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str):
        """Actor, critic and iteration (the JAX trainer's file; no optimizer
        state, as there)."""
        tree = bridge.trpo_state_to_flax(self.actor.state_dict(), self.critic.state_dict(),
                                         self.state.iteration)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def load(self, path: str):
        """Restore the actor, the critic and the iteration from a file of
        either package; the critic's Adam state and the env stay as they
        are, as in the JAX trainer."""
        if self.state is None:
            self.init_state()
        actor, critic, iteration = bridge.trpo_state_from_flax(checkpoint.load_tree(path))
        for module, sd in ((self.actor, actor), (self.critic, critic)):
            module.load_state_dict(checkpoint.restore_into(module.state_dict(), sd))
        self.state.iteration = iteration

    test = load

    @torch.no_grad()
    def act_inference(self, obs):
        """The policy's mean action on obs clipped to +-clip_obs."""
        return self.actor(torch.clamp(obs, -self.cfg.clip_obs, self.cfg.clip_obs))[0]
