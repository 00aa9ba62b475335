"""Offline RL trainers: TD3+BC, BCQ and IQL (twin of
massive_marl_tpu/algos/offrl/trainers.py).

The dataset (algos/offrl/datasets) lives on the device; a train step
gathers batch_size random rows (`_slots`).  The networks are float32 ReLU
MLPs with flax Dense's default init (rl/offpolicy.init_mlp: lecun-normal
kernels, zero biases), held as flax-layout trees {<net>: {"params":
{"Dense_i"}}}, each with its own plain Adam(lr) (no clipping); Polyak
averaging is (1 - tau) t + tau p over every network.
  * TD3+BC: TD3's twin-Q step with clipped target-policy noise, and every
    policy_freq steps the actor step -alpha / mean|Q| x mean Q + the
    behaviour-cloning MSE; only TD3+BC normalises states (the dataset's
    population mean and std plus 1e-3);
  * BCQ: the VAE step (latent 2 x act_dim, log_std clipped to [-4, 15]);
    the target over 10 decoded candidates per next state (z clipped to
    +-0.5), perturbed by phi x tanh, lmbda-weighted twin min/max, max over
    candidates; the twin-Q steps; the perturbation step on candidates
    decoded from the VAE step's noise (the JAX step reuses that key);
  * IQL: the expectile value step against the targets' twin min, the twin
    Q steps to r + discount (1 - d) V(s'), then advantage-weighted
    regression of the tanh-mean actor (weights exp(temperature x adv)
    capped at 100); its logged q_loss is the value loss.
`eval_online` rolls the policy in a live env: the tanh actor mean (TD3+BC,
IQL) or BCQ's argmax over Q1 of 10 perturbed VAE candidates, obs clipped at
+-5, envs reset from a generator seeded with seed + 1.  The checkpoint is
the JAX trainer's file {"params", "step"} (utils/bridge.offline_state_*).
Random draws go through `_slots` and `_normal`, in the reference's order.

Under a `mesh` (parallel/mesh.py) every rank draws the same batch rows and
keeps its batch_size / R of them, and its noise is its rows' part of the
draw over the whole batch; the gradients and the q_loss are averaged over
the ranks (TD3+BC's lambda from the global mean |Q|), so a step is the
single-process one.  eval_online splits its envs over the ranks.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos.offrl import datasets
from massive_marl_tpu_torch.algos.rl.offpolicy import _detached, dense, init_mlp
from massive_marl_tpu_torch.algos.rl.ppo import AdamState, adam_update
from massive_marl_tpu_torch.envs.base import env_generator
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw_rows
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclass
class OfflineConfig:
    algo: str = "td3_bc"
    batch_size: int = 256
    lr: float = 3e-4
    discount: float = 0.99
    tau: float = 0.005          # target <- (1 - tau) target + tau params
    hidden: int = 256
    layers: int = 2
    max_iterations: int = 100_000
    log_interval: int = 1000
    save_interval: int = 10_000
    dataset_root: str = "./datasets"
    # td3_bc
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_freq: int = 2
    alpha: float = 2.5
    normalize: bool = True
    # bcq
    phi: float = 0.05
    lmbda: float = 0.75
    # iql
    expectile: float = 0.7
    temperature: float = 3.0

    @classmethod
    def from_cfg_train(cls, cfg_train: dict, algo: str) -> "OfflineConfig":
        """The JAX key map: dataset_dir is not read (dataset_root stays
        ./datasets), nor bcq's vae_latent or iql's quantile."""
        learn = cfg_train.get("learn", {})
        kw = {"algo": algo}
        for k, yk in {"batch_size": "batch_size", "lr": "learning_rate",
                      "discount": "discount", "tau": "tau",
                      "hidden": "hidden_nodes", "layers": "hidden_layer",
                      "max_iterations": "max_iterations",
                      "log_interval": "log_interval", "save_interval": "save_interval",
                      "policy_noise": "policy_noise", "noise_clip": "noise_clip",
                      "policy_freq": "policy_freq", "alpha": "alpha",
                      "normalize": "normalize", "phi": "phi", "lmbda": "lmbda",
                      "expectile": "expectile", "temperature": "temperature"}.items():
            if yk in learn:
                kw[k] = learn[yk]
        kw["lr"] = float(kw.get("lr", 3e-4))
        return cls(**kw)


def mlp_apply(p: dict, *xs):
    """The _mlp of the JAX package: the inputs concatenated, ReLU Dense
    layers, a linear head."""
    x = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
    layers = p["params"]
    n = len(layers)
    for i in range(n - 1):
        x = F.relu(dense(layers[f"Dense_{i}"], x))
    return dense(layers[f"Dense_{n - 1}"], x)


@dataclass
class OfflineState:
    params: dict
    target_params: dict
    opts: Dict[str, AdamState]
    step: int = 0


class OfflineTrainer:
    def __init__(self, task: str, datatype: str, cfg: OfflineConfig, seed: int = 0,
                 log_dir: str | None = None, print_log: bool = True, data: dict | None = None,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        if cfg.algo not in ("td3_bc", "bcq", "iql"):
            raise ValueError(cfg.algo)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.log_dir = log_dir
        self.print_log = print_log
        self.seed = seed
        if data is None:
            path = datasets.dataset_dir(cfg.dataset_root, task, datatype)
            if not os.path.isdir(path):
                if datatype != "random":
                    raise FileNotFoundError(
                        f"dataset {path} missing; run --algo ppo_collect first "
                        f"(process_offrl.py dataset convention)")
                datasets.make_random_dataset(path, task=task, seed=seed, device=self.device)
            data = datasets.load_dataset(path)
        data = {k: np.asarray(v, np.float32) for k, v in data.items()}
        self.obs_dim = data["states"].shape[1]
        self.act_dim = data["actions"].shape[1]
        self.obs_mean = self.obs_std = None
        if cfg.normalize and cfg.algo == "td3_bc":
            mu = data["states"].mean(0, keepdims=True)
            std = data["states"].std(0, keepdims=True) + 1e-3
            data = dict(data, states=(data["states"] - mu) / std,
                        next_states=(data["next_states"] - mu) / std)
            self.obs_mean = torch.from_numpy(mu).to(self.device)
            self.obs_std = torch.from_numpy(std).to(self.device)
        self.data = {k: torch.from_numpy(v).to(self.device) for k, v in data.items()}
        self.N = len(data["states"])
        self.mesh = mesh or LOCAL
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, cfg.batch_size)
        self.latent_dim = 2 * self.act_dim
        self.state: OfflineState | None = None
        self.last_metrics: Dict[str, float] = {}

    # ------------------------------------------------------------------ build
    def net_widths(self) -> Dict[str, list]:
        """Each network's [in, hidden..., out] widths, in the JAX trainer's
        order."""
        c = self.cfg
        o, a, hid = self.obs_dim, self.act_dim, [c.hidden] * c.layers
        if c.algo == "td3_bc":
            shapes = {"actor": (o, a), "q1": (o + a, 1), "q2": (o + a, 1)}
        elif c.algo == "bcq":
            L = self.latent_dim
            shapes = {"vae_enc": (o + a, 2 * L), "vae_dec": (o + L, a), "pert": (o + a, a),
                      "q1": (o + a, 1), "q2": (o + a, 1)}
        else:
            shapes = {"actor": (o, 2 * a), "q1": (o + a, 1), "q2": (o + a, 1), "value": (o, 1)}
        return {k: [i, *hid, out] for k, (i, out) in shapes.items()}

    def init_state(self) -> OfflineState:
        g = torch.Generator()
        g.manual_seed(self.seed)
        params = {k: tree_map(lambda t: t.to(self.device).requires_grad_(True), init_mlp(w, g))
                  for k, w in self.net_widths().items()}
        opts = {k: AdamState(mu=[torch.zeros_like(x) for x in tree_leaves(p)],
                             nu=[torch.zeros_like(x) for x in tree_leaves(p)])
                for k, p in params.items()}
        self.state = OfflineState(params=params, target_params=_detached(
            tree_map(torch.clone, params)), opts=opts)
        return self.state

    # ------------------------------------------------------------ random draws
    def _slots(self):
        """batch_size dataset rows drawn uniformly."""
        return torch.randint(0, self.N, (self.cfg.batch_size,), generator=self.generator,
                             device=self.device)

    def _normal(self, shape, generator=None):
        """N(0, 1) over `shape`, whose leading axis is the batch's rows, or
        k consecutive entries per row (over the whole batch under a
        mesh)."""
        return draw_rows(torch.randn, shape, generator or self.generator, per_row=True,
                         device=self.device)

    # -------------------------------------------------------------- internals
    def _sample(self):
        idx = self._slots()[self.mesh.rows(self.cfg.batch_size)]
        b = {k: v[idx] for k, v in self.data.items()}
        return (b["states"], b["actions"], b["rewards"].squeeze(-1), b["dones"].squeeze(-1),
                b["next_states"])

    def _adam(self, name: str, loss):
        """One Adam(lr) step of network `name` on `loss`, in place."""
        leaves = tree_leaves(self.state.params[name])
        adam_update(leaves, self.mesh.mean(list(torch.autograd.grad(loss, leaves))),
                    self.state.opts[name], self.cfg.lr)

    def _polyak(self):
        tau = self.cfg.tau
        with torch.no_grad():
            t_leaves = tree_leaves(self.state.target_params)
            torch._foreach_mul_(t_leaves, 1 - tau)
            torch._foreach_add_(t_leaves,
                                torch._foreach_mul(tree_leaves(self.state.params), tau))

    def _q(self, p, o, a):
        return mlp_apply(p, o, a).squeeze(-1)

    def _twin_q_steps(self, o, a, target):
        """The q1 and q2 steps toward `target`; both losses are taken at the
        parameters before either step."""
        losses = {k: torch.mean((self._q(self.state.params[k], o, a) - target) ** 2)
                  for k in ("q1", "q2")}
        for k, loss in losses.items():
            self._adam(k, loss)

    def _td3bc_step(self):
        c, st = self.cfg, self.state
        o, a, r, d, o2 = self._sample()
        p, tp = st.params, st.target_params
        with torch.no_grad():
            noise = torch.clamp(c.policy_noise * self._normal(a.shape), -c.noise_clip,
                                c.noise_clip)
            a2 = torch.clamp(torch.tanh(mlp_apply(tp["actor"], o2)) + noise, -1, 1)
            tq = torch.minimum(self._q(tp["q1"], o2, a2), self._q(tp["q2"], o2, a2))
            target = r + c.discount * (1 - d) * tq
        self._twin_q_steps(o, a, target)
        if st.step % c.policy_freq == 0:
            pi = torch.tanh(mlp_apply(p["actor"], o))
            q = self._q(_detached(p["q1"]), o, pi)
            bc = torch.mean((pi - a) ** 2)
            if self.mesh is LOCAL:
                lmbda = c.alpha / (q.abs().mean() + 1e-8)
                self._adam("actor", -lmbda * q.mean() + bc)
            else:
                # -alpha Q / (A + 1e-8) of the global means Q, A: the rank's
                # share of its gradient, linear in its means q, a
                qm, am = q.mean(), q.abs().mean()
                Q, A = self.mesh.mean([qm.detach(), am.detach()])
                A = A + 1e-8
                self._adam("actor", -c.alpha * (qm / A - Q * am / A ** 2) + bc)
        self._polyak()
        with torch.no_grad():
            return self.mesh.mean(torch.mean((self._q(p["q1"], o, a) - target) ** 2))

    def _decode(self, dec_p, obs, z):
        return torch.tanh(mlp_apply(dec_p, obs, torch.clamp(z, -0.5, 0.5)))

    def _bcq_step(self):
        c, st = self.cfg, self.state
        o, a, r, d, o2 = self._sample()
        p, tp, L = st.params, st.target_params, self.latent_dim
        stats = mlp_apply(p["vae_enc"], o, a)
        mu, log_std = stats[:, :L], torch.clamp(stats[:, L:], -4, 15)
        eps = self._normal(mu.shape)
        z = mu + torch.exp(log_std) * eps
        recon = torch.tanh(mlp_apply(p["vae_dec"], o, z))
        kl = -0.5 * torch.mean(1 + 2 * log_std - mu ** 2 - torch.exp(2 * log_std))
        vae_loss = torch.mean((recon - a) ** 2) + 0.5 * kl
        enc, dec = tree_leaves(p["vae_enc"]), tree_leaves(p["vae_dec"])
        grads = self.mesh.mean(list(torch.autograd.grad(vae_loss, enc + dec)))
        adam_update(enc, list(grads[:len(enc)]), st.opts["vae_enc"], c.lr)
        adam_update(dec, list(grads[len(enc):]), st.opts["vae_dec"], c.lr)
        reps = 10
        with torch.no_grad():
            o2r = torch.repeat_interleave(o2, reps, dim=0)
            cand = self._decode(p["vae_dec"], o2r, self._normal((o2r.shape[0], L)))
            a2 = torch.clamp(cand + c.phi * torch.tanh(mlp_apply(tp["pert"], o2r, cand)), -1, 1)
            q1, q2 = self._q(tp["q1"], o2r, a2), self._q(tp["q2"], o2r, a2)
            q = c.lmbda * torch.minimum(q1, q2) + (1 - c.lmbda) * torch.maximum(q1, q2)
            target = r + c.discount * (1 - d) * q.reshape(-1, reps).max(dim=1).values
        self._twin_q_steps(o, a, target)
        with torch.no_grad():
            cand = self._decode(p["vae_dec"], o, eps)
        a_p = torch.clamp(cand + c.phi * torch.tanh(mlp_apply(p["pert"], o, cand)), -1, 1)
        self._adam("pert", -torch.mean(self._q(_detached(p["q1"]), o, a_p)))
        self._polyak()
        with torch.no_grad():
            return self.mesh.mean(torch.mean((self._q(p["q1"], o, a) - target) ** 2))

    def _iql_step(self):
        c, st = self.cfg, self.state
        o, a, r, d, o2 = self._sample()
        p, tp = st.params, st.target_params
        with torch.no_grad():
            tq = torch.minimum(self._q(tp["q1"], o, a), self._q(tp["q2"], o, a))
        diff = tq - mlp_apply(p["value"], o).squeeze(-1)
        weight = torch.where(diff > 0, c.expectile, 1 - c.expectile)
        loss_v = torch.mean(weight * diff ** 2)
        self._adam("value", loss_v)
        with torch.no_grad():
            target = r + c.discount * (1 - d) * mlp_apply(p["value"], o2).squeeze(-1)
        self._twin_q_steps(o, a, target)
        with torch.no_grad():
            adv = tq - mlp_apply(p["value"], o).squeeze(-1)
            weights = torch.clamp(torch.exp(adv * c.temperature), max=100.0)
        stats = mlp_apply(p["actor"], o)
        A = self.act_dim
        mu, log_std = stats[:, :A], torch.clamp(stats[:, A:], -5, 2)
        logp = torch.sum(-0.5 * ((a - torch.tanh(mu)) / torch.exp(log_std)) ** 2 - log_std
                         - 0.5 * np.log(2 * np.pi), dim=-1)
        self._adam("actor", -torch.mean(weights * logp))
        self._polyak()
        return self.mesh.mean(loss_v.detach())

    def train_step(self):
        """One step of cfg.algo; returns its q_loss (a 0-d tensor)."""
        step = {"td3_bc": self._td3bc_step, "bcq": self._bcq_step, "iql": self._iql_step}
        q_loss = step[self.cfg.algo]()
        self.state.step += 1
        return q_loss

    # ---------------------------------------------------------------- driving
    def run(self, iterations: int | None = None):
        c = self.cfg
        n = iterations or c.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        t0 = time.perf_counter()
        for it in range(self.state.step, n):
            q_loss = self.train_step()
            if it % c.log_interval == 0:
                self.last_metrics = {"q_loss": float(q_loss)}
                if writer:
                    writer.add_scalar("train/q_loss", self.last_metrics["q_loss"], it)
                if self.print_log:
                    print(f"[{c.algo}] step {it}: q_loss {self.last_metrics['q_loss']:.4f} "
                          f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if self.log_dir and c.save_interval and (it + 1) % c.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    @torch.no_grad()
    def act(self, obs, generator=None):
        """The acting rule of eval_online on clipped obs; BCQ draws its
        candidates' z through `_normal`."""
        p = self.state.params
        if self.obs_mean is not None:
            obs = (obs - self.obs_mean) / self.obs_std
        if self.cfg.algo == "td3_bc":
            return torch.tanh(mlp_apply(p["actor"], obs))
        if self.cfg.algo == "iql":
            return torch.tanh(mlp_apply(p["actor"], obs)[:, :self.act_dim])
        reps = 10
        orep = torch.repeat_interleave(obs, reps, dim=0)
        cand = self._decode(p["vae_dec"], orep, self._normal((orep.shape[0], self.latent_dim),
                                                             generator))
        a = torch.clamp(cand + self.cfg.phi * torch.tanh(mlp_apply(p["pert"], orep, cand)), -1, 1)
        q = self._q(p["q1"], orep, a).reshape(-1, reps)
        a = a.reshape(-1, reps, self.act_dim)
        return a[torch.arange(obs.shape[0], device=obs.device), q.argmax(dim=1)]

    @torch.no_grad()
    def eval_online(self, env, num_envs: int = 64, n_steps: int = 1000) -> float:
        """The learned policy's mean reward per step in `env`: num_envs envs
        reset from a generator seeded with seed + 1 (which also draws BCQ's
        z), stepped n_steps times with act(obs clipped at +-5)."""
        if self.state is None:
            self.init_state()
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + 1)
        g = self.mesh.shard_generator(g, num_envs)
        total = torch.zeros((), device=self.device)
        with env_generator(env, g):
            st = env.reset(self.mesh.local(num_envs))
            for _ in range(n_steps):
                st = env.step_batch(st, self.act(torch.clamp(st.obs, -5.0, 5.0), g))
                total = total + st.reward.mean()
        return float(self.mesh.mean(total)) / n_steps

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str):
        """Parameters and step (the JAX trainer's file; no targets or
        optimizer state, as there)."""
        tree = bridge.offline_state_to_flax(self.state.params, self.state.step)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def load(self, path: str):
        """Restore parameters and step from a file of either package; the
        targets and optimizer states stay as they are, as in the JAX
        trainer."""
        if self.state is None:
            self.init_state()
        st = self.state
        params, step = bridge.offline_state_from_flax(checkpoint.load_tree(path), st.params)
        with torch.no_grad():
            tree_map(lambda a, b: a.copy_(b), st.params, checkpoint.restore_into(st.params, params))
        st.step = step
