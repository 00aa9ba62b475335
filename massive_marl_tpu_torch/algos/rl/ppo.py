"""PPO (twin of massive_marl_tpu/algos/rl/ppo.py).

One iteration = an nsteps rollout of policy forward + batched env step,
then GAE and noptepochs x nminibatches clipped-surrogate updates with the
adaptive-KL step size.  Semantics kept from the reference:
  * clipped surrogate + clipped value loss;
  * adaptive KL lr x1.5 / /1.5 inside [1e-5, 1e-2], computed from the
    pre-step forward's (mean, log_std) and applied on the same step, and
    raised only when kl > 0;
  * GAE with (1 - done) masking and advantage normalisation with the
    population std;
  * sequential minibatches in the same order every epoch, no shuffle; the
    KL's old log_std is the value at the start of the update;
  * obs clipped to +-5 before the policy, actions to +-1 before the env;
  * the optimizer: global-norm clipping to 1.0, then Adam (b1 0.9, b2 0.999,
    eps 1e-8) scaled by the adaptive lr.
The trajectory dict has the reference's layout ([T, E, ...] for obs,
actions, logp, value, mean, reward, done).  With a `log_dir`, `run` logs the
reference's tags (utils/logging.Writer) and saves `model_<it>.ckpt` every
`save_interval` iterations; a checkpoint is the JAX trainer's own file
(utils/bridge.ppo_state_to_flax), so either package restores the other's.

Under a `mesh` (parallel/mesh.py) each rank steps its E / R envs and the
iteration is the single-process one: GAE is local, the advantages are
normalised by the global mean and population std, and each rank holds its
share of every T-major minibatch; its losses are its rows' sums over the
global minibatch size, and one all-reduce per minibatch sums the gradients,
the KL and the losses before the global-norm clip.  The logged means are
global.

On CUDA the update runs as one CUDA graph (update_graph.py, held as
`PPO.update_graph`): eagerly once, captured on the next update and replayed
on every later one; the CPU, a mesh and a `_loss` or `_step` overridden on
the instance keep it eager (`PPOUpdateGraph.refusal`).  So does the
rollout (rollout_graph.py, `PPO.rollout_graph`), on an env whose step
makes no read from the device on the host; the CPU, a mesh, domain
randomization and a `step_batch` overridden on the env instance keep it
eager (`PPORolloutGraph.refusal`).

The rollout, its policy steps, the update and each minibatch step's
forward, backward and optimizer are spans of utils/profiling (recorded
only while its recorder is on); a replay of the update's graph is the span
`update.graph`, one of the rollout's `rollout.graph`.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos import nets
from massive_marl_tpu_torch.algos.rl.rollout_graph import PPORolloutGraph
from massive_marl_tpu_torch.algos.rl.update_graph import PPOUpdateGraph
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer, fetch_metrics
from massive_marl_tpu_torch.utils.profiling import span, spanned


@dataclass
class PPOConfig:
    nsteps: int = 8
    noptepochs: int = 5
    nminibatches: int = 4
    gamma: float = 0.96
    lam: float = 0.95
    cliprange: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 1.0
    max_grad_norm: float = 1.0
    lr: float = 3e-4
    desired_kl: float = 0.016
    schedule: str = "adaptive"
    init_noise_std: float = 0.8
    hidden: tuple = (1024, 1024, 512)
    activation: str = "elu"
    clip_obs: float = 5.0
    clip_actions: float = 1.0
    max_iterations: int = 6500
    save_interval: int = 1000
    use_clipped_value_loss: bool = True

    @classmethod
    def from_cfg_train(cls, cfg_train: dict) -> "PPOConfig":
        """Build from a train YAML (cfg/ppo/config.yaml)."""
        learn = cfg_train.get("learn", {})
        pol = cfg_train.get("policy", {})
        kw = {}
        m = {
            "nsteps": "nsteps", "noptepochs": "noptepochs", "nminibatches": "nminibatches",
            "gamma": "gamma", "lam": "lam", "cliprange": "cliprange",
            "ent_coef": "ent_coef", "max_grad_norm": "max_grad_norm",
            "lr": "optim_stepsize", "desired_kl": "desired_kl",
            "schedule": "schedule", "init_noise_std": "init_noise_std",
            "max_iterations": "max_iterations", "save_interval": "save_interval",
        }
        for k, yk in m.items():
            if yk in learn:
                kw[k] = learn[yk]
        if "pi_hid_sizes" in pol:
            kw["hidden"] = tuple(pol["pi_hid_sizes"])
        if "activation" in pol:
            kw["activation"] = pol["activation"]
        if "clip_observations" in cfg_train:
            kw["clip_obs"] = cfg_train["clip_observations"]
        if "clip_actions" in cfg_train:
            kw["clip_actions"] = cfg_train["clip_actions"]
        kw["lr"] = float(kw.get("lr", 3e-4))
        return cls(**kw)


@dataclass
class AdamState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


def adam_scalars(count: int) -> tuple:
    """The reciprocals (1 / bc1, 1 / bc2) of Adam's bias corrections of the
    step after `count` steps, as Python floats (float64): the values of
    `adam_update`'s `scalars`."""
    c = count + 1
    return 1.0 / (1.0 - 0.9 ** c), 1.0 / (1.0 - 0.999 ** c)


def adam_update(params, grads, opt: AdamState, lr, max_grad_norm: float | None = None,
                eps: float = 1e-8, scalars=None):
    """optax's chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=eps))
    applied in place: the gradients scaled onto the norm ball when their
    global norm exceeds max_grad_norm (None: no clipping), then Adam (b1
    0.9, b2 0.999) with bias correction, params -= lr * update.  `lr` is a
    float or a 0-d tensor.  scalars: on CUDA, in place of the bias
    corrections as Python floats, adam_scalars(opt.count) as float32 device
    tensors (a CUDA graph's replays read them from a buffer the host fills,
    update_graph.py), multiplied in.  torch's CUDA `_foreach_div` by a
    Python float is itself the product with its float32 reciprocal, so both
    forms give the same bits there."""
    if max_grad_norm is not None:
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(g_norm < max_grad_norm, torch.ones_like(g_norm),
                            max_grad_norm / g_norm)
        grads = torch._foreach_mul(grads, scale)
    b1, b2 = 0.9, 0.999
    opt.count += 1
    torch._foreach_lerp_(opt.mu, grads, 1 - b1)
    torch._foreach_mul_(opt.nu, b2)
    torch._foreach_addcmul_(opt.nu, grads, grads, 1 - b2)
    if scalars is None:
        scaled, (s1, s2) = torch._foreach_div, (1 - b1 ** opt.count, 1 - b2 ** opt.count)
    else:
        scaled, (s1, s2) = torch._foreach_mul, scalars
    denom = scaled(opt.nu, s2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = scaled(opt.mu, s1)
    torch._foreach_div_(upd, denom)
    torch._foreach_mul_(upd, lr)
    with torch.no_grad():
        torch._foreach_sub_(params, upd)


def grads_or_zeros(loss, params: List[torch.Tensor], **kw):
    """d loss / d params, zeros for the parameters the loss does not reach
    (jax.grad's convention)."""
    gs = torch.autograd.grad(loss, params, allow_unused=True, **kw)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]


def gae(traj, last_value, gamma: float, lam: float) -> torch.Tensor:
    """GAE advantages [T, E] of a trajectory (reward, done, value), not
    normalised: delta = r + gamma v' (1 - d) - v, adv = delta + gamma lam
    (1 - d) adv'."""
    next_values = torch.cat([traj["value"][1:], last_value[None]], dim=0)
    adv = torch.zeros_like(last_value)
    advs = []
    for t in reversed(range(traj["reward"].shape[0])):
        d = traj["done"][t]
        delta = traj["reward"][t] + gamma * next_values[t] * (1 - d) - traj["value"][t]
        adv = delta + gamma * lam * (1 - d) * adv
        advs.append(adv)
    return torch.stack(advs[::-1])


def normalized(adv: torch.Tensor, mesh=LOCAL) -> torch.Tensor:
    """The advantages centred and divided by their population std plus 1e-8
    (over every rank's rows under a mesh)."""
    mean, std = mesh.mean_std(adv)
    return (adv - mean) / (std + 1e-8)


@dataclass
class PPOTrainState:
    opt: AdamState
    lr: torch.Tensor        # adaptive-KL controlled step size (0-d, on device)
    env_state: Any          # batched EnvState
    iteration: int = 0


class PPO:
    """PPO(env, num_envs, cfg).run(max_iterations)."""

    def __init__(self, env, num_envs: int, cfg: PPOConfig | None = None,
                 seed: int = 0, log_dir: str | None = None, device=None,
                 print_log: bool = True, mesh=None):
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, trainer on {self.device}")
        # full-float32 heads and value math on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env = env
        self.num_envs = num_envs
        self.cfg = cfg or PPOConfig()
        self.log_dir = log_dir
        self.print_log = print_log
        self.act_dim = env.num_actions * env.num_agents
        self.obs_dim = env.num_obs
        self.mesh = mesh or LOCAL
        self.local_envs = self.mesh.shard_env(env, num_envs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, num_envs)
        init_gen = torch.Generator()
        init_gen.manual_seed(seed)
        self.model = nets.ActorCritic(
            self.obs_dim, self.act_dim, self.cfg.hidden, self.cfg.hidden,
            self.cfg.activation, self.cfg.init_noise_std, generator=init_gen).to(self.device)
        self.state: PPOTrainState | None = None
        self.last_metrics: Dict[str, float] = {}
        self.update_graph = PPOUpdateGraph()
        self.rollout_graph = PPORolloutGraph()

    # ------------------------------------------------------------------ setup
    def init_state(self) -> PPOTrainState:
        params = list(self.model.parameters())
        opt = AdamState(mu=[torch.zeros_like(p) for p in params],
                        nu=[torch.zeros_like(p) for p in params])
        self.state = PPOTrainState(
            opt=opt, lr=torch.tensor(self.cfg.lr, device=self.device),
            env_state=self.env.reset(self.local_envs))
        return self.state

    # ---------------------------------------------------------------- rollout
    @spanned("trainer.rollout")
    @torch.no_grad()
    def rollout_phase(self) -> Dict[str, torch.Tensor]:
        """nsteps of policy + env; advances state.env_state and returns the
        trajectory dict.  On CUDA a replay of the rollout's graph
        (rollout_graph.py) wherever it takes the rollout."""
        if self.rollout_graph.refusal(self) is None:
            return self.rollout_graph(self)
        self.rollout_graph.eager_rollouts += 1
        traj, self.state.env_state = self._rollout(self.state.env_state)
        return traj

    def _rollout(self, env_state):
        """The rollout's body: nsteps of policy + env from env_state; returns
        (the trajectory dict, the final env state)."""
        cfg = self.cfg
        steps = []
        for _ in range(cfg.nsteps):
            with span("trainer.policy"):
                obs = torch.clamp(env_state.obs, -cfg.clip_obs, cfg.clip_obs)
                mean, value, log_std = self.model(obs)
                actions = nets.gaussian_sample(mean, log_std, noise=draw(
                    torch.randn, mean.shape, self.generator, device=mean.device,
                    dtype=mean.dtype))
                logp = nets.gaussian_log_prob(mean, log_std, actions)
                clipped = torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions)
            env_state = self.env.step_batch(env_state, clipped)
            steps.append(dict(obs=obs, actions=actions, logp=logp, value=value, mean=mean,
                              reward=env_state.reward,
                              done=env_state.done.to(torch.float32)))
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}, env_state

    # ----------------------------------------------------------------- update
    def gae(self, traj, last_value):
        """(advantages normalised by their population std, returns)."""
        adv = gae(traj, last_value, self.cfg.gamma, self.cfg.lam)
        return normalized(adv, self.mesh), adv + traj["value"]

    def _loss(self, batch, old_log_std, n=None):
        """(loss, surrogate, value loss, kl) of a minibatch: batch means, or
        with `n` (under a mesh) sums over the rank's rows divided by the
        global minibatch size n."""
        cfg = self.cfg
        if n is not None:
            bmean = lambda x: x.sum() / n
        else:
            bmean = torch.mean
        mean, value, log_std = self.model(batch["obs"])
        logp = nets.gaussian_log_prob(mean, log_std, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        surrogate_loss = bmean(torch.maximum(
            -adv * ratio, -adv * torch.clamp(ratio, 1 - cfg.cliprange, 1 + cfg.cliprange)))
        if cfg.use_clipped_value_loss:
            v_clip = batch["value"] + torch.clamp(value - batch["value"],
                                                  -cfg.cliprange, cfg.cliprange)
            value_loss = bmean(torch.maximum((value - batch["returns"]) ** 2,
                                             (v_clip - batch["returns"]) ** 2))
        else:
            value_loss = bmean((batch["returns"] - value) ** 2)
        if n is None:
            entropy = nets.gaussian_entropy(log_std, batch["obs"].shape[:1]).mean()
        else:   # the rank's share of a batch-independent entropy
            entropy = nets.gaussian_entropy(log_std) * (batch["obs"].shape[0] / n)
        loss = surrogate_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
        kl = None
        if cfg.schedule == "adaptive":
            with torch.no_grad():
                kl = bmean(nets.gaussian_kl(batch["mean"], old_log_std.expand_as(mean),
                                            mean, log_std.expand_as(mean)))
        return loss, surrogate_loss.detach(), value_loss.detach(), kl

    def _step(self, grads, lr):
        """Global-norm clip, Adam moments, p -= lr * update (in place); while
        the update's graph is captured, Adam's bias corrections come from
        the buffer its replays read."""
        opt = self.state.opt
        adam_update(list(self.model.parameters()), grads, opt, lr, self.cfg.max_grad_norm,
                    scalars=self.update_graph.step_scalars(opt.count))

    @spanned("trainer.update")
    def update_phase(self, traj: Dict[str, torch.Tensor], last_obs: torch.Tensor):
        """GAE and the epochs of minibatch updates on one trajectory; returns
        the iteration's metrics (device tensors).  On CUDA a replay of the
        update's graph (update_graph.py) wherever it takes the update."""
        if self.update_graph.refusal(self) is None:
            metrics = self.update_graph(self, traj, last_obs)
        else:
            self.update_graph.eager_updates += 1
            metrics = self._update(traj, last_obs)
        self.state.iteration += 1
        return metrics

    def _update(self, traj: Dict[str, torch.Tensor], last_obs: torch.Tensor):
        """The update's body: changes the parameters, Adam's moments and
        state.lr in place and returns the metrics; Adam's count advances on
        the host."""
        cfg, mesh = self.cfg, self.mesh
        T, E = traj["reward"].shape
        n_mb = cfg.nminibatches
        mb = (T * self.num_envs) // n_mb
        with torch.no_grad():
            _, last_value, _ = self.model(torch.clamp(last_obs, -cfg.clip_obs, cfg.clip_obs))
            adv, returns = self.gae(traj, last_value)
        old_log_std = self.model.log_std.detach().clone()
        flat = dict(obs=traj["obs"].reshape(T * E, -1), actions=traj["actions"].reshape(T * E, -1),
                    logp=traj["logp"].reshape(T * E), value=traj["value"].reshape(T * E),
                    mean=traj["mean"].reshape(T * E, -1), adv=adv.reshape(T * E),
                    returns=returns.reshape(T * E))
        params = list(self.model.parameters())
        lr = self.state.lr
        surr, vals = [], []
        for _ in range(cfg.noptepochs):
            for m in range(n_mb):
                lo, hi = mesh.span(m * mb, (m + 1) * mb, self.num_envs)
                batch = {k: v[lo:hi] for k, v in flat.items()}
                if mesh is LOCAL:
                    with span("update.forward"):
                        loss, s_loss, v_loss, kl = self._loss(batch, old_log_std)
                    with span("update.backward"):
                        grads = list(torch.autograd.grad(loss, params))
                else:
                    # one collective: the f32 partial sums of the gradients
                    # (rounded to bf16 after it where a layer is bf16), the
                    # losses and the kl
                    with nets.f32_weight_grads():
                        with span("update.forward"):
                            loss, s_loss, v_loss, kl = self._loss(batch, old_log_std, mb)
                        with span("update.backward"):
                            grads = list(torch.autograd.grad(loss, params))
                            n = len(grads)
                            red = mesh.sum(grads + [s_loss, v_loss]
                                           + ([kl] if kl is not None else []))
                            grads = nets.round_bf16(red[:n], nets.MLP.bf16_mask(self.model))
                    s_loss, v_loss, *rest = red[n:]
                    kl = rest[0] if rest else None
                with span("update.optimizer"):
                    if kl is not None:
                        lr = torch.where(kl > cfg.desired_kl * 2.0,
                                         torch.clamp(lr / 1.5, min=1e-5), lr)
                        lr = torch.where((kl < cfg.desired_kl / 2.0) & (kl > 0.0),
                                         torch.clamp(lr * 1.5, max=1e-2), lr)
                    self._step(grads, lr)
                surr.append(s_loss)
                vals.append(v_loss)
        self.state.lr.copy_(lr)
        reward, done = mesh.mean([traj["reward"].mean(), traj["done"].mean()])
        return dict(mean_reward=reward,
                    mean_value_loss=torch.stack(vals).mean(),
                    mean_surrogate_loss=torch.stack(surr).mean(),
                    mean_noise_std=nets.dist_std(self.model.log_std.detach()).mean(),
                    lr=lr, done_frac=done)

    def train_iter(self):
        traj = self.rollout_phase()
        return self.update_phase(traj, self.state.env_state.obs)

    # ---------------------------------------------------------------- driving
    def run(self, num_learning_iterations: int | None = None, log_interval: int = 1):
        n_iter = num_learning_iterations or self.cfg.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        steps_per_iter = self.cfg.nsteps * self.num_envs
        for it in range(self.state.iteration, n_iter):
            t0 = time.perf_counter()
            metrics = self.train_iter()
            if it % log_interval == 0:
                m = fetch_metrics(metrics)
                m["fps"] = steps_per_iter / (time.perf_counter() - t0)
                self.last_metrics = m
                if writer:
                    writer.add_scalar("Train2/mean_reward/step", m["mean_reward"], it)
                    writer.add_scalar("Loss/value_function", m["mean_value_loss"], it)
                    writer.add_scalar("Loss/surrogate", m["mean_surrogate_loss"], it)
                    writer.add_scalar("Policy/mean_noise_std", m["mean_noise_std"], it)
                    writer.add_scalar("Perf/fps", m["fps"], it)
                if self.print_log:
                    print(f"it {it}: rew/step {m['mean_reward']:.3f} vloss {m['mean_value_loss']:.3f} "
                          f"std {m['mean_noise_std']:.2f} lr {m['lr']:.2e} fps {m['fps']:.0f}",
                          flush=True)
            if self.log_dir and self.cfg.save_interval and (it + 1) % self.cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str):
        """The full train state: parameters, Adam moments and count, lr and
        iteration (the JAX package's file, flax msgpack)."""
        st = self.state
        names = [n for n, _ in self.model.named_parameters()]
        tree = bridge.ppo_state_to_flax(names, list(self.model.parameters()), st.opt.mu,
                                        st.opt.nu, st.opt.count, st.lr, st.iteration)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def load(self, path: str):
        """Restore parameters, Adam moments, lr and iteration from a file of
        either package; the env state is a fresh reset, as in the JAX
        trainer."""
        if self.state is None:
            self.init_state()
        params, mu, nu, count, lr, iteration = bridge.ppo_state_from_flax(
            checkpoint.load_tree(path))
        names = [n for n, _ in self.model.named_parameters()]
        restored = [checkpoint.restore_into(dict(self.model.named_parameters()), d)
                    for d in (params, mu, nu)]
        with torch.no_grad():
            for p, name in zip(self.model.parameters(), names):
                p.copy_(restored[0][name])
        self.state.opt = AdamState(mu=[restored[1][n] for n in names],
                                   nu=[restored[2][n] for n in names], count=count)
        self.state.lr = lr.to(self.device)
        self.state.iteration = iteration

    def test(self, path: str):
        self.load(path)

    # -------------------------------------------------------------- inference
    @torch.no_grad()
    def act_inference(self, obs):
        """The policy's mean action on obs clipped to +-clip_obs."""
        mean, _, _ = self.model(torch.clamp(obs, -self.cfg.clip_obs, self.cfg.clip_obs))
        return mean
