"""Off-policy SARL: DDPG, TD3 and SAC (twin of
massive_marl_tpu/algos/rl/offpolicy.py).

  * a replay ring [R, E, ...] on the device holds whole env rows per time
    slot: obs, actions and next_obs in bf16, rewards and dones in float32;
    its write pointer and fill count are host ints.  A gradient step draws
    batch_size slots uniformly from [0, max(count, 1)) and uses all E rows
    of each;
  * each env step (policy with exploration noise, env step, ring write) is
    followed by noptepochs x nminibatches gradient steps, once the ring
    holds warmup_slots slots (default batch_size); before that an iteration
    only collects;
  * a gradient step, in the reference's order: the Q step (one
    global-norm clip over q1 and q2 together, then Adam); the pi step
    against the updated Q (for TD3 only when the update count, before its
    increment, is a multiple of policy_delay); SAC's temperature dual step
    lr * (mean logp + target entropy), clipped to +-0.01, log_alpha kept in
    [-10, 2] (`ent_coef: auto`); then Polyak averaging of every network the
    target holds (SAC's target pi included; the temperature excluded);
  * DDPG: a tanh deterministic actor and act_noise exploration; TD3: twin Q,
    clipped target-policy noise and delayed pi steps; SAC: a squashed
    Gaussian actor (log_std clipped to [-20, 2]) with the tanh-corrected
    log-prob, twin Q, a fixed or learned temperature.
The networks are float32 ReLU MLPs (flax Dense defaults: lecun_normal
kernels, zero biases), held as parameter trees in flax's own layout
({"pi": {"params": {"Dense_i": {"kernel": [in, out], "bias"}}}, "q1",
["q2"], ["alpha": {"log_alpha"}]}), so a checkpoint is the JAX trainer's
own file.  Random draws go through `_normal` and `_slots`, in the
reference's order.

Under a `mesh` (parallel/mesh.py) each rank steps its E / R envs and its
ring holds their E / R columns (JAX's axis-1 sharding of [R, E, ...]).  The
sampled slots are drawn alike on every rank and each slot carries every
env, so the ranks hold equal shares of a batch: the Q and pi gradients,
the Q loss and SAC's mean log-prob are averaged over them.  The noise of a
batch is drawn over the global rows (parallel/mesh.draw_rows).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos.rl.ppo import AdamState, adam_update
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw_rows
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer, fetch_metrics
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
# flax's truncated_normal initializer: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


# ---------------------------------------------------------------------------
# networks (parameter trees in flax's layout)
# ---------------------------------------------------------------------------

def init_dense(fan_in: int, fan_out: int, generator: torch.Generator) -> dict:
    """flax Dense's default init: a lecun_normal kernel [in, out] (a normal
    of std sqrt(1 / fan_in) / 0.8796 cut at two of its stds) and a zero
    bias."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    kernel = torch.empty(fan_in, fan_out)
    torch.nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=generator)
    return {"kernel": kernel, "bias": torch.zeros(fan_out)}


def init_mlp(widths, generator: torch.Generator) -> dict:
    """{"params": {"Dense_i": ...}}: one Dense per pair of consecutive
    widths [in, hidden..., out]."""
    return {"params": {f"Dense_{i}": init_dense(a, b, generator)
                       for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}}


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def _trunk(p: dict, x: torch.Tensor, n_hidden: int) -> torch.Tensor:
    for i in range(n_hidden):
        x = F.relu(dense(p[f"Dense_{i}"], x))
    return x


def q_apply(p: dict, obs, act, n_hidden: int):
    """QFunction: concat [obs, act] -> ReLU MLP -> 1, squeezed."""
    x = _trunk(p["params"], torch.cat([obs, act], dim=-1), n_hidden)
    return dense(p["params"][f"Dense_{n_hidden}"], x).squeeze(-1)


def det_actor_apply(p: dict, obs, n_hidden: int):
    """DetActor: tanh of a ReLU MLP's head."""
    return torch.tanh(dense(p["params"][f"Dense_{n_hidden}"], _trunk(p["params"], obs, n_hidden)))


def sg_actor_apply(p: dict, obs, n_hidden: int):
    """SquashedGaussianActor: (mu, log_std clipped to [-20, 2])."""
    x = _trunk(p["params"], obs, n_hidden)
    mu = dense(p["params"][f"Dense_{n_hidden}"], x)
    log_std = torch.clamp(dense(p["params"][f"Dense_{n_hidden + 1}"], x), LOG_STD_MIN, LOG_STD_MAX)
    return mu, log_std


def squashed_sample(mu, log_std, noise):
    """(tanh(pre), log-prob of the squashed action) for pre = mu + std *
    noise, with the tanh correction of the spinning-up formulation."""
    std = torch.exp(log_std)
    pre = mu + std * noise
    logp = torch.sum(-0.5 * ((pre - mu) / std) ** 2 - log_std - 0.5 * math.log(2 * math.pi), -1)
    logp = logp - torch.sum(2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre)), -1)
    return torch.tanh(pre), logp


def _detached(tree):
    return tree_map(lambda t: t.detach(), tree)


# ---------------------------------------------------------------------------
# config / state
# ---------------------------------------------------------------------------

@dataclass
class OffPolicyConfig:
    algo: str = "sac"               # sac | td3 | ddpg
    nsteps: int = 8
    noptepochs: int = 1
    nminibatches: int = 4
    replay_size: int = 5000
    batch_size: int = 32            # time slots per gradient step
    gamma: float = 0.99
    polyak: float = 0.99            # targ <- polyak * targ + (1 - polyak) * new
    lr: float = 3e-4
    max_grad_norm: float = 1.0
    ent_coef: float = 0.2           # SAC alpha (its initial value when auto_alpha)
    auto_alpha: bool = False
    target_entropy: float | None = None  # default -act_dim
    reward_scale: float = 1.0
    act_noise: float = 0.1          # ddpg/td3 exploration noise
    target_noise: float = 0.2       # td3
    noise_clip: float = 0.5         # td3
    policy_delay: int = 2           # td3
    hidden_nodes: int = 1024
    hidden_layer: int = 3
    clip_obs: float = 5.0
    clip_actions: float = 1.0
    max_iterations: int = 6500
    save_interval: int = 1000
    warmup_slots: int | None = None  # defaults to batch_size

    @classmethod
    def from_cfg_train(cls, cfg_train: dict, algo: str) -> "OffPolicyConfig":
        """Build from a train YAML (cfg/{sac,td3,ddpg}/config.yaml) with the
        JAX package's key map; `ent_coef: auto` is SAC v2's learned
        temperature from 0.2."""
        learn = cfg_train.get("learn", {})
        kw = {"algo": algo}
        m = {"nsteps": "nsteps", "noptepochs": "noptepochs",
             "nminibatches": "nminibatches", "replay_size": "replay_size",
             "batch_size": "batch_size", "gamma": "gamma", "polyak": "polyak",
             "lr": "learning_rate", "max_grad_norm": "max_grad_norm",
             "ent_coef": "ent_coef", "reward_scale": "reward_scale",
             "act_noise": "act_noise", "target_noise": "target_noise",
             "noise_clip": "noise_clip", "policy_delay": "policy_delay",
             "hidden_nodes": "hidden_nodes", "hidden_layer": "hidden_layer",
             "max_iterations": "max_iterations", "save_interval": "save_interval",
             "auto_alpha": "auto_alpha", "target_entropy": "target_entropy"}
        for k, yk in m.items():
            if yk in learn:
                kw[k] = learn[yk]
        if kw.get("ent_coef") == "auto":
            kw["ent_coef"] = 0.2
            kw["auto_alpha"] = True
        kw["lr"] = float(kw.get("lr", 3e-4))
        return cls(**kw)


@dataclass
class Replay:
    obs: torch.Tensor        # [R, E, obs] bf16
    actions: torch.Tensor    # [R, E, act] bf16
    rewards: torch.Tensor    # [R, E]
    next_obs: torch.Tensor   # [R, E, obs] bf16
    dones: torch.Tensor      # [R, E]
    ptr: int = 0             # next write slot
    count: int = 0           # filled slots (<= R)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.obs, self.actions, self.rewards, self.next_obs, self.dones))


@dataclass
class OffPolicyState:
    params: dict             # {"pi", "q1", ["q2"], ["alpha"]}
    target_params: dict      # {"pi", "q1", ["q2"]}
    opt_pi: AdamState
    opt_q: AdamState
    replay: Replay
    env_state: Any
    iteration: int = 0
    update_count: int = 0


class OffPolicy:
    """SAC/TD3/DDPG trainer: OffPolicy(env, num_envs, cfg).run(n)."""

    def __init__(self, env, num_envs: int, cfg: OffPolicyConfig | None = None, seed: int = 0,
                 log_dir: str | None = None, device=None, print_log: bool = True, mesh=None):
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, trainer on {self.device}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env = env
        self.num_envs = num_envs
        self.cfg = cfg or OffPolicyConfig()
        if self.cfg.algo not in ("sac", "td3", "ddpg"):
            raise ValueError(f"unknown off-policy algorithm {self.cfg.algo!r}")
        self.seed = seed
        self.log_dir = log_dir
        self.print_log = print_log
        self.obs_dim = env.num_obs
        self.act_dim = env.num_actions * env.num_agents
        self.n_hidden = self.cfg.hidden_layer
        self.is_sac = self.cfg.algo == "sac"
        self.twin_q = self.cfg.algo in ("sac", "td3")
        self.mesh = mesh or LOCAL
        self.local_envs = self.mesh.shard_env(env, num_envs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, num_envs)
        self.state: OffPolicyState | None = None
        self.last_metrics: Dict[str, float] = {}
        # cumulative gradient steps and pi steps taken by this trainer
        self.grad_steps = 0
        self.pi_steps = 0

    # ------------------------------------------------------------------ setup
    def init_params(self) -> dict:
        g = torch.Generator()
        g.manual_seed(self.seed)
        hidden = [self.cfg.hidden_nodes] * self.n_hidden
        pi = init_mlp([self.obs_dim, *hidden, self.act_dim], g)
        if self.is_sac:
            pi["params"][f"Dense_{self.n_hidden + 1}"] = init_dense(hidden[-1], self.act_dim, g)
        params = {"pi": pi}
        for q in ("q1", "q2") if self.twin_q else ("q1",):
            params[q] = init_mlp([self.obs_dim + self.act_dim, *hidden, 1], g)
        return params

    def init_state(self) -> OffPolicyState:
        cfg, dev = self.cfg, self.device
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), self.init_params())
        target = _detached(tree_map(torch.clone, params))
        if self.is_sac and cfg.auto_alpha:
            params["alpha"] = {"log_alpha": torch.log(torch.tensor(float(cfg.ent_coef),
                                                                   device=dev))}
        zeros = lambda leaves: AdamState(mu=[torch.zeros_like(p) for p in leaves],
                                         nu=[torch.zeros_like(p) for p in leaves])
        E, R, bf = self.local_envs, cfg.replay_size, torch.bfloat16
        replay = Replay(
            obs=torch.zeros((R, E, self.obs_dim), dtype=bf, device=dev),
            actions=torch.zeros((R, E, self.act_dim), dtype=bf, device=dev),
            rewards=torch.zeros((R, E), device=dev),
            next_obs=torch.zeros((R, E, self.obs_dim), dtype=bf, device=dev),
            dones=torch.zeros((R, E), device=dev))
        self.state = OffPolicyState(
            params=params, target_params=target,
            opt_pi=zeros(tree_leaves(params["pi"])), opt_q=zeros(self._q_leaves(params)),
            replay=replay, env_state=self.env.reset(E))
        return self.state

    @staticmethod
    def _q_leaves(params):
        return tree_leaves({k: v for k, v in params.items() if k.startswith("q")})

    # ------------------------------------------------------------ random draws
    def _normal(self, shape):
        """N(0, 1) over `shape`, whose leading axis is one step's envs or a
        batch's slots x envs (over the global envs under a mesh)."""
        return draw_rows(torch.randn, shape, self.generator, device=self.device)

    def _slots(self, count: int):
        """batch_size time slots drawn uniformly from [0, max(count, 1))."""
        return torch.randint(0, max(count, 1), (self.cfg.batch_size,), generator=self.generator,
                             device=self.device)

    # -------------------------------------------------------------- internals
    def _pi(self, pi_params, obs):
        return (sg_actor_apply if self.is_sac else det_actor_apply)(pi_params, obs, self.n_hidden)

    def _policy_act(self, pi_params, obs, explore: bool):
        if self.is_sac:
            mu, log_std = self._pi(pi_params, obs)
            return squashed_sample(mu, log_std, self._normal(mu.shape))[0] if explore \
                else torch.tanh(mu)
        a = self._pi(pi_params, obs)
        if explore:
            a = a + self.cfg.act_noise * self._normal(a.shape)
        return torch.clamp(a, -1.0, 1.0)

    def _alpha(self, params):
        """The entropy temperature: learned (SAC v2) when auto_alpha, else
        fixed."""
        if self.is_sac and self.cfg.auto_alpha:
            return torch.exp(params["alpha"]["log_alpha"])
        return self.cfg.ent_coef

    def _q(self, q, obs, act):
        return q_apply(q, obs, act, self.n_hidden)

    def _q_loss(self, q_params, params, target_params, batch):
        """The Bellman loss of q1 (and q2) against the target's backup."""
        cfg = self.cfg
        o, a, r, o2, d = (batch["obs"], batch["actions"], batch["rewards"],
                          batch["next_obs"], batch["dones"])
        with torch.no_grad():
            if self.is_sac:
                mu2, log_std2 = self._pi(params["pi"], o2)
                a2, logp_a2 = squashed_sample(mu2, log_std2, self._normal(mu2.shape))
            else:
                a2 = self._pi(target_params["pi"], o2)
                logp_a2 = 0.0
                if cfg.algo == "td3":
                    eps = torch.clamp(cfg.target_noise * self._normal(a2.shape),
                                      -cfg.noise_clip, cfg.noise_clip)
                    a2 = torch.clamp(a2 + eps, -1.0, 1.0)
            q_t = self._q(target_params["q1"], o2, a2)
            if self.twin_q:
                q_t = torch.minimum(q_t, self._q(target_params["q2"], o2, a2))
            alpha = self._alpha(params) if self.is_sac else 0.0
            backup = r + cfg.gamma * (1 - d) * (q_t - alpha * logp_a2)
        loss = torch.mean((self._q(q_params["q1"], o, a) - backup) ** 2)
        if self.twin_q:
            loss = loss + torch.mean((self._q(q_params["q2"], o, a) - backup) ** 2)
        return loss

    def _pi_loss(self, pi_params, params, batch):
        """(loss, mean logp); Q's parameters enter detached, so the loss
        differentiates only through pi."""
        o = batch["obs"]
        q1 = _detached(params["q1"])
        if self.is_sac:
            mu, log_std = self._pi(pi_params, o)
            a, logp = squashed_sample(mu, log_std, self._normal(mu.shape))
            q = torch.minimum(self._q(q1, o, a), self._q(_detached(params["q2"]), o, a))
            alpha = self._alpha(params)
            alpha = alpha.detach() if isinstance(alpha, torch.Tensor) else alpha
            return torch.mean(alpha * logp - q), logp.mean().detach()
        return -torch.mean(self._q(q1, o, self._pi(pi_params, o))), None

    def _grad_update(self, st: OffPolicyState):
        """One gradient step on a batch sampled from the ring; returns the
        Q loss (a 0-d tensor)."""
        cfg, rp, mesh = self.cfg, st.replay, self.mesh
        B, E = cfg.batch_size, self.local_envs
        idx = self._slots(rp.count)
        batch = dict(obs=rp.obs[idx].reshape(B * E, -1).float(),
                     actions=rp.actions[idx].reshape(B * E, -1).float(),
                     rewards=rp.rewards[idx].reshape(B * E),
                     next_obs=rp.next_obs[idx].reshape(B * E, -1).float(),
                     dones=rp.dones[idx].reshape(B * E))
        params = st.params
        q_params = {k: v for k, v in params.items() if k.startswith("q")}
        q_leaves = tree_leaves(q_params)
        qloss = self._q_loss(q_params, params, st.target_params, batch)
        *qgrad, qloss = mesh.mean(list(torch.autograd.grad(qloss, q_leaves)) + [qloss.detach()])
        adam_update(q_leaves, qgrad, st.opt_q, cfg.lr, cfg.max_grad_norm)
        if cfg.algo != "td3" or st.update_count % cfg.policy_delay == 0:
            pi_leaves = tree_leaves(params["pi"])
            ploss, mean_logp = self._pi_loss(params["pi"], params, batch)
            pgrad = list(torch.autograd.grad(ploss, pi_leaves))
            if mean_logp is not None:
                *pgrad, mean_logp = mesh.mean(pgrad + [mean_logp])
            else:
                pgrad = mesh.mean(pgrad)
            adam_update(pi_leaves, pgrad, st.opt_pi, cfg.lr, cfg.max_grad_norm)
            self.pi_steps += 1
            if self.is_sac and cfg.auto_alpha:
                target_h = (cfg.target_entropy if cfg.target_entropy is not None
                            else -float(self.act_dim))
                la = params["alpha"]["log_alpha"]
                delta = torch.clamp(cfg.lr * (mean_logp + target_h), -0.01, 0.01)
                la.copy_(torch.clamp(la + delta, -10.0, 2.0))
        with torch.no_grad():
            for k, tgt in st.target_params.items():
                t_leaves = tree_leaves(tgt)
                torch._foreach_mul_(t_leaves, cfg.polyak)
                torch._foreach_add_(t_leaves, torch._foreach_mul(tree_leaves(params[k]),
                                                                 1 - cfg.polyak))
        st.update_count += 1
        self.grad_steps += 1
        return qloss.detach()

    def _env_step(self, st: OffPolicyState, n_updates: int):
        """Policy with exploration, env step, ring write, then n_updates
        gradient steps; returns (mean scaled reward, last Q loss)."""
        cfg, rp = self.cfg, st.replay
        with torch.no_grad():
            obs = torch.clamp(st.env_state.obs, -cfg.clip_obs, cfg.clip_obs)
            actions = self._policy_act(st.params["pi"], obs, explore=True)
            nxt = self.env.step_batch(st.env_state,
                                      torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions))
            r = nxt.reward * cfg.reward_scale
            bf = torch.bfloat16
            rp.obs[rp.ptr] = obs.to(bf)
            rp.actions[rp.ptr] = actions.to(bf)
            rp.rewards[rp.ptr] = r
            rp.next_obs[rp.ptr] = torch.clamp(nxt.obs, -cfg.clip_obs, cfg.clip_obs).to(bf)
            rp.dones[rp.ptr] = nxt.done.to(torch.float32)
        rp.ptr = (rp.ptr + 1) % cfg.replay_size
        rp.count = min(rp.count + 1, cfg.replay_size)
        st.env_state = nxt
        qloss = torch.zeros((), device=self.device)
        for _ in range(n_updates):
            qloss = self._grad_update(st)
        return r.mean(), qloss

    def train_iter(self, update: bool = True):
        """nsteps env steps, each followed by noptepochs x nminibatches
        gradient steps (none when `update` is False: the collect-only
        iteration); returns the iteration's metrics (device tensors)."""
        cfg, st = self.cfg, self.state
        n_updates = cfg.noptepochs * cfg.nminibatches if update else 0
        rews, qlosses = zip(*(self._env_step(st, n_updates) for _ in range(cfg.nsteps)))
        st.iteration += 1
        return dict(mean_reward=self.mesh.mean(torch.stack(rews).mean()),
                    q_loss=torch.stack(qlosses).mean())

    # ---------------------------------------------------------------- driving
    def run(self, num_learning_iterations: int | None = None, log_interval: int = 1):
        cfg = self.cfg
        n_iter = num_learning_iterations or cfg.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        warmup = cfg.warmup_slots if cfg.warmup_slots is not None else cfg.batch_size
        steps_per_iter = cfg.nsteps * self.num_envs
        for it in range(self.state.iteration, n_iter):
            t0 = time.perf_counter()
            # warm-up: collect without updating until the ring holds a batch
            metrics = self.train_iter(update=self.state.replay.count >= warmup)
            if it % log_interval == 0:
                m = fetch_metrics(metrics)
                m["fps"] = steps_per_iter / (time.perf_counter() - t0)
                self.last_metrics = m
                if writer:
                    writer.add_scalar("train/mean_reward", m["mean_reward"], it)
                    writer.add_scalar("train/q_loss", m["q_loss"], it)
                    writer.add_scalar("perf/fps", m["fps"], it)
                if self.print_log:
                    print(f"[{cfg.algo}] it {it}: rew/step {m['mean_reward']:.3f} "
                          f"qloss {m['q_loss']:.3f} fps {m['fps']:.0f}", flush=True)
            if self.log_dir and cfg.save_interval and (it + 1) % cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str):
        """Parameters, targets and iteration (the JAX trainer's file)."""
        st = self.state
        tree = bridge.offpolicy_state_to_flax(st.params, st.target_params, st.iteration)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def load(self, path: str):
        """Restore parameters, targets and iteration from a file of either
        package; as in the JAX trainer, the optimizer moments, the ring and
        the update count stay as they are."""
        if self.state is None:
            self.init_state()
        st = self.state
        params, target, iteration = bridge.offpolicy_state_from_flax(
            checkpoint.load_tree(path), st.params, st.target_params)
        with torch.no_grad():
            for mine, theirs in ((st.params, params), (st.target_params, target)):
                tree_map(lambda a, b: a.copy_(b), mine, checkpoint.restore_into(mine, theirs))
        st.iteration = iteration

    test = load

    @torch.no_grad()
    def act_inference(self, obs):
        """The deterministic action on obs clipped to +-clip_obs: tanh(mu)
        for SAC, the clipped actor output for DDPG/TD3."""
        obs = torch.clamp(obs, -self.cfg.clip_obs, self.cfg.clip_obs)
        return self._policy_act(self.state.params["pi"], obs, explore=False)
