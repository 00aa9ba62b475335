"""On-policy MARL runner: MAPPO / IPPO / HAPPO / HATRPO (twin of
massive_marl_tpu/algos/marl/runner.py).

One iteration is an `episode_length` rollout of every agent's policy and
the batched env step, then per-agent GAE and the updates:
  * the agent axis is a stacked-parameter dimension: every parameter leaf,
    optimizer moment and value-normalizer statistic carries a leading N;
  * the update runs on the fused Dense->ELU->LayerNorm kernels B2/B3, or
    under FUSED_TOWER=1 on the whole-tower kernels B4/B5 (fused_nets.py),
    when `use_fused_mlp` is on ("auto": on for a CUDA
    device, off on the CPU; off also when hidden_size % 128, the
    reference's rule), else on the flax-mirror nets (nets.py).  The rollout
    always runs on the flax-mirror nets, as in the reference;
  * schedules: `update_schedule="sequential"` (the default) updates one
    agent after another, all epochs each: MAPPO/IPPO in agent order, HAPPO
    over a random permutation with the importance factor
    prod_j pi_new/pi_old of the agents updated before; HATRPO over the same
    permutation, with a trust-region actor step (`_trpo_actor_update`) and
    `ppo_epoch` critic-only epochs.  "stacked" updates
    all MAPPO/IPPO agents jointly with [N, B] kernels; the sum of per-agent
    losses gives each agent its own gradient (parameters are disjoint), and
    the optimizer clips each agent's global norm on its own.  Without the
    fused path MAPPO/IPPO always take the stacked update;
  * value targets: PopArt (stats updated twice per loss call), ValueNorm
    (once) or raw returns (nets.norm_targets), denormalized for GAE;
  * minibatches: `num_mini_batch` contiguous chunks of a fresh permutation
    per epoch (one permutation shared by the agents of a stacked update),
    the remainder dropped;
  * the optimizer is optax.chain(clip_by_global_norm, [add_decayed_weights],
    adam) applied per agent ("adam" and "fused_adam" are the same math
    here), optionally with the first moment stored in bf16.

The trajectory dict keeps the reference's [T, E, N, ...] layout (obs
[T,E,N,obs], share [T,E,share], actions, logp, values, reward, done, bad).
The program's spans (utils/profiling; off unless the recorder is on):
`trainer.rollout` and `trainer.update` around the two phases,
`trainer.policy` around each rollout step's actor, critic, sample and
log-prob, `update.agent` around each agent's epochs of the sequential
schedule, and `update.forward` / `update.backward` / `update.optimizer`
around each actor and critic step's loss, gradient and Adam step.

On a CUDA device the sequential fused MAPPO/IPPO update with one
minibatch an epoch, no mesh and the runner's agent order runs as one CUDA
graph (update_graph.py, `MarlRunner.update_graph`): eager the first time,
captured the second, replayed in the span `update.graph` from then on; the
spans inside the update fire only where it runs eagerly or is captured.

Random numbers come from the runner's torch.Generator, so a run does not
replay the reference's threefry stream; the tests feed both packages the
same trajectory and, for HAPPO and HATRPO, the same agent permutation.

With a `log_dir`, `run` logs train/*, perf/fps and the episode returns
(utils/logging.Writer) and saves `marl_<it>.ckpt` every `save_interval`
iterations; a checkpoint is the JAX runner's own file
(utils/bridge.marl_state_to_flax), in the structure of cfg.optimizer, so
either package restores the other's.  `eval` runs deterministic episodes
in dedicated envs (every `eval_interval` iterations under `use_eval`).

Under a `mesh` (parallel/mesh.py) each rank steps its E / R envs, GAE is
local and the advantages are normalised by each agent's global mean and
population std.  The updates follow the JAX package's two families:
  * the fused path is shard-local, as JAX's shard_map is: each rank forms
    its minibatches from one permutation of its own rows (the same draw on
    every rank), and the gradients, losses, value-norm statistics and
    HATRPO's Fisher products and line-search values are averaged over the
    ranks (pmean);
  * the flax-mirror path is the single-process update (GSPMD): every rank
    draws the permutation of the global rows and keeps its own, and its
    losses, gradients, value-norm moments and Fisher products are sums over
    its rows divided by the global batch size, summed over the ranks; the
    bf16 layers' weight-gradient and Fisher-product sums are float32 (their
    backward is double-differentiable, nets._DenseBf16), rounded to bf16
    once after the sum.
Conjugate gradient and the line search decide only on all-reduced values,
which are the same bits on every rank.  The logged means are global.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos.marl import fused_nets, nets
from massive_marl_tpu_torch.algos.marl.nets import _lead
from massive_marl_tpu_torch.algos.marl.update_graph import UpdateGraph
from massive_marl_tpu_torch.algos.nets import f32_weight_grads, round_bf16
from massive_marl_tpu_torch.envs.base import eval_generator, evaluate_episodes
from massive_marl_tpu_torch.ops.fused_mlp import feature_norm
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer, fetch_metrics
from massive_marl_tpu_torch.utils.profiling import span, spanned
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from massive_marl_tpu_torch.wrap.vec_task import split_multi_agent_obs


@dataclass
class MarlConfig:
    """cfg/happo/config.yaml defaults (= cfg/mappo/config.yaml)."""
    algorithm_name: str = "mappo"
    episode_length: int = 8
    num_env_steps: int = 50_000_000
    gamma: float = 0.96
    gae_lambda: float = 0.95
    clip_param: float = 0.2
    ppo_epoch: int = 5
    num_mini_batch: int = 1
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.0
    max_grad_norm: float = 10.0
    huber_delta: float = 10.0
    lr: float = 5e-4
    critic_lr: float = 5e-4
    opti_eps: float = 1e-5
    weight_decay: float = 0.0
    hidden_size: int = 512
    layer_n: int = 2
    gain: float = 0.01
    std_x_coef: float = 1.0
    std_y_coef: float = 0.5
    use_centralized_v: bool = True       # False for IPPO
    kl_threshold: float = 0.016          # HATRPO
    ls_step: int = 10
    accept_ratio: float = 0.5
    use_gae: bool = True
    use_popart: bool = True
    use_valuenorm: bool = False
    use_proper_time_limits: bool = False
    use_policy_active_masks: bool = False
    use_value_active_masks: bool = False
    use_linear_lr_decay: bool = False
    use_max_grad_norm: bool = True
    use_recurrent_policy: bool = False
    bf16_adam_mu: bool = False           # Adam first moment stored in bf16
    optimizer: str = "adam"              # "adam" | "fused_adam": the same math here
    use_huber_loss: bool = True
    use_clipped_value_loss: bool = True
    update_schedule: str = "sequential"  # "sequential" | "stacked" (see module doc)
    data_chunk_length: Any = None
    use_fused_mlp: Any = "auto"          # "auto": on for a CUDA device, off on the CPU
    clip_obs: float = 7.0
    clip_actions: float = 1.0
    save_interval: int = 200
    log_interval: int = 1
    use_eval: bool = False
    eval_interval: int = 25
    eval_episodes: int = 32

    # yaml key -> field (the reference's config dict surface)
    _KEYMAP = {
        "episode_length": "episode_length", "num_env_steps": "num_env_steps",
        "gamma": "gamma", "gae_lambda": "gae_lambda", "clip_param": "clip_param",
        "ppo_epoch": "ppo_epoch", "num_mini_batch": "num_mini_batch",
        "value_loss_coef": "value_loss_coef", "entropy_coef": "entropy_coef",
        "max_grad_norm": "max_grad_norm", "huber_delta": "huber_delta",
        "lr": "lr", "critic_lr": "critic_lr", "opti_eps": "opti_eps",
        "weight_decay": "weight_decay",
        "hidden_size": "hidden_size", "layer_n": "layer_N", "gain": "gain",
        "std_x_coef": "std_x_coef", "std_y_coef": "std_y_coef",
        "use_centralized_v": "use_centralized_V",
        "use_recurrent_policy": "use_recurrent_policy",
        "kl_threshold": "kl_threshold", "ls_step": "ls_step",
        "accept_ratio": "accept_ratio",
        "use_gae": "use_gae",
        "use_popart": "use_popart",
        "use_valuenorm": "use_valuenorm",
        "use_proper_time_limits": "use_proper_time_limits",
        "use_policy_active_masks": "use_policy_active_masks",
        "use_value_active_masks": "use_value_active_masks",
        "use_linear_lr_decay": "use_linear_lr_decay",
        "use_max_grad_norm": "use_max_grad_norm",
        "use_huber_loss": "use_huber_loss",
        "use_clipped_value_loss": "use_clipped_value_loss",
        "data_chunk_length": "data_chunk_length",
        "use_fused_mlp": "use_fused_mlp",
        "update_schedule": "update_schedule",
        "bf16_adam_mu": "bf16_adam_mu",
        "optimizer": "optimizer",
        "use_eval": "use_eval", "eval_interval": "eval_interval",
        "eval_episodes": "eval_episodes",
        "save_interval": "save_interval", "log_interval": "log_interval",
    }
    # keys the reference consumes but that are structural no-ops here
    _NOOP_KEYS = {
        "env_name", "algorithm_name", "experiment_name", "run_dir", "seed",
        "use_render", "n_rollout_threads", "n_eval_rollout_threads",
        "use_obs_instead_of_state", "use_feature_normalization", "use_orthogonal",
        "use_ReLU", "actor_gain",
    }
    # keys whose non-default values select reference code paths that do not
    # exist here
    _UNSUPPORTED_NONDEFAULT = {
        "use_naive_recurrent_policy": False,
        "use_single_network": False,
        "recurrent_N": 1,
        "stacked_frames": 1,
    }

    @classmethod
    def from_cfg_train(cls, cfg_train: dict, algo: str) -> "MarlConfig":
        kw = {"algorithm_name": algo}
        for field, yk in cls._KEYMAP.items():
            if yk in cfg_train and cfg_train[yk] is not None:
                kw[field] = cfg_train[yk]
        if algo == "ippo":
            kw["use_centralized_v"] = False
        for f in ("lr", "critic_lr", "opti_eps", "weight_decay"):
            if f in kw:
                kw[f] = float(kw[f])
        known = set(cls._KEYMAP.values()) | cls._NOOP_KEYS
        for yk, v in cfg_train.items():
            if yk in cls._UNSUPPORTED_NONDEFAULT:
                if v != cls._UNSUPPORTED_NONDEFAULT[yk] and v is not None:
                    raise ValueError(
                        f"cfg key {yk}={v!r} selects a reference code path that "
                        f"is not implemented here (supported value: "
                        f"{cls._UNSUPPORTED_NONDEFAULT[yk]!r})")
            elif yk not in known:
                warnings.warn(f"unknown MARL cfg key {yk!r} ignored", stacklevel=2)
        return cls(**kw)

    def norm_mode(self) -> str:
        """happo/hatrpo: PopArt or nothing (happo_trainer.py:44-47).
        mappo/ippo: popart > valuenorm > none, not both (mappo_trainer.py:53-61)."""
        if self.algorithm_name in ("happo", "hatrpo"):
            return "popart" if self.use_popart else "none"
        if self.use_popart and self.use_valuenorm:
            raise ValueError("use_popart and use_valuenorm can not be set True "
                             "simultaneously (mappo_trainer.py:53-54)")
        if self.use_popart:
            return "popart"
        return "valuenorm" if self.use_valuenorm else "none"


def _foreach_div_scalar(xs, s):
    """xs divided by a bias correction s in the form ClipAdam.scalars gives
    for their device, a Python float or a float32 tensor: on CUDA s is the
    reciprocal and this is the product with it, elsewhere the quotient.
    torch's CUDA `_foreach_div` by a Python float is itself that product,
    and its tensor overload divides, so on CUDA the product is written out:
    a float and a tensor of the same value then give the same bits."""
    if xs[0].is_cuda:
        return torch._foreach_mul(xs, s)
    return torch._foreach_div(xs, s)


@dataclass
class AdamState:
    mu: List[torch.Tensor]      # per leaf, agent-stacked
    nu: List[torch.Tensor]
    count: List[int]            # steps taken, per agent


class ClipAdam:
    """optax.chain(clip_by_global_norm(clip), [add_decayed_weights(wd)],
    adam(lr, eps)) + apply_updates, per agent: each agent's gradient is
    clipped by its own global norm.  Updates the parameters in place."""

    def __init__(self, lr, clip, eps, wd=0.0, mu_bf16=False, b1=0.9, b2=0.999):
        self.lr, self.clip, self.eps, self.wd = lr, clip, eps, wd
        self.mu_bf16, self.b1, self.b2 = mu_bf16, b1, b2

    def init(self, leaves, num_agents) -> AdamState:
        mu_dtype = torch.bfloat16 if self.mu_bf16 else None
        return AdamState(mu=[torch.zeros_like(p, dtype=mu_dtype) for p in leaves],
                         nu=[torch.zeros_like(p) for p in leaves], count=[0] * num_agents)

    def scalars(self, count: int, device):
        """(bc1, bc2, lr) of the step after `count` steps on `device`, as
        Python floats (float64): Adam's bias corrections and the learning
        rate.  On CUDA bc1 and bc2 are their reciprocals, which
        `_foreach_div_scalar` multiplies by there."""
        c = count + 1
        bc1, bc2 = 1.0 - self.b1 ** c, 1.0 - self.b2 ** c
        lr = self.lr(count) if callable(self.lr) else self.lr
        if torch.device(device).type == "cuda":
            return 1.0 / bc1, 1.0 / bc2, lr
        return bc1, bc2, lr

    def step(self, params, grads, mu, nu, count: int, scalars=None):
        """params/grads/mu/nu: lists of [n, ...] tensors (views into the
        agent-stacked state); count: the n agents' step count before it.
        scalars: in place of `scalars(count, device)`'s Python floats,
        float32 device tensors of the same values (a CUDA graph's replays
        read them from a buffer the host fills, update_graph.py); both
        forms give the same bits."""
        b1, b2, eps = self.b1, self.b2, self.eps
        bc1, bc2, lr = self.scalars(count, params[0].device) if scalars is None else scalars
        n = grads[0].shape[0]
        norms = torch._foreach_norm([g[i] for i in range(n) for g in grads])
        gnorm = torch.linalg.vector_norm(torch.stack(norms).reshape(n, -1), dim=1)
        # optax clip_by_global_norm: no epsilon; the untaken 0/0 branch is selected away
        scale = torch.where(gnorm < self.clip, 1.0,
                            self.clip / torch.where(gnorm == 0.0, 1.0, gnorm))
        gs = torch._foreach_mul(grads, [_lead(scale, g) for g in grads])
        if self.wd:
            torch._foreach_add_(gs, params, alpha=self.wd)
        m = [x.float() for x in mu] if self.mu_bf16 else mu
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, gs, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
        denom = _foreach_div_scalar(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = _foreach_div_scalar(m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, lr)
        with torch.no_grad():
            torch._foreach_sub_(params, upd)
        if self.mu_bf16:
            for dst, src in zip(mu, m):
                dst.copy_(src)


@dataclass
class MarlTrainState:
    actor_params: Dict[str, Any]    # agent-stacked trees
    critic_params: Dict[str, Any]
    actor_opt: AdamState
    critic_opt: AdamState
    vnorm: nets.ValueNorm           # [N] running stats
    env_state: Any
    iteration: int = 0
    # episode-return bookkeeping (reference runner.py:145-163)
    ep_ret: torch.Tensor | None = None       # [E] team-reward sum since the last reset
    last_ep_ret: torch.Tensor | None = None  # [E] return of the last completed episode
    ep_count: torch.Tensor | None = None     # [E] completed episodes


def episode_returns(st, traj, mesh=LOCAL) -> Dict[str, torch.Tensor]:
    """Advance st's per-env episode-return accumulators (ep_ret,
    last_ep_ret, ep_count; reference runner.py:145-163) over traj's [T, E]
    reward and done; the mean return of the envs' last completed episodes
    and the number of envs with one (over every rank's envs)."""
    ep, last, cnt = st.ep_ret, st.last_ep_ret, st.ep_count
    for r, d in zip(traj["reward"], traj["done"]):
        ep = ep + r
        fin = d > 0
        last = torch.where(fin, ep, last)
        cnt = cnt + fin.to(torch.int32)
        ep = torch.where(fin, 0.0, ep)
    st.ep_ret, st.last_ep_ret, st.ep_count = ep, last, cnt
    have = cnt > 0
    total, count = mesh.sum([torch.where(have, last, 0.0).sum(), have.sum()])
    return dict(episode_rewards=total / torch.clamp_min(count, 1), episodes_done=count)


def _flat(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def _mean_kl(mean, std, mean_o, std_o, n=None):
    """Mean over the batch of KL(N(mean_o, std_o) || N(mean, std)), summed
    over the action dims; with `n`, the sum over the batch divided by n."""
    kl = torch.sum(torch.log(std / std_o) + (std_o ** 2 + (mean_o - mean) ** 2)
                   / (2.0 * std ** 2) - 0.5, dim=-1)
    return torch.mean(kl) if n is None else kl.sum() / n


def _nested_mean(groups):
    """Mean over the outer list of the means of the inner lists (the
    reference's per-agent, per-epoch loss averages)."""
    return torch.stack([torch.stack(g).mean() for g in groups]).mean()


class MarlRunner:
    """MarlRunner(env, num_envs, cfg).run(num_env_steps)."""

    def __init__(self, env, num_envs: int, cfg: MarlConfig | None = None, seed: int = 0,
                 log_dir: str | None = None, print_log: bool = True, mesh=None, device=None):
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, runner on {self.device}")
        c = self.cfg = cfg or MarlConfig()
        if c.algorithm_name not in ("mappo", "ippo", "happo", "hatrpo"):
            raise ValueError(f"unknown MARL algorithm {c.algorithm_name!r}")
        if c.update_schedule not in ("sequential", "stacked"):
            raise ValueError(f"MarlConfig.update_schedule must be 'sequential' or "
                             f"'stacked', got {c.update_schedule!r}")
        if c.optimizer not in ("adam", "fused_adam"):
            raise ValueError(f"MarlConfig.optimizer must be 'adam' or 'fused_adam', "
                             f"got {c.optimizer!r}")
        # full-float32 heads and value math on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env = env
        self.num_envs = num_envs
        self.seed = seed
        self.log_dir = log_dir
        self.print_log = print_log
        self.N = env.num_agents
        self.act_dim = env.num_actions
        self.obs_dim = env.num_ant_obs + (env.num_obs - env.num_agents * env.num_ant_obs)
        self.share_dim = env.num_obs
        self.critic_in_dim = self.share_dim if c.use_centralized_v else self.obs_dim
        self.norm_mode = c.norm_mode()
        # HATRPO shares HAPPO's permutation and importance factor
        self.is_happo = c.algorithm_name in ("happo", "hatrpo")
        self.is_trpo = c.algorithm_name == "hatrpo"
        use_fused = c.use_fused_mlp
        if use_fused == "auto":
            use_fused = self.device.type == "cuda"
        self.use_fused = bool(use_fused) and c.hidden_size % 128 == 0
        # mappo/ippo on the fused kernels go through the sequential per-agent
        # schedule unless "stacked" is asked for; agents are independent, so
        # both give the same parameters
        self.sequential = self.is_happo or (self.use_fused and c.update_schedule == "sequential")
        self.actor = nets.MarlActor(act_dim=self.act_dim, hidden_size=c.hidden_size,
                                    layer_n=c.layer_n, gain=c.gain,
                                    std_x_coef=c.std_x_coef, std_y_coef=c.std_y_coef)
        self.critic = nets.MarlCritic(hidden_size=c.hidden_size, layer_n=c.layer_n)
        self.actor_tx = self._make_tx(c.lr, num_envs)
        self.critic_tx = self._make_tx(c.critic_lr, num_envs)
        self.mesh = mesh or LOCAL
        # under a mesh, the fused update is shard-local (see the module doc)
        self.shard_local = self.use_fused
        self.local_envs = self.mesh.shard_env(env, num_envs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, num_envs)
        self.state: MarlTrainState | None = None
        self.last_metrics: Dict[str, float] = {}
        self.update_graph = UpdateGraph()
        # HATRPO: per agent of the last update, the Fisher-vector products,
        # the line-search candidates tried (improve, ratio, kl each) and the
        # index of the accepted one (-1: none, the parameters stay)
        self.trpo_log: List[Dict[str, Any]] = []

    def _make_tx(self, lr: float, num_envs: int) -> ClipAdam:
        c = self.cfg
        if c.use_linear_lr_decay:
            # update_linear_schedule: lr - lr * episode / episodes, stepped
            # once per training episode (all its epochs x minibatches share it)
            per_ep = c.ppo_epoch * max(1, c.num_mini_batch)
            episodes = max(1, int(c.num_env_steps) // (c.episode_length * num_envs))
            base = float(lr)
            lr = lambda count: base * (1.0 - min(count // per_ep, episodes) / episodes)
        return ClipAdam(lr, clip=c.max_grad_norm if c.use_max_grad_norm else float("inf"),
                        eps=c.opti_eps, wd=c.weight_decay, mu_bf16=c.bf16_adam_mu)

    # ------------------------------------------------------------------ setup
    def init_state(self) -> MarlTrainState:
        g = torch.Generator()
        g.manual_seed(self.seed)
        to_dev = lambda tree: tree_map(lambda x: x.to(self.device), tree)
        ap = to_dev(self.actor.init(self.N, self.obs_dim, g))
        cp = to_dev(self.critic.init(self.N, self.critic_in_dim, g))
        E = self.local_envs
        zeros = lambda dtype=torch.float32: torch.zeros(E, dtype=dtype, device=self.device)
        self.state = MarlTrainState(
            actor_params=ap, critic_params=cp,
            actor_opt=self.actor_tx.init(tree_leaves(ap), self.N),
            critic_opt=self.critic_tx.init(tree_leaves(cp), self.N),
            vnorm=nets.ValueNorm.create((self.N,), device=self.device),
            env_state=self.env.reset(E), iteration=0,
            ep_ret=zeros(), last_ep_ret=zeros(), ep_count=zeros(torch.int32))
        return self.state

    def _agent_views(self, obs_buf):
        """[E, full] -> (per-agent obs [N,E,obs], critic input [N,E,share_or_obs])."""
        obs = split_multi_agent_obs(obs_buf, self.N, self.env.num_ant_obs).transpose(0, 1)
        if self.cfg.use_centralized_v:
            return obs, obs_buf[None].expand(self.N, *obs_buf.shape)
        return obs, obs

    # ---------------------------------------------------------------- rollout
    @spanned("trainer.rollout")
    @torch.no_grad()
    def rollout_phase(self) -> Dict[str, torch.Tensor]:
        """episode_length steps of every agent's policy and the env step;
        advances state.env_state and returns the trajectory dict."""
        cfg, st = self.cfg, self.state
        E = self.local_envs
        max_ep_len = getattr(self.env, "max_episode_length", None)
        env_state = st.env_state
        steps = []
        for _ in range(cfg.episode_length):
            with span("trainer.policy"):
                obs_buf = torch.clamp(env_state.obs, -cfg.clip_obs, cfg.clip_obs)
                obs, cin = self._agent_views(obs_buf)
                mean, std = self.actor.apply(st.actor_params, obs)          # [N,E,act]
                noise = draw(torch.randn, mean.shape, self.generator, axis=1, device=self.device)
                actions = mean + std * noise
                logp = nets.normal_log_prob(mean, std, actions)             # [N,E]
                values = self.critic.apply(st.critic_params, cin)           # [N,E]
                a_clip = torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions)
            nxt = self.env.step_batch(env_state, a_clip.transpose(0, 1).reshape(E, -1))
            if cfg.use_proper_time_limits and max_ep_len is not None:
                bad = 1.0 - (nxt.done & (nxt.progress >= max_ep_len - 1)).float()
            else:
                bad = torch.ones(E, device=self.device)
            steps.append(dict(obs=obs.transpose(0, 1), share=obs_buf,
                              actions=actions.transpose(0, 1), logp=logp.t(),
                              values=values.t(), reward=nxt.reward,
                              done=nxt.done.float(), bad=bad))
            env_state = nxt
        st.env_state = env_state
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    # ----------------------------------------------------------------- update
    def _gae(self, traj, last_values, vn):
        """Per-agent GAE on the denormalized values (separated_buffer.py:
        124-168), then whole-buffer advantage normalization per agent.
        Returns (adv_norm, returns), each [N, T, E]."""
        cfg = self.cfg
        den = (lambda x: vn.denormalize(x)) if self.norm_mode != "none" else (lambda x: x)
        v = den(traj["values"].permute(2, 0, 1))                          # [N,T,E]
        last = den(last_values)                                            # [N,E]
        r, d, bad = traj["reward"], traj["done"], traj["bad"]
        T = r.shape[0]
        out = []
        if cfg.use_gae:
            nv = torch.cat([v[:, 1:], last[:, None]], dim=1)
            adv = torch.zeros_like(last)
            for t in reversed(range(T)):
                delta = r[t] + cfg.gamma * nv[:, t] * (1 - d[t]) - v[:, t]
                adv = delta + cfg.gamma * cfg.gae_lambda * (1 - d[t]) * adv
                if cfg.use_proper_time_limits:
                    adv = adv * bad[t]
                out.append(adv)
            adv = torch.stack(out[::-1], dim=1)
            returns = adv + v
        else:
            ret = last
            for t in reversed(range(T)):
                ret = ret * cfg.gamma * (1 - d[t]) + r[t]
                if cfg.use_proper_time_limits:
                    ret = ret * bad[t] + (1 - bad[t]) * v[:, t]
                out.append(ret)
            returns = torch.stack(out[::-1], dim=1)
            adv = returns - v
        flat = adv.reshape(adv.shape[0], -1)
        mean, std = self.mesh.mean_std(flat, dim=1)
        return (adv - _lead(mean, adv)) / (_lead(std, adv) + 1e-5), returns

    # ------------------------------------------------- collectives of a mesh
    @property
    def _glob(self) -> bool:
        """Under a mesh, on the global (flax-mirror, GSPMD) path."""
        return self.mesh is not LOCAL and not self.shard_local

    def _bmean(self, x, n):
        """The mean over the last (batch) axis of a batch of n rows over all
        ranks: the mean of the rank's rows alone or shard-local, else their
        sum divided by n (the rank's share of the global mean)."""
        return x.sum(-1) / n if self._glob else x.mean(-1)

    def _reduce(self, xs: list) -> list:
        """`_bmean`'s values of every rank combined: the identity alone, the
        mean over the ranks when shard-local (pmean), else the sum."""
        if self.mesh is LOCAL:
            return xs
        return self.mesh.mean(xs) if self.shard_local else self.mesh.sum(xs)

    def _wgrad(self):
        """On the global path, the bf16 layers' weight gradients are f32
        partial sums (algos/nets.f32_weight_grads)..."""
        return f32_weight_grads() if self._glob else contextlib.nullcontext()

    def _round(self, grads, tree):
        """... which are rounded to bf16 once they are summed (`_reduce`)."""
        return round_bf16(grads, nets.bf16_mask(tree)) if self._glob else grads

    def _global_rows(self, mask):
        """A [..., B] mask's sum over the batch, over every rank's rows on
        the global path."""
        return self.mesh.sum(mask.sum(-1)) if self._glob else mask.sum(-1)

    def _actor_loss(self, apply, params, mb, n=None):
        """Sum over the batch's agents of the clipped surrogate (times the
        HAPPO factor) minus the entropy bonus; and the per-agent surrogate.
        n: the minibatch's global size (`_bmean`)."""
        cfg = self.cfg
        mean, std = apply(params, mb["obs"])
        logp = nets.normal_log_prob(mean, std, mb["actions"])             # [n,B]
        ratio = torch.exp(logp - mb["logp"])
        surr1 = ratio * mb["adv"]
        surr2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * mb["adv"]
        obj = torch.minimum(surr1, surr2)
        if "factor" in mb:
            obj = mb["factor"] * obj
        ent = nets.normal_entropy(std)
        if cfg.use_policy_active_masks:
            act = mb["active"]
            wsum = torch.clamp_min(self._global_rows(act), 1e-8)
            loss_n = -(obj * act).sum(-1) / wsum
            ent_n = (ent * act).sum(-1) / wsum
        else:
            loss_n = -self._bmean(obj, n)
            ent_n = self._bmean(ent, n)
        return (loss_n - cfg.entropy_coef * ent_n).sum(), loss_n.detach()

    def _critic_loss(self, apply, params, mb, rn_c, rn_o, n=None):
        cfg = self.cfg
        values = apply(params, mb["cin"])                                   # [n,B]
        v_clip = mb["values"] + torch.clamp(values - mb["values"],
                                            -cfg.clip_param, cfg.clip_param)
        err_o, err_c = rn_o - values, rn_c - v_clip
        if cfg.use_huber_loss:
            l_o, l_c = nets.huber(err_o, cfg.huber_delta), nets.huber(err_c, cfg.huber_delta)
        else:
            l_o, l_c = 0.5 * err_o ** 2, 0.5 * err_c ** 2
        l = torch.maximum(l_o, l_c) if cfg.use_clipped_value_loss else l_o
        if cfg.use_value_active_masks:
            act = mb["active"]
            vl_n = (l * act).sum(-1) / torch.clamp_min(self._global_rows(act), 1e-8)
        else:
            vl_n = self._bmean(l, n)
        return (cfg.value_loss_coef * vl_n).sum(), vl_n.detach()

    @staticmethod
    def _grads(loss_fn, tree):
        """Gradients of loss_fn(tree) wrt every leaf, and its aux output
        (the spans update.forward and update.backward)."""
        leaves = [x.detach().requires_grad_() for x in tree_leaves(tree)]
        with span("update.forward"):
            loss, aux = loss_fn(tree_unflatten(tree, leaves))
        with span("update.backward"):
            return list(torch.autograd.grad(loss, leaves)), aux

    def _update_once(self, a_apply, c_apply, ap, ao, cp, co, vn, mb, agents: slice,
                     actor: bool = True, n: int = 0):
        """One actor step (skipped when not `actor`: HATRPO's critic-only
        epochs, which leave the actor's optimizer as it is), the value-target
        update and one critic step for the agents `agents` (views
        ap/cp/ao/co/vn already cut to them) on a minibatch of n global rows.
        Returns (vn', actor loss [n] or None, value loss [n])."""
        st = self.state
        aloss = None
        if actor:
            with self._wgrad():
                agrad, aloss = self._grads(lambda p: self._actor_loss(a_apply, p, mb, n), ap)
            *agrad, aloss = self._reduce(agrad + [aloss])
            agrad = self._round(agrad, ap)
            with span("update.optimizer"):
                self.actor_tx.step(tree_leaves(ap), agrad, ao.mu, ao.nu,
                                   *self._adam_count(0, st.actor_opt, agents))
        moments = None if self.mesh is LOCAL else \
            (lambda r: tuple(self._reduce([self._bmean(r, n), self._bmean(r * r, n)])))
        vn, rn_c, rn_o = nets.norm_targets(vn, mb["returns"], self.norm_mode, moments)
        with self._wgrad():
            cgrad, vloss = self._grads(lambda p: self._critic_loss(c_apply, p, mb, rn_c, rn_o, n),
                                       cp)
        *cgrad, vloss = self._reduce(cgrad + [vloss])
        cgrad = self._round(cgrad, cp)
        with span("update.optimizer"):
            self.critic_tx.step(tree_leaves(cp), cgrad, co.mu, co.nu,
                                *self._adam_count(1, st.critic_opt, agents))
        for opt in (st.actor_opt, st.critic_opt) if actor else (st.critic_opt,):
            opt.count[agents] = [x + 1 for x in opt.count[agents]]
        return vn, aloss, vloss

    def _adam_count(self, which: int, opt: AdamState, agents: slice) -> tuple:
        """ClipAdam.step's count for the agents' next step of the actor's
        (which 0) or the critic's (1) optimizer; while the update's graph
        is captured, also the device scalars its replays read for it."""
        count = opt.count[agents.start]
        if self.update_graph.base is None:
            return (count,)
        return count, self.update_graph.step_scalars(which, agents.start, count)

    def _epochs(self, a_apply, c_apply, batch, agents: slice, vn, actor: bool = True):
        """ppo_epoch x num_mini_batch updates of the agents `agents` (the
        critic alone when not `actor`).  batch leaves are [n, B, ...].
        Returns (vn', per-epoch lists of actor and value losses per
        minibatch, each [n]; the actor's lists stay empty without it)."""
        cfg, st = self.cfg, self.state
        view = lambda tree: tree_map(lambda x: x[agents], tree)
        ap, cp = view(st.actor_params), view(st.critic_params)
        opt_view = lambda o: AdamState([m[agents] for m in o.mu], [v[agents] for v in o.nu], [])
        ao, co = opt_view(st.actor_opt), opt_view(st.critic_opt)
        nmb = max(1, cfg.num_mini_batch)
        B = batch["obs"].shape[1]
        mbs = (B * self.mesh.size if self._glob else B) // nmb
        al, vl = [], []
        for _ in range(cfg.ppo_epoch):
            if nmb == 1:
                chunks = [batch]
            else:
                chunks = [{k: v[:, ix] for k, v in batch.items()}
                          for ix in self._minibatches(B, nmb)]
            al.append([])
            vl.append([])
            for mb in chunks:
                vn, a_n, v_n = self._update_once(a_apply, c_apply, ap, ao, cp, co, vn, mb,
                                                 agents, actor, mbs)
                if actor:
                    al[-1].append(a_n)
                vl[-1].append(v_n)
        return vn, al, vl

    def _minibatches(self, B: int, nmb: int):
        """One epoch's minibatches of the rank's B rows: nmb index tensors
        of contiguous chunks of a fresh permutation, the remainder dropped.
        On the global path under a mesh the permutation is of every rank's
        rows (T-major, num_envs a step) and each chunk keeps the rank's."""
        Bp = B * self.mesh.size if self._glob else B
        mbs = Bp // nmb
        idx = torch.randperm(Bp, generator=self.generator, device=self.device)
        idx = idx[: nmb * mbs].reshape(nmb, mbs)
        return [self.mesh.local_index(ix, self.num_envs) for ix in idx] if self._glob else idx

    def _update_nets(self):
        """(actor apply, critic apply, input normalization) of the update:
        the fused kernels on feature-normalized inputs, computed once per
        update because the LayerNorm statistics are parameter-free, or the
        flax-mirror nets on raw inputs."""
        cfg = self.cfg
        if not self.use_fused:
            return self.actor.apply, self.critic.apply, lambda x: x
        a_apply = lambda p, o: fused_nets.actor_apply(
            p, o, std_x_coef=cfg.std_x_coef, std_y_coef=cfg.std_y_coef,
            layer_n=cfg.layer_n, prenormed=True)
        c_apply = lambda p, x: fused_nets.critic_apply(p, x, layer_n=cfg.layer_n,
                                                       prenormed=True)
        return a_apply, c_apply, feature_norm

    def _trpo_actor_update(self, a_apply, ap, batch) -> torch.Tensor:
        """HATRPO's actor step for one agent (reference runner.py:725-860):
        conjugate gradient on the Fisher-vector product (10 iterations,
        stopping once i > 0 and the residual r.r < 1e-10), the step
        sqrt(2 kl_threshold / max(sFs, 1e-10)) along its direction s, then a
        backtracking line search over ls_step scales 0.5**i that takes the
        first candidate with improve > 0, improve / (expected * scale) >
        accept_ratio and mean KL <= kl_threshold (none: the parameters stay).
        The surrogate is factor * ratio * adv, unclipped.  Updates ap (views
        into the state) in place and returns the actor loss, -surrogate at
        the old parameters.  One autograd graph of a_apply gives the old
        outputs, the surrogate, its gradient and the Fisher-vector products'
        pullbacks (`_fvp`); a line-search candidate's surrogate and KL come
        from one forward."""
        cfg = self.cfg
        leaves = tree_leaves(ap)
        sizes = [p.numel() for p in leaves]
        flat0 = torch.cat([p.detach().reshape(-1) for p in leaves])
        unravel = lambda v: tree_unflatten(
            ap, [c.view_as(p) for c, p in zip(torch.split(v, sizes), leaves)])
        obs = batch["obs"]

        n = obs.shape[1] * self.mesh.size    # the batch's global rows

        def surrogate(mean, std):
            logp = nets.normal_log_prob(mean, std, batch["actions"])
            obj = (batch["factor"] * torch.exp(logp - batch["logp"]) * batch["adv"]).reshape(-1)
            if cfg.use_policy_active_masks:
                act = batch["active"].reshape(-1)
                return (obj * act).sum() / torch.clamp_min(self._global_rows(act), 1e-8)
            return self._bmean(obj, n)

        req = [p.detach().clone().requires_grad_() for p in leaves]
        with self._wgrad():
            mean, std = a_apply(tree_unflatten(ap, req), obs)
        mean_o, std_o = mean.detach(), std.detach()
        surr = surrogate(mean, std)
        *g, surr_all = self._reduce(list(torch.autograd.grad(surr, req, retain_graph=True))
                                    + [surr.detach()])
        g = _flat(self._round(g, ap))
        fvp = self._fvp(ap, obs, req, mean, std, n)
        fvps = 0
        x, r, p = torch.zeros_like(g), g.clone(), g.clone()
        rs = torch.dot(r, r)
        for i in range(10):
            if i > 0 and bool(rs < 1e-10):
                break
            Ap = fvp(p)
            fvps += 1
            alpha = rs / (torch.dot(p, Ap) + 1e-10)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_n = torch.dot(r, r)
            p = r + (rs_n / (rs + 1e-10)) * p
            rs = rs_n
        sfs = torch.dot(x, fvp(x))
        fvps += 1
        full_step = torch.sqrt(2.0 * cfg.kl_threshold / torch.clamp_min(sfs, 1e-10)) * x
        old_surr = surr_all
        expected = torch.dot(g, full_step)
        tried, accepted, new = [], -1, flat0
        with torch.no_grad():
            for i in range(cfg.ls_step):
                scale = 0.5 ** i
                cand = flat0 + scale * full_step
                m, s = a_apply(unravel(cand), obs)
                surr_c, kl = self._reduce([surrogate(m, s), self._kl(m, s, mean_o, std_o, n)])
                improve = surr_c - old_surr
                ratio = improve / torch.clamp_min(expected * scale, 1e-10)
                ok = (improve > 0) & (ratio > cfg.accept_ratio) & (kl <= cfg.kl_threshold)
                *vals, take = torch.stack([improve, ratio, kl, ok.float()]).tolist()
                tried.append(tuple(vals))
                if take:
                    accepted, new = i, cand
                    break
            for leaf, c in zip(leaves, torch.split(new, sizes)):
                leaf.copy_(c.view_as(leaf))
        self.trpo_log.append(dict(fvps=fvps, candidates=tried, accepted=accepted))
        return -old_surr

    def _kl(self, mean, std, mean_o, std_o, n=None):
        """_mean_kl of a batch of n global rows, as `_bmean` takes it."""
        return _mean_kl(mean, std, mean_o, std_o, n if self._glob else None)

    def _fvp(self, ap, obs, req, mean, std, n=None):
        """v -> F v + 0.1 v for one agent at the point (mean, std) =
        a_apply(ap with leaves req, obs), a graph kept for the pullbacks.

        On the fused path F v is the Gauss-Newton J^T M (J v) with M the
        diagonal Gaussian output metric (1/std^2 on the mean, 2/std^2 on the
        std, over B); J v is the tangent of one linearization
        (fused_nets.actor_linearize, kernel B2) and J^T u the pullback of the
        graph, so no forward runs inside the products.  Without the fused
        kernels it is the mean KL's Hessian-vector product, by double
        backward through the flax-mirror nets.  n: the batch's global rows;
        under a mesh the product is combined over the ranks (`_reduce`)
        before the damping."""
        cfg = self.cfg
        sizes = [p.numel() for p in req]
        mean_o, std_o = mean.detach(), std.detach()
        if self.use_fused:
            B = mean.shape[1]
            with torch.no_grad():
                tangent = fused_nets.actor_linearize(
                    ap, obs, std_x_coef=cfg.std_x_coef, std_y_coef=cfg.std_y_coef,
                    layer_n=cfg.layer_n, prenormed=True)[2]

            def fvp(v):
                with torch.no_grad():
                    dmean, dstd = tangent(tree_unflatten(
                        ap, [c.view_as(p) for c, p in zip(torch.split(v, sizes), req)]))
                    u = (dmean / std_o ** 2 / B, 2.0 * dstd / std_o ** 2 / B)
                Fv = _flat(torch.autograd.grad((mean, std), req, grad_outputs=u,
                                               retain_graph=True))
                return self._reduce([Fv])[0] + 0.1 * v
            return fvp
        gkl = torch.autograd.grad(self._kl(mean, std, mean_o, std_o, n), req, create_graph=True)

        def fvp(v):
            dot = sum((gk.reshape(-1) * vk).sum() for gk, vk in zip(gkl, torch.split(v, sizes)))
            Fv = self._reduce(list(torch.autograd.grad(dot, req, retain_graph=True)))
            return _flat(self._round(Fv, ap)) + 0.1 * v
        return fvp

    def _stacked(self, data, share):
        """All agents jointly (MAPPO/IPPO).  Returns the iteration's actor
        and value loss means."""
        cfg, st, N = self.cfg, self.state, self.N
        a_apply, c_apply, norm = self._update_nets()
        obs = norm(data["obs"])
        # the shared critic input is read by every agent, not copied N times
        cin = norm(share)[None].expand(N, *share.shape[:1], -1) if cfg.use_centralized_v \
            else obs
        vn, al, vl = self._epochs(a_apply, c_apply, dict(data, obs=obs, cin=cin),
                                  slice(0, N), st.vnorm)
        st.vnorm = vn
        # per step: the mean over agents; the fused joint update reports the
        # value loss with its coefficient, as the reference's stacked_epochs
        coef = cfg.value_loss_coef if self.use_fused else 1.0
        return (_nested_mean([[x.mean() for x in e] for e in al]),
                _nested_mean([[(coef * x).mean() for x in e] for e in vl]))

    def _sequential(self, data, share, perm):
        """One agent after another, all epochs each (HAPPO's factor scan,
        HATRPO's with its trust-region actor step; MAPPO/IPPO without the
        factor).  Returns the loss means."""
        cfg, st, N = self.cfg, self.state, self.N
        if perm is None:
            perm = (torch.randperm(N, generator=self.generator, device=self.device)
                    if self.is_happo else torch.arange(N))
        a_apply, c_apply, norm = self._update_nets()
        share_in = norm(share)[None] if cfg.use_centralized_v else None
        factor = torch.ones(1, data["obs"].shape[1], device=self.device)
        alosses, vlosses = [], []
        self.trpo_log = []
        for i in (int(i) for i in perm):
            with span("update.agent"):
                sl = slice(i, i + 1)
                batch = {k: v[sl] for k, v in data.items()}
                batch["obs"] = norm(batch["obs"])
                batch["cin"] = share_in if share_in is not None else batch["obs"]
                batch["factor"] = factor
                ap = tree_map(lambda x: x[sl], st.actor_params)
                if self.is_happo:
                    with torch.no_grad():
                        old_logp = nets.normal_log_prob(*a_apply(ap, batch["obs"]),
                                                        batch["actions"])
                if self.is_trpo:
                    aloss = self._trpo_actor_update(a_apply, ap, batch)
                    vn, _, vl = self._epochs(a_apply, c_apply, batch, sl, st.vnorm.index(sl),
                                             actor=False)
                else:
                    vn, al, vl = self._epochs(a_apply, c_apply, batch, sl, st.vnorm.index(sl))
                    aloss = _nested_mean([[x.mean() for x in e] for e in al])
                st.vnorm.assign(sl, vn)
                if self.is_happo:
                    with torch.no_grad():
                        new_logp = nets.normal_log_prob(*a_apply(ap, batch["obs"]),
                                                        batch["actions"])
                        factor = factor * torch.exp(new_logp - old_logp)
                alosses.append(aloss)
                vlosses.append(_nested_mean([[x.mean() for x in e] for e in vl]))
        return torch.stack(alosses).mean(), torch.stack(vlosses).mean()

    @spanned("trainer.update")
    def update_phase(self, traj: Dict[str, torch.Tensor], last_obs: torch.Tensor, *,
                     perm=None) -> Dict[str, torch.Tensor]:
        """GAE and the updates on one trajectory; returns the iteration's
        metrics (device tensors).  `perm` fixes HAPPO's and HATRPO's agent order (the
        tests use it to replay the reference's permutation)."""
        cfg, st, N = self.cfg, self.state, self.N
        T, E = traj["reward"].shape
        B = T * E
        with torch.no_grad():
            _, last_cin = self._agent_views(torch.clamp(last_obs, -cfg.clip_obs, cfg.clip_obs))
            last_values = self.critic.apply(st.critic_params, last_cin)    # [N,E]
            adv, returns = self._gae(traj, last_values, st.vnorm)
        agent_major = lambda x: x.permute(2, 0, 1, *range(3, x.dim())).reshape(N, B, *x.shape[3:])
        data = dict(obs=agent_major(traj["obs"]), actions=agent_major(traj["actions"]),
                    logp=agent_major(traj["logp"]), values=agent_major(traj["values"]),
                    adv=adv.reshape(N, B), returns=returns.reshape(N, B),
                    active=torch.ones(N, B, device=self.device))
        share = traj["share"].reshape(B, -1)
        if self.update_graph.refusal(self, perm) is None:
            aloss, vloss = self.update_graph(self, data, share)
        else:
            self.update_graph.eager_updates += 1
            aloss, vloss = (self._sequential(data, share, perm) if self.sequential
                            else self._stacked(data, share))

        st.iteration += 1
        reward, done = self.mesh.mean([traj["reward"].mean(), traj["done"].mean()])
        return dict(mean_reward=reward, value_loss=vloss, policy_loss=aloss,
                    done_frac=done, **episode_returns(st, traj, self.mesh))

    def train_iter(self):
        traj = self.rollout_phase()
        return self.update_phase(traj, self.state.env_state.obs)

    # ---------------------------------------------------------------- driving
    def run(self, num_env_steps: int | None = None):
        steps_per_iter = self.cfg.episode_length * self.num_envs
        n_iter = max(1, int((num_env_steps or self.cfg.num_env_steps) // steps_per_iter))
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        name = self.cfg.algorithm_name
        for it in range(self.state.iteration, n_iter):
            t0 = time.perf_counter()
            metrics = self.train_iter()
            if it % self.cfg.log_interval == 0:
                m = fetch_metrics(metrics)
                m["fps"] = steps_per_iter / (time.perf_counter() - t0)
                self.last_metrics = m
                if writer:
                    writer.add_scalar("train/mean_reward", m["mean_reward"], it)
                    writer.add_scalar("train/value_loss", m["value_loss"], it)
                    writer.add_scalar("train/policy_loss", m["policy_loss"], it)
                    writer.add_scalar("perf/fps", m["fps"], it)
                    if m["episodes_done"] > 0:
                        writer.add_scalar("train_episode_rewards", m["episode_rewards"],
                                          it * steps_per_iter)
                if self.print_log:
                    print(f"[{name}] it {it}/{n_iter} "
                          f"rew/step {m['mean_reward']:.3f} vloss {m['value_loss']:.3f} "
                          f"fps {m['fps']:.0f}", flush=True)
            if self.cfg.use_eval and self.cfg.eval_interval and it % self.cfg.eval_interval == 0:
                eval_rew = self.eval()
                if writer:
                    writer.add_scalar("eval/mean_episode_reward", eval_rew, it)
                if self.print_log:
                    print(f"[{name}] eval at it {it}: episode return {eval_rew:.3f}", flush=True)
            if self.log_dir and self.cfg.save_interval and (it + 1) % self.cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"marl_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    def eval(self, n_episodes: int | None = None, deterministic: bool = True):
        """Deterministic episodes in dedicated envs (JAX runner.py:1281-1336):
        E = min(n_episodes, num_envs) envs reset from a stream seeded from
        seed + 10_000 and the iteration, every agent acting with its clipped
        mean for max_episode_length steps; returns the mean over the envs
        of the team reward summed until each env's first done."""
        if self.state is None:
            self.init_state()
        cfg, ap = self.cfg, self.state.actor_params
        E = max(1, min(n_episodes or cfg.eval_episodes, self.num_envs))

        def policy(obs_buf):
            obs, _ = self._agent_views(torch.clamp(obs_buf, -cfg.clip_obs, cfg.clip_obs))
            mean, _ = self.actor.apply(ap, obs)
            return torch.clamp(mean, -cfg.clip_actions, cfg.clip_actions) \
                .transpose(0, 1).reshape(E, -1)

        return evaluate_episodes(self.env, E, policy,
                                 eval_generator(self.seed, self.device, self.state.iteration))

    def save(self, path: str):
        """Parameters, optimizer states, value normalizer and iteration (the
        JAX runner's file, flax msgpack)."""
        tree = checkpoint.to_host(bridge.marl_state_to_flax(self.cfg, self.state))
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(tree))

    def restore(self, path: str):
        """Restore from a file of either package; a file written under the
        other cfg.optimizer ('adam' vs 'fused_adam', or another optax chain)
        raises ValueError, as in the JAX runner."""
        if self.state is None:
            self.init_state()
        st = self.state
        try:
            r = bridge.marl_state_from_flax(self.cfg, checkpoint.load_tree(path))
            ap = checkpoint.restore_into(st.actor_params, r["actor_params"])
            cp = checkpoint.restore_into(st.critic_params, r["critic_params"])
            opts = [self._restored_opt(params, opt, r[key]) for params, opt, key in
                    ((st.actor_params, st.actor_opt, "actor_opt"),
                     (st.critic_params, st.critic_opt, "critic_opt"))]
            vn = checkpoint.restore_into(
                {"mean": st.vnorm.mean, "mean_sq": st.vnorm.mean_sq, "debias": st.vnorm.debias},
                r["vnorm"])
        except (ValueError, KeyError) as e:
            raise ValueError(
                f"checkpoint {path} does not match this runner's state. If it was saved "
                f"under a different cfg.optimizer ('adam' vs 'fused_adam') or optimizer "
                f"chain, restore with the setting it was saved with. Cause: {e}") from e
        st.actor_params, st.critic_params = ap, cp
        st.actor_opt, st.critic_opt = opts
        st.vnorm = nets.ValueNorm(beta=st.vnorm.beta, **vn)
        st.iteration = r["iteration"]

    @staticmethod
    def _restored_opt(params, opt: AdamState, restored) -> AdamState:
        mu, nu, count = restored
        if len(count) != len(opt.count):
            raise ValueError(f"checkpoint has {len(count)} agents' counts, the runner "
                             f"{len(opt.count)}")
        moments = [tree_leaves(checkpoint.restore_into(tree_unflatten(params, cur), new))
                   for cur, new in ((opt.mu, mu), (opt.nu, nu))]
        return AdamState(mu=moments[0], nu=moments[1], count=count)
