"""MADDPG: off-policy MARL with centralized critics (twin of
massive_marl_tpu/algos/marl/maddpg.py).

  * N deterministic actors pi_i(obs_i) (a ReLU MLP, then tanh) and N
    centralized critics Q_i(share obs, joint actions), float32 with flax's
    Dense init (lecun_normal kernels, zero biases), agent-stacked: every
    leaf carries a leading N, Dense kernels [N, in, out], in flax's layout
    ({"params": {"Dense_i": {"kernel", "bias"}}});
  * a replay ring of whole env rows [R, E, ...] on the device: obs,
    share, actions, next_obs and next_share in bf16, rewards and dones in
    float32; its write pointer and fill count are host ints.  A gradient
    step draws batch_size row indices from [0, max(count, 1)) and uses all
    E envs of each (the gather, not the ring, goes to float32);
  * each env step (the actors with clipped Gaussian act_noise, the env
    step, the ring write) is followed by updates_per_step gradient steps
    once the ring holds batch_size rows; before that an iteration only
    collects.  A gradient step, in the reference's order: every critic
    against r + gamma (1 - done) Q_i^targ(next share, the target actors'
    next actions); every actor against its UPDATED critic, the other
    agents' actions taken from the ring; Polyak averaging of both target
    sets;
  * per-agent Adam (eps 1e-8) with no gradient clipping; the agents' losses
    are summed, so each agent's gradient is its own.
The rollout's normal draws go through `_normal` ([E, N, act]), the row
indices through `_rows`.  A checkpoint ({"actor_params", "critic_params",
"iteration"}) is the JAX runner's file.

Under a `mesh` (parallel/mesh.py) each rank steps its E / R envs and its
ring holds their columns (the env axis, axis 1).  The sampled rows are
drawn alike on every rank and each carries every env, so the ranks hold
equal shares of a batch: the critics' and actors' gradients and the critic
loss are averaged over them.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos.marl.nets import lecun_dense
from massive_marl_tpu_torch.algos.rl.ppo import AdamState, adam_update
from massive_marl_tpu_torch.envs.base import eval_generator, evaluate_episodes
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer, fetch_metrics
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from massive_marl_tpu_torch.wrap.vec_task import split_multi_agent_obs


def init_stacked_mlp(num_agents: int, widths, generator: torch.Generator) -> dict:
    """{"params": {"Dense_i": {kernel [N, in, out], bias [N, out]}}}: one
    flax-initialised Dense per pair of consecutive widths, per agent."""
    return {"params": {f"Dense_{i}": lecun_dense(num_agents, a, b, generator)
                       for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}}


def mlp_apply(p: dict, x, n_hidden: int):
    """Agent-stacked ReLU MLP: x [N, B, in] -> [N, B, out] (the head
    linear)."""
    p = p["params"]
    dense = lambda d, x: torch.bmm(x, d["kernel"]) + d["bias"][:, None]
    for i in range(n_hidden):
        x = F.relu(dense(p[f"Dense_{i}"], x))
    return dense(p[f"Dense_{n_hidden}"], x)


def _requiring_grad(tree):
    """tree's leaves detached, each requiring grad (the step's inputs)."""
    return [p.detach().requires_grad_() for p in tree_leaves(tree)]


@dataclass
class MaddpgConfig:
    nsteps: int = 8
    replay_size: int = 10_000
    batch_size: int = 64
    gamma: float = 0.99
    polyak: float = 0.995
    lr: float = 1e-4
    act_noise: float = 0.1
    hidden: int = 256
    layers: int = 3
    clip_obs: float = 7.0
    clip_actions: float = 1.0
    max_iterations: int = 2500
    save_interval: int = 1000
    updates_per_step: int = 1

    @classmethod
    def from_cfg_train(cls, cfg_train: dict) -> "MaddpgConfig":
        """Build from cfg/maddpg/config.yaml's `learn:` block with the JAX key
        map."""
        learn = cfg_train.get("learn", {})
        kw = {}
        for k, yk in {"nsteps": "nsteps", "replay_size": "replay_size",
                      "batch_size": "batch_size", "gamma": "gamma", "polyak": "polyak",
                      "lr": "learning_rate", "act_noise": "act_noise", "hidden": "hidden_nodes",
                      "layers": "hidden_layer", "max_iterations": "max_iterations",
                      "save_interval": "save_interval"}.items():
            if yk in learn:
                kw[k] = learn[yk]
        kw["lr"] = float(kw.get("lr", 1e-4))
        return cls(**kw)


@dataclass
class MaddpgReplay:
    obs: torch.Tensor          # [R, E, N, obs] bf16
    share: torch.Tensor        # [R, E, share] bf16
    actions: torch.Tensor      # [R, E, N, act] bf16
    rewards: torch.Tensor      # [R, E]
    next_obs: torch.Tensor     # [R, E, N, obs] bf16
    next_share: torch.Tensor   # [R, E, share] bf16
    dones: torch.Tensor        # [R, E]
    ptr: int = 0               # next write row
    count: int = 0             # filled rows (<= R)

    def tensors(self):
        return (self.obs, self.share, self.actions, self.rewards, self.next_obs,
                self.next_share, self.dones)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


@dataclass
class MaddpgState:
    actor_params: dict
    critic_params: dict
    target_actor: dict
    target_critic: dict
    actor_opt: AdamState
    critic_opt: AdamState
    replay: MaddpgReplay
    env_state: Any
    iteration: int = 0


class MaddpgRunner:
    """MaddpgRunner(env, num_envs, cfg).run(num_iterations)."""

    def __init__(self, env, num_envs: int, cfg: MaddpgConfig | None = None, seed: int = 0,
                 log_dir: str | None = None, print_log: bool = True, mesh=None, device=None):
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, runner on {self.device}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env = env
        self.num_envs = num_envs
        self.cfg = cfg or MaddpgConfig()
        self.seed = seed
        self.log_dir = log_dir
        self.print_log = print_log
        self.N = env.num_agents
        self.act_dim = env.num_actions
        self.obs_dim = env.num_ant_obs + (env.num_obs - env.num_agents * env.num_ant_obs)
        self.share_dim = env.num_obs
        self.mesh = mesh or LOCAL
        self.local_envs = self.mesh.shard_env(env, num_envs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, num_envs)
        self.state: MaddpgState | None = None
        self.last_metrics: Dict[str, float] = {}
        self.grad_steps = 0       # gradient steps taken by this runner

    # ------------------------------------------------------------------ setup
    def init_params(self):
        """(actor, critic) agent-stacked parameter trees, flax's init."""
        g = torch.Generator()
        g.manual_seed(self.seed)
        c, N = self.cfg, self.N
        hidden = [c.hidden] * c.layers
        actor = init_stacked_mlp(N, [self.obs_dim, *hidden, self.act_dim], g)
        critic = init_stacked_mlp(N, [self.share_dim + N * self.act_dim, *hidden, 1], g)
        return actor, critic

    def init_state(self) -> MaddpgState:
        c, dev = self.cfg, self.device
        actor, critic = (tree_map(lambda x: x.to(dev), t) for t in self.init_params())
        zeros = lambda tree: AdamState(mu=[torch.zeros_like(p) for p in tree_leaves(tree)],
                                       nu=[torch.zeros_like(p) for p in tree_leaves(tree)])
        E, R, N, bf = self.local_envs, c.replay_size, self.N, torch.bfloat16
        z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
        replay = MaddpgReplay(
            obs=z(R, E, N, self.obs_dim, dtype=bf), share=z(R, E, self.share_dim, dtype=bf),
            actions=z(R, E, N, self.act_dim, dtype=bf), rewards=z(R, E),
            next_obs=z(R, E, N, self.obs_dim, dtype=bf),
            next_share=z(R, E, self.share_dim, dtype=bf), dones=z(R, E))
        self.state = MaddpgState(
            actor_params=actor, critic_params=critic,
            target_actor=tree_map(torch.clone, actor), target_critic=tree_map(torch.clone, critic),
            actor_opt=zeros(actor), critic_opt=zeros(critic), replay=replay,
            env_state=self.env.reset(E))
        return self.state

    # ------------------------------------------------------------ random draws
    def _normal(self, shape):
        """The rollout's noise [E, N, act] (over the global envs under a mesh)."""
        return draw(torch.randn, shape, self.generator, device=self.device)

    def _rows(self, count: int):
        """batch_size ring rows drawn uniformly from [0, max(count, 1))."""
        return torch.randint(0, max(count, 1), (self.cfg.batch_size,), generator=self.generator,
                             device=self.device)

    # -------------------------------------------------------------- internals
    def _act_all(self, actor_params, obs):
        """obs [B, N, obs] -> the actors' actions [B, N, act]."""
        return torch.tanh(mlp_apply(actor_params, obs.transpose(0, 1), self.cfg.layers)
                          ).transpose(0, 1)

    def _q_all(self, critic_params, share, joint):
        """Every agent's critic on (share [B, share], joint [N or 1, B, N *
        act]) -> [N, B]."""
        x = torch.cat([share[None].expand(joint.shape[0], *share.shape), joint], dim=-1)
        if x.shape[0] != self.N:
            x = x.expand(self.N, *x.shape[1:])
        return mlp_apply(critic_params, x, self.cfg.layers).squeeze(-1)

    def _views(self, obs_buf):
        """[E, full] clipped -> (per-agent obs [E, N, obs], share [E, full])."""
        return split_multi_agent_obs(obs_buf, self.N, self.env.num_ant_obs), obs_buf

    def _grad_update(self, st: MaddpgState):
        """One gradient step on B ring rows (B x E samples); returns the mean
        critic loss over the agents (a 0-d tensor)."""
        c, rp, mesh = self.cfg, st.replay, self.mesh
        B, E, N = c.batch_size, self.local_envs, self.N
        idx = self._rows(rp.count)
        rows = lambda t: t.index_select(0, idx).reshape(B * E, *t.shape[2:]).float()
        share, nshare = rows(rp.share), rows(rp.next_share)
        obs, nobs, acts = rows(rp.obs), rows(rp.next_obs), rows(rp.actions)
        rews, dones = rows(rp.rewards), rows(rp.dones)
        with torch.no_grad():
            joint_next = self._act_all(st.target_actor, nobs).reshape(B * E, -1)
            tq = self._q_all(st.target_critic, nshare, joint_next[None])
            target = rews + c.gamma * (1 - dones) * tq                           # [N, BE]
        joint = acts.reshape(B * E, -1)
        c_req = _requiring_grad(st.critic_params)
        closs = ((self._q_all(tree_unflatten(st.critic_params, c_req), share, joint[None])
                  - target) ** 2).mean(1)
        *cgrad, closs = mesh.mean(list(torch.autograd.grad(closs.sum(), c_req))
                                  + [closs.detach()])
        adam_update(tree_leaves(st.critic_params), cgrad, st.critic_opt, c.lr)
        # every actor against its updated critic; the others' actions from the ring
        a_req = _requiring_grad(st.actor_params)
        a = self._act_all(tree_unflatten(st.actor_params, a_req), obs)         # [BE, N, act]
        own = torch.eye(N, dtype=torch.bool, device=self.device)[:, None, :, None]
        mixed = torch.where(own, a.transpose(0, 1)[:, :, None], acts[None])      # [N, BE, N, act]
        aloss = -self._q_all(st.critic_params, share, mixed.reshape(N, B * E, -1)).mean(1)
        adam_update(tree_leaves(st.actor_params),
                    mesh.mean(list(torch.autograd.grad(aloss.sum(), a_req))), st.actor_opt, c.lr)
        with torch.no_grad():
            for tgt, src in ((st.target_actor, st.actor_params),
                             (st.target_critic, st.critic_params)):
                t_leaves = tree_leaves(tgt)
                torch._foreach_mul_(t_leaves, c.polyak)
                torch._foreach_add_(t_leaves, torch._foreach_mul(tree_leaves(src), 1 - c.polyak))
        self.grad_steps += 1
        return closs.detach().mean()

    def _env_step(self, st: MaddpgState, update: bool):
        """The actors with exploration noise, the env step, the ring write,
        then (when `update`) updates_per_step gradient steps; returns (mean
        reward, critic loss)."""
        c, rp = self.cfg, st.replay
        with torch.no_grad():
            obs, share = self._views(torch.clamp(st.env_state.obs, -c.clip_obs, c.clip_obs))
            a = self._act_all(st.actor_params, obs)
            a = torch.clamp(a + c.act_noise * self._normal(a.shape), -c.clip_actions,
                            c.clip_actions)
            nxt = self.env.step_batch(st.env_state, a.reshape(self.local_envs, -1))
            nobs, nshare = self._views(torch.clamp(nxt.obs, -c.clip_obs, c.clip_obs))
            bf = torch.bfloat16
            for dst, src in zip(rp.tensors(), (obs.to(bf), share.to(bf), a.to(bf), nxt.reward,
                                                nobs.to(bf), nshare.to(bf), nxt.done.float())):
                dst[rp.ptr] = src
        rp.ptr = (rp.ptr + 1) % c.replay_size
        rp.count = min(rp.count + 1, c.replay_size)
        st.env_state = nxt
        closs = torch.zeros((), device=self.device)
        if update:
            for _ in range(c.updates_per_step):
                closs = self._grad_update(st)
        return nxt.reward.mean(), closs

    def train_iter(self, update: bool = True):
        """nsteps env steps, each followed by its gradient steps (none when
        `update` is False: the collect-only iteration); returns the metrics
        (device tensors)."""
        st = self.state
        rews, closses = zip(*(self._env_step(st, update) for _ in range(self.cfg.nsteps)))
        st.iteration += 1
        return dict(mean_reward=self.mesh.mean(torch.stack(rews).mean()),
                    critic_loss=torch.stack(closses).mean())

    # ---------------------------------------------------------------- driving
    def run(self, num_iterations: int | None = None, log_interval: int = 1):
        c = self.cfg
        n = num_iterations or c.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        for it in range(self.state.iteration, n):
            t0 = time.perf_counter()
            # collect without updating until the ring holds a batch of rows
            metrics = self.train_iter(update=self.state.replay.count >= c.batch_size)
            if it % log_interval == 0:
                m = fetch_metrics(metrics)
                m["fps"] = c.nsteps * self.num_envs / (time.perf_counter() - t0)
                self.last_metrics = m
                if writer:
                    writer.add_scalar("train/mean_reward", m["mean_reward"], it)
                    writer.add_scalar("train/critic_loss", m["critic_loss"], it)
                if self.print_log:
                    print(f"[maddpg] it {it}: rew {m['mean_reward']:.3f} fps {m['fps']:.0f}",
                          flush=True)
            if self.log_dir and c.save_interval and (it + 1) % c.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"maddpg_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    def save(self, path: str):
        """The actors', the critics' parameters and the iteration (the JAX
        runner's file)."""
        st = self.state
        tree = bridge.maddpg_state_to_flax(st.actor_params, st.critic_params, st.iteration)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def restore(self, path: str):
        """Parameters and iteration from a file of either package; the
        targets, optimizer moments and the ring stay, as in the JAX runner."""
        if self.state is None:
            self.init_state()
        st = self.state
        actor, critic, iteration = bridge.maddpg_state_from_flax(checkpoint.load_tree(path),
                                                                  st.actor_params, st.critic_params)
        st.actor_params = checkpoint.restore_into(st.actor_params, actor)
        st.critic_params = checkpoint.restore_into(st.critic_params, critic)
        st.iteration = iteration

    @torch.no_grad()
    def eval(self, n_episodes: int | None = None, deterministic: bool = True):
        """Deterministic episodes in num_envs dedicated envs (reset from seed +
        10_000 and the iteration), the actors without exploration noise; the
        mean first-episode return."""
        if self.state is None:
            self.init_state()
        c, ap, E = self.cfg, self.state.actor_params, self.num_envs

        def policy(obs_buf):
            obs, _ = self._views(torch.clamp(obs_buf, -c.clip_obs, c.clip_obs))
            return self._act_all(ap, obs).reshape(E, -1)

        return evaluate_episodes(self.env, E, policy,
                                 eval_generator(self.seed, self.device, self.state.iteration))
