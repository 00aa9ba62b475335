"""Multi-task SAC (twin of massive_marl_tpu/algos/mtrl/mtsac.py).

One squashed-Gaussian SAC policy and twin Q trained across K tasks:
  * observations are clipped, zero-padded to the widest task's and
    followed by the task one-hot; actions are sampled at the widest task's
    width and cut per task (clipped to +-1) for its env;
  * one float32 replay ring [R, E, ...] is shared by every task (not the
    bf16 ring of rl/offpolicy.Replay: the JAX MTSAC ring is float32); each
    task's collect step writes one slot and advances the host-side ptr and
    count;
  * once count >= batch_size an iteration ends with noptepochs x
    nminibatches gradient steps on batch_size slots x E envs drawn from
    [0, max(count, 1)): the Q step (the backup from the current pi, the
    targets' twin min and the fixed ent_coef), then the pi step against the
    new Q, each Adam(lr) after global-norm clipping, then Polyak averaging
    of every network;
  * rewards are not scaled (the JAX MTSAC ignores reward_scale).
The networks are rl/offpolicy's flax-layout trees (init_mlp,
sg_actor_apply, q_apply, squashed_sample).  Random draws go through
`_normal` and `_slots`, in the reference's order.  The JAX MTSAC has no
save/load, so this one has none.

Under a `mesh` (parallel/mesh.py) each rank steps E / R envs of every task
and the shared ring holds their columns (axis 1).  The slots are drawn
alike on every rank and carry every env, so the Q and pi gradients and the
Q loss are averaged over the ranks; a batch's noise is drawn over the
global rows (parallel/mesh.draw_rows).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict

import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos.mtrl.mtppo import check_devices
from massive_marl_tpu_torch.algos.rl.offpolicy import (OffPolicyConfig, _detached, init_dense,
                                                       init_mlp, q_apply, sg_actor_apply,
                                                       squashed_sample)
from massive_marl_tpu_torch.algos.rl.ppo import AdamState, adam_update
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw_rows
from massive_marl_tpu_torch.utils.logging import Writer
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map
from massive_marl_tpu_torch.wrap.multi_task_vec_task import task_obs


@dataclass
class MTSACConfig(OffPolicyConfig):
    pass


@dataclass
class Ring:
    """The shared float32 replay ring; ptr and count count slots."""
    obs: torch.Tensor        # [R, E, obs]
    actions: torch.Tensor    # [R, E, act]
    rewards: torch.Tensor    # [R, E]
    dones: torch.Tensor      # [R, E]
    next_obs: torch.Tensor   # [R, E, obs]
    ptr: int = 0
    count: int = 0

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.obs, self.actions, self.rewards, self.dones, self.next_obs))


@dataclass
class MTSACState:
    params: dict             # {"pi", "q1", "q2"}
    target_params: dict
    opt_pi: AdamState
    opt_q: AdamState
    replay: Ring
    env_states: Dict[str, Any]
    iteration: int = 0


class MTSAC:
    def __init__(self, envs: Dict[str, Any], num_envs: int, cfg: MTSACConfig | None = None,
                 seed: int = 0, log_dir: str | None = None, print_log: bool = True,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        check_devices(envs, self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.envs = envs
        self.task_names = sorted(envs)
        self.K = len(self.task_names)
        self.num_envs = num_envs
        self.cfg = cfg or MTSACConfig(algo="sac")
        self.seed = seed
        self.log_dir = log_dir
        self.print_log = print_log
        self.max_obs = max(e.num_obs for e in envs.values())
        self.obs_dim = self.max_obs + self.K
        self.act_dims = {t: envs[t].num_actions * envs[t].num_agents for t in self.task_names}
        self.act_dim = max(self.act_dims.values())
        self.n_hidden = self.cfg.hidden_layer
        self.mesh = mesh or LOCAL
        self.local_envs = num_envs
        for env in envs.values():
            self.local_envs = self.mesh.shard_env(env, num_envs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, num_envs)
        self.state: MTSACState | None = None
        self.last_metrics: Dict[str, float] = {}
        # cumulative gradient steps taken by this trainer
        self.grad_steps = 0

    def _aug(self, obs: torch.Tensor, idx: int) -> torch.Tensor:
        return task_obs(obs, self.max_obs, self.K, idx)

    def init_params(self) -> dict:
        g = torch.Generator()
        g.manual_seed(self.seed)
        hidden = [self.cfg.hidden_nodes] * self.n_hidden
        pi = init_mlp([self.obs_dim, *hidden, self.act_dim], g)
        pi["params"][f"Dense_{self.n_hidden + 1}"] = init_dense(hidden[-1], self.act_dim, g)
        q = lambda: init_mlp([self.obs_dim + self.act_dim, *hidden, 1], g)
        return {"pi": pi, "q1": q(), "q2": q()}

    def init_state(self) -> MTSACState:
        cfg, dev = self.cfg, self.device
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), self.init_params())
        zeros = lambda leaves: AdamState(mu=[torch.zeros_like(p) for p in leaves],
                                         nu=[torch.zeros_like(p) for p in leaves])
        R, E = cfg.replay_size, self.local_envs
        ring = Ring(obs=torch.zeros((R, E, self.obs_dim), device=dev),
                    actions=torch.zeros((R, E, self.act_dim), device=dev),
                    rewards=torch.zeros((R, E), device=dev), dones=torch.zeros((R, E), device=dev),
                    next_obs=torch.zeros((R, E, self.obs_dim), device=dev))
        self.state = MTSACState(
            params=params, target_params=_detached(tree_map(torch.clone, params)),
            opt_pi=zeros(tree_leaves(params["pi"])),
            opt_q=zeros(tree_leaves({"q1": params["q1"], "q2": params["q2"]})),
            replay=ring, env_states={t: self.envs[t].reset(E) for t in self.task_names})
        return self.state

    # ------------------------------------------------------------ random draws
    def _normal(self, shape):
        """N(0, 1) over `shape`, whose leading axis is one step's envs or a
        batch's slots x envs (over the global envs under a mesh)."""
        return draw_rows(torch.randn, shape, self.generator, device=self.device)

    def _slots(self, count: int):
        """batch_size slots drawn uniformly from [0, max(count, 1))."""
        return torch.randint(0, max(count, 1), (self.cfg.batch_size,), generator=self.generator,
                             device=self.device)

    # ---------------------------------------------------------------- collect
    def _pi(self, pi_params, obs):
        return sg_actor_apply(pi_params, obs, self.n_hidden)

    def _q(self, q, obs, act):
        return q_apply(q, obs, act, self.n_hidden)

    @torch.no_grad()
    def collect(self, task: str):
        """nsteps of `task`, each written to the ring; returns the mean
        reward (a device scalar)."""
        c, st, rp = self.cfg, self.state, self.state.replay
        env, idx, act_dim = self.envs[task], self.task_names.index(task), self.act_dims[task]
        env_state = st.env_states[task]
        rews = []
        for _ in range(c.nsteps):
            obs = self._aug(torch.clamp(env_state.obs, -c.clip_obs, c.clip_obs), idx)
            mu, log_std = self._pi(st.params["pi"], obs)
            a, _ = squashed_sample(mu, log_std, self._normal(mu.shape))
            env_state = env.step_batch(env_state, torch.clamp(a[:, :act_dim], -1.0, 1.0))
            rp.obs[rp.ptr] = obs
            rp.actions[rp.ptr] = a
            rp.rewards[rp.ptr] = env_state.reward
            rp.dones[rp.ptr] = env_state.done.to(torch.float32)
            rp.next_obs[rp.ptr] = self._aug(torch.clamp(env_state.obs, -c.clip_obs, c.clip_obs),
                                            idx)
            rp.ptr = (rp.ptr + 1) % c.replay_size
            rp.count = min(rp.count + 1, c.replay_size)
            rews.append(env_state.reward.mean())
        st.env_states[task] = env_state
        return torch.stack(rews).mean()

    # ----------------------------------------------------------------- update
    def grad_step(self):
        """One Q step, one pi step and the Polyak averaging on a batch drawn
        from the ring; returns the Q loss (a 0-d tensor)."""
        c, st, rp = self.cfg, self.state, self.state.replay
        B, mesh = c.batch_size * self.local_envs, self.mesh
        idx = self._slots(rp.count)
        o, a = rp.obs[idx].reshape(B, -1), rp.actions[idx].reshape(B, -1)
        r, d = rp.rewards[idx].reshape(B), rp.dones[idx].reshape(B)
        o2 = rp.next_obs[idx].reshape(B, -1)
        params, tp = st.params, st.target_params
        with torch.no_grad():
            mu2, ls2 = self._pi(params["pi"], o2)
            a2, logp2 = squashed_sample(mu2, ls2, self._normal(mu2.shape))
            tq = torch.minimum(self._q(tp["q1"], o2, a2), self._q(tp["q2"], o2, a2))
            backup = r + c.gamma * (1 - d) * (tq - c.ent_coef * logp2)
        qloss = (torch.mean((self._q(params["q1"], o, a) - backup) ** 2)
                 + torch.mean((self._q(params["q2"], o, a) - backup) ** 2))
        q_leaves = tree_leaves({"q1": params["q1"], "q2": params["q2"]})
        *qgrad, qloss = mesh.mean(list(torch.autograd.grad(qloss, q_leaves)) + [qloss.detach()])
        adam_update(q_leaves, qgrad, st.opt_q, c.lr, c.max_grad_norm)
        mu, ls = self._pi(params["pi"], o)
        api, logp = squashed_sample(mu, ls, self._normal(mu.shape))
        q1, q2 = _detached(params["q1"]), _detached(params["q2"])
        ploss = torch.mean(c.ent_coef * logp
                           - torch.minimum(self._q(q1, o, api), self._q(q2, o, api)))
        pi_leaves = tree_leaves(params["pi"])
        adam_update(pi_leaves, mesh.mean(list(torch.autograd.grad(ploss, pi_leaves))), st.opt_pi,
                    c.lr, c.max_grad_norm)
        with torch.no_grad():
            t_leaves = tree_leaves(tp)
            torch._foreach_mul_(t_leaves, c.polyak)
            torch._foreach_add_(t_leaves, torch._foreach_mul(tree_leaves(params), 1 - c.polyak))
        self.grad_steps += 1
        return qloss.detach()

    def train_iter(self):
        """Every task's collect steps, then the gradient steps once the
        ring holds batch_size slots; returns (per-task mean rewards, the
        last Q loss or None)."""
        c = self.cfg
        rewards = {t: self.collect(t) for t in self.task_names}
        if self.mesh is not LOCAL:
            rewards = dict(zip(rewards, self.mesh.mean(list(rewards.values()))))
        qloss = None
        if self.state.replay.count >= c.batch_size:
            for _ in range(c.noptepochs * c.nminibatches):
                qloss = self.grad_step()
        self.state.iteration += 1
        return rewards, qloss

    # ---------------------------------------------------------------- driving
    def run(self, num_iterations: int | None = None, log_interval: int = 1):
        n = num_iterations or self.cfg.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        for it in range(self.state.iteration, n):
            t0 = time.perf_counter()
            rewards, qloss = self.train_iter()
            if it % log_interval == 0:
                m = {t: float(r) for t, r in rewards.items()}
                ql = 0.0 if qloss is None else float(qloss)
                self.last_metrics = {**{f"reward_{t}": r for t, r in m.items()}, "q_loss": ql}
                if writer:
                    for t, r in m.items():
                        writer.add_scalar(f"train/reward_{t}", r, it)
                    writer.add_scalar("train/q_loss", ql, it)
                if self.print_log:
                    rs = " ".join(f"{t}:{r:.2f}" for t, r in m.items())
                    print(f"[mtsac] it {it}: {rs} qloss {ql:.3f} "
                          f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if writer:
            writer.close()
        return self.state
