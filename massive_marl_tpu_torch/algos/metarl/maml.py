"""MAML-PPO meta-RL (twin of massive_marl_tpu/algos/metarl/maml.py).

A meta-iteration over meta_batch_size task slots.  Each slot keeps its own
batched env state across meta-iterations and a task angle drawn uniform in
(-pi, pi), drawn again every meta-iteration.  Per slot:
  * adapt_steps inner steps: a support rollout of support_steps, then
    params - inner_lr * d pg_loss / d params, the gradient taken with
    create_graph=True, so the meta-gradient is exact second order;
  * a query rollout of query_steps with the adapted parameters, and its
    pg_loss under them (evaluated with torch.func.functional_call).
Rollouts sample with detached parameters (trajectories are data, so the
physics needs no backward).  The meta step is Adam(lr) after global-norm
clipping on the mean of the slots' query losses.

The task reward (`_task_reward`): on an ant task, the velocity of ant 0's
torso projected on the task heading, zero on a step that crosses a reset
(prev.done, or progress not advancing), plus 0.05 x the env reward; on an
env whose state has a `pos`, -(pos - angle / pi)**2; else the env reward.
`pg_loss`: GAE with the advantages detached and normalised by their
population std, the clipped ratio against the detached rollout log-prob,
plus the unclipped value loss.  As in the JAX package, the config reads no
`policy` block (the nets are (256, 256)).  Random draws go through
`_normal` (action noise) and `_uniform` (task angles).

Under a `mesh` (parallel/mesh.py) each slot's envs are split over the
ranks (axis 1 of the JAX package's [slots, E] env state), each holding an
equal share.  The meta-gradient is the single-process one: the advantages
are normalised by their global mean and std, the inner gradient is the
ranks' mean through a differentiable all-reduce (Mesh.mean_diff, so each
rank's Hessian meets the global query gradient), and the meta-gradients,
losses and rewards are averaged over the ranks.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List

import torch
from torch.func import functional_call

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos import nets
from massive_marl_tpu_torch.algos.rl.ppo import AdamState, adam_update, gae, normalized
from massive_marl_tpu_torch.envs.base import env_generator
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer


@dataclass
class MAMLConfig:
    support_steps: int = 8
    query_steps: int = 8
    adapt_steps: int = 1
    inner_lr: float = 0.01
    meta_batch_size: int = 4
    gamma: float = 0.96
    lam: float = 0.95
    cliprange: float = 0.2
    lr: float = 3e-4
    max_grad_norm: float = 1.0
    hidden: tuple = (256, 256)
    activation: str = "elu"
    init_noise_std: float = 0.8
    clip_obs: float = 5.0
    clip_actions: float = 1.0
    max_iterations: int = 1000
    save_interval: int = 200

    @classmethod
    def from_cfg_train(cls, cfg_train: dict) -> "MAMLConfig":
        learn = cfg_train.get("learn", {})
        kw = {}
        for k, yk in {"support_steps": "support_steps", "query_steps": "query_steps",
                      "adapt_steps": "adapt_steps", "inner_lr": "inner_lr",
                      "meta_batch_size": "meta_batch_size", "gamma": "gamma",
                      "lam": "lam", "cliprange": "cliprange", "lr": "optim_stepsize",
                      "max_iterations": "max_iterations",
                      "save_interval": "save_interval"}.items():
            if yk in learn:
                kw[k] = learn[yk]
        if "lr" in kw:
            kw["lr"] = float(kw["lr"])
        return cls(**kw)


@dataclass
class MAMLState:
    opt: AdamState
    env_states: List[Any]          # one batched EnvState per task slot
    task_params: torch.Tensor      # [meta_batch_size] task angles
    iteration: int = 0


class MAMLPPO:
    """Meta-trainer over a batched env; the tasks are reward-shaping
    parameters (a target heading angle)."""

    def __init__(self, env, num_envs: int, cfg: MAMLConfig | None = None, seed: int = 0,
                 log_dir: str | None = None, print_log: bool = True, device=None, mesh=None):
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, trainer on {self.device}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env = env
        self.num_envs = num_envs
        self.cfg = c = cfg or MAMLConfig()
        self.seed = seed
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
        self.model = nets.ActorCritic(self.obs_dim, self.act_dim, c.hidden, c.hidden,
                                      c.activation, c.init_noise_std,
                                      generator=init_gen).to(self.device)
        self.state: MAMLState | None = None
        self.last_metrics: Dict[str, float] = {}

    # ------------------------------------------------------------ random draws
    def _normal(self, shape, generator=None):
        """Action noise [E, act] (over the global envs under a mesh)."""
        return draw(torch.randn, shape, generator or self.generator, device=self.device)

    def _uniform(self, shape, generator=None):
        """Task angles uniform in (-pi, pi)."""
        u = torch.rand(shape, generator=generator or self.generator, device=self.device)
        return u * (2 * math.pi) - math.pi

    def init_state(self) -> MAMLState:
        params = list(self.model.parameters())
        c = self.cfg
        self.state = MAMLState(
            opt=AdamState(mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params]),
            env_states=[self.env.reset(self.local_envs) for _ in range(c.meta_batch_size)],
            task_params=self._uniform((c.meta_batch_size,)))
        return self.state

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _apply(self, params, obs):
        return functional_call(self.model, params, (obs,))

    # ------------------------------------------------------------ task reward
    def _task_reward(self, prev, nxt, task_param):
        pl = getattr(nxt, "pipeline", None)
        if pl is not None and hasattr(pl, "ant_qpos"):
            dt = getattr(getattr(self.env, "spec", None), "dt", 0.0166)
            xy1 = prev.pipeline.ant_qpos[..., 0, 0:2]
            xy2 = pl.ant_qpos[..., 0, 0:2]
            heading = torch.stack([torch.cos(task_param), torch.sin(task_param)])
            proj_v = ((xy2 - xy1) / dt) @ heading
            reset_step = prev.done | (nxt.progress <= prev.progress)
            proj_v = torch.where(reset_step, 0.0, proj_v)
            return proj_v + 0.05 * nxt.reward
        if hasattr(nxt, "pos"):
            return -(nxt.pos - task_param / math.pi) ** 2
        return nxt.reward

    # -------------------------------------------------------------- rollouts
    @torch.no_grad()
    def rollout(self, params, env_state, n_steps: int, task_param, generator=None):
        """n_steps of the policy under `params` (detached); returns (env
        state, trajectory [T, E, ...]: obs, actions, logp, value, reward (the
        task's), done)."""
        c = self.cfg
        params = {k: v.detach() for k, v in params.items()}
        steps = []
        for _ in range(n_steps):
            obs = torch.clamp(env_state.obs, -c.clip_obs, c.clip_obs)
            mean, value, log_std = self._apply(params, obs)
            a = nets.gaussian_sample(mean, log_std, noise=self._normal(mean.shape, generator))
            logp = nets.gaussian_log_prob(mean, log_std, a)
            nxt = self.env.step_batch(env_state, torch.clamp(a, -c.clip_actions, c.clip_actions))
            steps.append(dict(obs=obs, actions=a, logp=logp, value=value,
                              reward=self._task_reward(env_state, nxt, task_param),
                              done=nxt.done.to(torch.float32)))
            env_state = nxt
        return env_state, {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    def pg_loss(self, params, traj, last_obs):
        """The A2C-style clipped surrogate plus the value loss of `traj`
        under `params` (differentiable in `params`)."""
        c = self.cfg
        with torch.no_grad():
            adv = gae(traj, self._apply(params, last_obs)[1], c.gamma, c.lam)
            returns = adv + traj["value"]
            adv_n = normalized(adv, self.mesh)
        mean, value, log_std = self._apply(params, traj["obs"])
        ratio = torch.exp(nets.gaussian_log_prob(mean, log_std, traj["actions"])
                          - traj["logp"].detach())
        surr = -torch.mean(torch.minimum(
            ratio * adv_n, torch.clamp(ratio, 1 - c.cliprange, 1 + c.cliprange) * adv_n))
        return surr + torch.mean((value - returns) ** 2)

    def adapt(self, params, env_state, task_param, create_graph: bool = True, generator=None):
        """adapt_steps inner steps from `env_state`; returns (adapted
        params, env state after the support rollouts)."""
        c = self.cfg
        for _ in range(c.adapt_steps):
            env_state, traj = self.rollout(params, env_state, c.support_steps, task_param,
                                           generator)
            last = torch.clamp(env_state.obs, -c.clip_obs, c.clip_obs)
            names = list(params)
            grads = torch.autograd.grad(self.pg_loss(params, traj, last),
                                        [params[k] for k in names], create_graph=create_graph)
            grads = self.mesh.mean_diff(grads) if create_graph else self.mesh.mean(list(grads))
            params = {k: params[k] - c.inner_lr * g for k, g in zip(names, grads)}
        return params, env_state

    # ------------------------------------------------------------ meta step
    def meta_grads(self, create_graph: bool = True):
        """The meta-gradient (a list in named_parameters order), the meta
        loss and the slots' mean query reward; advances the slots' env
        states.  create_graph=False drops the second-order term (for the
        tests)."""
        c, st = self.cfg, self.state
        params = self.params()
        names = list(params)
        grads = [torch.zeros_like(p) for p in params.values()]
        losses, rews = [], []
        for i in range(c.meta_batch_size):
            tp = st.task_params[i]
            adapted, env_state = self.adapt(params, st.env_states[i], tp, create_graph)
            env_state, qtraj = self.rollout(adapted, env_state, c.query_steps, tp)
            last = torch.clamp(env_state.obs, -c.clip_obs, c.clip_obs)
            loss = self.pg_loss(adapted, qtraj, last)
            g = torch.autograd.grad(loss / c.meta_batch_size, [params[k] for k in names])
            torch._foreach_add_(grads, g)
            st.env_states[i] = env_state
            losses.append(loss.detach())
            rews.append(qtraj["reward"].mean())
        *grads, loss, rew = self.mesh.mean(grads + [torch.stack(losses).mean(),
                                                     torch.stack(rews).mean()])
        return grads, loss, rew

    def meta_iter(self):
        """One meta-iteration; returns its metrics (device scalars)."""
        c, st = self.cfg, self.state
        grads, loss, mean_rew = self.meta_grads()
        adam_update(list(self.model.parameters()), grads, st.opt, c.lr, c.max_grad_norm)
        st.task_params = self._uniform((c.meta_batch_size,))
        st.iteration += 1
        return dict(meta_loss=loss, mean_reward=mean_rew)

    # ------------------------------------------------------------ evaluation
    def eval_adapt(self, env_state, task_param, generator):
        """(pre, post): the mean task reward of a query rollout before and
        after the inner adaptation, both from `env_state` (a step builds a
        new state and leaves its input as it was) with the same draws of
        `generator` (the action noise and, through env_generator, the env's
        resets), so only the adaptation differs."""
        c = self.cfg
        params = {k: v.detach().requires_grad_(True) for k, v in self.params().items()}
        snap = generator.get_state()
        _, pre = self.rollout(params, env_state, c.query_steps, task_param, generator)
        adapted, _ = self.adapt(params, env_state, task_param, False, generator)
        generator.set_state(snap)
        _, post = self.rollout(adapted, env_state, c.query_steps, task_param, generator)
        return pre["reward"].mean(), post["reward"].mean()

    def eval_adaptation(self, n_tasks: int = 8, seed: int | None = None):
        """(pre, post) averaged over n_tasks held-out angles drawn from a
        generator seeded with seed + 20_000 (the trainer's seed by default);
        each task's envs are reset from that generator, which also draws
        the actions, so the training streams are left as they were."""
        if self.state is None:
            self.init_state()
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed if seed is None else seed) + 20_000)
        g = self.mesh.shard_generator(g, self.num_envs)
        task_params = self._uniform((n_tasks,), g)
        pres, posts = [], []
        with env_generator(self.env, g):
            for i in range(n_tasks):
                es = self.env.reset(self.local_envs)
                pre, post = self.mesh.mean(list(self.eval_adapt(es, task_params[i], g)))
                pres.append(float(pre))
                posts.append(float(post))
        return sum(pres) / n_tasks, sum(posts) / n_tasks

    # ---------------------------------------------------------------- driving
    def run(self, num_iterations: int | None = None, log_interval: int = 1):
        n = num_iterations or self.cfg.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        for it in range(self.state.iteration, n):
            t0 = time.perf_counter()
            m = self.meta_iter()
            if it % log_interval == 0:
                m = {k: float(v) for k, v in m.items()}
                self.last_metrics = m
                if writer:
                    writer.add_scalar("train/meta_loss", m["meta_loss"], it)
                    writer.add_scalar("train/mean_reward", m["mean_reward"], it)
                if self.print_log:
                    print(f"[mamlppo] it {it}: loss {m['meta_loss']:.3f} "
                          f"rew {m['mean_reward']:.3f} ({time.perf_counter() - t0:.2f}s)",
                          flush=True)
            if self.log_dir and self.cfg.save_interval and (it + 1) % self.cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str):
        """Parameters and iteration (the JAX trainer's file)."""
        tree = bridge.mtppo_state_to_flax(self.model.state_dict(), self.state.iteration)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def load(self, path: str):
        """Restore parameters and iteration from a file of either package;
        the optimizer, slots and task angles stay as they are."""
        if self.state is None:
            self.init_state()
        params, iteration = bridge.mtppo_state_from_flax(checkpoint.load_tree(path),
                                                         what="MAML checkpoint")
        self.model.load_state_dict(checkpoint.restore_into(self.model.state_dict(), params))
        self.state.iteration = iteration
