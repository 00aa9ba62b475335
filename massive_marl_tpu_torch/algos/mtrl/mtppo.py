"""Multi-task PPO and the random-policy baseline (twin of
massive_marl_tpu/algos/mtrl/mtppo.py).

One ActorCritic (algos/nets.py) is shared by K tasks whose obs and action
widths may differ:
  * observations are clipped, zero-padded to the widest task's and, in mode
    "add-onehot", followed by the task's one-hot ("vanilla": nothing
    appended);
  * actions are sampled at the widest task's width, their log-prob summed
    over all of it, and the first act_dim columns go to the task's env;
  * each task collects nsteps with its own GAE; the batches are joined in
    sorted(task name) order;
  * the update normalises the advantages over the joined batch (population
    std), then takes noptepochs full-batch steps (no minibatches, no
    adaptive KL) of the clipped surrogate plus vf_coef x the clipped value
    loss: p -= lr * Adam(clip_by_global_norm(g)) (ppo.adam_update).
Per-task mean rewards are logged apart.  The checkpoint is the JAX
trainer's file {"params": the flax ActorCritic tree, "iteration"}
(utils/bridge.mtppo_state_to_flax), so either package restores the other's.
The action noise goes through `_normal`, in the reference's order.

Under a `mesh` (parallel/mesh.py) each rank steps E / R envs of every task
and holds an equal share of the joined batch: the advantages are
normalised by their global mean and std, and the gradients (the bf16
layers' f32 partial sums, rounded after the mean) and losses are averaged
over the ranks.  The logged rewards are global.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos import nets
from massive_marl_tpu_torch.algos.rl.ppo import (AdamState, PPOConfig, adam_update, gae,
                                                 grads_or_zeros, normalized)
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer
from massive_marl_tpu_torch.wrap.multi_task_vec_task import task_obs


@dataclass
class MTPPOConfig(PPOConfig):
    task_sample_mode: str = "round_robin"
    # "add-onehot" appends the task one-hot to the obs; "vanilla" feeds the
    # padded obs
    mode: str = "add-onehot"

    @classmethod
    def from_cfg_train(cls, cfg_train: dict) -> "MTPPOConfig":
        """PPOConfig's key map plus `mode` (the YAML's task_sample_mode is
        not read, as in the JAX package)."""
        base = PPOConfig.from_cfg_train(cfg_train)
        mode = cfg_train.get("mode", "add-onehot")
        if mode not in ("add-onehot", "vanilla"):
            raise ValueError(f"unknown multi-task mode {mode!r}")
        return cls(**base.__dict__, mode=mode)


@dataclass
class MTPPOState:
    opt: AdamState
    lr: torch.Tensor
    env_states: Dict[str, Any]     # task -> batched EnvState
    iteration: int = 0


def check_devices(envs: Dict[str, Any], device: torch.device):
    for t, env in envs.items():
        if torch.device(env.device) != device:
            raise ValueError(f"env {t} is on {env.device}, trainer on {device}")


class MTPPO:
    """MTPPO(envs, num_envs, cfg).run(max_iterations); `envs` maps task
    names to batched envs on one device, num_envs per task."""

    def __init__(self, envs: Dict[str, Any], num_envs: int, cfg: MTPPOConfig | None = None,
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
        self.cfg = cfg or MTPPOConfig()
        self.seed = seed
        self.log_dir = log_dir
        self.print_log = print_log
        self.obs_dims = {t: envs[t].num_obs for t in self.task_names}
        self.act_dims = {t: envs[t].num_actions * envs[t].num_agents for t in self.task_names}
        self.max_obs = max(self.obs_dims.values())
        self.max_act = max(self.act_dims.values())
        self.obs_dim = self.max_obs + (self.K if self.cfg.mode == "add-onehot" else 0)
        self.mesh = mesh or LOCAL
        self.local_envs = num_envs
        for env in envs.values():
            self.local_envs = self.mesh.shard_env(env, num_envs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, num_envs)
        init_gen = torch.Generator()
        init_gen.manual_seed(seed)
        c = self.cfg
        self.model = nets.ActorCritic(self.obs_dim, self.max_act, c.hidden, c.hidden,
                                      c.activation, c.init_noise_std,
                                      generator=init_gen).to(self.device)
        self.state: MTPPOState | None = None
        self.last_metrics: Dict[str, float] = {}

    def _aug_obs(self, obs: torch.Tensor, task_idx: int) -> torch.Tensor:
        return task_obs(obs, self.max_obs, self.K, task_idx, self.cfg.mode == "add-onehot")

    def init_state(self) -> MTPPOState:
        params = list(self.model.parameters())
        self.state = MTPPOState(
            opt=AdamState(mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params]),
            lr=torch.tensor(self.cfg.lr, device=self.device),
            env_states={t: self.envs[t].reset(self.local_envs) for t in self.task_names})
        return self.state

    def _normal(self, shape):
        """The action noise of one rollout step (over the global envs under
        a mesh)."""
        return draw(torch.randn, shape, self.generator, device=self.device)

    # ---------------------------------------------------------------- collect
    @torch.no_grad()
    def collect(self, task: str):
        """nsteps of `task` under the shared policy; advances its env state
        and returns (flat batch with GAE advantages and returns, mean
        reward)."""
        cfg, env = self.cfg, self.envs[task]
        idx, act_dim = self.task_names.index(task), self.act_dims[task]
        env_state = self.state.env_states[task]
        steps = []
        for _ in range(cfg.nsteps):
            obs = self._aug_obs(torch.clamp(env_state.obs, -cfg.clip_obs, cfg.clip_obs), idx)
            mean, value, log_std = self.model(obs)
            actions = nets.gaussian_sample(mean, log_std, noise=self._normal(mean.shape))
            logp = nets.gaussian_log_prob(mean, log_std, actions)
            env_state = env.step_batch(env_state, torch.clamp(
                actions[:, :act_dim], -cfg.clip_actions, cfg.clip_actions))
            steps.append(dict(obs=obs, actions=actions, logp=logp, value=value,
                              reward=env_state.reward, done=env_state.done.to(torch.float32)))
        self.state.env_states[task] = env_state
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        last = self._aug_obs(torch.clamp(env_state.obs, -cfg.clip_obs, cfg.clip_obs), idx)
        adv = gae(traj, self.model(last)[1], cfg.gamma, cfg.lam)
        n = cfg.nsteps * self.local_envs
        batch = dict(obs=traj["obs"].reshape(n, -1), actions=traj["actions"].reshape(n, -1),
                     logp=traj["logp"].reshape(n), value=traj["value"].reshape(n),
                     adv=adv.reshape(n), returns=(adv + traj["value"]).reshape(n))
        return batch, traj["reward"].mean()

    def collect_all(self):
        """Every task's batch, joined in task-name order, and the per-task
        mean rewards (device scalars)."""
        batches, rewards = [], {}
        for t in self.task_names:
            batch, rewards[t] = self.collect(t)
            batches.append(batch)
        return {k: torch.cat([b[k] for b in batches]) for k in batches[0]}, rewards

    # ----------------------------------------------------------------- update
    def _normalized(self, batch):
        return dict(batch, adv=normalized(batch["adv"], self.mesh))

    def _mean_grads(self, fn):
        """(gradients of fn()'s loss over the model, fn()'s 0-d aux value):
        under a mesh averaged over the ranks in one collective, the bf16
        layers' gradients as f32 partial sums rounded after the mean."""
        params = list(self.model.parameters())
        if self.mesh is LOCAL:
            loss, aux = fn()
            return grads_or_zeros(loss, params), aux
        with nets.f32_weight_grads():
            loss, aux = fn()
            grads = grads_or_zeros(loss, params)
        *grads, aux = self.mesh.mean(grads + [aux])
        return nets.round_bf16(grads, nets.MLP.bf16_mask(self.model)), aux

    def _loss(self, batch):
        cfg = self.cfg
        mean, value, log_std = self.model(batch["obs"])
        ratio = torch.exp(nets.gaussian_log_prob(mean, log_std, batch["actions"]) - batch["logp"])
        adv = batch["adv"]
        surr = torch.mean(torch.maximum(
            -adv * ratio, -adv * torch.clamp(ratio, 1 - cfg.cliprange, 1 + cfg.cliprange)))
        v_clip = batch["value"] + torch.clamp(value - batch["value"], -cfg.cliprange,
                                              cfg.cliprange)
        vloss = torch.mean(torch.maximum((value - batch["returns"]) ** 2,
                                         (v_clip - batch["returns"]) ** 2))
        return surr + cfg.vf_coef * vloss, vloss.detach()

    def update(self, batch):
        """noptepochs full-batch steps on the joined batch; returns the
        mean value loss over the epochs."""
        batch = self._normalized(batch)
        params = list(self.model.parameters())
        vlosses = []
        for _ in range(self.cfg.noptepochs):
            grads, vloss = self._mean_grads(lambda: self._loss(batch))
            adam_update(params, grads, self.state.opt, self.state.lr, self.cfg.max_grad_norm)
            vlosses.append(vloss)
        return torch.stack(vlosses).mean()

    def train_iter(self):
        """One iteration; returns (per-task mean rewards, value loss) as
        device scalars."""
        batch, rewards = self.collect_all()
        vloss = self.update(batch)
        self.state.iteration += 1
        if self.mesh is not LOCAL:
            rewards = dict(zip(rewards, self.mesh.mean(list(rewards.values()))))
        return rewards, vloss

    # ---------------------------------------------------------------- driving
    def run(self, num_learning_iterations: int | None = None, log_interval: int = 1):
        n = num_learning_iterations or self.cfg.max_iterations
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        tag = type(self).__name__.lower()
        for it in range(self.state.iteration, n):
            t0 = time.perf_counter()
            rewards, vloss = self.train_iter()
            if it % log_interval == 0:
                m = {t: float(r) for t, r in rewards.items()}
                self.last_metrics = {**{f"reward_{t}": r for t, r in m.items()},
                                     "value_loss": float(vloss)}
                if writer:
                    for t, r in m.items():
                        writer.add_scalar(f"train/reward_{t}", r, it)
                    writer.add_scalar("train/value_loss", self.last_metrics["value_loss"], it)
                if self.print_log:
                    rews = " ".join(f"{t}:{r:.2f}" for t, r in m.items())
                    print(f"[{tag}] it {it}: {rews} ({time.perf_counter() - t0:.2f}s)",
                          flush=True)
            if self.log_dir and self.cfg.save_interval and (it + 1) % self.cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str):
        """Parameters and iteration (the JAX trainer's file; no optimizer
        state, as there)."""
        tree = bridge.mtppo_state_to_flax(self.model.state_dict(), self.state.iteration)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def load(self, path: str):
        """Restore parameters and iteration from a file of either package;
        the optimizer, lr and envs stay as they are, as in the JAX
        trainer."""
        if self.state is None:
            self.init_state()
        params, iteration = bridge.mtppo_state_from_flax(checkpoint.load_tree(path))
        self.model.load_state_dict(checkpoint.restore_into(self.model.state_dict(), params))
        self.state.iteration = iteration


class RandomPolicyRunner:
    """`--algo random`: every task stepped with actions uniform in [-1, 1),
    iterations x steps_per_iter steps from a fresh reset; the mean reward
    per step of each task.  The draws go through `_uniform`."""

    def __init__(self, envs: Dict[str, Any], num_envs: int = 32, seed: int = 0, device=None):
        self.device = resolve_device(device)
        check_devices(envs, self.device)
        self.envs = envs
        self.num_envs = num_envs
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _uniform(self, shape):
        return torch.rand(shape, generator=self.generator, device=self.device) * 2.0 - 1.0

    @torch.no_grad()
    def run(self, iterations: int = 10, steps_per_iter: int = 8) -> Dict[str, float]:
        results = {}
        for t, env in self.envs.items():
            state = env.reset(self.num_envs)
            act_dim = env.num_actions * env.num_agents
            total = torch.zeros((), device=self.device)
            for _ in range(iterations * steps_per_iter):
                state = env.step_batch(state, self._uniform((self.num_envs, act_dim)))
                total = total + state.reward.mean()
            results[t] = float(total) / (iterations * steps_per_iter)
            print(f"[random] {t}: mean reward/step {results[t]:.3f}", flush=True)
        return results
